"""Evaluation metrics for boosting (host-side numpy).

A copy of ``auc`` from the JAX package's ``models/gbdt/metrics.py``; the
other metrics arrive with validation and early stopping.
"""

from __future__ import annotations

import numpy as np


def auc(labels, margin, weights=None) -> float:
    w = np.ones_like(margin) if weights is None else np.asarray(weights, np.float64)
    order = np.argsort(margin, kind="stable")
    y = np.asarray(labels, np.float64)[order]
    w = w[order]
    pos = (y > 0).astype(np.float64) * w
    neg = (1.0 - (y > 0)) * w
    cum_neg = np.cumsum(neg)
    total_pos, total_neg = pos.sum(), neg.sum()
    if total_pos == 0 or total_neg == 0:
        return 0.5
    # rank-sum with tie correction via average ranks over ties
    m = np.asarray(margin, np.float64)[order]
    auc_sum = 0.0
    i = 0
    n = len(m)
    while i < n:
        j = i
        while j < n and m[j] == m[i]:
            j += 1
        tie_pos = pos[i:j].sum()
        tie_neg = neg[i:j].sum()
        neg_before = cum_neg[i - 1] if i > 0 else 0.0
        auc_sum += tie_pos * (neg_before + tie_neg / 2.0)
        i = j
    return float(auc_sum / (total_pos * total_neg))
