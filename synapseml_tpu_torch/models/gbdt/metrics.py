"""Evaluation metrics for boosting (host-side numpy).

The PyTorch port of the JAX package's ``models/gbdt/metrics.py``: AUC,
binary and multiclass log loss and error, L2/RMSE, L1 and MAPE, and the
default metric of each objective.  ``ndcg_at`` waits for lambdarank.
"""

from __future__ import annotations

from typing import Dict

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


def binary_logloss(labels, margin, weights=None) -> float:
    p = 1.0 / (1.0 + np.exp(-np.asarray(margin, np.float64)))
    p = np.clip(p, 1e-15, 1 - 1e-15)
    y = np.asarray(labels, np.float64)
    ll = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    return _wmean(ll, weights)


def binary_error(labels, margin, weights=None) -> float:
    pred = (np.asarray(margin) > 0).astype(np.float64)
    return _wmean(pred != np.asarray(labels), weights)


def multi_logloss(labels, margin, weights=None) -> float:
    m = np.asarray(margin, np.float64)
    m = m - m.max(axis=1, keepdims=True)
    p = np.exp(m)
    p /= p.sum(axis=1, keepdims=True)
    y = np.asarray(labels, np.int64)
    ll = -np.log(np.clip(p[np.arange(len(y)), y], 1e-15, None))
    return _wmean(ll, weights)


def multi_error(labels, margin, weights=None) -> float:
    pred = np.argmax(margin, axis=1)
    return _wmean(pred != np.asarray(labels), weights)


def l2(labels, pred, weights=None) -> float:
    d = np.asarray(pred, np.float64) - np.asarray(labels, np.float64)
    return _wmean(d * d, weights)


def rmse(labels, pred, weights=None) -> float:
    return float(np.sqrt(l2(labels, pred, weights)))


def l1(labels, pred, weights=None) -> float:
    return _wmean(np.abs(np.asarray(pred, np.float64) - np.asarray(labels, np.float64)), weights)


def mape(labels, pred, weights=None) -> float:
    y = np.asarray(labels, np.float64)
    return _wmean(np.abs(np.asarray(pred, np.float64) - y) / np.maximum(np.abs(y), 1.0), weights)


def _wmean(x, weights=None) -> float:
    x = np.asarray(x, np.float64)
    if weights is None:
        return float(x.mean())
    w = np.asarray(weights, np.float64)
    return float((x * w).sum() / max(w.sum(), 1e-12))


#: metric name -> (fn(labels, margin_or_pred, weights), larger_is_better)
METRICS: Dict[str, tuple] = {
    "auc": (auc, True),
    "binary_logloss": (binary_logloss, False),
    "binary_error": (binary_error, False),
    "multi_logloss": (multi_logloss, False),
    "multi_error": (multi_error, False),
    "l2": (l2, False),
    "mse": (l2, False),
    "rmse": (rmse, False),
    "l1": (l1, False),
    "mae": (l1, False),
    "mape": (mape, False),
}


def default_metric(objective: str, num_class: int) -> str:
    if objective == "binary":
        return "binary_logloss"
    if objective in ("multiclass", "multiclassova"):
        return "multi_logloss"
    if objective in ("regression_l1", "mae"):
        return "l1"
    return "l2"
