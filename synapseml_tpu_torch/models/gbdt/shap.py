"""Exact TreeSHAP feature attributions.

The PyTorch port's copy of the JAX package's ``models/gbdt/shap.py``:
Lundberg et al.'s polynomial-time algorithm over the flat tree arrays.
For every decision path the EXTEND/UNWIND recursion keeps the
distribution of subset sizes along the path, which gives the exact
Shapley value of each feature under the tree's cover-weighted
conditional expectation; the per-node row covers (``Tree.node_count``)
supply the weights.

Host-side numpy by design, as in the JAX package: attribution explains
tens to thousands of rows, not the training set.  The recursion visits
every node of a tree whatever the row (the row decides only which child
is "hot", i.e. carries its one-fraction), so here one recursion per tree
carries every row at once: each path entry's fractions and weights are
(n,) arrays, and every float operation is the JAX package's per-row
operation, elementwise.  ``Booster.predict_contrib(approximate=True)``
takes the Saabas path attribution instead, as do models without cover
counts (:func:`has_cover_counts`).
"""

from __future__ import annotations

from typing import List

import numpy as np


class _Path:
    """One decision path: per entry its feature (-1 for the root's
    dummy), zero fraction, one fraction and weight, the last three (n,)
    float64 arrays."""

    def __init__(self, feat: List[int], pz: list, po: list, w: list):
        self.feat, self.pz, self.po, self.w = feat, pz, po, w

    def extend(self, pz, po, pi: int, n: int) -> "_Path":
        feat, zs, os_, w = (self.feat + [pi], self.pz + [pz], self.po + [po],
                            list(self.w))
        w.append(np.ones(n) if not self.w else np.zeros(n))
        ln = len(feat) - 1
        for i in range(ln - 1, -1, -1):
            w[i + 1] = w[i + 1] + po * w[i] * (i + 1) / (ln + 1)
            w[i] = pz * w[i] * (ln - i) / (ln + 1)
        return _Path(feat, zs, os_, w)

    def unwind(self, i: int) -> "_Path":
        w = list(self.w)
        ln = len(w) - 1
        po, pz = self.po[i], self.pz[i]
        hot = po != 0
        nxt = w[ln]
        with np.errstate(divide="ignore", invalid="ignore"):
            for j in range(ln - 1, -1, -1):
                tmp = w[j]
                a = nxt * (ln + 1) / ((j + 1) * po)
                b = w[j] * (ln + 1) / (pz * (ln - j))
                w[j] = np.where(hot, a, b)
                nxt = np.where(hot, tmp - w[j] * pz * (ln - j) / (ln + 1),
                               nxt)
        keep = [k for k in range(ln + 1) if k != i]
        return _Path([self.feat[k] for k in keep],
                     [self.pz[k] for k in keep], [self.po[k] for k in keep],
                     w[:ln])

    def unwound_sum(self, i: int):
        ln = len(self.w) - 1
        po, pz = self.po[i], self.pz[i]
        hot = po != 0
        total = 0.0
        nxt = self.w[ln]
        with np.errstate(divide="ignore", invalid="ignore"):
            for j in range(ln - 1, -1, -1):
                tmp = nxt * (ln + 1) / ((j + 1) * po)
                total = total + np.where(
                    hot, tmp, self.w[j] * (ln + 1) / (pz * (ln - j)))
                nxt = np.where(hot, self.w[j] - tmp * pz * (ln - j) / (ln + 1),
                               nxt)
        return total


def _tree_shap_rows(split_feature, threshold, left, right, default_left,
                    node_count, leaf_value, x, phi, scale,
                    missing_zero=None):
    """Exact TreeSHAP of every row of ``x`` (n, F) on one tree; adds
    into ``phi`` (n, F+1)."""
    n = x.shape[0]

    def recurse(node: int, path: _Path, pz, po, pi: int):
        path = path.extend(pz, po, pi, n)
        f = int(split_feature[node])
        if f < 0:                                   # leaf
            v = float(leaf_value[node]) * scale
            for i in range(1, len(path.feat)):
                w = path.unwound_sum(i)
                phi[:, path.feat[i]] += w * (path.po[i] - path.pz[i]) * v
            return
        xv = x[:, f]
        miss = np.isnan(xv)
        if missing_zero is not None and bool(missing_zero[node]):
            miss = miss | (np.abs(xv) <= 1e-35)
        go_left = np.where(miss, bool(default_left[node]),
                           xv <= threshold[node])
        iz, io = np.ones(n), np.ones(n)
        k = next((i for i in range(1, len(path.feat))
                  if path.feat[i] == f), None)
        if k is not None:
            iz, io = path.pz[k], path.po[k]
            path = path.unwind(k)
        cover = max(float(node_count[node]), 1e-12)
        lc, rc = int(left[node]), int(right[node])
        recurse(lc, path, float(node_count[lc]) / cover * iz,
                np.where(go_left, io, 0.0), f)
        recurse(rc, path, float(node_count[rc]) / cover * iz,
                np.where(go_left, 0.0, io), f)

    recurse(0, _Path([], [], [], []), np.ones(n), np.ones(n), -1)


def _expected_value(node_count, leaf_mask, leaf_value) -> float:
    root = max(float(node_count[0]), 1e-12)
    return float(np.sum(node_count[leaf_mask] * leaf_value[leaf_mask]) / root)


def tree_shap_values(booster, features: np.ndarray,
                     bin_space: bool = False) -> np.ndarray:
    """Exact per-feature contributions + bias for every row: (n, F+1) for
    single-output models, (n, K·(F+1)) for multiclass (the last slot of
    each block is the expected value, the bias).

    ``bin_space``: route by ``split_bin`` over the binned features
    (categorical models split in bin space; the mapper's transform is
    applied here, so callers pass raw features)."""
    features = np.ascontiguousarray(features, np.float32)
    if bin_space:
        features = booster.bin_mapper.transform(features).astype(np.float32)
    n = features.shape[0]
    F = booster.bin_mapper.num_features
    K = booster.num_class
    out = np.zeros((n, K, F + 1), np.float64)
    for t_idx, t in enumerate(booster.trees):
        k = booster.tree_class[t_idx]
        w = booster.tree_weights[t_idx]
        if booster.config.boosting_type == "rf":
            w = w / max(sum(1 for c in booster.tree_class if c == k), 1)
        nn = int(t.num_nodes)
        sf = np.asarray(t.split_feature[:nn])
        thr = np.asarray(t.split_bin[:nn], np.float32) if bin_space \
            else np.asarray(t.threshold[:nn])
        lc = np.asarray(t.left_child[:nn])
        rc = np.asarray(t.right_child[:nn])
        dl = np.asarray(t.default_left[:nn])
        leaf_mask = sf < 0
        nc = np.asarray(t.node_count[:nn], np.float64)
        lv = np.asarray(t.node_value[:nn], np.float64)
        out[:, k, F] += _expected_value(nc, leaf_mask, lv) * w
        mz = None if bin_space else np.asarray(t.missing_zero[:nn])
        if n:
            _tree_shap_rows(sf, thr, lc, rc, dl, nc, lv, features,
                            out[:, k], w, missing_zero=mz)
    out[:, :, F] += booster.init_score[:K][None, :]
    if K == 1:
        return out[:, 0, :]
    return out.reshape(n, -1)


def has_cover_counts(booster) -> bool:
    return any(float(np.asarray(t.node_count).max()) > 0
               for t in booster.trees)
