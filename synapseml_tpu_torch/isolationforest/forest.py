"""Isolation forest on a device.

The reference wraps LinkedIn's JVM isolation-forest library behind a
72-line Estimator (reference: isolationforest/IsolationForest.scala:19 —
params numEstimators/maxSamples/contamination/bootstrap/maxFeatures,
outputs predictedLabel + outlierScore).  Here the forest itself is
implemented: tree *construction* is cheap host work over small random
subsamples (numpy, on the same ``default_rng(seed)`` draws as the JAX
package, so the trees are equal), and *scoring* — the O(rows × trees ×
depth) part — runs on the device over flattened (trees, nodes) tensors:
``maxDepth`` steps of batched gathers, all trees advancing in lock-step,
with no per-row branching.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import (BoolParam, FloatParam, IntParam, PyObjectParam,
                           StringParam)
from ..core.pipeline import Estimator, Model
from ..device import resolve_device


def _avg_path_length(n) -> np.ndarray:
    """c(n) = 2 H(n-1) - 2(n-1)/n — expected path length of an
    unsuccessful BST search; the normalizer from the iForest paper."""
    n = np.asarray(n, np.float64)
    out = np.zeros_like(n)
    mask = n > 1
    nm = n[mask]
    out[mask] = 2.0 * (np.log(nm - 1) + 0.5772156649) \
        - 2.0 * (nm - 1) / nm
    return out


def _build_tree(x: np.ndarray, rng, max_depth: int):
    """Arrays (feature, threshold, left, right, leaf_adj) for one tree."""
    feature, thresh, left, right, leaf_adj = [], [], [], [], []

    def new_node():
        feature.append(-1)
        thresh.append(0.0)
        left.append(-1)
        right.append(-1)
        leaf_adj.append(0.0)
        return len(feature) - 1

    def grow(rows: np.ndarray, depth: int) -> int:
        node = new_node()
        n = len(rows)
        if depth >= max_depth or n <= 1:
            leaf_adj[node] = float(_avg_path_length(np.array([n]))[0])
            return node
        sub = x[rows]
        spread = sub.max(0) - sub.min(0)
        candidates = np.where(spread > 0)[0]
        if len(candidates) == 0:
            leaf_adj[node] = float(_avg_path_length(np.array([n]))[0])
            return node
        f = int(rng.choice(candidates))
        lo, hi = sub[:, f].min(), sub[:, f].max()
        t = float(rng.uniform(lo, hi))
        go_left = sub[:, f] <= t
        feature[node] = f
        thresh[node] = t
        left[node] = grow(rows[go_left], depth + 1)
        right[node] = grow(rows[~go_left], depth + 1)
        return node

    grow(np.arange(len(x)), 0)
    return (np.asarray(feature, np.int32), np.asarray(thresh, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(leaf_adj, np.float32))


def _path_lengths(x: torch.Tensor, feature: torch.Tensor,
                  thresh: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor, leaf_adj: torch.Tensor,
                  max_depth: int) -> torch.Tensor:
    """(R, F) rows vs stacked (T, N) trees -> (R,) mean path length.

    All trees advance one level per step; a row at a leaf stays there, so
    padded depth iterations are no-ops.  The (T, N) arrays are read
    flattened at ``tree * N + node``.
    """
    T, N = feature.shape
    R = x.shape[0]
    base = (torch.arange(T, device=x.device) * N)[None, :]       # (1, T)
    feature, thresh = feature.reshape(-1), thresh.reshape(-1)
    left, right = left.reshape(-1), right.reshape(-1)
    node = torch.zeros((R, T), dtype=torch.int64, device=x.device)
    depth = torch.zeros((R, T), dtype=torch.float32, device=x.device)
    for _ in range(max_depth):
        at = base + node
        f = feature[at]                                          # (R, T)
        is_leaf = f < 0
        xv = torch.gather(x, 1, f.clamp(min=0))
        nxt = torch.where(xv <= thresh[at], left[at], right[at])
        node = torch.where(is_leaf, node, nxt)
        depth = depth + (~is_leaf).to(torch.float32)
    adj = leaf_adj.reshape(-1)[base + node]
    return (depth + adj).mean(dim=1)


class IsolationForest(Estimator):
    """Isolation-forest estimator (param surface mirrors the reference
    wrapper: IsolationForest.scala:19)."""

    featuresCol = StringParam(doc="feature vector column", default="features")
    predictionCol = StringParam(doc="0/1 outlier label column",
                                default="predictedLabel")
    scoreCol = StringParam(doc="outlier score column", default="outlierScore")
    numEstimators = IntParam(doc="number of trees", default=100)
    maxSamples = IntParam(doc="subsample size per tree", default=256)
    maxFeatures = FloatParam(doc="feature fraction per tree", default=1.0)
    bootstrap = BoolParam(doc="sample with replacement", default=False)
    contamination = FloatParam(doc="expected outlier fraction (0 disables "
                               "thresholding)", default=0.0)
    seed = IntParam(doc="rng seed", default=0)
    device = StringParam(doc="device the scoring runs on: 'cuda' (raises "
                             "when no card is present) or 'cpu'",
                         default="cuda")

    def _fit(self, ds: Dataset) -> "IsolationForestModel":
        resolve_device(self.device)
        col = ds[self.featuresCol]
        x = (np.stack([np.asarray(v, np.float32) for v in col])
             if col.dtype == object else
             np.asarray(col, np.float32).reshape(len(col), -1))
        rng = np.random.default_rng(int(self.seed))
        n, d = x.shape
        sub_n = min(int(self.maxSamples), n)
        max_depth = int(np.ceil(np.log2(max(sub_n, 2))))
        n_feat = max(1, int(round(float(self.maxFeatures) * d)))

        trees = []
        feat_subsets = []
        for _ in range(int(self.numEstimators)):
            rows = rng.choice(n, size=sub_n, replace=bool(self.bootstrap))
            feats = (np.arange(d) if n_feat == d
                     else np.sort(rng.choice(d, n_feat, replace=False)))
            trees.append(_build_tree(x[np.ix_(rows, feats)], rng, max_depth))
            feat_subsets.append(feats)

        # pad trees to a common node count and remap features to global ids
        max_nodes = max(len(t[0]) for t in trees)
        T = len(trees)
        feature = np.full((T, max_nodes), -1, np.int32)
        thresh = np.zeros((T, max_nodes), np.float32)
        left = np.zeros((T, max_nodes), np.int32)
        right = np.zeros((T, max_nodes), np.int32)
        leaf_adj = np.zeros((T, max_nodes), np.float32)
        for i, (f, th, l, r, a) in enumerate(trees):
            k = len(f)
            remapped = np.where(f >= 0, feat_subsets[i][np.maximum(f, 0)], -1)
            feature[i, :k] = remapped
            thresh[i, :k] = th
            left[i, :k] = l
            right[i, :k] = r
            leaf_adj[i, :k] = a

        model = IsolationForestModel()
        model.set("treeFeature", feature)
        model.set("treeThreshold", thresh)
        model.set("treeLeft", left)
        model.set("treeRight", right)
        model.set("treeLeafAdj", leaf_adj)
        model.set("subsampleSize", sub_n)
        model.set("maxDepth", max_depth)
        model._copy_values_from(self)

        if float(self.contamination) > 0:
            scores = model._scores(x)
            thr = float(np.quantile(scores, 1.0 - float(self.contamination)))
        else:
            thr = 0.5
        model.set("threshold", thr)
        return model


class IsolationForestModel(Model):
    featuresCol = StringParam(doc="feature vector column", default="features")
    predictionCol = StringParam(doc="0/1 outlier label column",
                                default="predictedLabel")
    scoreCol = StringParam(doc="outlier score column", default="outlierScore")
    treeFeature = PyObjectParam(doc="(T, N) split feature ids (-1 leaf)")
    treeThreshold = PyObjectParam(doc="(T, N) split thresholds")
    treeLeft = PyObjectParam(doc="(T, N) left child index")
    treeRight = PyObjectParam(doc="(T, N) right child index")
    treeLeafAdj = PyObjectParam(doc="(T, N) leaf path-length adjustment")
    subsampleSize = IntParam(doc="per-tree subsample size", default=256)
    maxDepth = IntParam(doc="tree depth bound", default=8)
    threshold = FloatParam(doc="outlier score threshold", default=0.5)
    device = StringParam(doc="device the scoring runs on: 'cuda' (raises "
                             "when no card is present) or 'cpu'",
                         default="cuda")

    def _scores(self, x: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.device)

        def up(name, dtype):
            return torch.as_tensor(np.asarray(self.get(name)), dtype=dtype,
                                   device=dev)

        mean_path = _path_lengths(
            torch.as_tensor(np.asarray(x, np.float32), device=dev),
            up("treeFeature", torch.int64), up("treeThreshold", torch.float32),
            up("treeLeft", torch.int64), up("treeRight", torch.int64),
            up("treeLeafAdj", torch.float32), int(self.maxDepth))
        c = float(_avg_path_length(np.array([int(self.subsampleSize)]))[0])
        return np.asarray(2.0 ** (-mean_path.cpu().numpy() / max(c, 1e-9)))

    def _transform(self, ds: Dataset) -> Dataset:
        col = ds[self.featuresCol]
        x = (np.stack([np.asarray(v, np.float32) for v in col])
             if col.dtype == object else
             np.asarray(col, np.float32).reshape(len(col), -1))
        scores = self._scores(x)
        labels = (scores >= float(self.threshold)).astype(np.int64)
        return ds.with_columns({self.scoreCol: scores,
                                self.predictionCol: labels})
