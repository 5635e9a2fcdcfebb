"""Exact K-nearest-neighbours on a device.

Re-designs the reference's ball-tree KNN (reference: core/.../nn/KNN.scala:
49,79, nn/ConditionalKNN.scala:32, nn/BallTree.scala — a per-partition
JVM ball tree queried row-by-row with a bounded priority queue).  A ball
tree is the right structure for a scalar CPU; on a GPU the winning
layout is brute force on the matrix units: ``dist^2 = |q|^2 - 2 q·X^T +
|x|^2`` is one (Q, D) x (D, N) product per tile of the index, merged into
a running (Q, k) best.  The index goes to the device once per
``transform`` and is scanned in ``leafSize``-row tiles, so the device
holds one tile of distances at a time; nothing returns to the host until
the k winners are refined.  Products run in full float32 (TF32 off).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import IntParam, PyObjectParam, StringParam
from ..core.pipeline import Estimator, Model
from ..device import DeviceLike, full_f32, resolve_device


def _merge_best(best_d, best_i, d2, ids, k: int):
    """Running top-k merge: the k smallest of ``[best | tile]``.  A stable
    ascending sort keeps, among equal distances, the lower position —
    the kept best before the tile, and a tile in index order — which is
    ``lax.top_k``'s order on the negated distances."""
    cat_d = torch.cat([best_d, d2], dim=1)
    cat_i = torch.cat([best_i, ids.expand(d2.shape[0], -1)], dim=1)
    vals, pos = torch.sort(cat_d, dim=1, stable=True)
    return vals[:, :k], torch.gather(cat_i, 1, pos[:, :k])


def _topk_scan(queries: torch.Tensor, index: torch.Tensor, k: int, tile: int,
               eligible=None):
    """(Q, D) queries vs (N, D) index on one device -> (Q, k) distances^2
    and int64 indices (-1 where fewer than k rows are eligible).

    Scans the index in ``tile``-row chunks; each chunk gives a (Q, tile)
    distance block from one product.  ``eligible(lo, hi)`` returns a
    (Q, hi - lo) mask of index rows a query may match, or None."""
    dev = queries.device
    n = index.shape[0]
    best_d = torch.full((queries.shape[0], k), float("inf"),
                        dtype=torch.float32, device=dev)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int64,
                        device=dev)
    with full_f32():
        q2 = (queries * queries).sum(1, keepdim=True)             # (Q, 1)
        for lo in range(0, n, tile):
            chunk = index[lo:lo + tile]
            x2 = (chunk * chunk).sum(1)                            # (tile,)
            d2 = q2 - 2.0 * (queries @ chunk.T) + x2[None, :]      # (Q, tile)
            if eligible is not None:
                d2 = torch.where(eligible(lo, lo + chunk.shape[0]), d2,
                                 float("inf"))
            ids = torch.arange(lo, lo + chunk.shape[0], device=dev)[None]
            best_d, best_i = _merge_best(best_d, best_i, d2, ids, k)
    return best_d, best_i


def _refine_topk(queries: torch.Tensor, points: torch.Tensor,
                 idx: torch.Tensor):
    """Exact re-computation of the k winners' squared distances.

    The ``|q|^2 - 2 q.x + |x|^2`` expansion cancels catastrophically near
    zero distance — a self-match reports ~sqrt(eps.|x|^2).  The scan
    still finds the right NEIGHBOURS (error is uniform across
    candidates); only the k returned distances need the direct
    ``sum((q - x)^2)`` form, float32 differences summed in float64 on the
    device — O(Q.k.D) next to the O(Q.N.D) scan.  Winners re-sort on the
    refined distances (stable, so expansion-order ties keep the scan's
    order); padded ``-1`` slots stay +inf/last.  Returns host arrays."""
    valid = idx >= 0
    diff = (points[idx.clamp(min=0)] - queries[:, None, :]).double()
    d2r = (diff * diff).sum(-1)
    d2r = torch.where(valid, d2r, float("inf"))
    d2r, order = torch.sort(d2r, dim=1, stable=True)
    return d2r.cpu().numpy(), torch.gather(idx, 1, order).cpu().numpy()


def _stack_vectors(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.stack([np.asarray(v, np.float32) for v in col])
    return np.asarray(col, np.float32).reshape(len(col), -1)


def _tile(leaf_size: int, n: int) -> int:
    return int(min(leaf_size, max(8, n)))


def _query(queries: np.ndarray, index: np.ndarray, k: int, tile: int,
           dev: torch.device, labels=None, cond=None):
    """Upload the index and queries once, scan, refine -> host (Q, k)."""
    q = torch.as_tensor(np.ascontiguousarray(queries, np.float32), device=dev)
    x = torch.as_tensor(np.ascontiguousarray(index, np.float32), device=dev)
    eligible = None
    if labels is not None:
        lab = torch.as_tensor(labels, dtype=torch.int64, device=dev)
        cnd = torch.as_tensor(cond, dtype=torch.bool, device=dev)

        def eligible(lo, hi):
            return cnd[:, lab[lo:hi]]
    _, idx = _topk_scan(q, x, k, tile, eligible)
    return _refine_topk(q, x, idx)


class BallTree:
    """API-parity shim for the reference BallTree (nn/BallTree.scala).

    Construction keeps the points; ``query_point``/``query`` run the same
    tiled top-k scan as :class:`KNNModel` on ``device``.  There is
    deliberately no tree: the branchy traversal serializes while a
    (Q, D)x(D, N) product fills the device, so brute force IS the fast
    path.
    """

    def __init__(self, points: np.ndarray, values: Optional[Sequence] = None,
                 tile: int = 1024, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.points = np.asarray(points, np.float32)
        self.values = (list(values) if values is not None
                       else list(range(len(self.points))))
        self.tile = _tile(tile, len(self.points))

    def query(self, queries: np.ndarray, k: int = 1):
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        k = min(k, len(self.points))
        d2, idx = _query(queries, self.points, k, self.tile, self.device)
        return np.sqrt(d2), idx

    def query_point(self, point: np.ndarray, k: int = 1):
        dist, idx = self.query(point[None], k)
        return [(self.values[j], float(d))
                for d, j in zip(dist[0], idx[0]) if j >= 0]


class KNN(Estimator):
    """Exact KNN estimator (reference: nn/KNN.scala:49).

    ``fit`` snapshots the index (features + optional values column);
    the model emits, per query row, the k nearest values and distances.
    """

    featuresCol = StringParam(doc="vector column to index", default="features")
    valuesCol = StringParam(doc="payload column returned per match",
                            default="values")
    outputCol = StringParam(doc="output column of matches", default="output")
    k = IntParam(doc="number of matches", default=5)
    leafSize = IntParam(doc="scan tile size (ball-tree leafSize analogue)",
                        default=1024)
    device = StringParam(doc="device to run on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")

    def _fit(self, ds: Dataset) -> "KNNModel":
        resolve_device(self.device)
        feats = _stack_vectors(ds[self.featuresCol])
        values = (list(ds[self.valuesCol]) if self.valuesCol in ds
                  else list(range(ds.num_rows)))
        model = KNNModel()
        model.set("indexFeatures", feats)
        model.set("indexValues", values)
        model._copy_values_from(self)
        return model


class KNNModel(Model):
    featuresCol = StringParam(doc="vector column to query", default="features")
    valuesCol = StringParam(doc="payload column returned per match",
                            default="values")
    outputCol = StringParam(doc="output column of matches", default="output")
    k = IntParam(doc="number of matches", default=5)
    leafSize = IntParam(doc="scan tile size", default=1024)
    device = StringParam(doc="device to run on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")
    indexFeatures = PyObjectParam(doc="(N, D) indexed vectors")
    indexValues = PyObjectParam(doc="payload per indexed vector")

    def _transform(self, ds: Dataset) -> Dataset:
        dev = resolve_device(self.device)
        index = np.asarray(self.get("indexFeatures"), np.float32)
        values = self.get("indexValues")
        queries = _stack_vectors(ds[self.featuresCol])
        k = min(int(self.k), len(index))
        d2, idx = _query(queries, index, k, _tile(self.leafSize, len(index)),
                         dev)
        out = np.empty(ds.num_rows, dtype=object)
        for i in range(ds.num_rows):
            out[i] = [{"value": values[j], "distance": float(np.sqrt(d))}
                      for d, j in zip(d2[i], idx[i]) if j >= 0]
        return ds.with_column(self.outputCol, out)


class ConditionalKNN(Estimator):
    """KNN with label-conditioned matching (reference:
    nn/ConditionalKNN.scala:32): each query carries a set of acceptable
    labels; only index rows whose label is in that set may match."""

    featuresCol = StringParam(doc="vector column to index", default="features")
    valuesCol = StringParam(doc="payload column returned per match",
                            default="values")
    labelCol = StringParam(doc="per-index-row label", default="labels")
    conditionerCol = StringParam(doc="per-query set of acceptable labels",
                                 default="conditioner")
    outputCol = StringParam(doc="output column of matches", default="output")
    k = IntParam(doc="number of matches", default=5)
    leafSize = IntParam(doc="scan tile size", default=1024)
    device = StringParam(doc="device to run on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")

    def _fit(self, ds: Dataset) -> "ConditionalKNNModel":
        resolve_device(self.device)
        feats = _stack_vectors(ds[self.featuresCol])
        values = (list(ds[self.valuesCol]) if self.valuesCol in ds
                  else list(range(ds.num_rows)))
        raw_labels = list(ds[self.labelCol])
        uniq = sorted({l for l in raw_labels})
        lab_to_id = {l: i for i, l in enumerate(uniq)}
        labels = np.array([lab_to_id[l] for l in raw_labels], np.int32)
        model = ConditionalKNNModel()
        model.set("indexFeatures", feats)
        model.set("indexValues", values)
        model.set("indexLabels", labels)
        model.set("labelVocabulary", uniq)
        model._copy_values_from(self)
        return model


class ConditionalKNNModel(Model):
    featuresCol = StringParam(doc="vector column to query", default="features")
    valuesCol = StringParam(doc="payload column", default="values")
    labelCol = StringParam(doc="per-index-row label", default="labels")
    conditionerCol = StringParam(doc="per-query acceptable labels",
                                 default="conditioner")
    outputCol = StringParam(doc="output column of matches", default="output")
    k = IntParam(doc="number of matches", default=5)
    leafSize = IntParam(doc="scan tile size", default=1024)
    device = StringParam(doc="device to run on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")
    indexFeatures = PyObjectParam(doc="(N, D) indexed vectors")
    indexValues = PyObjectParam(doc="payload per indexed vector")
    indexLabels = PyObjectParam(doc="(N,) int label ids")
    labelVocabulary = PyObjectParam(doc="label id -> original label")

    def _transform(self, ds: Dataset) -> Dataset:
        dev = resolve_device(self.device)
        index = np.asarray(self.get("indexFeatures"), np.float32)
        values = self.get("indexValues")
        labels = np.asarray(self.get("indexLabels"), np.int32)
        vocab = list(self.get("labelVocabulary"))
        lab_to_id = {l: i for i, l in enumerate(vocab)}
        n_labels = max(len(vocab), 1)

        queries = _stack_vectors(ds[self.featuresCol])
        cond = np.zeros((ds.num_rows, n_labels), bool)
        for i, want in enumerate(ds[self.conditionerCol]):
            wants = want if isinstance(want, (list, tuple, set, np.ndarray)) \
                else [want]
            for w in wants:
                if w in lab_to_id:
                    cond[i, lab_to_id[w]] = True

        k = min(int(self.k), len(index))
        d2, idx = _query(queries, index, k, _tile(self.leafSize, len(index)),
                         dev, labels, cond)
        out = np.empty(ds.num_rows, dtype=object)
        for i in range(ds.num_rows):
            matches = []
            for d, j in zip(d2[i], idx[i]):
                if j >= 0 and np.isfinite(d):
                    matches.append({"value": values[j],
                                    "distance": float(np.sqrt(d)),
                                    "label": vocab[labels[j]]})
            out[i] = matches
        return ds.with_column(self.outputCol, out)
