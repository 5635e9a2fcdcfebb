"""SAR — Smart Adaptive Recommendations — on a device.

Re-designs the reference's Spark SAR (reference: core/.../recommendation/
SAR.scala:36 + SARModel.scala): item-item similarity from co-occurrence
counts and time-decayed user-item affinity, scored as ``affinity @
similarity``.  The Spark build computes co-occurrence with a self-join;
here the binarized user-item matrix B is dense on the device and the
co-occurrence matrix is ONE product ``B^T B`` — the all-pairs similarity
the reference assembles row-by-row — followed by the Jaccard / lift
normalization as elementwise ops on the device.  Products run in full
float32 (TF32 off); top-k is a stable sort, so equal scores keep the
lower item index first, as ``lax.top_k`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import IntParam, PyObjectParam, StringParam
from ..core.pipeline import Estimator, Model
from ..device import full_f32, resolve_device

_DEVICE_DOC = ("device to run on: 'cuda' (raises when no card is present) "
               "or 'cpu'")


def _similarity(seen: torch.Tensor, thresh: float, fn: str) -> torch.Tensor:
    """(U, I) 0/1 matrix -> (I, I) float32 item similarity."""
    with full_f32():
        cooc = seen.T @ seen
    cooc = torch.where(cooc >= thresh, cooc, torch.zeros_like(cooc))
    if fn == "cooccurrence":
        return cooc
    diag = torch.diagonal(cooc).clone()
    if fn == "jaccard":
        denom = diag[:, None] + diag[None, :] - cooc
    else:  # lift
        denom = diag[:, None] * diag[None, :]
    return torch.where(denom > 0, cooc / denom, torch.zeros_like(cooc))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with full_f32():
        return a @ b


class SAR(Estimator):
    """SAR estimator.

    Params mirror the reference (SAR.scala): ``similarityFunction`` in
    {jaccard, lift, cooccurrence}, ``supportThreshold`` minimum
    co-occurrence count, ``timeDecayCoeff`` half-life (days) applied when
    ``timeCol`` is set.
    """

    userCol = StringParam(doc="user id column", default="user")
    itemCol = StringParam(doc="item id column", default="item")
    ratingCol = StringParam(doc="rating column", default="rating")
    timeCol = StringParam(doc="timestamp column (seconds) for decay")
    similarityFunction = StringParam(
        doc="item-item similarity normalization", default="jaccard",
        allowed=("jaccard", "lift", "cooccurrence"))
    supportThreshold = IntParam(doc="min co-occurrence support", default=4)
    timeDecayCoeff = IntParam(doc="affinity half-life in days", default=30)
    device = StringParam(doc=_DEVICE_DOC, default="cuda")

    def _fit(self, ds: Dataset) -> "SARModel":
        dev = resolve_device(self.device)
        users_raw = ds[self.userCol]
        items_raw = ds[self.itemCol]
        user_vocab, user_idx = np.unique(users_raw, return_inverse=True)
        item_vocab, item_idx = np.unique(items_raw, return_inverse=True)
        n_u, n_i = len(user_vocab), len(item_vocab)

        ratings = (ds[self.ratingCol].astype(np.float32)
                   if self.ratingCol in ds else np.ones(ds.num_rows,
                                                        np.float32))
        # -- affinity: time-decayed sum of ratings (SAR.scala affinity) ----
        time_col = self.get("timeCol")
        if time_col and time_col in ds:
            t = ds[time_col].astype(np.float64)
            ref = t.max()
            half_life_s = float(self.timeDecayCoeff) * 86400.0
            decay = np.power(2.0, -(ref - t) / half_life_s).astype(np.float32)
            weights = ratings * decay
        else:
            weights = ratings
        affinity = np.zeros((n_u, n_i), np.float32)
        np.add.at(affinity, (user_idx, item_idx), weights)

        # -- co-occurrence on the device: C = B^T B, B = binarized A -----
        seen = np.zeros((n_u, n_i), np.float32)
        seen[user_idx, item_idx] = 1.0
        sim = _similarity(torch.as_tensor(seen, device=dev),
                          float(self.supportThreshold),
                          self.similarityFunction).cpu().numpy()

        model = SARModel()
        model.set("userVocabulary", user_vocab)
        model.set("itemVocabulary", item_vocab)
        model.set("userAffinity", affinity)
        model.set("itemSimilarity", sim)
        model.set("seenItems", seen)
        model._copy_values_from(self)
        return model


class SARModel(Model):
    userCol = StringParam(doc="user id column", default="user")
    itemCol = StringParam(doc="item id column", default="item")
    ratingCol = StringParam(doc="rating column", default="rating")
    predictionCol = StringParam(doc="score output column",
                                default="prediction")
    recommendationsCol = StringParam(doc="top-k output column",
                                     default="recommendations")
    userVocabulary = PyObjectParam(doc="user id vocabulary")
    itemVocabulary = PyObjectParam(doc="item id vocabulary")
    userAffinity = PyObjectParam(doc="(U, I) affinity matrix")
    itemSimilarity = PyObjectParam(doc="(I, I) similarity matrix")
    seenItems = PyObjectParam(doc="(U, I) binary seen matrix")
    device = StringParam(doc=_DEVICE_DOC, default="cuda")

    def _upload(self, name: str, rows=None) -> torch.Tensor:
        arr = np.asarray(self.get(name))
        return torch.as_tensor(arr if rows is None else arr[rows],
                               device=resolve_device(self.device))

    def _scores(self) -> torch.Tensor:
        """(U, I) recommendation scores = affinity @ similarity on the
        device (SARModel.recommendForAllUsers analogue)."""
        return _matmul(self._upload("userAffinity"),
                       self._upload("itemSimilarity"))

    def _transform(self, ds: Dataset) -> Dataset:
        """Score explicit (user, item) pairs.  Only the affinity rows of
        the users actually present are multiplied against the similarity
        matrix — not the full (U, I) score matrix."""
        resolve_device(self.device)
        user_vocab = np.asarray(self.get("userVocabulary"))
        item_vocab = np.asarray(self.get("itemVocabulary"))
        u_map = {u: i for i, u in enumerate(user_vocab)}
        i_map = {v: i for i, v in enumerate(item_vocab)}
        users = ds[self.userCol]
        items = ds[self.itemCol]
        u_idx = np.array([u_map.get(u, -1) for u in users], np.int64)
        i_idx = np.array([i_map.get(v, -1) for v in items], np.int64)
        known = (u_idx >= 0) & (i_idx >= 0)
        out = np.zeros(ds.num_rows, np.float32)
        if known.any():
            uniq_u, local = np.unique(u_idx[known], return_inverse=True)
            sub = _matmul(self._upload("userAffinity", uniq_u),
                          self._upload("itemSimilarity"))
            rows = torch.as_tensor(local, device=sub.device)
            cols = torch.as_tensor(i_idx[known], device=sub.device)
            out[known] = sub[rows, cols].cpu().numpy()
        return ds.with_column(self.predictionCol, out)

    def recommend_for_all_users(self, k: int,
                                remove_seen: bool = True) -> Dataset:
        user_vocab = np.asarray(self.get("userVocabulary"))
        item_vocab = np.asarray(self.get("itemVocabulary"))
        scores = self._scores()
        if remove_seen:
            scores = torch.where(self._upload("seenItems") > 0,
                                 float("-inf"), scores)
        k = min(k, scores.shape[1])
        vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
        recs = np.empty(len(user_vocab), dtype=object)
        for u in range(len(user_vocab)):
            recs[u] = [{"item": item_vocab[j], "rating": float(v)}
                       for j, v in zip(idx[u], vals[u]) if np.isfinite(v)]
        return Dataset({self.userCol: user_vocab,
                        self.recommendationsCol: recs})
