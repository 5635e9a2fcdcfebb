"""Kernel SHAP family.

Re-designs the reference's Kernel SHAP (reference:
explainers/KernelSHAPBase.scala:37 + KernelSHAPSampler coalition sampling,
TabularSHAP.scala, VectorSHAP.scala, TextSHAP.scala, ImageSHAP.scala):
sample feature coalitions weighted by the Shapley kernel, score
background-blended inputs, and solve a constrained weighted least squares
whose solution is the Shapley value vector.  The empty/full coalitions are
pinned with large weights so phi_0 = E[f(background)] and
sum(phi) = f(x) - phi_0 hold (the reference imposes the same constraints
analytically).  The solves are one batched least-squares call on the
explainer's device (``lime._solve_rows``)."""

from __future__ import annotations

from math import comb
from typing import Optional, Sequence

import numpy as np

from ..core.dataset import Dataset
from ..core.params import FloatParam, ListParam, PyObjectParam, StringParam
from ..core.pipeline import Transformer
from ..image.superpixel import slic_segments
from .common import LocalExplainerParams, extract_targets, replicate_row
from .lime import PhaseClock, _concat_cols, _solve_rows


def shapley_kernel_weight(d: int, s: int) -> float:
    """pi(s) = (d-1) / (C(d,s) * s * (d-s)); infinite at s in {0, d}."""
    if s <= 0 or s >= d:
        return 1e6  # constraint rows
    return (d - 1) / (comb(d, s) * s * (d - s))


def sample_coalitions(d: int, n_samples: int, rng) -> np.ndarray:
    """(S, d) binary coalition matrix; first two rows are empty/full.
    Coalition sizes are drawn with probability proportional to the Shapley
    kernel mass at each size (KernelSHAPSampler analogue)."""
    sizes = np.arange(1, d)
    if len(sizes) == 0:
        probs = None
    else:
        mass = np.array([(d - 1) / (s * (d - s)) for s in sizes], np.float64)
        probs = mass / mass.sum()
    out = np.zeros((n_samples, d), bool)
    out[1, :] = True  # row 0 empty, row 1 full
    for i in range(2, n_samples):
        if probs is None:
            out[i] = rng.random(d) < 0.5
            continue
        s = rng.choice(sizes, p=probs)
        idx = rng.choice(d, size=s, replace=False)
        out[i, idx] = True
    return out


class _SHAPParams(LocalExplainerParams):
    infWeight = FloatParam(doc="weight pinning the empty/full coalitions",
                           default=1e6)


class _SHAPBase(_SHAPParams, Transformer):
    """Shared solve: subclasses build coalitions + perturbed inputs."""

    def _weights(self, coalitions: np.ndarray) -> np.ndarray:
        """Regression weights per sampled coalition.

        ``sample_coalitions`` already draws each coalition with probability
        proportional to its Shapley kernel weight (size ∝ kernel mass, then
        a uniform subset of that size), so the importance-sampled least
        squares must weight interior samples UNIFORMLY — re-applying the
        kernel here would square the size weighting.  Only the pinned
        empty/full constraint rows carry ``infWeight``."""
        d = coalitions.shape[1]
        sizes = coalitions.sum(1).astype(int)
        return np.where((sizes == 0) | (sizes == d),
                        float(self.infWeight), 1.0).astype(np.float64)


class TabularSHAP(_SHAPBase):
    """Kernel SHAP over numeric/categorical columns
    (TabularSHAP.scala analogue)."""

    inputCols = ListParam(doc="feature columns to explain")
    backgroundData = PyObjectParam(doc="Dataset of background rows")

    def __init__(self, model=None, inputCols: Optional[Sequence[str]] = None,
                 **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))

    def _transform(self, ds: Dataset) -> Dataset:
        bg = self.get("backgroundData")
        if bg is None:
            raise ValueError("TabularSHAP requires backgroundData")
        cols = self.inputCols
        d = len(cols)
        S = self.numSamples
        clock = PhaseClock(self.device)
        rng = np.random.default_rng(self.seed)
        n = ds.num_rows
        blocks, coalition_list = [], []
        for i in range(n):
            coalitions = sample_coalitions(d, S, rng)
            bg_idx = rng.integers(0, bg.num_rows, S)
            perturbed = replicate_row(ds, i, S)
            for j, c in enumerate(cols):
                inst_val = ds[c][i]
                bg_vals = bg[c][bg_idx]
                on = coalitions[:, j]
                if ds[c].dtype == object:
                    col = np.empty(S, dtype=object)
                    for s in range(S):
                        col[s] = inst_val if on[s] else bg_vals[s]
                    perturbed[c] = col
                else:
                    perturbed[c] = np.where(on, inst_val, bg_vals).astype(ds[c].dtype)
            blocks.append(perturbed)
            coalition_list.append(coalitions)
        merged = {c: _concat_cols([b[c] for b in blocks]) for c in blocks[0]}
        clock.mark("perturb")
        scored = self.model.transform(Dataset(merged, ds.num_partitions))
        targets = extract_targets(scored, self.targetCol,
                                  self.get("targetClasses"))
        clock.mark("score")
        T = targets.shape[1]
        tg = targets.reshape(n, S, T)
        st = np.stack(coalition_list).astype(np.float32)
        w = np.stack([self._weights(c) for c in coalition_list])
        coefs, r2 = _solve_rows(st, tg, w, 0.0, self.device)
        # phi_0 (intercept) = value at empty coalition; append it like the
        # reference (explanation vector length d+1, base value first)
        out, r2s = [], []
        for i in range(n):
            base = tg[i, 0]                      # empty coalition output
            phis = coefs[i]                      # (T, d)
            out.append(np.concatenate([base[:, None], phis], 1).astype(np.float64))
            r2s.append(r2[i].astype(np.float64))
        clock.mark("solve")
        self.timings = clock.seconds
        return ds.with_columns({self.outputCol: out, self.metricsCol: r2s})


class VectorSHAP(_SHAPBase):
    """Kernel SHAP over a dense vector column (VectorSHAP.scala analogue)."""

    inputCol = StringParam(doc="vector column", default="features")
    backgroundData = PyObjectParam(doc="Dataset of background rows")

    def __init__(self, model=None, inputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if inputCol is not None:
            self.set("inputCol", inputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        bg = self.get("backgroundData")
        if bg is None:
            raise ValueError("VectorSHAP requires backgroundData")
        clock = PhaseClock(self.device)
        bg_mat = np.stack([np.asarray(v, np.float64)
                           for v in bg[self.inputCol]])
        rng = np.random.default_rng(self.seed)
        n = ds.num_rows
        S = self.numSamples
        d = bg_mat.shape[1]
        blocks, coalition_list = [], []
        for i in range(n):
            inst = np.asarray(ds[self.inputCol][i], np.float64)
            coalitions = sample_coalitions(d, S, rng)
            bg_rows = bg_mat[rng.integers(0, len(bg_mat), S)]
            z = np.where(coalitions, inst, bg_rows)
            perturbed = replicate_row(ds, i, S)
            col = np.empty(S, dtype=object)
            for s in range(S):
                col[s] = z[s]
            perturbed[self.inputCol] = col
            blocks.append(perturbed)
            coalition_list.append(coalitions)
        merged = {c: _concat_cols([b[c] for b in blocks]) for c in blocks[0]}
        clock.mark("perturb")
        scored = self.model.transform(Dataset(merged, ds.num_partitions))
        targets = extract_targets(scored, self.targetCol,
                                  self.get("targetClasses"))
        clock.mark("score")
        T = targets.shape[1]
        tg = targets.reshape(n, S, T)
        st = np.stack(coalition_list).astype(np.float32)
        w = np.stack([self._weights(c) for c in coalition_list])
        coefs, r2 = _solve_rows(st, tg, w, 0.0, self.device)
        out, r2s = [], []
        for i in range(n):
            base = tg[i, 0]
            out.append(np.concatenate([base[:, None], coefs[i]], 1).astype(np.float64))
            r2s.append(r2[i].astype(np.float64))
        clock.mark("solve")
        self.timings = clock.seconds
        return ds.with_columns({self.outputCol: out, self.metricsCol: r2s})


class TextSHAP(_SHAPBase):
    """Kernel SHAP over text tokens (TextSHAP.scala analogue): coalition =
    subset of token positions kept; removed tokens are deleted."""

    inputCol = StringParam(doc="text column", default="text")
    tokensCol = StringParam(doc="tokenization output", default="tokens")

    def __init__(self, model=None, inputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if inputCol is not None:
            self.set("inputCol", inputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        clock = PhaseClock(self.device)
        rng = np.random.default_rng(self.seed)
        exp_col, r2_col, tok_col = [], [], []
        for i in range(ds.num_rows):
            tokens = str(ds[self.inputCol][i]).split()
            d = max(len(tokens), 1)
            S = self.numSamples
            coalitions = sample_coalitions(d, S, rng)
            texts = [" ".join(t for t, m in zip(tokens, row) if m)
                     for row in coalitions]
            perturbed = replicate_row(ds, i, S)
            col = np.empty(S, dtype=object)
            col[:] = texts
            perturbed[self.inputCol] = col
            clock.mark("perturb")
            scored = self.model.transform(Dataset(perturbed, 1))
            targets = extract_targets(scored, self.targetCol,
                                      self.get("targetClasses"))
            clock.mark("score")
            st = coalitions.astype(np.float32)
            w = self._weights(coalitions)
            coefs, r2 = _solve_rows(st[None], targets[None], w[None], 0.0,
                                    self.device)
            base = targets[0]
            exp_col.append(np.concatenate([base[:, None], coefs[0]], 1)
                           .astype(np.float64))
            r2_col.append(r2[0].astype(np.float64))
            clock.mark("solve")
            tok_col.append(tokens)
        self.timings = clock.seconds
        return ds.with_columns({self.outputCol: exp_col,
                                self.metricsCol: r2_col,
                                self.tokensCol: tok_col})


class ImageSHAP(_SHAPBase):
    """Kernel SHAP over superpixels (ImageSHAP.scala analogue)."""

    inputCol = StringParam(doc="image column (H,W,C arrays)", default="image")
    cellSize = FloatParam(doc="superpixel cell size", default=16.0)
    modifier = FloatParam(doc="superpixel compactness", default=130.0)
    superpixelCol = StringParam(doc="superpixel assignment output",
                                default="superpixels")

    def __init__(self, model=None, inputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if inputCol is not None:
            self.set("inputCol", inputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        clock = PhaseClock(self.device)
        rng = np.random.default_rng(self.seed)
        exp_col, r2_col, sp_col = [], [], []
        for i in range(ds.num_rows):
            img = np.asarray(ds[self.inputCol][i], np.float32)
            seg = slic_segments(img, cell_size=self.cellSize,
                                modifier=self.modifier, device=self.device)
            d = int(seg.max()) + 1
            S = self.numSamples
            coalitions = sample_coalitions(d, S, rng)
            mean_color = img.reshape(-1, img.shape[-1]).mean(0)
            imgs = np.empty(S, dtype=object)
            for s in range(S):
                keep = coalitions[s][seg]
                imgs[s] = np.where(keep[..., None], img, mean_color).astype(img.dtype)
            perturbed = replicate_row(ds, i, S)
            perturbed[self.inputCol] = imgs
            clock.mark("perturb")
            scored = self.model.transform(Dataset(perturbed, 1))
            targets = extract_targets(scored, self.targetCol,
                                      self.get("targetClasses"))
            clock.mark("score")
            st = coalitions.astype(np.float32)
            w = self._weights(coalitions)
            coefs, r2 = _solve_rows(st[None], targets[None], w[None], 0.0,
                                    self.device)
            base = targets[0]
            exp_col.append(np.concatenate([base[:, None], coefs[0]], 1)
                           .astype(np.float64))
            r2_col.append(r2[0].astype(np.float64))
            clock.mark("solve")
            sp_col.append(seg)
        self.timings = clock.seconds
        return ds.with_columns({self.outputCol: exp_col,
                                self.metricsCol: r2_col,
                                self.superpixelCol: sp_col})
