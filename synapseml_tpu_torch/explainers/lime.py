"""LIME family — local linear surrogate explanations.

Re-designs the reference's LIME implementations (reference:
explainers/LIMEBase.scala:137 + TabularLIME.scala, VectorLIME.scala,
TextLIME.scala, ImageLIME.scala): for each row, sample perturbed copies,
score them with the wrapped model, and fit a kernel-weighted lasso whose
coefficients are the explanation.  All rows' perturbations are scored in
ONE ``model.transform`` call (the reference scores per-row sample
DataFrames), and the per-row, per-target weighted solves are one batched
solver call on the explainer's device.  The perturbations are drawn on
the host from ``np.random.default_rng(seed)`` in a fixed order of calls.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import FloatParam, ListParam, PyObjectParam, StringParam
from ..core.pipeline import Transformer
from ..device import DeviceLike, resolve_device, synchronize
from ..image.superpixel import slic_segments
from .common import LocalExplainerParams, extract_targets, replicate_row
from .solvers import lasso_batched, least_squares_batched


class _LIMEParams(LocalExplainerParams):
    kernelWidth = FloatParam(doc="similarity kernel width (default "
                             "sqrt(d)*0.75 at fit time)", default=0.0)
    regularization = FloatParam(doc="lasso alpha (0 = least squares)",
                                default=0.0)


def _solve_rows(states: np.ndarray, targets: np.ndarray, weights: np.ndarray,
                alpha: float, device: DeviceLike = "cuda"):
    """states (R, S, D), targets (R, S, T), weights (R, S) ->
    coefs (R, T, D), r2 (R, T): one batched solve over the R·T problems
    (each row's states repeated over its targets)."""
    R, S, D = states.shape
    T = targets.shape[2]
    dev = resolve_device(device)
    x = torch.as_tensor(states, dtype=torch.float32, device=dev)
    x = x[:, None].expand(R, T, S, D).reshape(R * T, S, D)
    y = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    y = y.permute(0, 2, 1).reshape(R * T, S)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = w[:, None].expand(R, T, S).reshape(R * T, S)
    if alpha > 0:
        res = lasso_batched(x, y, alpha, w, device=dev)
    else:
        res = least_squares_batched(x, y, w, device=dev)
    return (res.coefficients.reshape(R, T, D).cpu().numpy(),
            res.r_squared.reshape(R, T).cpu().numpy())


class PhaseClock:
    """Host seconds spent perturbing, scoring and solving in the last
    transform (``explainer.timings``); the device is synchronized at
    each boundary so a phase holds its own device work."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self.seconds = {"perturb": 0.0, "score": 0.0, "solve": 0.0}
        self._t = time.perf_counter()

    def mark(self, phase: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        self.seconds[phase] += now - self._t
        self._t = now


def _kernel_weights(states01: np.ndarray, width: float) -> np.ndarray:
    """exp(-d^2 / width^2) with d = distance from the all-ones (original)
    state (LIMEBase.getSampleWeightUdf analogue)."""
    d2 = ((1.0 - states01) ** 2).sum(-1)
    return np.exp(-d2 / max(width, 1e-9) ** 2)


class _LIMEBase(_LIMEParams, Transformer):
    """Shared transform loop: subclasses implement ``_perturb_row``."""

    def _prepare(self, ds: Dataset) -> Dict:
        """Row-independent context (background stats etc.), computed ONCE
        per transform instead of per explained row."""
        return {}

    def _perturb_row(self, ds: Dataset, i: int, rng, ctx: Dict) -> Dict:
        """Returns dict(perturbed=column dict, states=(S, D) regression
        features, states01=(S, D) similarity space in [0,1])."""
        raise NotImplementedError

    def _transform(self, ds: Dataset) -> Dataset:
        clock = PhaseClock(self.device)
        rng = np.random.default_rng(self.seed)
        n = ds.num_rows
        ctx = self._prepare(ds)
        blocks, states, states01 = [], [], []
        for i in range(n):
            p = self._perturb_row(ds, i, rng, ctx)
            blocks.append(p["perturbed"])
            states.append(p["states"])
            states01.append(p["states01"])
        merged = {c: _concat_cols([b[c] for b in blocks])
                  for c in blocks[0]}
        big = Dataset(merged, ds.num_partitions)
        clock.mark("perturb")
        scored = self.model.transform(big)
        targets = extract_targets(scored, self.targetCol,
                                  self.get("targetClasses"))
        clock.mark("score")
        S = states[0].shape[0]
        D = states[0].shape[1]
        T = targets.shape[1]
        st = np.stack(states)                    # (R, S, D)
        st01 = np.stack(states01)
        tg = targets.reshape(n, S, T)
        width = self.kernelWidth or (np.sqrt(D) * 0.75)
        w = _kernel_weights(st01, width)
        coefs, r2 = _solve_rows(st, tg, w, self.regularization, self.device)
        exp_col = [coefs[i].astype(np.float64) for i in range(n)]  # (T, D)
        r2_col = [r2[i].astype(np.float64) for i in range(n)]
        clock.mark("solve")
        self.timings = clock.seconds
        return ds.with_columns({self.outputCol: exp_col,
                                self.metricsCol: r2_col})


def _concat_cols(cols: List[np.ndarray]) -> np.ndarray:
    if cols[0].dtype == object:
        out = np.empty(sum(len(c) for c in cols), dtype=object)
        k = 0
        for c in cols:
            out[k:k + len(c)] = c
            k += len(c)
        return out
    return np.concatenate(cols)


class TabularLIME(_LIMEBase):
    """LIME over numeric/categorical columns (TabularLIME.scala analogue).
    Numeric features are perturbed with background-std gaussian noise;
    categorical features are resampled from the background distribution."""

    inputCols = ListParam(doc="feature columns to explain")
    backgroundData = PyObjectParam(doc="Dataset for sampling statistics")
    categoricalFeatures = ListParam(doc="subset of inputCols treated as "
                                    "categorical", default=None)

    def __init__(self, model=None, inputCols: Optional[Sequence[str]] = None,
                 **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))

    def _background(self) -> Dataset:
        bg = self.get("backgroundData")
        if bg is None:
            raise ValueError("TabularLIME requires backgroundData")
        return bg

    def _prepare(self, ds: Dataset) -> Dict:
        bg = self._background()
        cats = set(self.get_or_default("categoricalFeatures") or [])
        stats = {}
        for c in self.inputCols:
            if c not in cats:
                vals = bg[c].astype(np.float64)
                stats[c] = (float(np.nanmean(vals)),
                            float(np.nanstd(vals)) or 1.0)
        return {"bg": bg, "cats": cats, "stats": stats}

    def _perturb_row(self, ds: Dataset, i: int, rng, ctx: Dict) -> Dict:
        bg, cats, stats = ctx["bg"], ctx["cats"], ctx["stats"]
        cols = self.inputCols
        S = self.numSamples
        perturbed = replicate_row(ds, i, S)
        states = np.zeros((S, len(cols)), np.float32)
        states01 = np.zeros((S, len(cols)), np.float32)
        for j, c in enumerate(cols):
            if c in cats:
                bg_col = bg[c]
                samples = bg_col[rng.integers(0, len(bg_col), S)]
                orig = ds[c][i]
                same = np.array([s == orig for s in samples])
                # keep original value on ~half so locality is represented
                keep = rng.random(S) < 0.5
                final = np.where(keep, orig, samples)
                if ds[c].dtype == object:
                    col = np.empty(S, dtype=object)
                    col[:] = final
                    perturbed[c] = col
                else:
                    perturbed[c] = final.astype(ds[c].dtype)
                ind = np.where(keep, 1.0, same.astype(np.float64))
                states[:, j] = ind
                states01[:, j] = ind
            else:
                mu, sd = stats[c]
                orig = float(ds[c][i])
                z = orig + rng.normal(0.0, sd, S)
                if np.issubdtype(ds[c].dtype, np.integer):
                    z = np.round(z)
                # regress on the values the model actually sees
                fed = z.astype(ds[c].dtype)
                perturbed[c] = fed
                z = fed.astype(np.float64)
                states[:, j] = (z - mu) / sd
                # similarity in [0,1]: 1 at the original value
                states01[:, j] = np.exp(-0.5 * ((z - orig) / sd) ** 2)
        return {"perturbed": perturbed, "states": states,
                "states01": states01}


class VectorLIME(_LIMEBase):
    """LIME over a dense vector column (VectorLIME.scala analogue)."""

    inputCol = StringParam(doc="vector column to explain", default="features")
    backgroundData = PyObjectParam(doc="Dataset for sampling statistics")

    def __init__(self, model=None, inputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if inputCol is not None:
            self.set("inputCol", inputCol)

    def _prepare(self, ds: Dataset) -> Dict:
        bg = self.get("backgroundData")
        mat = (np.stack([np.asarray(v, np.float64) for v in bg[self.inputCol]])
               if bg is not None else
               np.stack([np.asarray(v, np.float64) for v in ds[self.inputCol]]))
        return {"mu": mat.mean(0),
                "sd": np.where(mat.std(0) > 0, mat.std(0), 1.0)}

    def _perturb_row(self, ds: Dataset, i: int, rng, ctx: Dict) -> Dict:
        mu, sd = ctx["mu"], ctx["sd"]
        orig = np.asarray(ds[self.inputCol][i], np.float64)
        S = self.numSamples
        z = orig + rng.normal(0.0, 1.0, (S, len(orig))) * sd
        perturbed = replicate_row(ds, i, S)
        col = np.empty(S, dtype=object)
        for s in range(S):
            col[s] = z[s]
        perturbed[self.inputCol] = col
        states = ((z - mu) / sd).astype(np.float32)
        states01 = np.exp(-0.5 * ((z - orig) / sd) ** 2).astype(np.float32)
        return {"perturbed": perturbed, "states": states,
                "states01": states01}


class TextLIME(_LIMEBase):
    """LIME over text: binary token masking (TextLIME.scala analogue).
    Explanation has one coefficient per token position."""

    inputCol = StringParam(doc="text column", default="text")
    tokensCol = StringParam(doc="output column with the tokenization",
                            default="tokens")
    samplingFraction = FloatParam(doc="P(token kept) per sample", default=0.7)

    def __init__(self, model=None, inputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if inputCol is not None:
            self.set("inputCol", inputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        # token counts differ per row -> solve per row (not rectangular)
        clock = PhaseClock(self.device)
        rng = np.random.default_rng(self.seed)
        exp_col, r2_col, tok_col = [], [], []
        for i in range(ds.num_rows):
            tokens = str(ds[self.inputCol][i]).split()
            d = max(len(tokens), 1)
            S = self.numSamples
            mask = rng.random((S, d)) < self.samplingFraction
            mask[0, :] = True  # include the unperturbed text
            texts = [" ".join(t for t, m in zip(tokens, row) if m)
                     for row in mask]
            perturbed = replicate_row(ds, i, S)
            col = np.empty(S, dtype=object)
            col[:] = texts
            perturbed[self.inputCol] = col
            clock.mark("perturb")
            scored = self.model.transform(Dataset(perturbed, 1))
            targets = extract_targets(scored, self.targetCol,
                                      self.get("targetClasses"))
            clock.mark("score")
            states = mask.astype(np.float32)
            width = self.kernelWidth or (np.sqrt(d) * 0.75)
            w = _kernel_weights(states, width)
            coefs, r2 = _solve_rows(states[None], targets[None], w[None],
                                    self.regularization, self.device)
            exp_col.append(coefs[0].astype(np.float64))
            r2_col.append(r2[0].astype(np.float64))
            clock.mark("solve")
            tok_col.append(tokens)
        self.timings = clock.seconds
        return ds.with_columns({self.outputCol: exp_col,
                                self.metricsCol: r2_col,
                                self.tokensCol: tok_col})


class ImageLIME(_LIMEBase):
    """LIME over images via superpixel masking (ImageLIME.scala analogue:
    cellSize/modifier SLIC params, samplingFraction superpixel keep rate)."""

    inputCol = StringParam(doc="image column (H,W,C arrays)", default="image")
    cellSize = FloatParam(doc="superpixel cell size", default=16.0)
    modifier = FloatParam(doc="superpixel compactness", default=130.0)
    samplingFraction = FloatParam(doc="P(superpixel kept)", default=0.7)
    superpixelCol = StringParam(doc="output: superpixel assignment",
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
            mask = rng.random((S, d)) < self.samplingFraction
            mask[0, :] = True
            imgs = np.empty(S, dtype=object)
            mean_color = img.reshape(-1, img.shape[-1]).mean(0)
            for s in range(S):
                keep = mask[s][seg]           # (H, W) bool
                out = np.where(keep[..., None], img, mean_color)
                imgs[s] = out.astype(img.dtype)
            perturbed = replicate_row(ds, i, S)
            perturbed[self.inputCol] = imgs
            clock.mark("perturb")
            scored = self.model.transform(Dataset(perturbed, 1))
            targets = extract_targets(scored, self.targetCol,
                                      self.get("targetClasses"))
            clock.mark("score")
            states = mask.astype(np.float32)
            width = self.kernelWidth or (np.sqrt(d) * 0.75)
            w = _kernel_weights(states, width)
            coefs, r2 = _solve_rows(states[None], targets[None], w[None],
                                    self.regularization, self.device)
            exp_col.append(coefs[0].astype(np.float64))
            r2_col.append(r2[0].astype(np.float64))
            clock.mark("solve")
            sp_col.append(seg)
        self.timings = clock.seconds
        return ds.with_columns({self.outputCol: exp_col,
                                self.metricsCol: r2_col,
                                self.superpixelCol: sp_col})
