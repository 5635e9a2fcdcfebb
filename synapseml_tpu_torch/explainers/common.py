"""Shared plumbing for local explainers (LocalExplainer.scala:13 analogue)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.dataset import Dataset
from ..core.params import IntParam, ListParam, PyObjectParam, StringParam


class LocalExplainerParams:
    model = PyObjectParam(doc="fitted model whose output is explained")
    targetCol = StringParam(doc="model output column to explain",
                            default="probability")
    targetClasses = ListParam(doc="class indices to explain (vector outputs)",
                              default=None)
    outputCol = StringParam(doc="explanation output column", default="explanation")
    metricsCol = StringParam(doc="fit-quality output column (r2)", default="r2")
    numSamples = IntParam(doc="perturbations per row", default=1000)
    seed = IntParam(doc="sampling seed", default=0)
    device = StringParam(doc="device the surrogate solves run on: 'cuda' "
                             "(raises when no card is present) or 'cpu'; "
                             "the wrapped model runs where it was built",
                         default="cuda")


def extract_targets(scored: Dataset, target_col: str,
                    target_classes: Optional[Sequence[int]]) -> np.ndarray:
    """(n, T) matrix of model outputs: scalar column -> T=1; vector column ->
    selected class indices (default: class 1 if binary-like else all)."""
    col = scored[target_col]
    if col.dtype != object:
        return col.astype(np.float64)[:, None]
    mat = np.stack([np.asarray(v, np.float64).ravel() for v in col])
    if target_classes:
        return mat[:, list(target_classes)]
    if mat.shape[1] == 2:
        return mat[:, 1:2]
    return mat


def replicate_row(ds: Dataset, row_idx: int, n: int) -> dict:
    """n copies of one row as a column dict."""
    out = {}
    for c in ds.columns:
        v = ds[c]
        if v.dtype == object:
            col = np.empty(n, dtype=object)
            for i in range(n):
                col[i] = v[row_idx]
            out[c] = col
        else:
            out[c] = np.repeat(v[row_idx:row_idx + 1], n)
    return out
