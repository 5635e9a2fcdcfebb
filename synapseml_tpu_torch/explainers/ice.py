"""Individual Conditional Expectation / Partial Dependence.

Re-designs the reference's ICE transformer (reference:
explainers/ICEExplainer.scala:130 — ICETransformer with kind
"individual"|"average"|"feature", numeric ranges and categorical top-K).
All grid×row evaluations are flattened into one ``model.transform`` call.
No device work of its own: the wrapped model runs where it was built.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.dataset import Dataset
from ..core.params import IntParam, ListParam, PyObjectParam, StringParam
from ..core.pipeline import Transformer
from .common import extract_targets


class ICETransformer(Transformer):
    model = PyObjectParam(doc="fitted model to probe")
    targetCol = StringParam(doc="model output column", default="probability")
    targetClasses = ListParam(doc="class indices for vector outputs",
                              default=None)
    kind = StringParam(doc="individual|average", default="individual",
                       allowed=("individual", "average"))
    categoricalFeatures = ListParam(doc="categorical feature columns",
                                    default=None)
    numericFeatures = ListParam(doc="numeric feature columns", default=None)
    numSplits = IntParam(doc="grid points for numeric features", default=10)
    topNValues = IntParam(doc="top-K values for categorical features",
                          default=10)
    outputColSuffix = StringParam(doc="suffix for per-feature output columns",
                                  default="_dependence")

    def __init__(self, model=None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)

    def _grid(self, ds: Dataset, col: str, categorical: bool) -> np.ndarray:
        v = ds[col]
        if categorical:
            vals, counts = np.unique(
                v.astype(str) if v.dtype == object else v, return_counts=True)
            top = vals[np.argsort(-counts)][:self.topNValues]
            if v.dtype == object:
                out = np.empty(len(top), dtype=object)
                out[:] = top
                return out
            return top.astype(v.dtype)
        x = v.astype(np.float64)
        lo, hi = np.nanmin(x), np.nanmax(x)
        return np.linspace(lo, hi, self.numSplits).astype(v.dtype)

    def _transform(self, ds: Dataset) -> Dataset:
        n = ds.num_rows
        out_cols: Dict[str, List] = {}
        feats = ([(c, False) for c in (self.get_or_default("numericFeatures") or [])]
                 + [(c, True) for c in (self.get_or_default("categoricalFeatures") or [])])
        if not feats:
            raise ValueError("ICETransformer needs numericFeatures and/or "
                             "categoricalFeatures")
        result_ds = ds
        pdp_cols: Dict[str, List] = {}
        for col, categorical in feats:
            grid = self._grid(ds, col, categorical)
            G = len(grid)
            # build n*G rows: row i repeated with col set to each grid value
            rep: Dict[str, np.ndarray] = {}
            for c in ds.columns:
                v = ds[c]
                if v.dtype == object:
                    big = np.empty(n * G, dtype=object)
                    for i in range(n):
                        for g in range(G):
                            big[i * G + g] = v[i]
                    rep[c] = big
                else:
                    rep[c] = np.repeat(v, G)
            if grid.dtype == object:
                gcol = np.empty(n * G, dtype=object)
                for i in range(n):
                    gcol[i * G:(i + 1) * G] = grid
                rep[col] = gcol
            else:
                rep[col] = np.tile(grid, n)
            scored = self.model.transform(Dataset(rep, ds.num_partitions))
            targets = extract_targets(scored, self.targetCol,
                                      self.get("targetClasses"))
            curves = targets.reshape(n, G, -1)
            name = f"{col}{self.outputColSuffix}"
            if self.kind == "average":
                # one output row per feature: grid values + (G, T) PDP matrix
                pdp_cols.setdefault("feature", []).append(col)
                pdp_cols.setdefault("values", []).append(
                    list(grid) if grid.dtype == object
                    else grid.astype(np.float64))
                pdp_cols.setdefault("dependence", []).append(
                    curves.mean(0).astype(np.float64))
            else:
                result_ds = result_ds.with_column(
                    name, [curves[i].astype(np.float64) for i in range(n)])
        if self.kind == "average":
            return Dataset(pdp_cols, num_partitions=1)
        return result_ds
