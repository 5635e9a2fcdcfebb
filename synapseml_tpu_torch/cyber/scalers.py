"""Per-group scalar scalers (reference: cyber/feature/scalers.py —
StandardScalarScaler standardizes per partition key;
LinearScalarScaler maps each group's [min, max] onto a required
range)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..core.dataset import Dataset
from ..core.params import DictParam, FloatParam, StringParam
from ..core.pipeline import Estimator, Model


def _group_indices(keys: np.ndarray) -> Dict[Any, np.ndarray]:
    out: Dict[Any, list] = {}
    for i, k in enumerate(keys):
        out.setdefault(str(k), []).append(i)
    return {k: np.asarray(v) for k, v in out.items()}


class _PerGroupScalerModel(Model):
    inputCol = StringParam(doc="value column")
    partitionKey = StringParam(doc="group column")
    outputCol = StringParam(doc="scaled output column")
    perGroupStats = DictParam(doc="group → stats", default=None)

    def _norm(self, x: np.ndarray, stats: Dict[str, float]) -> np.ndarray:
        raise NotImplementedError

    def _transform(self, ds: Dataset) -> Dataset:
        stats = self.get("perGroupStats") or {}
        x = np.asarray(ds[self.inputCol], np.float64)
        out = np.empty(ds.num_rows, np.float64)
        for key, idx in _group_indices(ds[self.partitionKey]).items():
            s = stats.get(key)
            if s is None:  # unseen group passes through unscaled
                out[idx] = x[idx]
            else:
                out[idx] = self._norm(x[idx], s)
        return ds.with_column(self.outputCol, out)


class StandardScalarScalerModel(_PerGroupScalerModel):
    """(x - mean)/std per group, times coefficientFactor (reference:
    scalers.py StandardScalarScalerModel)."""

    coefficientFactor = FloatParam(doc="multiplier on the standardized "
                                   "value", default=1.0)

    def _norm(self, x, s):
        std = s["std"] if s["std"] != 0.0 else 1.0
        return float(self.coefficientFactor) * (x - s["mean"]) / std


class StandardScalarScaler(Estimator):
    """Learn per-group mean/std (reference: scalers.py
    StandardScalarScaler)."""

    inputCol = StringParam(doc="value column")
    partitionKey = StringParam(doc="group column")
    outputCol = StringParam(doc="scaled output column")
    coefficientFactor = FloatParam(doc="multiplier", default=1.0)

    def _fit(self, ds: Dataset) -> StandardScalarScalerModel:
        x = np.asarray(ds[self.inputCol], np.float64)
        stats = {}
        for key, idx in _group_indices(ds[self.partitionKey]).items():
            stats[key] = {"mean": float(x[idx].mean()),
                          "std": float(x[idx].std())}
        return StandardScalarScalerModel(
            inputCol=self.inputCol, partitionKey=self.partitionKey,
            outputCol=self.outputCol, perGroupStats=stats,
            coefficientFactor=float(self.coefficientFactor))


class LinearScalarScalerModel(_PerGroupScalerModel):
    """a*x + b per group mapping [min, max] → [minRequired, maxRequired]
    (reference: scalers.py LinearScalarScalerModel — degenerate groups
    map to maxRequired)."""

    def _norm(self, x, s):
        return s["a"] * x + s["b"]


class LinearScalarScaler(Estimator):
    """Learn the per-group affine map (reference: scalers.py
    LinearScalarScaler)."""

    inputCol = StringParam(doc="value column")
    partitionKey = StringParam(doc="group column")
    outputCol = StringParam(doc="scaled output column")
    minRequiredValue = FloatParam(doc="range low", default=0.0)
    maxRequiredValue = FloatParam(doc="range high", default=1.0)

    def _fit(self, ds: Dataset) -> LinearScalarScalerModel:
        x = np.asarray(ds[self.inputCol], np.float64)
        lo, hi = float(self.minRequiredValue), float(self.maxRequiredValue)
        stats = {}
        for key, idx in _group_indices(ds[self.partitionKey]).items():
            xmin, xmax = float(x[idx].min()), float(x[idx].max())
            delta = xmax - xmin
            if delta != 0.0:
                a = (hi - lo) / delta
                b = hi - a * xmax
            else:
                a, b = 0.0, hi
            stats[key] = {"a": a, "b": b}
        return LinearScalarScalerModel(
            inputCol=self.inputCol, partitionKey=self.partitionKey,
            outputCol=self.outputCol, perGroupStats=stats)
