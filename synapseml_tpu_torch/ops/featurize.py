"""Auto-featurization stages.

Re-designs the reference's ``featurize`` package (reference:
core/src/main/scala/com/microsoft/azure/synapse/ml/featurize/*.scala):
value indexing, missing-data cleaning, type conversion, zero-variance
feature pruning, and the one-call :class:`Featurize` that assembles mixed
numeric/categorical/text columns into a single dense ``features`` vector.
The PyTorch port's copy of the JAX package's ``ops/featurize.py``: every
stage computes with numpy on the host, as there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.dataset import Dataset, find_unused_column_name
from ..core.params import (ArrayParam, BoolParam, DictParam, IntParam,
                           ListParam, PyObjectParam, StringParam)
from ..core.pipeline import Estimator, Model, Transformer


class ValueIndexer(Estimator):
    """Map arbitrary column values to contiguous 0..K-1 indices
    (reference: featurize/ValueIndexer.scala; levels sorted for
    determinism)."""

    inputCol = StringParam(doc="column to index")
    outputCol = StringParam(doc="index output column")

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _fit(self, ds: Dataset) -> "ValueIndexerModel":
        col = ds[self.inputCol]
        uniq = sorted(set(col.tolist()), key=lambda x: (x is None, str(x)))
        return ValueIndexerModel(
            inputCol=self.inputCol, outputCol=self.outputCol,
            levels=[u.item() if hasattr(u, "item") else u for u in uniq])


class ValueIndexerModel(Model):
    inputCol = StringParam(doc="column to index")
    outputCol = StringParam(doc="index output column")
    levels = ListParam(doc="ordered distinct values; index = position")

    def _transform(self, ds: Dataset) -> Dataset:
        table = {v: i for i, v in enumerate(self.levels or [])}
        col = ds[self.inputCol]
        idx = np.fromiter(
            (table.get(x.item() if hasattr(x, "item") else x, -1) for x in col),
            dtype=np.int64, count=len(col))
        if (idx < 0).any():
            bad = col[idx < 0][:3]
            raise ValueError(f"unseen levels in {self.inputCol}: {list(bad)}")
        return ds.with_column(self.outputCol, idx)


class IndexToValue(Transformer):
    """Inverse of ValueIndexerModel (reference: featurize/IndexToValue.scala).
    Levels are taken from the ``levels`` param (set by the indexer model)."""

    inputCol = StringParam(doc="index column")
    outputCol = StringParam(doc="value output column")
    levels = ListParam(doc="ordered distinct values")

    def _transform(self, ds: Dataset) -> Dataset:
        levels = self.levels or []
        idx = ds[self.inputCol].astype(np.int64)
        vals = [levels[i] for i in idx]
        return ds.with_column(self.outputCol, vals)


class CleanMissingData(Estimator):
    """Fill NaN/None per column with mean/median/custom
    (reference: featurize/CleanMissingData.scala)."""

    #: this stage's JOB is consuming NaN — the row guard must not screen
    #: its inputs or a pipeline-level handleInvalid='quarantine' would
    #: dead-letter exactly the rows it exists to repair
    _guard_screen_nan = False

    inputCols = ListParam(doc="columns to clean")
    outputCols = ListParam(doc="cleaned output columns")
    cleaningMode = StringParam(doc="Mean|Median|Custom", default="Mean",
                               allowed=("Mean", "Median", "Custom"))
    customValue = PyObjectParam(doc="fill value for Custom mode")

    def __init__(self, inputCols: Optional[Sequence[str]] = None,
                 outputCols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))
        if outputCols is not None:
            self.set("outputCols", list(outputCols))

    def _fit(self, ds: Dataset) -> "CleanMissingDataModel":
        mode = self.cleaningMode
        fills: List[float] = []
        for c in self.inputCols:
            v = ds[c].astype(np.float64)
            finite = v[np.isfinite(v)]
            if mode == "Mean":
                fills.append(float(finite.mean()) if len(finite) else 0.0)
            elif mode == "Median":
                fills.append(float(np.median(finite)) if len(finite) else 0.0)
            else:
                fills.append(float(self.customValue))
        return CleanMissingDataModel(
            inputCols=list(self.inputCols), outputCols=list(self.outputCols),
            fillValues=fills)


class CleanMissingDataModel(Model):
    _guard_screen_nan = False          # NaN is this model's input domain

    inputCols = ListParam(doc="columns to clean")
    outputCols = ListParam(doc="cleaned output columns")
    fillValues = ListParam(doc="per-column fill values")

    def _transform(self, ds: Dataset) -> Dataset:
        out = ds
        for c, o, fill in zip(self.inputCols, self.outputCols, self.fillValues):
            v = ds[c].astype(np.float64)
            v = np.where(np.isfinite(v), v, fill)
            out = out.with_column(o, v)
        return out


class DataConversion(Transformer):
    """Cast columns to a target dtype (reference:
    featurize/DataConversion.scala — convertTo boolean/byte/short/integer/
    long/float/double/string/date)."""

    cols = ListParam(doc="columns to convert")
    convertTo = StringParam(doc="target type", default="double",
                            allowed=("boolean", "byte", "short", "integer",
                                     "long", "float", "double", "string"))
    dateTimeFormat = StringParam(doc="parity: date format",
                                 default="yyyy-MM-dd HH:mm:ss")

    _DTYPES = {"boolean": np.bool_, "byte": np.int8, "short": np.int16,
               "integer": np.int32, "long": np.int64, "float": np.float32,
               "double": np.float64}

    def __init__(self, cols: Optional[Sequence[str]] = None,
                 convertTo: Optional[str] = None, **kw):
        super().__init__(**kw)
        if cols is not None:
            self.set("cols", list(cols))
        if convertTo is not None:
            self.set("convertTo", convertTo)

    def _transform(self, ds: Dataset) -> Dataset:
        out = ds
        for c in self.cols or []:
            v = ds[c]
            if self.convertTo == "string":
                out = out.with_column(c, [str(x) for x in v])
            else:
                out = out.with_column(c, v.astype(self._DTYPES[self.convertTo]))
        return out


class CountSelector(Estimator):
    """Drop features that are all-zero in the fit data
    (reference: featurize/CountSelector.scala)."""

    inputCol = StringParam(doc="vector column", default="features")
    outputCol = StringParam(doc="pruned vector column", default="features")

    def _fit(self, ds: Dataset) -> "CountSelectorModel":
        mat = ds.to_numpy([self.inputCol], dtype=np.float64)
        keep = np.flatnonzero((mat != 0).any(axis=0))
        return CountSelectorModel(inputCol=self.inputCol,
                                  outputCol=self.outputCol,
                                  indices=[int(i) for i in keep])


class CountSelectorModel(Model):
    inputCol = StringParam(doc="vector column", default="features")
    outputCol = StringParam(doc="pruned vector column", default="features")
    indices = ListParam(doc="kept feature indices")

    def _transform(self, ds: Dataset) -> Dataset:
        mat = ds.to_numpy([self.inputCol], dtype=np.float64)
        keep = np.asarray(self.indices or [], dtype=np.int64)
        pruned = mat[:, keep]
        return ds.with_column(self.outputCol,
                              [row.astype(np.float64) for row in pruned])


class Featurize(Estimator):
    """One-call auto-featurizer: numeric columns pass through, string
    columns are one-hot (or hashed when high-cardinality), missing values
    imputed — output is a single dense vector column
    (reference: featurize/Featurize.scala + Featurize defaults:
    oneHotEncodeCategoricals, numFeatures hashing dimension)."""

    inputCols = ListParam(doc="columns to featurize")
    outputCol = StringParam(doc="assembled vector column", default="features")
    oneHotEncodeCategoricals = BoolParam(doc="one-hot strings", default=True)
    # the reference defaults to 2^18 sparse; the assembled vectors here are
    # dense, so the default hash dimension is 4096
    numFeatures = IntParam(doc="hash dim for high-cardinality/text columns "
                           "(dense)", default=4096)
    imputeMissing = BoolParam(doc="impute NaN with mean", default=True)

    #: one-hot cardinality cutoff; beyond this a string column is hashed
    _MAX_ONE_HOT = 100

    def __init__(self, inputCols: Optional[Sequence[str]] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _fit(self, ds: Dataset) -> "FeaturizeModel":
        plan: List[Dict[str, Any]] = []
        for c in self.inputCols:
            v = ds[c]
            if v.dtype != object:
                x = v.astype(np.float64)
                finite = x[np.isfinite(x)]
                mean = float(finite.mean()) if len(finite) else 0.0
                plan.append({"col": c, "kind": "numeric", "fill": mean})
            elif len(v) and isinstance(v[0], (list, tuple, np.ndarray)):
                plan.append({"col": c, "kind": "vector",
                             "dim": int(len(np.asarray(v[0]).ravel()))})
            else:
                uniq = sorted({str(x) for x in v})
                if self.oneHotEncodeCategoricals and len(uniq) <= self._MAX_ONE_HOT:
                    plan.append({"col": c, "kind": "onehot", "levels": uniq})
                else:
                    # hashing trick for high-cardinality strings; the full
                    # numFeatures dimension is honored — output vectors are
                    # dense, so users trading memory for fewer collisions
                    # get exactly what they asked for
                    plan.append({"col": c, "kind": "hash",
                                 "dim": self.numFeatures})
        return FeaturizeModel(outputCol=self.outputCol, plan=plan,
                              imputeMissing=self.imputeMissing)


class FeaturizeModel(Model):
    outputCol = StringParam(doc="assembled vector column", default="features")
    plan = PyObjectParam(doc="per-column featurization plan")
    imputeMissing = BoolParam(doc="impute NaN with mean", default=True)

    def _transform(self, ds: Dataset) -> Dataset:
        blocks: List[np.ndarray] = []
        for spec in self.plan or []:
            c, kind = spec["col"], spec["kind"]
            v = ds[c]
            if kind == "numeric":
                x = v.astype(np.float64)
                if self.imputeMissing:
                    x = np.where(np.isfinite(x), x, spec["fill"])
                blocks.append(x[:, None])
            elif kind == "vector":
                blocks.append(np.stack(
                    [np.asarray(x, dtype=np.float64).ravel() for x in v]))
            elif kind == "onehot":
                table = {s: i for i, s in enumerate(spec["levels"])}
                out = np.zeros((len(v), len(table)))
                for i, x in enumerate(v):
                    j = table.get(str(x))
                    if j is not None:
                        out[i, j] = 1.0
                blocks.append(out)
            else:  # hash
                from ..core.hashing import murmurhash3_32
                dim = spec["dim"]
                out = np.zeros((len(v), dim))
                for i, x in enumerate(v):
                    h = murmurhash3_32(str(x).encode("utf-8"), seed=0)
                    out[i, h % dim] = 1.0
                blocks.append(out)
        mat = np.concatenate(blocks, axis=1) if blocks else np.zeros((ds.num_rows, 0))
        return ds.with_column(self.outputCol,
                              [row for row in mat.astype(np.float64)])
