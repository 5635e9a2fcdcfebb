"""Generic dataset-op pipeline stages.

Re-designs the reference's ``stages`` package (reference:
core/src/main/scala/com/microsoft/azure/synapse/ml/stages/*.scala) for the
columnar :class:`Dataset`.  The crucial semantic shift is batching: the
reference mini-batchers turn *rows into list-valued rows* so per-partition
UDFs can amortize JNI calls (stages/MiniBatchTransformer.scala:55,79,153,189);
here they bound the batches a downstream stage takes at once.  The
PyTorch port's copy of the JAX package's ``ops/stages.py``: the stages
compute with numpy on the host, as there.
"""

from __future__ import annotations

import time
import unicodedata
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.dataset import Dataset, find_unused_column_name
from ..core.params import (BoolParam, DictParam, FloatParam, IntParam,
                           ListParam, Param, PyObjectParam, StringParam,
                           UDFParam)
from ..core.pipeline import Estimator, Model, PipelineStage, Transformer
from ..core.utils import StopWatch


# --------------------------------------------------------------------------
# column plumbing (reference: stages/DropColumns.scala, SelectColumns.scala,
# RenameColumn.scala, Repartition.scala, Cacher.scala, Lambda.scala)
# --------------------------------------------------------------------------


class DropColumns(Transformer):
    """reference: stages/DropColumns.scala."""

    cols = ListParam(doc="columns to drop", default=None)

    def __init__(self, cols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if cols is not None:
            self.set("cols", list(cols))

    def _transform(self, ds: Dataset) -> Dataset:
        cols = self.get_or_default("cols") or []
        missing = [c for c in cols if c not in ds]
        if missing:
            raise KeyError(f"cannot drop missing columns {missing}")
        return ds.drop(*cols)


class SelectColumns(Transformer):
    """reference: stages/SelectColumns.scala."""

    cols = ListParam(doc="columns to keep", default=None)

    def __init__(self, cols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if cols is not None:
            self.set("cols", list(cols))

    def _transform(self, ds: Dataset) -> Dataset:
        return ds.select(*(self.get_or_default("cols") or []))


class RenameColumn(Transformer):
    """reference: stages/RenameColumn.scala."""

    inputCol = StringParam(doc="column to rename")
    outputCol = StringParam(doc="new name")

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        return ds.rename(self.inputCol, self.outputCol)


class Repartition(Transformer):
    """Set the partition count — the partition→chip placement input
    (reference: stages/Repartition.scala)."""

    n = IntParam(doc="target partition count", default=1)
    disable = BoolParam(doc="pass through unchanged", default=False)

    def __init__(self, n: Optional[int] = None, **kw):
        super().__init__(**kw)
        if n is not None:
            self.set("n", n)

    def _transform(self, ds: Dataset) -> Dataset:
        if self.disable:
            return ds
        return ds.repartition(self.n)


class Cacher(Transformer):
    """reference: stages/Cacher.scala — on Spark this pins the DataFrame;
    our Datasets are host-resident numpy, so materialization is a no-op
    (kept for pipeline parity)."""

    disable = BoolParam(doc="skip caching", default=False)

    def _transform(self, ds: Dataset) -> Dataset:
        return ds


class Lambda(Transformer):
    """Arbitrary ds->ds function stage (reference: stages/Lambda.scala)."""

    transformFunc = UDFParam(doc="Dataset -> Dataset function")

    def __init__(self, transformFunc: Optional[Callable[[Dataset], Dataset]] = None,
                 **kw):
        super().__init__(**kw)
        if transformFunc is not None:
            self.set("transformFunc", transformFunc)

    def _transform(self, ds: Dataset) -> Dataset:
        return self.transformFunc(ds)


class UDFTransformer(Transformer):
    """Column-wise user function, applied *batched* over the whole column
    array — the reference applies a row UDF (stages/UDFTransformer.scala);
    batching keeps the hot path vectorizable.

    ``udf`` receives one positional numpy array per input column and returns
    an array (or list) of ``num_rows`` outputs.
    """

    inputCol = StringParam(doc="single input column")
    inputCols = ListParam(doc="multiple input columns")
    outputCol = StringParam(doc="output column")
    udf = UDFParam(doc="vectorized fn: (*cols) -> column")

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 udf: Optional[Callable] = None,
                 inputCols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))
        if outputCol is not None:
            self.set("outputCol", outputCol)
        if udf is not None:
            self.set("udf", udf)

    def _transform(self, ds: Dataset) -> Dataset:
        cols = self.inputCols if self.is_set("inputCols") else [self.inputCol]
        arrays = [ds[c] for c in cols]
        out = self.udf(*arrays)
        return ds.with_column(self.outputCol, out)


class MultiColumnAdapter(Transformer):
    """Apply a one-in/one-out base stage to each (inputCol, outputCol) pair
    (reference: stages/MultiColumnAdapter.scala)."""

    baseStage = PyObjectParam(doc="stage with inputCol/outputCol params")
    inputCols = ListParam(doc="input columns")
    outputCols = ListParam(doc="output columns")

    def __init__(self, baseStage: Optional[PipelineStage] = None,
                 inputCols: Optional[Sequence[str]] = None,
                 outputCols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if baseStage is not None:
            self.set("baseStage", baseStage)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))
        if outputCols is not None:
            self.set("outputCols", list(outputCols))

    def _transform(self, ds: Dataset) -> Dataset:
        ins, outs = self.inputCols, self.outputCols
        if len(ins) != len(outs):
            raise ValueError("inputCols and outputCols must align")
        cur = ds
        for i, o in zip(ins, outs):
            stage = self.baseStage.copy()
            stage.set("inputCol", i)
            stage.set("outputCol", o)
            if isinstance(stage, Estimator):
                cur = stage.fit(cur).transform(cur)
            else:
                cur = stage.transform(cur)
        return cur


# --------------------------------------------------------------------------
# row restructuring (reference: stages/Explode.scala, EnsembleByKey.scala)
# --------------------------------------------------------------------------


class Explode(Transformer):
    """Expand a list-valued column into one row per element
    (reference: stages/Explode.scala)."""

    inputCol = StringParam(doc="list-valued column")
    outputCol = StringParam(doc="scalar output column")

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        col = ds[self.inputCol]
        out_name = self.outputCol or self.inputCol
        lengths = np.fromiter((len(v) for v in col), dtype=np.int64,
                              count=len(col))
        idx = np.repeat(np.arange(len(col)), lengths)
        exploded: List[Any] = [x for v in col for x in v]
        cols: Dict[str, Any] = {}
        for name in ds.columns:
            if name == self.inputCol and out_name == self.inputCol:
                continue
            cols[name] = ds[name][idx]
        cols[out_name] = exploded
        # each exploded row descends from its parent row — quarantining
        # an element still names the source row that carried the list
        ri = ds.source_index[idx] if ds.has_source_index else None
        return Dataset(cols, ds.num_partitions, row_index=ri)


class EnsembleByKey(Transformer):
    """Average prediction columns grouped by key columns
    (reference: stages/EnsembleByKey.scala)."""

    keys = ListParam(doc="grouping key columns")
    cols = ListParam(doc="numeric/vector columns to average")
    colNames = ListParam(doc="output names (default mean(col))")
    strategy = StringParam(doc="aggregation strategy", default="mean",
                           allowed=("mean",))
    collapseGroup = BoolParam(doc="one row per key (vs broadcast back)",
                              default=True)
    vectorDims = DictParam(doc="unused hint, kept for parity")

    def __init__(self, keys: Optional[Sequence[str]] = None,
                 cols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if keys is not None:
            self.set("keys", list(keys))
        if cols is not None:
            self.set("cols", list(cols))

    def _transform(self, ds: Dataset) -> Dataset:
        keys, cols = self.keys, self.cols
        names = self.colNames if self.is_set("colNames") else \
            [f"mean({c})" for c in cols]
        key_arrays = [ds[k] for k in keys]
        composite = np.empty(ds.num_rows, dtype=object)
        for i in range(ds.num_rows):
            composite[i] = tuple(str(a[i]) for a in key_arrays)
        uniq, inv = np.unique(composite, return_inverse=True)
        means: Dict[str, np.ndarray] = {}
        for c, name in zip(cols, names):
            v = ds[c]
            if v.dtype == object:  # vector column: stack then segment-mean
                mat = np.stack([np.asarray(x, dtype=np.float64) for x in v])
                sums = np.zeros((len(uniq), mat.shape[1]))
                np.add.at(sums, inv, mat)
                counts = np.bincount(inv, minlength=len(uniq))[:, None]
                mean = sums / np.maximum(counts, 1)
                means[name] = np.array([row for row in mean], dtype=object)
            else:
                sums = np.bincount(inv, weights=v.astype(np.float64),
                                   minlength=len(uniq))
                counts = np.bincount(inv, minlength=len(uniq))
                means[name] = sums / np.maximum(counts, 1)
        if self.collapseGroup:
            first_idx = np.zeros(len(uniq), dtype=np.int64)
            seen = np.zeros(len(uniq), dtype=bool)
            for i, g in enumerate(inv):
                if not seen[g]:
                    seen[g] = True
                    first_idx[g] = i
            out = {k: ds[k][first_idx] for k in keys}
            out.update(means)
            return Dataset(out, ds.num_partitions)
        new_cols = {name: (arr[inv] if arr.dtype != object
                           else np.array([arr[g] for g in inv], dtype=object))
                    for name, arr in means.items()}
        return ds.with_columns(new_cols)


# --------------------------------------------------------------------------
# class balancing / stratified partitioning
# (reference: stages/ClassBalancer.scala, StratifiedRepartition.scala)
# --------------------------------------------------------------------------


class ClassBalancer(Estimator):
    """Fit per-class weights = max(count)/count(class)
    (reference: stages/ClassBalancer.scala)."""

    inputCol = StringParam(doc="label column", default="label")
    outputCol = StringParam(doc="weight output column", default="weight")
    broadcastJoin = BoolParam(doc="kept for parity", default=True)

    def __init__(self, inputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)

    def _fit(self, ds: Dataset) -> "ClassBalancerModel":
        labels = ds[self.inputCol]
        uniq, counts = np.unique(labels, return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        return ClassBalancerModel(
            inputCol=self.inputCol, outputCol=self.outputCol,
            values=[v.item() if hasattr(v, "item") else v for v in uniq],
            weights=list(weights))


class ClassBalancerModel(Model):
    inputCol = StringParam(doc="label column", default="label")
    outputCol = StringParam(doc="weight output column", default="weight")
    values = ListParam(doc="class values")
    weights = ListParam(doc="class weights")

    def __init__(self, **kw):
        super().__init__(**kw)

    def _transform(self, ds: Dataset) -> Dataset:
        table = {v: w for v, w in zip(self.values, self.weights)}
        labels = ds[self.inputCol]
        w = np.fromiter((table[x.item() if hasattr(x, "item") else x]
                         for x in labels), dtype=np.float64, count=len(labels))
        return ds.with_column(self.outputCol, w)


class StratifiedRepartition(Transformer):
    """Reorder rows so every partition sees every class
    (reference: stages/StratifiedRepartition.scala — 'equal'/'original'/
    'mixed' spread modes over partition ids)."""

    labelCol = StringParam(doc="class label column", default="label")
    mode = StringParam(doc="equal|original|mixed", default="mixed",
                       allowed=("equal", "original", "mixed"))
    seed = IntParam(doc="shuffle seed", default=1518410069)

    def __init__(self, labelCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if labelCol is not None:
            self.set("labelCol", labelCol)

    def _transform(self, ds: Dataset) -> Dataset:
        labels = ds[self.labelCol]
        rng = np.random.default_rng(self.seed % (2 ** 32))
        uniq = np.unique(labels)
        # round-robin interleave classes so contiguous partition slices are
        # stratified; 'equal' additionally truncates to equal class counts
        per_class = [np.flatnonzero(labels == u) for u in uniq]
        if self.mode == "equal":
            m = min(len(ix) for ix in per_class)
            per_class = [rng.permutation(ix)[:m] for ix in per_class]
        elif self.mode == "mixed":
            per_class = [rng.permutation(ix) for ix in per_class]
        order = []
        iters = [iter(ix) for ix in per_class]
        alive = list(range(len(iters)))
        while alive:
            nxt = []
            for k in alive:
                try:
                    order.append(next(iters[k]))
                    nxt.append(k)
                except StopIteration:
                    pass
            alive = nxt
        return ds._mask_rows(np.asarray(order, dtype=np.int64))


# --------------------------------------------------------------------------
# mini-batching (reference: stages/MiniBatchTransformer.scala:55,79,153,189,
# stages/Batchers.scala)
# --------------------------------------------------------------------------


def _to_batches(ds: Dataset, sizes: Sequence[int]) -> Dataset:
    cols: Dict[str, Any] = {}
    offsets = np.cumsum([0] + list(sizes))
    for name in ds.columns:
        v = ds[name]
        batched = np.empty(len(sizes), dtype=object)
        for i in range(len(sizes)):
            batched[i] = list(v[offsets[i]:offsets[i + 1]])
        cols[name] = batched
    return Dataset(cols, ds.num_partitions)


class FixedMiniBatchTransformer(Transformer):
    """Group rows into fixed-size list-valued batches
    (reference: stages/MiniBatchTransformer.scala:153).  ``buffered`` and
    ``maxBufferSize`` are parity params; batching is eager here."""

    batchSize = IntParam(doc="rows per batch", default=10)
    buffered = BoolParam(doc="parity: background buffering", default=False)
    maxBufferSize = IntParam(doc="parity: buffer cap", default=2147483647)

    def __init__(self, batchSize: Optional[int] = None, **kw):
        super().__init__(**kw)
        if batchSize is not None:
            self.set("batchSize", batchSize)

    def _transform(self, ds: Dataset) -> Dataset:
        b = self.batchSize
        n = ds.num_rows
        sizes = [min(b, n - s) for s in range(0, n, b)]
        return _to_batches(ds, sizes)


class DynamicMiniBatchTransformer(Transformer):
    """One batch per partition, capped by maxBatchSize (reference:
    stages/MiniBatchTransformer.scala:55 — batch = whatever is available)."""

    maxBatchSize = IntParam(doc="max rows per batch", default=2147483647)

    def _transform(self, ds: Dataset) -> Dataset:
        sizes: List[int] = []
        for a, b in ds.partition_bounds():
            size = b - a
            while size > 0:
                take = min(size, self.maxBatchSize)
                sizes.append(take)
                size -= take
        return _to_batches(ds, sizes)


class TimeIntervalMiniBatchTransformer(Transformer):
    """Parity stage for the streaming time-interval batcher (reference:
    stages/MiniBatchTransformer.scala:79).  On a materialized Dataset the
    interval degenerates to per-partition batches; maxBatchSize still caps."""

    millisToWait = IntParam(doc="interval in ms", default=1000)
    maxBatchSize = IntParam(doc="max rows per batch", default=2147483647)

    def _transform(self, ds: Dataset) -> Dataset:
        return DynamicMiniBatchTransformer(
            maxBatchSize=self.maxBatchSize)._transform(ds)


class FlattenBatch(Transformer):
    """Invert a mini-batcher: explode all list-valued columns in lockstep
    (reference: stages/MiniBatchTransformer.scala:189)."""

    def _transform(self, ds: Dataset) -> Dataset:
        first = ds[ds.columns[0]]
        lengths = np.fromiter((len(v) for v in first), dtype=np.int64,
                              count=len(first))
        cols: Dict[str, Any] = {}
        for name in ds.columns:
            v = ds[name]
            flat: List[Any] = []
            for i, batch in enumerate(v):
                if len(batch) != lengths[i]:
                    raise ValueError(
                        f"ragged batch in {name}: {len(batch)} != {lengths[i]}")
                flat.extend(batch)
            cols[name] = flat
        return Dataset(cols, ds.num_partitions)


class PartitionConsolidator(Transformer):
    """Funnel all rows to one partition per host — used so rate-limited
    resources (HTTP clients, native handles) are shared once per JVM in the
    reference (stages/PartitionConsolidator.scala:22).  Here: coalesce to
    one partition per process of the initialized ``torch.distributed``
    group (one without a group), so one process owns the stage."""

    concurrency = IntParam(doc="parity: client concurrency", default=1)
    concurrentTimeout = FloatParam(doc="parity: seconds to wait", default=100.0)

    def _transform(self, ds: Dataset) -> Dataset:
        import torch.distributed as dist
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        return ds.repartition(max(1, world))


# --------------------------------------------------------------------------
# text normalization (reference: stages/TextPreprocessor.scala,
# stages/UnicodeNormalize.scala)
# --------------------------------------------------------------------------


class TextPreprocessor(Transformer):
    """Trie-based find/replace over a string column
    (reference: stages/TextPreprocessor.scala — longest-match semantics)."""

    inputCol = StringParam(doc="input text column")
    outputCol = StringParam(doc="output text column")
    map = DictParam(doc="substring -> replacement")
    normFunc = StringParam(doc="identity|lowerCase", default="identity",
                           allowed=("identity", "lowerCase"))

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 map: Optional[Dict[str, str]] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)
        if map is not None:
            self.set("map", dict(map))

    def _transform(self, ds: Dataset) -> Dataset:
        norm = (lambda s: s.lower()) if self.normFunc == "lowerCase" else (lambda s: s)
        # keys go through the same normalization as the text, else an
        # uppercase key could never match normalized input
        table = {norm(k): v for k, v in
                 (self.get_or_default("map") or {}).items()}
        # longest-first replacement reproduces the reference trie's
        # longest-match-wins behavior
        keys = sorted(table, key=len, reverse=True)

        def clean(s: str) -> str:
            s = norm(str(s))
            out = []
            i = 0
            while i < len(s):
                for k in keys:
                    if k and s.startswith(k, i):
                        out.append(table[k])
                        i += len(k)
                        break
                else:
                    out.append(s[i])
                    i += 1
            return "".join(out)

        col = ds[self.inputCol]
        return ds.with_column(self.outputCol, [clean(s) for s in col])


class UnicodeNormalize(Transformer):
    """reference: stages/UnicodeNormalize.scala (NFC/NFD/NFKC/NFKD + lower)."""

    inputCol = StringParam(doc="input text column")
    outputCol = StringParam(doc="output text column")
    form = StringParam(doc="NFC|NFD|NFKC|NFKD", default="NFKD",
                       allowed=("NFC", "NFD", "NFKC", "NFKD"))
    lower = BoolParam(doc="lowercase after normalization", default=True)

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        col = ds[self.inputCol]
        out = [unicodedata.normalize(self.form, str(s)) for s in col]
        if self.lower:
            out = [s.lower() for s in out]
        return ds.with_column(self.outputCol, out)


# --------------------------------------------------------------------------
# summarization / timing (reference: stages/SummarizeData.scala,
# stages/Timer.scala)
# --------------------------------------------------------------------------


class SummarizeData(Transformer):
    """Per-column summary statistics table
    (reference: stages/SummarizeData.scala — counts/basic/sample/percentiles
    flag groups)."""

    counts = BoolParam(doc="include count stats", default=True)
    basic = BoolParam(doc="include basic stats", default=True)
    sample = BoolParam(doc="include sample stats", default=True)
    percentiles = BoolParam(doc="include percentiles", default=True)
    errorThreshold = FloatParam(doc="parity: approx quantile error", default=0.0)

    def _transform(self, ds: Dataset) -> Dataset:
        rows: List[Dict[str, Any]] = []
        for name in ds.columns:
            v = ds[name]
            row: Dict[str, Any] = {"Feature": name}
            numeric = v.dtype != object and v.dtype.kind in "ifub"
            x = v.astype(np.float64) if numeric else None
            finite = x[np.isfinite(x)] if numeric else None
            if self.counts:
                row["Count"] = float(len(v))
                row["Unique Value Count"] = float(len(np.unique(v.astype(str) if v.dtype == object else v)))
                row["Missing Value Count"] = (
                    float(np.sum(~np.isfinite(x))) if numeric else
                    float(sum(1 for s in v if s is None)))
            if self.basic:
                row["Mean"] = float(finite.mean()) if numeric and len(finite) else np.nan
                row["Standard Deviation"] = (
                    float(finite.std(ddof=1)) if numeric and len(finite) > 1 else np.nan)
                row["Min"] = float(finite.min()) if numeric and len(finite) else np.nan
                row["Max"] = float(finite.max()) if numeric and len(finite) else np.nan
            if self.sample:
                row["Sample Variance"] = (
                    float(finite.var(ddof=1)) if numeric and len(finite) > 1 else np.nan)
                if numeric and len(finite) > 2 and finite.std() > 0:
                    z = (finite - finite.mean()) / finite.std()
                    row["Sample Skewness"] = float(np.mean(z ** 3))
                    row["Sample Kurtosis"] = float(np.mean(z ** 4) - 3)
                else:
                    row["Sample Skewness"] = np.nan
                    row["Sample Kurtosis"] = np.nan
            if self.percentiles:
                for q, label in ((0.005, "P0.5"), (0.01, "P1"), (0.05, "P5"),
                                 (0.25, "P25"), (0.5, "Median"), (0.75, "P75"),
                                 (0.95, "P95"), (0.99, "P99"), (0.995, "P99.5")):
                    row[label] = (float(np.quantile(finite, q))
                                  if numeric and len(finite) else np.nan)
            rows.append(row)
        return Dataset.from_rows(rows, num_partitions=1)


class Timer(Estimator):
    """Wrap a stage and report wall-clock for fit/transform
    (reference: stages/Timer.scala)."""

    stage = PyObjectParam(doc="stage to time")
    logToScala = BoolParam(doc="parity: log to driver", default=True)
    disableMaterialization = BoolParam(doc="parity", default=True)

    def __init__(self, stage: Optional[PipelineStage] = None, **kw):
        super().__init__(**kw)
        if stage is not None:
            self.set("stage", stage)

    def _fit(self, ds: Dataset) -> "TimerModel":
        stage = self.stage
        sw = StopWatch()
        if isinstance(stage, Estimator):
            with sw.measure():
                fitted = stage.fit(ds)
        else:
            fitted = stage
        model = TimerModel(stage=fitted, logToScala=self.logToScala)
        model.fit_time_s = sw.elapsed_s
        return model


class TimerModel(Model):
    stage = PyObjectParam(doc="wrapped fitted transformer")
    logToScala = BoolParam(doc="parity", default=True)

    fit_time_s: float = 0.0
    last_transform_time_s: float = 0.0

    def __init__(self, stage: Optional[Transformer] = None, **kw):
        super().__init__(**kw)
        if stage is not None:
            self.set("stage", stage)

    def _transform(self, ds: Dataset) -> Dataset:
        sw = StopWatch()
        with sw.measure():
            out = self.stage.transform(ds)
        self.last_transform_time_s = sw.elapsed_s
        return out
