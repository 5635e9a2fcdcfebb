"""Per-partition id indexers (reference: cyber/feature/indexers.py —
IdIndexer/IdIndexerModel map string ids to contiguous ints per
partition key, with ``undo_transform`` for the reverse mapping)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataset import Dataset
from ..core.params import BoolParam, DictParam, StringParam
from ..core.pipeline import Estimator, Model


class IdIndexer(Estimator):
    """Assign 1-based contiguous indices to ids, scoped by partition key
    (reference: indexers.py IdIndexer — ``resetPerPartition`` restarts
    numbering per partition)."""

    inputCol = StringParam(doc="id column to index")
    partitionKey = StringParam(doc="partition/tenant column")
    outputCol = StringParam(doc="index output column")
    resetPerPartition = BoolParam(doc="restart numbering per partition",
                                  default=True)

    def _fit(self, ds: Dataset) -> "IdIndexerModel":
        keys = ds[self.partitionKey]
        vals = ds[self.inputCol]
        mapping: Dict[Any, Dict[Any, int]] = {}
        counter: Dict[Any, int] = {}
        global_count = 0
        for k, v in zip(keys, vals):
            per = mapping.setdefault(k, {})
            if v in per:
                continue
            if self.resetPerPartition:
                counter[k] = counter.get(k, 0) + 1
                per[v] = counter[k]
            else:
                global_count += 1
                per[v] = global_count
        return IdIndexerModel(inputCol=self.inputCol,
                              partitionKey=self.partitionKey,
                              outputCol=self.outputCol,
                              mapping={str(k): {str(v): i
                                                for v, i in per.items()}
                                       for k, per in mapping.items()})


class IdIndexerModel(Model):
    """Apply the learned (partition, id) → index mapping; unseen ids get
    0 (reference uses null; 0 is our sentinel since indices are 1-based)."""

    inputCol = StringParam(doc="id column to index")
    partitionKey = StringParam(doc="partition/tenant column")
    outputCol = StringParam(doc="index output column")
    mapping = DictParam(doc="partition → {id → index}", default=None)

    def _transform(self, ds: Dataset) -> Dataset:
        mapping = self.get("mapping") or {}
        keys = ds[self.partitionKey]
        vals = ds[self.inputCol]
        out = np.zeros(ds.num_rows, dtype=np.int64)
        for i, (k, v) in enumerate(zip(keys, vals)):
            out[i] = mapping.get(str(k), {}).get(str(v), 0)
        return ds.with_column(self.outputCol, out)

    def undo_transform(self, ds: Dataset) -> Dataset:
        """index → original id (reference: IdIndexerModel.undo_transform)."""
        mapping = self.get("mapping") or {}
        inverse = {k: {i: v for v, i in per.items()}
                   for k, per in mapping.items()}
        keys = ds[self.partitionKey]
        idxs = ds[self.outputCol]
        out = np.empty(ds.num_rows, dtype=object)
        for i, (k, ix) in enumerate(zip(keys, idxs)):
            out[i] = inverse.get(str(k), {}).get(int(ix))
        return ds.with_column(self.inputCol, out)


class MultiIndexer(Estimator):
    """Fit several IdIndexers at once (reference: indexers.py
    MultiIndexer)."""

    def __init__(self, indexers: Optional[List[IdIndexer]] = None, **kw):
        super().__init__(**kw)
        self.indexers = list(indexers or [])

    def _fit(self, ds: Dataset) -> "MultiIndexerModel":
        m = MultiIndexerModel()
        m.models = [ix.fit(ds) for ix in self.indexers]
        return m


class MultiIndexerModel(Model):
    models: List[IdIndexerModel]

    def __init__(self, **kw):
        super().__init__(**kw)
        self.models = []

    def _transform(self, ds: Dataset) -> Dataset:
        for m in self.models:
            ds = m.transform(ds)
        return ds

    def get_model_by_input_col(self, col: str) -> Optional[IdIndexerModel]:
        for m in self.models:
            if m.inputCol == col:
                return m
        return None
