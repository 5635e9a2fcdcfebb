"""Hashing-trick featurizer + namespace interactions.

The PyTorch port's copy of the JAX package's ``models/online/featurizer.py``
(host numpy; string columns hash through the native batch hasher).
Re-designs the reference's VW feature engineering (reference:
vw/.../VowpalWabbitFeaturizer.scala:25,150-165 — murmur hash with
column-name prefix into a SparseVector — and
VowpalWabbitInteractions.scala:96 — namespace crossing).  TPU difference:
output is a *dense* vector column sized for the MXU; hash dimension
defaults accordingly (VW defaults to 2^18 sparse bits).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ...core.dataset import Dataset
from ...core.hashing import murmurhash3_32, murmurhash3_column
from ...core.params import (BoolParam, IntParam, ListParam, StringParam)
from ...core.pipeline import Transformer


class HashingFeaturizer(Transformer):
    """Hash input columns into one dense vector column.

    - numeric columns contribute value at index hash(colName)
    - string columns contribute 1.0 at index hash(colName + value)
    - list-of-string columns contribute counts per token
    (reference: VowpalWabbitFeaturizer.scala featurizer dispatch by dtype)
    """

    inputCols = ListParam(doc="columns to hash")
    outputCol = StringParam(doc="dense vector output", default="features")
    numBits = IntParam(doc="log2 of hash dimension", default=12)
    seed = IntParam(doc="murmur seed (hashSeed param)", default=0)
    sumCollisions = BoolParam(doc="sum colliding values (vs overwrite)",
                              default=True)
    preserveOrderNumBits = IntParam(doc="parity: VW order-preserving bits",
                                    default=0)
    signedMode = BoolParam(doc="use a hash bit as value sign", default=False)

    def __init__(self, inputCols: Optional[Sequence[str]] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        dim = 1 << self.numBits
        seed = self.seed
        n = ds.num_rows
        out = np.zeros((n, dim), np.float32)
        for c in self.inputCols:
            v = ds[c]
            if v.dtype != object:  # numeric: fixed index per column
                idx = murmurhash3_32(c, seed) % dim
                vals = v.astype(np.float32)
                if self.sumCollisions:
                    out[:, idx] += vals
                else:
                    out[:, idx] = vals
            else:
                # flatten (row, token) pairs and hash the whole column in
                # one native batch call (textproc.cpp), then scatter
                rows: List[int] = []
                flat: List[str] = []
                for i, x in enumerate(v):
                    tokens = x if isinstance(x, (list, tuple, np.ndarray)) else [x]
                    for t in tokens:
                        rows.append(i)
                        flat.append(c + str(t))
                if not flat:
                    continue
                hashes = murmurhash3_column(flat, seed).astype(np.int64)
                ridx = np.asarray(rows, np.int64)
                vals = np.ones(len(flat), np.float32)
                if self.signedMode:
                    vals = np.where((hashes >> 31) & 1, -1.0, 1.0).astype(np.float32)
                if self.sumCollisions:
                    np.add.at(out, (ridx, hashes % dim), vals)
                else:
                    out[ridx, hashes % dim] = vals
        return ds.with_column(self.outputCol, [row for row in out])


class FeatureInteractions(Transformer):
    """Quadratic/cubic crossing of hashed vector columns — VW's ``-q``/
    namespace interactions (reference: VowpalWabbitInteractions.scala:96).
    The cross of vectors a, b is the outer product flattened and re-hashed
    into ``numBits`` dims; on TPU the outer product is one einsum."""

    inputCols = ListParam(doc="vector columns to cross")
    outputCol = StringParam(doc="crossed vector output", default="interactions")
    numBits = IntParam(doc="log2 of output dimension", default=12)
    sumCollisions = BoolParam(doc="sum colliding values", default=True)

    def __init__(self, inputCols: Optional[Sequence[str]] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCols is not None:
            self.set("inputCols", list(inputCols))
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        cols = [np.stack([np.asarray(v, np.float32).ravel() for v in ds[c]])
                for c in self.inputCols]
        cross = cols[0]
        for other in cols[1:]:
            n = cross.shape[0]
            cross = np.einsum("ni,nj->nij", cross, other).reshape(n, -1)
        dim = 1 << self.numBits
        d_in = cross.shape[1]
        # deterministic index re-hash: position p -> murmur(p) % dim
        idx = np.array([murmurhash3_32(p.to_bytes(4, "little")) % dim
                        for p in range(d_in)], np.int64)
        out = np.zeros((cross.shape[0], dim), np.float32)
        if self.sumCollisions:
            np.add.at(out, (slice(None), idx), cross)
        else:
            # overwrite-on-collision: last position hashing to a slot wins
            out[:, idx] = cross
        return ds.with_column(self.outputCol, [row for row in out])


class VectorZipper(Transformer):
    """Combine one or more input columns into a sequence column
    (reference: vw/VectorZipper.scala:15-45 — used to assemble per-action
    columns into the action-features list for contextual bandits)."""

    inputCols = ListParam(doc="columns to zip")
    outputCol = StringParam(doc="sequence output column", default="zipped")

    def _transform(self, ds: Dataset) -> Dataset:
        cols = [ds[c] for c in self.inputCols]
        out = np.empty(ds.num_rows, object)
        for i in range(ds.num_rows):
            out[i] = [c[i] for c in cols]
        return ds.with_column(self.outputCol, out)
