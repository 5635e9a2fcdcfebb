"""Complement-set sampling (reference: cyber/anomaly/
complement_access.py ComplementAccessTransformer — sample index tuples
from the cartesian range that do NOT appear in the input; used as
negative examples for explicit-feedback CF)."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..core.dataset import Dataset
from ..core.params import IntParam, ListParam, StringParam
from ..core.pipeline import Transformer


class ComplementAccessTransformer(Transformer):
    """Sample unseen index tuples per partition (reference:
    complement_access.py — factor × |rows| candidates drawn uniformly in
    each indexed column's [min, max], observed tuples removed)."""

    partitionKey = StringParam(doc="partition column (optional)")
    indexedColNamesArr = ListParam(doc="indexed columns to complement")
    complementsetFactor = IntParam(doc="≈ complement rows per input row",
                                   default=2)
    seed = IntParam(doc="sampling seed", default=0)

    def _transform(self, ds: Dataset) -> Dataset:
        cols: List[str] = list(self.indexedColNamesArr or [])
        factor = int(self.complementsetFactor)
        rng = np.random.default_rng(int(self.seed))
        pk = self.get("partitionKey")
        if pk:
            parts: Dict[Any, np.ndarray] = {}
            for i, k in enumerate(ds[pk]):
                parts.setdefault(k, []).append(i)
            groups = {k: np.asarray(v) for k, v in parts.items()}
        else:
            groups = {None: np.arange(ds.num_rows)}

        out_keys: List[Any] = []
        out_cols: Dict[str, List[int]] = {c: [] for c in cols}
        for key, idx in groups.items():
            observed = set(zip(*(ds[c][idx] for c in cols)))
            bounds = [(int(ds[c][idx].min()), int(ds[c][idx].max()))
                      for c in cols]
            n_draw = factor * len(idx)
            draws = np.stack([rng.integers(lo, hi + 1, size=n_draw)
                              for lo, hi in bounds], axis=1)
            seen_draw = set()
            for row in draws:
                tup = tuple(int(v) for v in row)
                if tup in observed or tup in seen_draw:
                    continue
                seen_draw.add(tup)
                out_keys.append(key)
                for c, v in zip(cols, tup):
                    out_cols[c].append(v)

        data: Dict[str, np.ndarray] = {}
        if pk:
            data[pk] = np.asarray(out_keys, dtype=object)
        for c in cols:
            data[c] = np.asarray(out_cols[c], dtype=np.int64)
        return Dataset(data)
