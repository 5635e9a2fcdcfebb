"""Columnar Dataset — a host-resident table of numpy columns.

A copy of the JAX package's ``core/dataset.py`` for the PyTorch port: a
:class:`Dataset` is a columnar table (dict of numpy arrays) carrying a
``num_partitions`` hint.  Numeric columns move to the device as dense
blocks when a stage needs them; object columns (strings, ragged lists)
stay host-side.  CSV ingest goes through the port's native parser
(:func:`~synapseml_tpu_torch.native.read_csv_matrix`), and the permissive
``from_rows``/``from_csv`` modes route invalid rows through the row
guard's skip/quarantine policy.
"""

from __future__ import annotations

import numpy as np
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union


def _dedupe_names(names: Sequence[str]) -> List[str]:
    """Rename duplicate column names ``x`` → ``x_1``, ``x_2``… (dict-keyed
    columns would silently drop duplicates); shared by both CSV paths so
    strict and permissive modes produce identical schemas."""
    uniq: List[str] = []
    for n in names:
        if n in uniq:
            base, k = n, 1
            while f"{base}_{k}" in uniq or f"{base}_{k}" in names:
                k += 1
            n = f"{base}_{k}"
        uniq.append(n)
    return uniq


def _as_column(values, n_rows: Optional[int] = None) -> np.ndarray:
    if isinstance(values, np.ndarray):
        arr = values
    else:
        values = list(values)
        if values and isinstance(values[0], (list, tuple, np.ndarray, dict, bytes)):
            arr = np.empty(len(values), dtype=object)
            for i, v in enumerate(values):
                arr[i] = v
        else:
            arr = np.asarray(values)
            if arr.dtype.kind in ("U", "S"):
                arr = arr.astype(object)
    if n_rows is not None and len(arr) != n_rows:
        raise ValueError(f"column length {len(arr)} != {n_rows}")
    return arr


class Dataset:
    """Immutable columnar table with partition metadata.

    ``row_index`` is optional SOURCE-row provenance: once attached (via
    :meth:`with_source_index`, typically by the row guard at a pipeline
    boundary), every row operation (``filter``, ``_mask_rows``, ``sort``,
    ``union``, batching, …) carries it along, so a row skipped or
    quarantined three stages deep still points at the row of the ORIGINAL
    input that produced it.  Untracked datasets pay nothing.
    """

    def __init__(self, columns: Dict[str, Any], num_partitions: int = 1,
                 row_index: Optional[np.ndarray] = None):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        n = None
        cols: Dict[str, np.ndarray] = {}
        for name, vals in columns.items():
            arr = _as_column(vals, n)
            if n is None:
                n = len(arr)
            cols[name] = arr
        self._cols = cols
        self._n = int(n)
        self.num_partitions = max(1, min(int(num_partitions), self._n or 1))
        if row_index is not None:
            row_index = np.asarray(row_index, dtype=np.int64)
            if len(row_index) != self._n:
                raise ValueError(
                    f"row_index length {len(row_index)} != {self._n} rows")
        self._row_index = row_index

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_dict(d: Dict[str, Any], num_partitions: int = 1) -> "Dataset":
        return Dataset(d, num_partitions)

    @staticmethod
    def from_rows(rows: Sequence[Dict[str, Any]], num_partitions: int = 1,
                  handle_invalid: str = "error",
                  quarantine: Any = None) -> "Dataset":
        """Build from a list of row dicts.

        ``handle_invalid="error"`` (default) keeps the strict behavior: a
        row missing a key raises.  ``"skip"`` drops ragged rows (non-dict
        rows and rows MISSING one of the schema's keys; extra keys are
        ignored, exactly as the strict path ignores them);
        ``"quarantine"`` additionally writes them — with their row
        numbers — to the dead-letter store (``quarantine``: a
        Quarantine, a directory, or None for the default dir)."""
        if not rows:
            raise ValueError("no rows")
        if handle_invalid == "error":
            keys = list(rows[0].keys())
            return Dataset({k: [r[k] for r in rows] for k in keys},
                           num_partitions)
        # permissive: the schema comes from the FIRST DICT row — a
        # non-dict row 0 is exactly the input this mode must tolerate
        first = next((r for r in rows if isinstance(r, dict)), None)
        if first is None:
            raise ValueError(f"no dict rows among {len(rows)} inputs")
        keys = list(first.keys())
        keyset = set(keys)
        good: List[Dict[str, Any]] = []
        good_idx: List[int] = []
        bad: List[Tuple[int, Any, str]] = []
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                bad.append((i, r, f"row {i} is {type(r).__name__}, "
                            "not a dict"))
            elif not keyset.issubset(r.keys()):
                # extra keys are fine (the strict path ignores them too);
                # only MISSING schema keys make a row ragged
                bad.append((i, r, f"ragged row {i}: missing keys "
                            f"{sorted(map(str, keyset - set(r.keys())))}"))
            else:
                good.append(r)
                good_idx.append(i)
        Dataset._report_ingest_invalid(
            "Dataset.from_rows", handle_invalid, quarantine,
            [(i, repr(r), msg) for i, r, msg in bad])
        if not good:
            raise ValueError(
                f"no valid rows: all {len(rows)} rows were ragged "
                f"(first: {bad[0][2]})")
        return Dataset({k: [r[k] for r in good] for k in keys},
                       num_partitions,
                       row_index=np.asarray(good_idx, dtype=np.int64))

    @staticmethod
    def from_pandas(df, num_partitions: int = 1) -> "Dataset":
        return Dataset({c: df[c].to_numpy() for c in df.columns}, num_partitions)

    @staticmethod
    def _report_ingest_invalid(source: str, handle_invalid: str,
                               quarantine: Any,
                               bad: Sequence[Tuple[int, str, str]]) -> None:
        """Route ingest-time invalid rows/lines (``(index, raw, reason)``)
        through the skip/quarantine policy + telemetry."""
        if handle_invalid not in ("skip", "quarantine"):
            raise ValueError(
                f"handle_invalid must be 'error', 'skip' or 'quarantine', "
                f"got {handle_invalid!r}")
        if not bad:
            return
        from ..resilience.rowguard import ErrorRecord, Quarantine
        from ..telemetry import get_registry
        from .logging import logger
        records = [ErrorRecord(stage_uid=source, stage_class=source,
                               row_index=int(i), error_class="ParseError",
                               error_message=msg, verb="ingest")
                   for i, _, msg in bad]
        get_registry().counter(
            "rowguard_rows_total", "rows screened out by the guard",
            ("stage", "outcome")).inc(len(bad), stage=source,
                                      outcome=handle_invalid)
        if handle_invalid == "quarantine":
            store = (quarantine if isinstance(quarantine, Quarantine)
                     else Quarantine(quarantine))
            rows = Dataset(
                {"raw": [raw for _, raw, _ in bad]},
                row_index=np.asarray([i for i, _, _ in bad],
                                     dtype=np.int64))
            store.add(source, rows, records, stage_class=source)
        logger.warning("%s: %s %d invalid row(s) (first: %s)",
                       source, handle_invalid, len(bad), bad[0][2])

    @staticmethod
    def from_csv(path: str, delim: str = ",",
                 num_partitions: int = 1, handle_invalid: str = "error",
                 quarantine: Any = None) -> "Dataset":
        """Numeric CSV via the native C++ parser (multithreaded mmap parse;
        see synapseml_tpu_torch/native/loader.cpp), numpy fallback.

        ``handle_invalid="skip"``/``"quarantine"`` switches to a
        permissive line-validating parse: ragged lines (wrong field
        count) and unparseable fields are dropped or dead-lettered with
        their file line numbers instead of crashing the native parser,
        and columns that parse to all-NaN are reported (they usually mean
        a text column fed to a numeric reader)."""
        if handle_invalid != "error":
            return Dataset._from_csv_permissive(
                path, delim, num_partitions, handle_invalid, quarantine)
        from ..native import read_csv_matrix
        mat, names = read_csv_matrix(path, delim)
        return Dataset({n: mat[:, i].copy()
                        for i, n in enumerate(_dedupe_names(names))},
                       num_partitions)

    @staticmethod
    def _from_csv_permissive(path: str, delim: str, num_partitions: int,
                             handle_invalid: str,
                             quarantine: Any) -> "Dataset":
        from ..native import _read_header
        has_header, names = _read_header(path, delim)
        names = _dedupe_names(names)
        good: List[List[float]] = []
        good_idx: List[int] = []
        bad: List[Tuple[int, str, str]] = []
        ncols = len(names)
        with open(path, "r", errors="replace") as f:
            if has_header:
                f.readline()
            data_row = 0
            for lineno, line in enumerate(f, start=2 if has_header else 1):
                raw = line.rstrip("\r\n")
                if not raw.strip():
                    continue
                fields = raw.split(delim)
                if len(fields) != ncols:
                    bad.append((data_row, raw,
                                f"line {lineno}: {len(fields)} fields, "
                                f"expected {ncols}"))
                    data_row += 1
                    continue
                try:
                    # empty fields are missing values (genfromtxt parity)
                    vals = [float(x) if x.strip() else float("nan")
                            for x in fields]
                except ValueError as e:
                    bad.append((data_row, raw, f"line {lineno}: {e}"))
                    data_row += 1
                    continue
                good.append(vals)
                good_idx.append(data_row)
                data_row += 1
        Dataset._report_ingest_invalid("Dataset.from_csv", handle_invalid,
                                       quarantine, bad)
        if not good:
            raise ValueError(f"{path}: no parseable data lines "
                             f"({len(bad)} invalid)")
        mat = np.asarray(good, dtype=np.float32)
        all_nan = [names[j] for j in range(ncols)
                   if bool(np.all(np.isnan(mat[:, j])))]
        if all_nan:
            from ..telemetry import get_registry
            from .logging import logger
            for c in all_nan:
                get_registry().counter(
                    "dataset_all_nan_columns_total",
                    "columns that parsed to all-NaN on CSV ingest",
                    ("column",)).inc(1, column=c)
            logger.warning("%s: columns %s parsed to all-NaN — likely "
                           "non-numeric data in a numeric reader",
                           path, all_nan)
        return Dataset({n: mat[:, j].copy() for j, n in enumerate(names)},
                       num_partitions,
                       row_index=np.asarray(good_idx, dtype=np.int64))

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({k: list(v) if v.dtype == object else v
                             for k, v in self._cols.items()})

    # -- source-row provenance --------------------------------------------
    @property
    def source_index(self) -> np.ndarray:
        """Source-row index per row: the tracked provenance when attached,
        else each row's own position (identity)."""
        if self._row_index is not None:
            return self._row_index
        return np.arange(self._n, dtype=np.int64)

    @property
    def has_source_index(self) -> bool:
        return self._row_index is not None

    def with_source_index(self, index: Optional[Any] = None) -> "Dataset":
        """Attach source-row provenance (identity when ``index`` is None);
        a no-op when already tracked and no explicit index is given."""
        if index is None:
            if self._row_index is not None:
                return self
            index = np.arange(self._n, dtype=np.int64)
        return Dataset(self._cols, self.num_partitions, row_index=index)

    # -- basic introspection ----------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._cols.keys())

    @property
    def num_rows(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def __contains__(self, col: str) -> bool:
        return col in self._cols

    def __getitem__(self, col: str) -> np.ndarray:
        return self._cols[col]

    def column(self, col: str) -> np.ndarray:
        return self._cols[col]

    def schema(self) -> Dict[str, str]:
        return {k: str(v.dtype) for k, v in self._cols.items()}

    def dtypes(self) -> Dict[str, np.dtype]:
        return {k: v.dtype for k, v in self._cols.items()}

    # -- projections -------------------------------------------------------
    def select(self, *cols: str) -> "Dataset":
        missing = [c for c in cols if c not in self._cols]
        if missing:
            raise KeyError(f"columns not found: {missing}; have {self.columns}")
        return Dataset({c: self._cols[c] for c in cols}, self.num_partitions,
                       row_index=self._row_index)

    def drop(self, *cols: str) -> "Dataset":
        keep = {k: v for k, v in self._cols.items() if k not in cols}
        return Dataset(keep, self.num_partitions, row_index=self._row_index)

    def with_column(self, name: str, values) -> "Dataset":
        cols = dict(self._cols)
        cols[name] = _as_column(values, self._n)
        return Dataset(cols, self.num_partitions, row_index=self._row_index)

    def with_columns(self, new: Dict[str, Any]) -> "Dataset":
        cols = dict(self._cols)
        for name, values in new.items():
            cols[name] = _as_column(values, self._n)
        return Dataset(cols, self.num_partitions, row_index=self._row_index)

    def rename(self, old: str, new: str) -> "Dataset":
        cols = {}
        for k, v in self._cols.items():
            cols[new if k == old else k] = v
        return Dataset(cols, self.num_partitions, row_index=self._row_index)

    # -- row ops -----------------------------------------------------------
    def take(self, n: int) -> "Dataset":
        return self._mask_rows(slice(0, n))

    def head(self, n: int = 5) -> List[Dict[str, Any]]:
        return self.take(min(n, self._n)).collect()

    def first(self) -> Dict[str, Any]:
        return {k: v[0] for k, v in self._cols.items()}

    def collect(self) -> List[Dict[str, Any]]:
        keys = self.columns
        return [{k: self._cols[k][i] for k in keys} for i in range(self._n)]

    def _mask_rows(self, idx) -> "Dataset":
        ri = self._row_index[idx] if self._row_index is not None else None
        return Dataset({k: v[idx] for k, v in self._cols.items()},
                       self.num_partitions, row_index=ri)

    def filter(self, pred: Union[np.ndarray, Callable[[Dict[str, Any]], bool]]) -> "Dataset":
        if callable(pred):
            mask = np.fromiter((bool(pred(r)) for r in self.iter_rows()),
                               dtype=bool, count=self._n)
        else:
            mask = np.asarray(pred, dtype=bool)
        return self._mask_rows(mask)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        keys = self.columns
        for i in range(self._n):
            yield {k: self._cols[k][i] for k in keys}

    def sort(self, col: str, ascending: bool = True) -> "Dataset":
        order = np.argsort(self._cols[col], kind="stable")
        if not ascending:
            order = order[::-1]
        return self._mask_rows(order)

    def union(self, other: "Dataset") -> "Dataset":
        if set(self.columns) != set(other.columns):
            raise ValueError("union requires identical column sets")
        cols = {}
        for k in self.columns:
            a, b = self._cols[k], other._cols[k]
            if a.dtype == object or b.dtype == object:
                out = np.empty(len(a) + len(b), dtype=object)
                out[:len(a)] = a
                out[len(a):] = b
                cols[k] = out
            else:
                cols[k] = np.concatenate([a, b])
        # provenance survives only when BOTH sides track it (mixing a
        # tracked side with implicit positions would fabricate indices)
        ri = None
        if self._row_index is not None and other._row_index is not None:
            ri = np.concatenate([self._row_index, other._row_index])
        return Dataset(cols, self.num_partitions, row_index=ri)

    def sample(self, fraction: float, seed: int = 0) -> "Dataset":
        rng = np.random.default_rng(seed)
        mask = rng.random(self._n) < fraction
        return self._mask_rows(mask)

    def random_split(self, weights: Sequence[float], seed: int = 0) -> List["Dataset"]:
        rng = np.random.default_rng(seed)
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        assignment = rng.choice(len(w), size=self._n, p=w)
        return [self._mask_rows(assignment == i) for i in range(len(w))]

    def shuffle(self, seed: int = 0) -> "Dataset":
        rng = np.random.default_rng(seed)
        return self._mask_rows(rng.permutation(self._n))

    def group_by_agg(self, key: str, aggs: Dict[str, Tuple[str, str]]) -> "Dataset":
        """Tiny groupBy: aggs maps out_col -> (in_col, fn) with fn in
        {sum, mean, count, min, max}."""
        keys = self._cols[key]
        uniq, inv = np.unique(keys, return_inverse=True)
        out: Dict[str, Any] = {key: uniq}
        for out_col, (in_col, fn) in aggs.items():
            counts = np.bincount(inv, minlength=len(uniq))
            if fn == "count":
                out[out_col] = counts
                continue
            vals = self._cols[in_col].astype(np.float64)
            sums = np.bincount(inv, weights=vals, minlength=len(uniq))
            if fn == "sum":
                out[out_col] = sums
            elif fn == "mean":
                out[out_col] = sums / np.maximum(counts, 1)
            elif fn in ("min", "max"):
                red = np.full(len(uniq), np.inf if fn == "min" else -np.inf)
                op = np.minimum if fn == "min" else np.maximum
                op.at(red, inv, vals)
                out[out_col] = red
            else:
                raise ValueError(f"unknown agg {fn}")
        return Dataset(out, self.num_partitions)

    # -- partitioning (the Spark-partition analogue) -----------------------
    def repartition(self, n: int) -> "Dataset":
        return Dataset(self._cols, num_partitions=n,
                       row_index=self._row_index)

    def coalesce(self, n: int) -> "Dataset":
        return self.repartition(min(n, self.num_partitions))

    def partition_bounds(self) -> List[Tuple[int, int]]:
        """Deterministic contiguous row ranges, one per partition."""
        n, p = self._n, self.num_partitions
        base, rem = divmod(n, p)
        bounds, start = [], 0
        for i in range(p):
            size = base + (1 if i < rem else 0)
            bounds.append((start, start + size))
            start += size
        return bounds

    def partitions(self) -> List["Dataset"]:
        return [self._mask_rows(slice(a, b)) for a, b in self.partition_bounds()]

    def iter_batches(self, batch_size: int) -> Iterator["Dataset"]:
        for start in range(0, self._n, batch_size):
            yield self._mask_rows(slice(start, start + batch_size))

    # -- device materialization -------------------------------------------
    def to_numpy(self, cols: Sequence[str], dtype=np.float32) -> np.ndarray:
        """Stack numeric columns (or a single vector column) to a dense
        (rows, features) matrix — FastVectorAssembler analogue
        (reference: org/apache/spark/ml/feature/FastVectorAssembler.scala)."""
        if len(cols) == 1 and self._cols[cols[0]].dtype == object:
            col = self._cols[cols[0]]
            return np.stack([np.asarray(v, dtype=dtype) for v in col])
        return np.column_stack([self._cols[c].astype(dtype) for c in cols])

    def __repr__(self):
        return (f"Dataset({self._n} rows x {len(self._cols)} cols, "
                f"{self.num_partitions} partitions: {self.schema()})")


def find_unused_column_name(base: str, ds: Dataset) -> str:
    """reference: core/schema/DatasetExtensions.findUnusedColumnName."""
    if base not in ds:
        return base
    i = 1
    while f"{base}_{i}" in ds:
        i += 1
    return f"{base}_{i}"
