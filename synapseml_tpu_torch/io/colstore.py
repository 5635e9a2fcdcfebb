"""Chunked, bounded-memory columnar sources over SMLC/SMLS stores.

The PyTorch port's copy of the JAX package's ``io/colstore.py`` (numpy
only): :class:`ChunkedColumnSource` memory-maps an SMLC column store and
reads it in row chunks, :class:`SparseChunkedSource` does the same over
an SMLS CSR store and densifies only its own chunk, so host memory stays
O(chunk) while a consumer (``models.gbdt.booster.train``) assembles its
state on the device.  :func:`write_matrix` writes the v1 f32 format with
its own numpy writer (the same bytes as the JAX package's native writer)
or the v2 bf16 format, :func:`read_matrix` reads a store back whole,
:func:`csv_to_colstore` converts a CSV through the native parser, and
:func:`write_csr` writes SMLS stores.
``shard(i, n)`` restricts a source to host ``i``'s contiguous row range.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_HEADER_BYTES = 4 + 4 + 8 + 8       # magic, version, rows, cols

#: SMLC payload dtype by header version: v1 is the native loader's f32;
#: v2 stores bf16 (uint16 bit pattern) — half the ingest traffic of the
#: GBDT streaming path for one bf16 rounding of the feature values
#: (binning is quantile-based, so split quality is AUC-pinned, not
#: bit-pinned; see docs/api/perf.md "GBDT fused bf16 ingest")
_VERSION_F32 = 1
_VERSION_BF16 = 2


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit patterns (uint16), round-to-nearest-even —
    the same rounding as ``torch.bfloat16`` casts, implemented on
    the raw bits so the storage layer needs no ml_dtypes import."""
    bits = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    # RNE: add 0x7FFF + lsb-of-kept-half, then truncate
    rounded = bits + 0x7FFF + ((bits >> 16) & 1)
    out = (rounded >> 16).astype(np.uint16)
    # NaN must stay NaN (the rounding above can carry into the exponent
    # and turn a NaN payload into inf): force the quiet-NaN pattern
    nan = np.isnan(arr)
    if nan.any():
        out[nan] = np.uint16(0x7FC0)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) → exact float32 values."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16) \
        .view(np.float32)


def _balanced_range(lo: int, hi: int, index: int,
                    count: int) -> Tuple[int, int]:
    """Host ``index``'s contiguous slice of [lo, hi) under the balanced
    placement rule (first ``n % count`` shards carry one extra row —
    ClusterUtil.getNumRowsPerPartition): ONE definition shared by the
    dense and sparse sources so nested sharding stays consistent."""
    if not 0 <= index < count:
        raise ValueError(f"shard index {index} outside [0, {count})")
    base, extra = divmod(hi - lo, count)
    s = lo + index * base + min(index, extra)
    return s, s + base + (1 if index < extra else 0)


def _open_colstore(path: str) -> Tuple[np.memmap, int, int, bool]:
    with open(path, "rb") as f:
        if f.read(4) != b"SMLC":
            raise IOError(f"{path}: not an SMLC column store")
        version = int(np.frombuffer(f.read(4), np.uint32)[0])
        rows = int(np.frombuffer(f.read(8), np.int64)[0])
        cols = int(np.frombuffer(f.read(8), np.int64)[0])
    if version not in (_VERSION_F32, _VERSION_BF16):
        raise IOError(f"{path}: unknown SMLC version {version}")
    bf16 = version == _VERSION_BF16
    mm = np.memmap(path, np.uint16 if bf16 else np.float32, mode="r",
                   offset=_HEADER_BYTES, shape=(cols, rows))
    return mm, rows, cols, bf16


class ChunkedColumnSource:
    """Row-chunk iteration over an SMLC file with optional label/weight
    columns split out of the feature matrix.

    ``feature_cols``/``label_col``/``weight_col`` are column indices into
    the stored matrix; by default every column is a feature.  The memmap
    is the only handle on the data — a chunk read touches each feature
    column's contiguous slice, so resident memory is O(chunk_rows · F).
    """

    def __init__(self, path: str,
                 feature_cols: Optional[Sequence[int]] = None,
                 label_col: Optional[int] = None,
                 weight_col: Optional[int] = None,
                 chunk_rows: int = 65_536,
                 row_range: Optional[Tuple[int, int]] = None):
        self.path = path
        self._mm, total_rows, total_cols, self._bf16 = _open_colstore(path)
        if feature_cols is None:
            excluded = {c for c in (label_col, weight_col) if c is not None}
            feature_cols = [c for c in range(total_cols) if c not in excluded]
        self.feature_cols = list(feature_cols)
        self.label_col = label_col
        self.weight_col = weight_col
        self.chunk_rows = int(chunk_rows)
        lo, hi = row_range if row_range is not None else (0, total_rows)
        if not 0 <= lo <= hi <= total_rows:
            raise ValueError(f"row_range {row_range} outside [0, {total_rows}]")
        self._lo, self._hi = lo, hi

    # -- shape -------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._hi - self._lo

    @property
    def num_features(self) -> int:
        return len(self.feature_cols)

    # -- placement (partition→host map analogue) ---------------------------
    def shard(self, index: int, count: int) -> "ChunkedColumnSource":
        """Host ``index``'s contiguous row range out of ``count`` hosts
        (deterministic balanced split: first ``rows % count`` shards carry
        one extra row — the same rule every host computes locally, no
        rendezvous required)."""
        lo, hi = _balanced_range(self._lo, self._hi, index, count)
        return ChunkedColumnSource(
            self.path, self.feature_cols, self.label_col, self.weight_col,
            self.chunk_rows, row_range=(lo, hi))

    # -- reads -------------------------------------------------------------
    def _col_slice(self, c: int, lo: int, hi: int) -> np.ndarray:
        """One column's [lo, hi) slice as f32 (exact bf16 upcast on v2
        stores — NEVER ``astype`` the raw uint16 bit patterns)."""
        raw = self._mm[c, lo:hi]
        return bf16_bits_to_f32(raw) if self._bf16 \
            else np.asarray(raw, np.float32)

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        out = np.empty((hi - lo, len(self.feature_cols)), np.float32)
        for j, c in enumerate(self.feature_cols):
            out[:, j] = self._col_slice(c, lo, hi)
        return out

    def _read_chunk(self, lo: int, hi: int) -> Tuple[np.ndarray,
                                                     Optional[np.ndarray],
                                                     Optional[np.ndarray]]:
        y = (self._col_slice(self.label_col, lo, hi)
             if self.label_col is not None else None)
        w = (self._col_slice(self.weight_col, lo, hi)
             if self.weight_col is not None else None)
        return self._rows(lo, hi), y, w

    def iter_chunks(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray],
                                            Optional[np.ndarray]]]:
        """Yield (X_chunk, y_chunk | None, w_chunk | None) row chunks."""
        for lo in range(self._lo, self._hi, self.chunk_rows):
            yield self._read_chunk(lo, min(lo + self.chunk_rows, self._hi))

    def read_labels(self) -> Optional[np.ndarray]:
        if self.label_col is None:
            return None
        return self._col_slice(self.label_col, self._lo, self._hi)

    def read_weights(self) -> Optional[np.ndarray]:
        if self.weight_col is None:
            return None
        return self._col_slice(self.weight_col, self._lo, self._hi)

    def sample_rows(self, k: int, seed: int = 0) -> np.ndarray:
        """Uniform row sample (same draw as fit_bin_mapper's in-memory
        sampling, so streamed and in-memory training bin identically)."""
        n = self.num_rows
        if n <= k:
            return self._rows(self._lo, self._hi)
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(n, k, replace=False)) + self._lo
        out = np.empty((k, len(self.feature_cols)), np.float32)
        for j, c in enumerate(self.feature_cols):
            raw = self._mm[c][idx]
            out[:, j] = bf16_bits_to_f32(raw) if self._bf16 \
                else raw
        return out

    def iter_batches(self, batch_size: int,
                     rng: Optional[np.random.Generator] = None,
                     ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray],
                                         Optional[np.ndarray]]]:
        """Fixed-size minibatches for DL training loops.  With ``rng``,
        chunk ORDER and intra-chunk rows are shuffled (bounded-memory
        approximate shuffle: exact within a chunk, chunk-granular across
        the file — the streaming-shuffle tradeoff every out-of-core loader
        makes); the tail partial batch is dropped.
        """
        starts = list(range(self._lo, self._hi, self.chunk_rows))
        if rng is not None:
            rng.shuffle(starts)
        leftovers: Optional[Tuple[np.ndarray, ...]] = None
        for lo in starts:
            X, y, w = self._read_chunk(lo, min(lo + self.chunk_rows,
                                               self._hi))
            if rng is not None:
                perm = rng.permutation(len(X))
                X = X[perm]
                y = y[perm] if y is not None else None
                w = w[perm] if w is not None else None
            if leftovers is not None:
                X = np.concatenate([leftovers[0], X])
                y = (np.concatenate([leftovers[1], y])
                     if y is not None else None)
                w = (np.concatenate([leftovers[2], w])
                     if w is not None else None)
            full = (len(X) // batch_size) * batch_size
            for s in range(0, full, batch_size):
                yield (X[s:s + batch_size],
                       y[s:s + batch_size] if y is not None else None,
                       w[s:s + batch_size] if w is not None else None)
            leftovers = (X[full:], y[full:] if y is not None else None,
                         w[full:] if w is not None else None)


def write_matrix(path: str, matrix: np.ndarray,
                 dtype: str = "f32") -> None:
    """Write a matrix as an SMLC column store.

    ``dtype="f32"`` is the native loader's v1 format; ``dtype="bf16"``
    writes the v2 bf16 colstore — half the bytes on disk AND half the
    ingest traffic of every later streamed read (the GBDT histogram
    byte-diet's storage half: values round once to bf16, reads upcast
    exactly to f32, bin boundaries move by at most one rounding ulp)."""
    if dtype == "f32":
        _write_f32(path, np.asarray(matrix, np.float32))
        return
    if dtype != "bf16":
        raise ValueError(f"dtype={dtype!r}: expected 'f32' or 'bf16'")
    matrix = np.ascontiguousarray(matrix, np.float32)
    rows, cols = matrix.shape
    with open(path, "wb") as f:
        f.write(b"SMLC")
        f.write(np.uint32(_VERSION_BF16).tobytes())
        f.write(np.int64(rows).tobytes())
        f.write(np.int64(cols).tobytes())
        # column-major like the native writer: one column = one
        # contiguous run, which is what chunk reads slice
        f.write(np.ascontiguousarray(
            f32_to_bf16_bits(matrix).T).tobytes())


def _write_f32(path: str, matrix: np.ndarray) -> None:
    """The v1 f32 store: header, then the matrix column-major (one
    column = one contiguous run, which is what chunk reads slice)."""
    m = np.ascontiguousarray(matrix.T)
    with open(path, "wb") as f:
        f.write(b"SMLC")
        f.write(np.uint32(_VERSION_F32).tobytes())
        f.write(np.int64(matrix.shape[0]).tobytes())
        f.write(np.int64(matrix.shape[1]).tobytes())
        m.tofile(f)


def read_matrix(path: str) -> np.ndarray:
    """The whole SMLC store as a (rows, cols) float32 matrix (v2 bf16
    stores upcast exactly) — the reader of :func:`write_matrix`'s files
    and of the JAX package's native writer's."""
    mm, _, _, bf16 = _open_colstore(path)
    data = bf16_bits_to_f32(mm) if bf16 else np.array(mm, np.float32)
    return data.T


def csv_to_colstore(csv_path: str, out_path: str,
                    delim: str = ",") -> Tuple[int, list]:
    """Parse a CSV with the native multithreaded loader and persist it as
    an SMLC column store; returns (rows, column_names)."""
    from ..native import read_csv_matrix
    mat, names = read_csv_matrix(csv_path, delim)
    _write_f32(out_path, mat)
    return mat.shape[0], names


# --------------------------------------------------------------------------
# sparse (CSR) out-of-core source
# --------------------------------------------------------------------------

_SPARSE_HEADER = 4 + 4 + 8 + 8 + 8 + 1 + 1   # magic, ver, rows, cols, nnz,
                                             # has_label, has_weight


def write_csr(path: str, indptr: np.ndarray, indices: np.ndarray,
              data: np.ndarray, num_cols: int,
              labels: Optional[np.ndarray] = None,
              weights: Optional[np.ndarray] = None) -> None:
    """Write a CSR matrix as an SMLS sparse store.

    Layout: header | indptr int64 (rows+1) | indices int32 (nnz) |
    data f32 (nnz) | labels f32 (rows)? | weights f32 (rows)?.  Row-major
    CSR keeps any row RANGE contiguous in indices/data, which is what
    makes ``shard``/chunk reads O(chunk nnz).
    """
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int32)
    data = np.asarray(data, np.float32)
    rows = len(indptr) - 1
    if rows < 0:
        raise ValueError("indptr must have at least one entry")
    if len(indices) != len(data) or int(indptr[-1]) != len(data):
        raise ValueError(
            f"inconsistent CSR: len(indices)={len(indices)}, "
            f"len(data)={len(data)}, indptr[-1]={int(indptr[-1])}")
    if int(indptr[0]) != 0 or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr must start at 0 and be non-decreasing")
    if len(indices) and (indices.min() < 0 or indices.max() >= num_cols):
        raise ValueError("column index out of range")
    for name, arr in (("labels", labels), ("weights", weights)):
        if arr is not None and len(arr) != rows:
            raise ValueError(f"{name} has {len(arr)} entries for "
                             f"{rows} rows")
    with open(path, "wb") as f:
        f.write(b"SMLS")
        f.write(np.uint32(1).tobytes())
        f.write(np.int64(rows).tobytes())
        f.write(np.int64(num_cols).tobytes())
        f.write(np.int64(len(data)).tobytes())
        f.write(np.uint8(0 if labels is None else 1).tobytes())
        f.write(np.uint8(0 if weights is None else 1).tobytes())
        f.write(indptr.tobytes())
        f.write(indices.tobytes())
        f.write(data.tobytes())
        if labels is not None:
            f.write(np.asarray(labels, np.float32).tobytes())
        if weights is not None:
            f.write(np.asarray(weights, np.float32).tobytes())


class SparseChunkedSource:
    """CSR micro-batch source with the same protocol as
    :class:`ChunkedColumnSource` (``num_rows``/``num_features``/
    ``iter_chunks``/``sample_rows``/``read_labels``/``read_weights``/
    ``shard``), so GBDT streaming train consumes it unchanged.

    The reference streams sparse micro-batches into the shared native
    dataset (reference: StreamingPartitionTask.scala:264
    ``pushMicroBatches`` sparse path over LGBM_DatasetPushRowsByCSR...).
    Here each chunk densifies ONLY its own rows (O(chunk_rows · F) host,
    memset + nnz scatter) before binning and EFB bundling — the FULL
    matrix never exists densely on the host, which is the point for
    one-hot matrices whose dense form is hundreds of times their nnz.
    """

    def __init__(self, path: str, chunk_rows: int = 65_536,
                 _range: Optional[Tuple[int, int]] = None):
        self.path = path
        self.chunk_rows = int(chunk_rows)
        with open(path, "rb") as f:
            if f.read(4) != b"SMLS":
                raise IOError(f"{path}: not an SMLS sparse store")
            np.frombuffer(f.read(4), np.uint32)
            self._rows_total = int(np.frombuffer(f.read(8), np.int64)[0])
            self._cols = int(np.frombuffer(f.read(8), np.int64)[0])
            self._nnz = int(np.frombuffer(f.read(8), np.int64)[0])
            self._has_label = bool(np.frombuffer(f.read(1), np.uint8)[0])
            self._has_weight = bool(np.frombuffer(f.read(1), np.uint8)[0])
        off = _SPARSE_HEADER
        self._indptr = np.memmap(path, np.int64, "r", offset=off,
                                 shape=(self._rows_total + 1,))
        off += (self._rows_total + 1) * 8
        self._indices = np.memmap(path, np.int32, "r", offset=off,
                                  shape=(self._nnz,))
        off += self._nnz * 4
        self._data = np.memmap(path, np.float32, "r", offset=off,
                               shape=(self._nnz,))
        off += self._nnz * 4
        self._labels = None
        if self._has_label:
            self._labels = np.memmap(path, np.float32, "r", offset=off,
                                     shape=(self._rows_total,))
            off += self._rows_total * 4
        self._weights = None
        if self._has_weight:
            self._weights = np.memmap(path, np.float32, "r", offset=off,
                                      shape=(self._rows_total,))
        self._lo, self._hi = _range or (0, self._rows_total)

    @property
    def num_rows(self) -> int:
        return self._hi - self._lo

    @property
    def num_features(self) -> int:
        return self._cols

    def shard(self, index: int, count: int) -> "SparseChunkedSource":
        """Contiguous row-range restriction for host ``index`` of
        ``count`` — nests: sharding a shard subdivides ITS range."""
        lo, hi = _balanced_range(self._lo, self._hi, index, count)
        return SparseChunkedSource(self.path, self.chunk_rows,
                                   _range=(lo, hi))

    def _dense_rows(self, row_idx: np.ndarray) -> np.ndarray:
        """Densify an arbitrary row set: memset + one scatter of its nnz."""
        out = np.zeros((len(row_idx), self._cols), np.float32)
        starts = self._indptr[row_idx]
        ends = self._indptr[row_idx + 1]
        for i, (s, e) in enumerate(zip(starts, ends)):
            out[i, self._indices[s:e]] = self._data[s:e]
        return out

    def _dense_range(self, lo: int, hi: int) -> np.ndarray:
        """Densify a contiguous row range with ONE vectorized scatter over
        the range's nnz slice (no per-row python loop)."""
        out = np.zeros((hi - lo, self._cols), np.float32)
        s, e = int(self._indptr[lo]), int(self._indptr[hi])
        if e > s:
            counts = np.diff(self._indptr[lo:hi + 1]).astype(np.int64)
            rows = np.repeat(np.arange(hi - lo), counts)
            out[rows, self._indices[s:e]] = self._data[s:e]
        return out

    def iter_chunks(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray],
                                            Optional[np.ndarray]]]:
        for lo in range(self._lo, self._hi, self.chunk_rows):
            hi = min(lo + self.chunk_rows, self._hi)
            y = (np.asarray(self._labels[lo:hi], np.float32)
                 if self._labels is not None else None)
            w = (np.asarray(self._weights[lo:hi], np.float32)
                 if self._weights is not None else None)
            yield self._dense_range(lo, hi), y, w

    def read_labels(self) -> Optional[np.ndarray]:
        if self._labels is None:
            return None
        return np.asarray(self._labels[self._lo:self._hi], np.float32)

    def read_weights(self) -> Optional[np.ndarray]:
        if self._weights is None:
            return None
        return np.asarray(self._weights[self._lo:self._hi], np.float32)

    def sample_rows(self, k: int, seed: int = 0) -> np.ndarray:
        n = self.num_rows
        if n <= k:
            return self._dense_range(self._lo, self._hi)
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(n, k, replace=False)) + self._lo
        return self._dense_rows(idx)


def dense_to_csr(matrix: np.ndarray):
    """(indptr, indices, data) of a dense matrix — test/convert helper."""
    matrix = np.asarray(matrix, np.float32)
    mask = matrix != 0.0
    counts = mask.sum(axis=1)
    indptr = np.zeros(len(matrix) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    rows, cols = np.nonzero(mask)
    return indptr, cols.astype(np.int32), matrix[rows, cols]
