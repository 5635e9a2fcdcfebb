"""The port's host C++: the online learners' text path and the CSV parser.

- ``textproc.cpp`` (a copy of the JAX package's): batch MurmurHash3 and
  the VW-format parser.  A failed build raises: nothing falls back to
  Python here.  The pure-Python hasher
  (:func:`~synapseml_tpu_torch.core.hashing.murmurhash3_32`) and parser
  (:func:`~synapseml_tpu_torch.models.online.generic.parse_vw_line`) stay
  as the plain versions the tests hold this path against.
- ``loader.cpp`` (the CSV part of the JAX package's): the multithreaded
  mmap CSV parser behind :func:`read_csv_matrix`.  As in the JAX package,
  a missing toolchain or a parse the C++ refuses falls back to
  ``numpy.genfromtxt``, which gives the same matrix; :data:`CSV_PARSES`
  counts which of the two parsed each file, so a broken build shows.

Each library builds with ``g++ -O3`` at first use into ``build/native/``
at the root of the checkout (listed in ``.gitignore``), under a name that
carries a hash of the source and flags, and binds over ``ctypes``.
Host code, not device kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "textproc.cpp"
_LOADER_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()


def _build(src: Path = _SRC, stem: str = "smltext") -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    out = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = ["g++", *_FLAGS, str(src), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {src.name} failed: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"building {src.name} failed (g++ exited "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    with _LOCK:
        lib = ctypes.CDLL(str(_build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sml_murmur3_batch.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int64,
                                      ctypes.c_uint32, u32p, ctypes.c_int]
    lib.sml_vw_count.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int64,
                                 ctypes.c_uint32, i64p, ctypes.c_int]
    lib.sml_vw_parse.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int64,
                                 ctypes.c_uint32, ctypes.c_int, i64p, i32p,
                                 i32p, f32p, f32p, f32p, u8p, ctypes.c_int]
    lib.sml_coo_densify.argtypes = [i32p, i32p, f32p, ctypes.c_int64, f32p,
                                    ctypes.c_int64, ctypes.c_int]
    for fn in ("sml_murmur3_batch", "sml_vw_count", "sml_vw_parse",
               "sml_coo_densify"):
        getattr(lib, fn).restype = None
    return lib


def _concat_utf8(strings) -> Tuple[bytes, np.ndarray]:
    enc = [s.encode("utf-8") if isinstance(s, str) else bytes(s)
           for s in strings]
    offsets = np.zeros(len(enc) + 1, np.int64)
    if enc:
        np.cumsum([len(b) for b in enc], out=offsets[1:])
    return b"".join(enc), offsets


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def murmur3_batch(strings, seed: int = 0, n_threads: int = 0) -> np.ndarray:
    """murmur3_x86_32 of every string → uint32 array."""
    lib = _lib()
    buf, offsets = _concat_utf8(strings)
    n = len(offsets) - 1
    out = np.empty(n, np.uint32)
    lib.sml_murmur3_batch(buf, _p(offsets, ctypes.c_int64), n,
                          ctypes.c_uint32(seed & 0xFFFFFFFF),
                          _p(out, ctypes.c_uint32), n_threads)
    return out


def vw_parse_batch(lines, num_bits: int, seed: int = 0, n_threads: int = 0):
    """Parse VW-format lines → ``(rows, idxs, vals, labels, weights,
    has_label)`` COO arrays (rows ascending)."""
    lib = _lib()
    buf, offsets = _concat_utf8(str(l) for l in lines)
    n = len(offsets) - 1
    counts = np.zeros(n, np.int64)
    seed32 = ctypes.c_uint32(seed & 0xFFFFFFFF)
    lib.sml_vw_count(buf, _p(offsets, ctypes.c_int64), n, seed32,
                     _p(counts, ctypes.c_int64), n_threads)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    total = int(starts[-1])
    rows = np.empty(total, np.int32)
    idxs = np.empty(total, np.int32)
    vals = np.empty(total, np.float32)
    labels = np.empty(n, np.float32)
    weights = np.empty(n, np.float32)
    has = np.empty(n, np.uint8)
    lib.sml_vw_parse(buf, _p(offsets, ctypes.c_int64), n, seed32,
                     int(num_bits), _p(starts, ctypes.c_int64),
                     _p(rows, ctypes.c_int32), _p(idxs, ctypes.c_int32),
                     _p(vals, ctypes.c_float), _p(labels, ctypes.c_float),
                     _p(weights, ctypes.c_float), _p(has, ctypes.c_uint8),
                     n_threads)
    return rows, idxs, vals, labels, weights, has


def coo_densify(rows: np.ndarray, idxs: np.ndarray, vals: np.ndarray,
                out: np.ndarray) -> None:
    """``out[row, idx] += val`` (rows ascending, as the parser emits
    them); ``out`` is a C-contiguous f32 matrix."""
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("coo_densify needs a C-contiguous float32 matrix")
    _lib().sml_coo_densify(_p(rows, ctypes.c_int32), _p(idxs, ctypes.c_int32),
                           _p(vals, ctypes.c_float), len(rows),
                           _p(out, ctypes.c_float), out.shape[1], 0)


# --------------------------------------------------------------------------
# the CSV parser (loader.cpp)
# --------------------------------------------------------------------------

#: which parser read each file through :func:`read_csv_matrix`:
#: ``"native"`` (loader.cpp) or ``"genfromtxt"`` (the fallback)
CSV_PARSES: Counter = Counter()


@functools.lru_cache(maxsize=None)
def _loader() -> Optional[ctypes.CDLL]:
    """The CSV parser's library, or None when it cannot be built (the
    caller falls back to ``numpy.genfromtxt``, as the JAX package does)."""
    try:
        with _LOCK:
            lib = ctypes.CDLL(str(_build(_LOADER_SRC, "smlloader")))
    except (RuntimeError, OSError) as e:
        from ..core.logging import logger
        logger.warning("native CSV parser unavailable, numpy.genfromtxt "
                       "parses instead: %s", e)
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sml_csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_char, i64p, i64p]
    lib.sml_csv_dims.restype = ctypes.c_int
    lib.sml_csv_read_f32.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_char, ctypes.c_int64,
                                     ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int]
    lib.sml_csv_read_f32.restype = ctypes.c_int
    return lib


def _read_header(path: str, delim: str) -> Tuple[bool, List[str]]:
    """(has_header, column names): the first line is a header unless
    every field parses as a number or is empty; without a header the
    columns are ``f0``, ``f1``, ..."""
    with open(path, "r", errors="replace") as f:
        first = f.readline().rstrip("\r\n")
    fields = first.split(delim)

    def numeric(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return s.strip() == ""

    has_header = not all(numeric(x) for x in fields)
    names = (fields if has_header
             else [f"f{i}" for i in range(len(fields))])
    return has_header, names


def read_csv_matrix(path: str, delim: str = ",",
                    n_threads: int = 0) -> Tuple[np.ndarray, List[str]]:
    """(rows, cols) float32 matrix + column names.  The native path maps
    the file and parses it on ``n_threads`` threads (0: one a core);
    the fallback is ``numpy.genfromtxt``.  Empty or unparseable fields
    read as NaN on both paths; a ragged line is NaN-padded natively."""
    has_header, names = _read_header(path, delim)
    lib = _loader()
    if lib is not None:
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        rc = lib.sml_csv_dims(path.encode(), int(has_header),
                              delim.encode(), ctypes.byref(rows),
                              ctypes.byref(cols))
        if rc == 0:
            r, c = rows.value, cols.value
            out = np.empty((c, r), np.float32)  # column-major blocks
            rc = lib.sml_csv_read_f32(
                path.encode(), int(has_header), delim.encode(), r, c,
                _p(out, ctypes.c_float), int(n_threads))
            if rc >= 0:
                CSV_PARSES["native"] += 1
                return out.T, names[:c]
    mat = np.genfromtxt(path, delimiter=delim,
                        skip_header=1 if has_header else 0,
                        dtype=np.float32, ndmin=2)
    CSV_PARSES["genfromtxt"] += 1
    return mat, names[:mat.shape[1]]


__all__ = ["CSV_PARSES", "coo_densify", "murmur3_batch", "read_csv_matrix",
           "vw_parse_batch"]
