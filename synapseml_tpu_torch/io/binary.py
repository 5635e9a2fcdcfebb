"""Binary file ingestion (reference: core/.../io/binary/
BinaryFileFormat.scala:250, BinaryFileReader.scala:105 — recursive
directory walk, optional zip inspection, seeded subsampling; schema
{path, bytes} per BinaryFileSchema).  The PyTorch port's copy of the JAX
package's ``io/binary.py``."""

from __future__ import annotations

import io
import os
import zipfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.dataset import Dataset


def _walk(path: str, recursive: bool) -> List[str]:
    """Files under ``path`` (reference: BinaryFileReader.recursePath —
    symlink-cycle-safe recursion)."""
    if os.path.isfile(path):
        return [path]
    out: List[str] = []
    seen = set()
    for root, dirs, files in os.walk(path, followlinks=True):
        real = os.path.realpath(root)
        if real in seen:
            dirs[:] = []
            continue
        seen.add(real)
        for f in sorted(files):
            out.append(os.path.join(root, f))
        if not recursive:
            break
    return out


def _iter_entries(fp: str, inspect_zip: bool
                  ) -> Iterator[Tuple[str, bytes]]:
    """(path, bytes) rows; zip members get ``archive.zip/member`` paths
    (reference: BinaryFileFormat.scala zip handling +
    KeyValueReaderIterator.scala)."""
    if inspect_zip and fp.endswith(".zip") and zipfile.is_zipfile(fp):
        with zipfile.ZipFile(fp) as zf:
            for name in zf.namelist():
                if name.endswith("/"):
                    continue
                yield f"{fp}/{name}", zf.read(name)
    else:
        with open(fp, "rb") as f:
            yield fp, f.read()


class BinaryFileReader:
    """Directory of binary files → Dataset (reference:
    BinaryFileReader.read — sampleRatio/inspectZip/seed options)."""

    @staticmethod
    def read(path: str, recursive: bool = False, sample_ratio: float = 1.0,
             inspect_zip: bool = True, seed: int = 0) -> Dataset:
        rng = np.random.default_rng(seed)
        paths: List[str] = []
        blobs: List[bytes] = []
        for fp in _walk(path, recursive):
            for name, data in _iter_entries(fp, inspect_zip):
                if sample_ratio < 1.0 and rng.random() >= sample_ratio:
                    continue
                paths.append(name)
                blobs.append(data)
        path_col = np.asarray(paths, dtype=object)
        byte_col = np.empty(len(blobs), dtype=object)
        for i, b in enumerate(blobs):
            byte_col[i] = b
        return Dataset({"path": path_col, "bytes": byte_col})


def read_binary_files(path: str, **kw) -> Dataset:
    """Module-level convenience (reference: IOImplicits' reader syntax)."""
    return BinaryFileReader.read(path, **kw)
