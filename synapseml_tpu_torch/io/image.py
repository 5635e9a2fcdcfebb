"""Image file ingestion (reference: core/.../io/image/ImageUtils +
org/apache/spark/ml/source/image/PatchedImageFileFormat.scala — reads a
directory of images into the image schema {path, height, width,
nChannels, mode, data}; ``dropImageFailures`` filters undecodable
files).  The PyTorch port's copy of the JAX package's ``io/image.py``;
PIL is imported at the first decode."""

from __future__ import annotations

import io
import os
from typing import List, Optional

import numpy as np

from ..core.dataset import Dataset
from .binary import BinaryFileReader

#: reference ImageSchema modes (OpenCV type codes): CV_8UC1/CV_8UC3/CV_8UC4
MODE_GRAY = 0
MODE_BGR = 16
MODE_BGRA = 24

_IMAGE_EXT = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tif", ".tiff",
              ".webp")


def decode_image(data: bytes):
    """bytes → (H, W, C) uint8 array in BGR order, or None if
    undecodable (reference: ImageUtils.safeRead — OpenCV decodes BGR,
    so the same channel order is kept here for parity)."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover - PIL is in the image
        return None
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:
        return None
    if img.mode not in ("L", "RGB", "RGBA"):
        img = img.convert("RGB")
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        return arr[:, :, None]
    return arr[:, :, ::-1] if arr.shape[2] in (3, 4) else arr


def read_images(path: str, recursive: bool = False,
                drop_image_failures: bool = True,
                sample_ratio: float = 1.0, seed: int = 0) -> Dataset:
    """Directory → image-schema Dataset (reference:
    PatchedImageFileFormat.scala + ImageSchemaUtils)."""
    raw = BinaryFileReader.read(path, recursive=recursive,
                                sample_ratio=sample_ratio,
                                inspect_zip=False, seed=seed)
    rows = []
    for p, b in zip(raw["path"], raw["bytes"]):
        if not str(p).lower().endswith(_IMAGE_EXT):
            continue
        arr = decode_image(b)
        if arr is None:
            if drop_image_failures:
                continue
            rows.append((p, 0, 0, 0, -1, None))
        else:
            h, w, c = arr.shape
            mode = {1: MODE_GRAY, 3: MODE_BGR, 4: MODE_BGRA}.get(c, -1)
            rows.append((p, h, w, c, mode, arr))
    n = len(rows)
    data_col = np.empty(n, dtype=object)
    for i, r in enumerate(rows):
        data_col[i] = r[5]
    return Dataset({
        "path": np.asarray([r[0] for r in rows], dtype=object),
        "height": np.asarray([r[1] for r in rows], dtype=np.int64),
        "width": np.asarray([r[2] for r in rows], dtype=np.int64),
        "nChannels": np.asarray([r[3] for r in rows], dtype=np.int64),
        "mode": np.asarray([r[4] for r in rows], dtype=np.int64),
        "data": data_col,
    })
