"""Image pipeline stages on a device.

Re-designs the reference's per-row OpenCV stage pipeline
(reference: opencv/.../ImageTransformer.scala:643-675 — a list of
ImageTransformerStage specs applied row-by-row through JNI) as batched
torch calls: equally-sized images are stacked to (N, H, W, C), uploaded
once, and every stage runs on the whole batch; ragged batches are grouped
by shape first.  Output columns hold float32 numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import BoolParam, ListParam, PyObjectParam, StringParam
from ..core.pipeline import Transformer
from ..device import full_f32, resolve_device
from . import ops


class ImageTransformer(Transformer):
    """Chained image ops (reference: opencv ImageTransformer stage list:
    resize/crop/colorFormat/blur/threshold/gaussianKernel/flip).

    Use the fluent helpers::

        ImageTransformer(inputCol="image").resize(224, 224).blur(5, 1.5)

    Stage specs serialize as plain dicts (the reference serializes stage
    name + params the same way).  ``device`` is ``"cuda"`` (raises
    without a card) or ``"cpu"``; the float32 ops run with TF32 off.
    """

    inputCol = StringParam(doc="image column (H,W,C arrays)", default="image")
    outputCol = StringParam(doc="output image column", default="out_image")
    stages = ListParam(doc="ordered op specs", default=None)
    toTensor = BoolParam(doc="emit float32 CHW tensor (toTensor param)",
                         default=False)
    normalizeMean = ListParam(doc="per-channel mean for tensor output")
    normalizeStd = ListParam(doc="per-channel std for tensor output")
    colorScaleFactor = PyObjectParam(doc="scalar scale before normalize")
    device = StringParam(doc="device to run on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    # -- fluent builders (reference ImageTransformer setters) --------------
    def _append(self, spec: Dict[str, Any]) -> "ImageTransformer":
        cur = list(self.get_or_default("stages") or [])
        cur.append(spec)
        self.set("stages", cur)
        return self

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._append({"op": "resize", "height": height, "width": width})

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._append({"op": "crop", "x": x, "y": y,
                             "height": height, "width": width})

    def center_crop(self, height: int, width: int) -> "ImageTransformer":
        """Crop centered on the image midpoint, clamped to the image size
        (reference: CenterCropImage, opencv/.../ImageTransformer.scala:139)."""
        return self._append({"op": "centercrop", "height": int(height),
                             "width": int(width)})

    def color_format(self, mode: str) -> "ImageTransformer":
        return self._append({"op": "color", "mode": mode})

    def blur(self, aperture: int, sigma: float) -> "ImageTransformer":
        return self._append({"op": "blur", "aperture": int(aperture),
                             "sigma": float(sigma)})

    def threshold(self, thresh: float, max_val: float = 255.0) -> "ImageTransformer":
        return self._append({"op": "threshold", "threshold": float(thresh),
                             "maxVal": float(max_val)})

    def gaussian_kernel(self, aperture: int, sigma: float) -> "ImageTransformer":
        return self._append({"op": "gaussian", "aperture": int(aperture),
                             "sigma": float(sigma)})

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        return self._append({"op": "flip", "flipCode": int(flip_code)})

    def normalize(self, mean: Sequence[float], std: Sequence[float],
                  color_scale_factor: float = 1 / 255.0) -> "ImageTransformer":
        self.set("toTensor", True)
        self.set("normalizeMean", [float(m) for m in mean])
        self.set("normalizeStd", [float(s) for s in std])
        self.set("colorScaleFactor", float(color_scale_factor))
        return self

    # -- execution ---------------------------------------------------------
    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The stage list on one (N, H, W, C) float32 batch on its device
        → NHWC images, or NCHW tensors when ``toTensor`` is set."""
        for spec in self.get_or_default("stages") or []:
            op = spec["op"]
            if op == "resize":
                x = ops.resize_bilinear(x, spec["height"], spec["width"])
            elif op == "crop":
                x = ops.center_crop(x, spec["x"], spec["y"],
                                    spec["width"], spec["height"])
            elif op == "centercrop":
                h, w = int(x.shape[1]), int(x.shape[2])
                ch = min(spec["height"], h)
                cw = min(spec["width"], w)
                x = ops.center_crop(x, w // 2 - cw // 2, h // 2 - ch // 2,
                                    cw, ch)
            elif op == "color":
                x = ops.color_convert(x, spec["mode"])
            elif op in ("blur", "gaussian"):
                x = ops.gaussian_blur(x, spec["aperture"], spec["sigma"])
            elif op == "threshold":
                x = ops.threshold(x, spec["threshold"], spec["maxVal"])
            elif op == "flip":
                x = ops.flip(x, spec["flipCode"])
            else:
                raise ValueError(f"unknown image op {op!r}")
        if self.toTensor:
            scale = float(self.get_or_default("colorScaleFactor") or 1.0)
            x = x * scale
            mean = self.get_or_default("normalizeMean")
            std = self.get_or_default("normalizeStd")
            if mean is not None:
                m = torch.tensor(mean, dtype=torch.float32, device=x.device)
                s = torch.tensor(std, dtype=torch.float32, device=x.device)
                x = (x - m) / s
            x = torch.movedim(x, -1, 1)  # NHWC -> NCHW tensor convention
        return x

    def _transform(self, ds: Dataset) -> Dataset:
        dev = resolve_device(self.get_or_default("device"))
        col = ds[self.inputCol]
        imgs = [np.asarray(v) for v in col]
        # group equal shapes so each group is one upload and one batched call
        by_shape: Dict[tuple, List[int]] = {}
        for i, im in enumerate(imgs):
            by_shape.setdefault(im.shape, []).append(i)
        results: List[Optional[np.ndarray]] = [None] * len(imgs)
        for shape, idxs in by_shape.items():
            batch = np.stack([imgs[i] for i in idxs]).astype(np.float32)
            if batch.ndim == 3:  # grayscale H,W -> H,W,1
                batch = batch[..., None]
            with full_f32():
                out = self.apply_batch(torch.from_numpy(batch).to(dev))
            out = out.contiguous().cpu().numpy()
            for k, i in enumerate(idxs):
                results[i] = out[k]
        out_col = np.empty(len(imgs), dtype=object)
        for i, r in enumerate(results):
            out_col[i] = r
        return ds.with_column(self.outputCol, out_col)


class UnrollImage(Transformer):
    """Flatten an image column into a numeric vector column
    (reference: image/UnrollImage.scala:169 — OpenCV-channel-order aware).
    A host reshape: no device work."""

    inputCol = StringParam(doc="image column", default="image")
    outputCol = StringParam(doc="vector output", default="unrolled")

    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if inputCol is not None:
            self.set("inputCol", inputCol)
        if outputCol is not None:
            self.set("outputCol", outputCol)

    def _transform(self, ds: Dataset) -> Dataset:
        col = ds[self.inputCol]
        out = np.empty(len(col), dtype=object)
        for i, v in enumerate(col):
            out[i] = np.asarray(v, np.float64).ravel()
        return ds.with_column(self.outputCol, out)


class UnrollBinaryImage(UnrollImage):
    """Parity alias (reference: image/UnrollBinaryImage.scala) — binary
    payloads are decoded by the IO layer before reaching this stage."""


class ImageSetAugmenter(Transformer):
    """Supplement a training set with flipped copies of its images
    (reference: opencv/.../ImageSetAugmenter.scala:20-67 — identity rows
    plus a left-right and/or up-down flipped union, other columns kept)."""

    inputCol = StringParam(doc="image column", default="image")
    outputCol = StringParam(doc="augmented image column", default="augmented")
    flipLeftRight = BoolParam(doc="add left-right flipped copies",
                              default=True)
    flipUpDown = BoolParam(doc="add up-down flipped copies", default=False)
    device = StringParam(doc="device the flips run on: 'cuda' (raises when "
                             "no card is present) or 'cpu'", default="cuda")

    def _transform(self, ds: Dataset) -> Dataset:
        resolve_device(self.get_or_default("device"))
        out = ds.with_column(self.outputCol, ds[self.inputCol])
        # OpenCV flip codes (ImageTransformer.flip): 1 = left-right, 0 = up-down
        for enabled, code in ((self.flipLeftRight, 1), (self.flipUpDown, 0)):
            if not enabled:
                continue
            flipped = (ImageTransformer(inputCol=self.inputCol,
                                        outputCol=self.outputCol,
                                        device=self.get_or_default("device"))
                       .flip(code).transform(ds))
            # keep the augmented column dtype-homogeneous with the identity
            # rows (ImageTransformer computes in float32)
            col = flipped[self.outputCol]
            src = ds[self.inputCol]
            cast = np.empty(len(col), object)
            for i in range(len(col)):
                cast[i] = np.asarray(col[i]).astype(
                    np.asarray(src[i]).dtype)
            out = out.union(flipped.with_column(self.outputCol, cast))
        return out
