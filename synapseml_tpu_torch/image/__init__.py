"""Image ops — the OpenCV-module and core-image equivalents, in PyTorch.

The reference ships two image layers: JNI OpenCV stages
(opencv/.../ImageTransformer.scala:68-283 — Resize/Crop/ColorFormat/Blur/
Threshold/GaussianKernel/Flip applied per row) and pure-Scala helpers
(image/UnrollImage.scala:169, image/SuperpixelTransformer.scala:37).
Here every pixel op is a torch call over a stacked (N, H, W, C) batch on
the stage's device — no per-row JNI.
"""

from .ops import (gaussian_kernel, gaussian_blur, resize_bilinear,
                  center_crop, flip, threshold, color_convert)
from .stages import (ImageSetAugmenter, ImageTransformer, UnrollImage,
                     UnrollBinaryImage)
from .superpixel import SuperpixelTransformer, slic_segments

__all__ = [
    "gaussian_kernel", "gaussian_blur", "resize_bilinear", "center_crop",
    "flip", "threshold", "color_convert",
    "ImageSetAugmenter", "ImageTransformer", "UnrollImage", "UnrollBinaryImage",
    "SuperpixelTransformer", "slic_segments",
]
