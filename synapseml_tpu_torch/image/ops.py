"""Batched image ops in PyTorch.

Each op is one reference OpenCV stage (reference: opencv/.../
ImageTransformer.scala — ResizeImage:68, CropImage:109, ColorFormat:148,
Blur:171, Threshold:196, GaussianKernel:221, Flip:252) over a stacked
(N, H, W, C) float32 tensor on the batch's device.

:func:`resize` computes the JAX package's resize exactly as
``jax.image.resize`` defines it (jax/_src/image/scale.py): half-pixel
sample positions, a triangle (linear), Keys-cubic (a = -0.5) or
nearest rule, an antialiasing kernel widened by the downsampling factor,
weights renormalised per output sample and zeroed where the sample falls
outside the input.  The weights are computed in float32 with numpy, as
jax does, and applied as one contraction per resized axis.
``torch.nn.functional.interpolate`` is not the same function: its
bicubic uses a = -0.75 and its antialias follows PIL.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., np.float32(0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "trilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic,
            "tricubic": _keys_cubic}


@functools.lru_cache(maxsize=256)
def resize_weights(in_size: int, out_size: int, method: str,
                   antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax's ``compute_weight_mat``
    for a plain resize (scale out/in, no translation)."""
    kernel = _KERNELS[method]
    inv_scale = 1. / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.)) if antialias else 1.
    sample_f = ((np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale
                - 0.5)
    x = (np.abs(sample_f[np.newaxis, :]
                - np.arange(in_size, dtype=np.float32)[:, np.newaxis])
         / kernel_scale).astype(np.float32)
    w = kernel(x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000. * _EPS32,
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[np.newaxis, :], w, np.float32(0)).astype(np.float32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=256)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """jax's nearest rule: floor((j + 0.5) * in / out) in float32."""
    off = (np.arange(out_size, dtype=np.float32) + 0.5) * in_size / out_size
    idx = np.floor(off.astype(np.float32)).astype(np.int64)
    idx.setflags(write=False)
    return idx


def resize(x: torch.Tensor, shape: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` on a tensor: every
    axis whose size changes is resampled; the rest pass through."""
    shape = [int(s) for s in shape]
    if len(shape) != x.dim():
        raise ValueError(f"shape must have length equal to the number of "
                         f"dimensions of x; {shape} vs {tuple(x.shape)}")
    if method != "nearest" and method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    if not x.is_floating_point():
        x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            idx = torch.tensor(nearest_indices(m, n), device=x.device)
            x = torch.index_select(x, d, idx)
            continue
        w = torch.tensor(resize_weights(m, n, method, antialias),
                         device=x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x


def resize_bilinear(images: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """(N,H,W,C) -> (N,out_h,out_w,C), jax's antialiased bilinear."""
    n, _, _, c = images.shape
    return resize(images, (n, out_h, out_w, c), "bilinear")


def center_crop(images: torch.Tensor, x: int, y: int, w: int,
                h: int) -> torch.Tensor:
    """CropImage analogue: the fixed rectangle [y, y+h) x [x, x+w)."""
    if x < 0 or y < 0 or y + h > images.shape[1] or x + w > images.shape[2]:
        raise ValueError(f"crop ({x}, {y}, {w}, {h}) outside an image of "
                         f"{tuple(images.shape[1:3])}")
    return images[:, y:y + h, x:x + w, :]


def gaussian_kernel(aperture: int, sigma: float) -> np.ndarray:
    """Separable 1-D gaussian taps (GaussianKernel stage analogue)."""
    half = aperture // 2
    xs = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / max(sigma, 1e-9)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _gauss_taps(aperture: int, sigma: float, device) -> torch.Tensor:
    half = aperture // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    s = torch.clamp(torch.tensor(sigma, dtype=torch.float32,
                                 device=device), min=1e-9)
    k = torch.exp(-0.5 * (xs / s) ** 2)
    return k / k.sum()


def gaussian_blur(images: torch.Tensor, aperture: int,
                  sigma: float) -> torch.Tensor:
    """Separable gaussian blur as two depthwise convolutions with "SAME"
    zero padding (Blur analogue — the reference calls cv2.GaussianBlur per
    row)."""
    k = _gauss_taps(aperture, sigma, images.device)
    n, h, w, c = images.shape
    x = torch.movedim(images, -1, 1).reshape(n * c, 1, h, w)
    lo, hi = (aperture - 1) // 2, aperture - 1 - (aperture - 1) // 2
    x = F.conv2d(F.pad(x, (0, 0, lo, hi)), k.reshape(1, 1, aperture, 1))
    x = F.conv2d(F.pad(x, (lo, hi, 0, 0)), k.reshape(1, 1, 1, aperture))
    return torch.movedim(x.reshape(n, c, h, w), 1, -1)


def flip(images: torch.Tensor, flip_code: int = 1) -> torch.Tensor:
    """OpenCV flip codes: 0 = vertical (up/down), >0 horizontal, <0 both."""
    if flip_code == 0:
        return torch.flip(images, (1,))
    if flip_code > 0:
        return torch.flip(images, (2,))
    return torch.flip(images, (1, 2))


def threshold(images: torch.Tensor, thresh: float,
              max_val: float) -> torch.Tensor:
    """Binary threshold (Threshold stage, cv2.THRESH_BINARY)."""
    return torch.where(images > thresh,
                       torch.tensor(max_val, dtype=images.dtype,
                                    device=images.device),
                       torch.tensor(0.0, dtype=images.dtype,
                                    device=images.device))


_BGR_TO_GRAY = (0.114, 0.587, 0.299)


def color_convert(images: torch.Tensor, mode: str) -> torch.Tensor:
    """ColorFormat analogue; modes: gray (BGR weights), rgb<->bgr swap."""
    if mode == "gray":
        wts = torch.tensor(_BGR_TO_GRAY, dtype=torch.float32,
                           device=images.device)
        return (images * wts).sum(-1, keepdim=True)
    if mode in ("bgr2rgb", "rgb2bgr"):
        return torch.flip(images, (-1,))
    raise ValueError(f"unknown color mode {mode!r}")
