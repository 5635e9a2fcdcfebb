"""The counter-based random numbers the JAX package draws its row samples
from: threefry-2x32 keys, ``fold_in`` and f32 ``uniform``, bit for bit.

The JAX package draws its bagging mask as ``uniform(fold_in(PRNGKey(
bagging_seed), it // freq), (N,)) < bagging_fraction`` and GOSS's
small-gradient sample from ``PRNGKey(seed * 100003 + it)``; a port that
draws the same bits grows the same trees.  Access-anomaly ALS starts from
``normal`` factors on the two halves of ``split(PRNGKey(seed))``.  These
are copies of ``jax.random.PRNGKey``, ``fold_in``, ``split``, ``uniform``
and ``normal`` for the threefry-2x32
generator in its partitionable layout (``jax_threefry_partitionable``,
on by default since jax 0.5): element ``i`` of an ``(n,)`` draw hashes
the counter pair ``(i >> 32, i & 0xffffffff)`` and xors the two output
words.

A key is a host pair of 32-bit ints.  :func:`uniform` hashes its counters
with torch integer ops on ``device``, so the card and the CPU draw the
same bits; values are held in int64 lanes masked to 32 bits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``/``x1``: int64
    numpy arrays or torch tensors holding uint32 values → the two output
    words, of the same kind."""
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    return (0, int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashes ``(0, data)``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.int64),
                          np.array([int(data) & _M32], np.int64))
    return int(y0[0]), int(y1[0])


def random_bits(key: Key, n: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 values in [0, 2^32)
    on ``device``."""
    dev = resolve_device(device)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    y0, y1 = threefry2x32(key, i >> 32, i & _M32)
    return y0 ^ y1


def uniform(key: Key, n: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: f32 in [0, 1) on ``device``,
    the top 23 bits of each word as the mantissa of a float in [1, 2),
    minus 1."""
    bits = random_bits(key, n, device)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: key ``i`` hashes the counter pair
    ``(0, i)``, so it equals ``fold_in(key, i)`` in this layout."""
    y0, y1 = threefry2x32(key, np.zeros(num, np.int64),
                          np.arange(num, dtype=np.int64))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


# XLA's f32 erf_inv (Giles' single-precision approximation): the two
# polynomials in w = -log1p(-x^2), for w < 5 and for w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``erfinv`` by the polynomial XLA lowers ``lax.erf_inv`` to
    (``torch.special.erfinv`` is another approximation: up to ~90 ulps
    apart).  Each Horner step ``c + p * w`` is rounded to f32 once, as
    XLA's fused multiply-add does; only ``log1p`` is torch's, which keeps
    the result within a few ulps of XLA's."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = (torch.where(lt, lo[i], hi[i]).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: Key, shape, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32 on ``device``: a uniform
    over [nextafter(-1, 0), 1) from the top 23 bits of each word, then
    ``sqrt(2) * erfinv``."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape)) if shape else 1
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    f = uniform(key, n, device)
    u = torch.clamp(f * float(np.float32(1.0) - lo) + float(lo), min=float(lo))
    return (np.float32(np.sqrt(2.0)).item() * erfinv_f32(u)).reshape(shape)
