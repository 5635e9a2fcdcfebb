"""MurmurHash3 x86 32-bit — the hashing-trick primitive.

The PyTorch port's copy of the JAX package's ``core/hashing.py``: the
hashes are bit-identical.  The reference's VW featurizer hashes feature names/values with murmur3,
with a pre-hashed-prefix optimization for column names
(reference: vw/src/main/scala/.../VowpalWabbitMurmurWithPrefix.scala:80,
VowpalWabbitFeaturizer.scala:150-165).  This implements the same algorithm
(public domain, Austin Appleby) in masked Python-int arithmetic — an order
of magnitude faster than numpy-scalar boxing in the per-token inner loop —
plus a column-level helper that hashes a whole token iterable at once.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import numpy as np

_MASK = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def murmurhash3_32(data: Union[bytes, str], seed: int = 0) -> int:
    """murmur3_x86_32 of a byte/str payload; returns an unsigned 32-bit int."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = seed & _MASK
    n = len(data)
    nblocks = n >> 2
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * _C1) & _MASK
        k = ((k << 15) | (k >> 17)) & _MASK
        k = (k * _C2) & _MASK
        h ^= k
        h = ((h << 13) | (h >> 19)) & _MASK
        h = (h * 5 + 0xE6546B64) & _MASK
    tail = data[nblocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _MASK
        k = ((k << 15) | (k >> 17)) & _MASK
        k = (k * _C2) & _MASK
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


def murmurhash3_column(tokens: Iterable[str], seed: int = 0) -> np.ndarray:
    """Hash every token of a column in one call -> uint32 array, with the
    native batch hasher (``synapseml_tpu_torch/native/textproc.cpp``; a
    failed build raises).  :func:`murmurhash3_32` is its plain version."""
    toks = tokens if isinstance(tokens, (list, tuple)) else list(tokens)
    from ..native import murmur3_batch
    return murmur3_batch(toks, seed)


class MurmurWithPrefix:
    """Hash ``prefix + value`` with the prefix pre-encoded once —
    the reference's trick for 'column-name + feature-value' hashes
    (VowpalWabbitMurmurWithPrefix.scala)."""

    def __init__(self, prefix: str):
        self.prefix = prefix.encode("utf-8")

    def hash(self, value: str, seed: int = 0) -> int:
        return murmurhash3_32(self.prefix + value.encode("utf-8"), seed)


def hash_features(tokens: Iterable[str], dim: int, seed: int = 0,
                  signed: bool = True) -> np.ndarray:
    """Hashing-trick bag-of-tokens -> dense vector of length ``dim``.

    ``signed`` applies the sign-bit convention (sign from one hash bit) so
    collisions cancel in expectation.
    """
    out = np.zeros(dim, dtype=np.float64)
    for t in tokens:
        h = murmurhash3_32(t, seed)
        idx = h % dim
        if signed:
            out[idx] += 1.0 if (h >> 31) & 1 == 0 else -1.0
        else:
            out[idx] += 1.0
    return out
