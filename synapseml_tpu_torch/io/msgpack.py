"""A msgpack decoder for flax checkpoints (``flax_model.msgpack``).

The port reads flax's serialized trees without the ``msgpack`` or
``flax`` packages.  :func:`unpack` decodes every msgpack type (nil, bool,
ints, floats, str, bin, array, map, ext and fixext) and flax's ext codes
(``flax.serialization._MsgpackExtType``):

- 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)`` triple;
- 2, a Python complex: a packed ``(real, imag)`` pair;
- 3, a numpy scalar: an ndarray of shape ``()``, returned as its scalar.

:func:`restore` also rejoins the leaves flax split into a
``__msgpack_chunked_array__`` dict (arrays over ``MAX_CHUNK_SIZE`` bytes).
Each array is copied once out of the file's bytes.  ``bfloat16``
arrays keep their 16-bit patterns as ``uint16`` in a :class:`BF16Bits`
wrapper, since numpy has no bfloat16; :func:`widen_bf16` turns them into
the float32 values flax would give.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["BF16Bits", "restore", "unpack", "widen_bf16"]

#: flax's ext type codes
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

#: the key flax marks a chunked array leaf with
CHUNKED_KEY = "__msgpack_chunked_array__"


class BF16Bits:
    """A bfloat16 array held as its ``uint16`` bit patterns."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.bits.shape

    def reshape(self, shape) -> "BF16Bits":
        return BF16Bits(self.bits.reshape(shape))


def widen_bf16(x: BF16Bits) -> np.ndarray:
    """bfloat16 bit patterns → the float32 array of the same values."""
    return (x.bits.astype(np.uint32) << 16).view(np.float32)


class _Reader:
    """One pass over a msgpack byte buffer."""

    def __init__(self, buf, bin_views: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        #: bin values as views of the buffer instead of bytes copies
        self.bin_views = bin_views

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(self.unpack(">" + "BHI"[b - 0xC4]))
            return data if self.bin_views else bytes(data)
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack: invalid type byte 0x{b:02x} at "
                         f"offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_COMPLEX:
            re_, im = _Reader(data).read()
            return complex(re_, im)
        if code == EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr if isinstance(arr, BF16Bits) else arr[()]
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _ndarray(data: memoryview):
    """flax's ndarray ext payload → a (writable) array copied out of
    ``data``."""
    shape, name, raw = _Reader(data, bin_views=True).read()
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(s) for s in shape)
    if not isinstance(raw, memoryview):
        raise ValueError("msgpack: malformed ndarray payload")
    if name == "bfloat16":
        return BF16Bits(np.frombuffer(raw, np.uint16).reshape(shape).copy())
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"msgpack: ndarray dtype {name!r} is not a numpy "
                         "dtype") from e
    if dtype.hasobject:
        raise ValueError("msgpack: object arrays are not read")
    return np.frombuffer(raw, dtype).reshape(shape).copy()


def unpack(buf) -> Any:
    """Decode one msgpack object from ``buf`` (bytes-like); trailing bytes
    raise."""
    r = _Reader(buf)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out


def _unchunk(node: Dict[str, Any]):
    shape = tuple(int(node["shape"][str(i)])
                  for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if chunks and isinstance(chunks[0], BF16Bits):
        return BF16Bits(np.concatenate([c.bits for c in chunks])
                        .reshape(shape))
    return np.concatenate(chunks).reshape(shape)


def _rejoin(node: Any) -> Any:
    if isinstance(node, dict):
        if CHUNKED_KEY in node:
            return _unchunk(node)
        return {k: _rejoin(v) for k, v in node.items()}
    return node


def restore(buf) -> Any:
    """flax's ``msgpack_restore``: the decoded tree with chunked array
    leaves rejoined."""
    return _rejoin(unpack(buf))
