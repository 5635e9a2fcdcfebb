"""Launch counts of the port's CUDA kernels, in one registry.

Every kernel wrapper calls :func:`count` right after its kernel launched,
and nowhere else: the plain versions never count.  Launches are kept by
shape under :func:`launch_key`; :func:`total` sums one kernel's shapes.
A caller that wants the launches of one run calls :func:`reset` just
before it and reads :data:`BY_SHAPE` just after.
"""

from __future__ import annotations

from typing import Dict

#: launches since the last :func:`reset`, keyed by :func:`launch_key`
BY_SHAPE: Dict[str, int] = {}


def launch_key(kernel: str, **dims) -> str:
    """``kernel[name=value,...]``, the dims in the order the wrapper
    passes them."""
    return kernel + "[" + ",".join(f"{k}={v}" for k, v in dims.items()) + "]"


def count(kernel: str, **dims) -> None:
    key = launch_key(kernel, **dims)
    BY_SHAPE[key] = BY_SHAPE.get(key, 0) + 1


def reset() -> None:
    BY_SHAPE.clear()


def shapes(kernel: str) -> Dict[str, int]:
    """The launches of ``kernel`` since the last :func:`reset`, by shape."""
    pre = kernel + "["
    return {k: n for k, n in BY_SHAPE.items() if k.startswith(pre)}


def total(kernel: str) -> int:
    return sum(shapes(kernel).values())
