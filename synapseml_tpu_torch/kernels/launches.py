"""Launch counts of the port's CUDA kernels, in one registry.

Every kernel wrapper calls :func:`count` right after its kernel launched,
and nowhere else: the plain versions never count.  Launches are kept by
shape under :func:`launch_key`; :func:`total` sums one kernel's shapes.
A caller that wants the launches of one run calls :func:`reset` just
before it and reads :data:`BY_SHAPE` just after.

A kernel recorded into a CUDA graph launches when the graph replays, not
when the wrapper runs: inside :func:`recording` the wrapper's counts go
to the recording instead, and each replay adds them with :func:`add`.
A recording holds the counts of its own thread only: another thread's
launches meanwhile go to :data:`BY_SHAPE`.  Every update and read of
:data:`BY_SHAPE` here holds one lock, so the launches of wrappers that
run on several threads at once (the tuner's trials) are all counted.

Beside its count, every wrapper reports the bytes its launch reads and
writes (:func:`io_bytes`: each operand and result once).  The
kernels are reached through ctypes, below PyTorch's dispatcher, so a
cost capture (``telemetry.roofline.capture``) learns their bytes only
from this report, made while :func:`reporting_bytes` is active on the
thread.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

#: launches since the last :func:`reset`, keyed by :func:`launch_key`
BY_SHAPE: Dict[str, int] = {}
#: guards every read-modify-write of BY_SHAPE
_LOCK = threading.Lock()
#: ``.sink``: the callable ``sink(kernel, nbytes)`` this thread's
#: :func:`io_bytes` reports go to (absent or None: nowhere)
_BYTES = threading.local()
#: ``.into``: where this thread's :func:`count` goes while it captures a
#: CUDA graph (absent or None: BY_SHAPE)
_RECORDING = threading.local()


def launch_key(kernel: str, **dims) -> str:
    """``kernel[name=value,...]``, the dims in the order the wrapper
    passes them."""
    return kernel + "[" + ",".join(f"{k}={v}" for k, v in dims.items()) + "]"


def count(kernel: str, **dims) -> None:
    key = launch_key(kernel, **dims)
    into = getattr(_RECORDING, "into", None)
    if into is not None:            # this thread's own recording
        into[key] = into.get(key, 0) + 1
        return
    with _LOCK:
        BY_SHAPE[key] = BY_SHAPE.get(key, 0) + 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Counts made inside go into the yielded dict and not into
    :data:`BY_SHAPE`: wrap a CUDA graph's capture in it, and :func:`add`
    the dict at each replay."""
    _RECORDING.into = {}
    try:
        yield _RECORDING.into
    finally:
        _RECORDING.into = None


def add(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a recorded graph."""
    with _LOCK:
        for key, n in counts.items():
            BY_SHAPE[key] = BY_SHAPE.get(key, 0) + n


def io_bytes(kernel: str, *parts) -> None:
    """Report one launch's operand and result bytes to the cost capture
    active on this thread, if any: each part is a tensor (all its bytes),
    an int (bytes, for an operand read in part) or None (skipped)."""
    sink = getattr(_BYTES, "sink", None)
    if sink is not None:
        sink(kernel, sum(p if isinstance(p, int)
                         else p.numel() * p.element_size()
                         for p in parts if p is not None))


def wants_bytes() -> bool:
    """Is a cost capture listening on this thread?  A wrapper whose byte
    count needs a host sync computes it only then."""
    return getattr(_BYTES, "sink", None) is not None


@contextlib.contextmanager
def reporting_bytes(sink) -> Iterator[None]:
    """Send this thread's :func:`io_bytes` reports to ``sink(kernel,
    nbytes)`` inside the block."""
    prev = getattr(_BYTES, "sink", None)
    _BYTES.sink = sink
    try:
        yield
    finally:
        _BYTES.sink = prev


def reset() -> None:
    with _LOCK:
        BY_SHAPE.clear()


def snapshot() -> Dict[str, int]:
    """A copy of :data:`BY_SHAPE`, taken under the lock."""
    with _LOCK:
        return dict(BY_SHAPE)


def shapes(kernel: str) -> Dict[str, int]:
    """The launches of ``kernel`` since the last :func:`reset`, by shape."""
    pre = kernel + "["
    with _LOCK:
        return {k: n for k, n in BY_SHAPE.items() if k.startswith(pre)}


def total(kernel: str) -> int:
    return sum(shapes(kernel).values())
