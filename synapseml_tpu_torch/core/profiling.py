"""Profiling: device traces + named host-side phase timing.

The PyTorch port of the JAX package's ``core/profiling.py``.  Host phase
timing (:class:`PhaseTimer`) is the JAX package's, unchanged; :func:`trace`
is ``torch.profiler`` over the CPU and, where a card is present, its
CUDA activities (kernel launches and their device times), written as a
Chrome/TensorBoard trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch

__all__ = ["PhaseTimer", "trace"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the body into ``log_dir``
    (``trace_<pid>_<n>.json``, Chrome trace format; view it in Perfetto
    or TensorBoard).  Degrades to a no-op if the profiler cannot start —
    one already active, say: entry failures are caught, body exceptions
    are not."""
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile
        if torch.autograd.profiler._is_profiler_enabled:
            # a second session would end the first one's on exit
            raise RuntimeError("a profiler is already active")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                n = len([f for f in os.listdir(log_dir)
                         if f.startswith(f"trace_{os.getpid()}_")])
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace_{os.getpid()}_{n}.json"))
            except Exception:
                pass


class PhaseTimer:
    """Accumulating named phase timer.

    >>> t = PhaseTimer()
    >>> with t.phase("binning"): ...
    >>> with t.phase("train"): ...
    >>> t.report()   # {"binning": 0.01, "train": 1.2}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] = self._acc.get(name, 0.0) + (
                time.perf_counter() - t0)
            self._counts[name] = self._counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self._acc)

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def reset(self) -> None:
        self._acc.clear()
        self._counts.clear()
