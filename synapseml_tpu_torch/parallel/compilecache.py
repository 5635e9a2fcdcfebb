"""The kernel build cache shared by a gang, and build attribution.

The PyTorch port's counterpart of the JAX package's
``parallel/compilecache.py``.  There the "compile" is XLA's and the cache
is jax's persistent compilation cache; here the only compile the port
runs is the ``nvcc`` build of its hand-written kernels
(:mod:`synapseml_tpu_torch.kernels._build`, one shared library a source,
named by a hash of the source and flags), so:

- **the cache** is a directory of those libraries.
  :func:`enable_compilation_cache` points the kernel builds there; the
  directory threads through
  :class:`~synapseml_tpu_torch.parallel.supervisor.GangSupervisor`
  (``compile_cache_dir``) to every worker as ``SMLTPU_COMPILE_CACHE_DIR``,
  and each worker calls :func:`enable_from_env` before its task runs, so
  a relaunched or resized gang loads the libraries an earlier attempt
  built instead of running ``nvcc`` again.  Outside a gang nothing
  changes: the builds go to ``build/kernels/`` of the checkout.
- **attribution**: :func:`install_compile_listeners` attributes each
  build's seconds to the thread's :func:`compile_label`
  (``unattributed`` otherwise), under the JAX package's metric names:
  the ``llm_compile_seconds{program}`` histogram and
  ``xla_compiles_total{program}`` for every build, and
  ``xla_compile_cache_hits_total`` / ``xla_compile_cache_misses_total``
  for the libraries found in the directory and the ones built.
  :func:`cache_stats` holds the same tallies for the process.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, Optional

from ..telemetry import get_registry

__all__ = [
    "COMPILE_CACHE_ENV", "cache_stats", "compile_label",
    "compilation_cache_dir", "current_label", "enable_compilation_cache",
    "enable_from_env", "install_compile_listeners",
]

#: env var carrying the kernel build cache directory to every gang worker
#: (the ``SMLTPU_CKPT_DIR`` idiom)
COMPILE_CACHE_ENV = "SMLTPU_COMPILE_CACHE_DIR"

#: histogram buckets of build seconds (an ``nvcc`` build of one source
#: takes seconds to a minute)
_COMPILE_SECONDS_BUCKETS = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
                            100.0, 300.0)

_lock = threading.Lock()
_listeners_installed = False
_cache_dir: Optional[str] = None
_tls = threading.local()
_counts = {"compiles": 0, "cache_hits": 0, "cache_misses": 0}


def current_label() -> str:
    return getattr(_tls, "label", None) or "unattributed"


@contextlib.contextmanager
def compile_label(label: str) -> Iterator[None]:
    """Attribute any kernel build on THIS thread inside the block to
    ``label`` (nests; the innermost label wins)."""
    prev = getattr(_tls, "label", None)
    _tls.label = label
    try:
        yield
    finally:
        _tls.label = prev


def install_compile_listeners() -> bool:
    """Register the process-wide build listener (idempotent) → True."""
    global _listeners_installed
    with _lock:
        if _listeners_installed:
            return True
        reg = get_registry()
        h_seconds = reg.histogram(
            "llm_compile_seconds",
            "kernel build (nvcc) seconds per built library, labelled by "
            "the thread's compile label (unattributed: a build outside "
            "any labelled region)",
            ("program",), buckets=_COMPILE_SECONDS_BUCKETS)
        c_compiles = reg.counter(
            "xla_compiles_total", "kernel builds (nvcc) run by this "
            "process", ("program",))
        c_hits = reg.counter(
            "xla_compile_cache_hits_total",
            "kernel libraries loaded from the build directory", ())
        c_misses = reg.counter(
            "xla_compile_cache_misses_total",
            "kernel libraries the build directory did not hold (built, "
            "then stored)", ())

        def on_build(event: str, name: str, seconds: float) -> None:
            if event == "hit":
                _counts["cache_hits"] += 1
                c_hits.inc(1)
                return
            label = current_label()
            _counts["compiles"] += 1
            _counts["cache_misses"] += 1
            c_misses.inc(1)
            h_seconds.observe(seconds, program=label)
            c_compiles.inc(1, program=label)

        from ..kernels import _build
        _build.add_build_listener(on_build)
        _listeners_installed = True
        return True


def cache_stats() -> Dict[str, int]:
    """This process's tallies: ``compiles`` (builds), ``cache_hits``
    (libraries found built) and ``cache_misses`` (libraries built)."""
    return dict(_counts)


def compilation_cache_dir() -> Optional[str]:
    """The directory this process enabled, or None."""
    return _cache_dir


def enable_compilation_cache(cache_dir: str) -> bool:
    """Build and load the kernels in ``cache_dir`` from now on (installs
    the attribution listener too) → True."""
    global _cache_dir
    install_compile_listeners()
    from ..kernels import _build
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    with _lock:
        _cache_dir = str(cache_dir)
    from ..telemetry.flight import record as flight_record
    flight_record("compile_cache", dir=str(cache_dir))
    return True


def enable_from_env() -> Optional[str]:
    """Worker side: enable the cache the supervisor threaded through
    ``SMLTPU_COMPILE_CACHE_DIR`` (→ the directory), else just install the
    attribution listener (→ None)."""
    cache_dir = os.environ.get(COMPILE_CACHE_ENV)
    if cache_dir:
        enable_compilation_cache(cache_dir)
        return cache_dir
    install_compile_listeners()
    return None
