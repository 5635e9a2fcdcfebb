"""OOM-adaptive batching: the part of the JAX package's row guard that
device batch consumers (the ONNX runner) call.

Consumers with a device batch dimension catch an out-of-memory failure,
halve the batch size, remember the safe size per key in the
``rowguard_safe_batch_size`` gauge, and retry instead of dying.  The
markers match XLA's ``RESOURCE_EXHAUSTED`` status text, the injected
:class:`~synapseml_tpu_torch.resilience.faults.ResourceExhaustedError`,
and PyTorch's ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory").

Fault site: ``oom`` fires before every adaptive device call (arm kind
``oom`` with ``when`` on the batch size).

Telemetry: ``rowguard_oom_events_total{key}``,
``rowguard_safe_batch_size{key}``.

The rest of the row guard (``handleInvalid`` skip/quarantine,
poison-batch bisection, the dead-letter quarantine) is still to port.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

from ..telemetry.registry import get_registry
from .faults import get_faults

logger = logging.getLogger("synapseml_tpu_torch")

#: substrings marking a device allocation failure (XLA's status string,
#: the injected stand-in, and PyTorch's "CUDA out of memory" all carry one)
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "out of memory",
                "OUT_OF_MEMORY", "Out of memory")


def is_oom_error(e: BaseException) -> bool:
    """True for device out-of-memory failures (``torch.cuda.OutOfMemoryError``,
    host ``MemoryError``, or the injected
    :class:`~synapseml_tpu_torch.resilience.faults.ResourceExhaustedError`).
    These are batch-SIZE failures, not row failures: the adaptive batchers
    own the recovery."""
    if isinstance(e, MemoryError):
        return True
    text = f"{type(e).__name__}: {e}"
    return any(m in text for m in _OOM_MARKERS)


_safe_batch_lock = threading.Lock()
_safe_batch: Dict[str, int] = {}


def safe_batch_size(key: str, requested: int) -> int:
    """The remembered OOM-safe batch size for ``key`` capped at
    ``requested`` (``requested`` when nothing is remembered)."""
    with _safe_batch_lock:
        known = _safe_batch.get(key)
    return requested if known is None else max(1, min(requested, known))


def reset_safe_batch(key: Optional[str] = None) -> None:
    """Forget remembered OOM-safe batch sizes (all keys when None) —
    tests isolate their injected OOMs with this; a real deployment keeps
    the memory for the life of the process."""
    with _safe_batch_lock:
        if key is None:
            _safe_batch.clear()
        else:
            _safe_batch.pop(key, None)


def record_safe_batch(key: str, size: int) -> None:
    with _safe_batch_lock:
        _safe_batch[key] = int(size)
    get_registry().gauge(
        "rowguard_safe_batch_size",
        "largest batch size that ran without RESOURCE_EXHAUSTED",
        ("key",)).set(int(size), key=key)


def oom_fault_point(key: str, batch: int) -> None:
    """Injection site consulted before every adaptive device call: arm
    ``oom=oom`` (optionally with a ``when`` predicate on ``batch``) to
    manufacture a deterministic RESOURCE_EXHAUSTED."""
    get_faults().raise_point("oom", key=key, batch=int(batch))


def run_adaptive(key: str, batch_size: int, fn) -> Any:
    """Run ``fn(batch_size)`` with OOM-adaptive halving.

    ``fn`` executes the whole workload chunked at the given batch size
    (calling :func:`oom_fault_point` before each device dispatch).  On an
    out-of-memory failure the batch size halves and ``fn`` reruns; the
    size that completes is remembered per ``key`` (process-wide dict + the
    ``rowguard_safe_batch_size`` gauge) so later calls start at the safe
    size instead of re-discovering it.  Other errors propagate untouched;
    an OOM at batch size 1 is unrecoverable and re-raises.
    """
    requested = max(1, int(batch_size))
    bs = safe_batch_size(key, requested)
    reg = get_registry()
    hit_oom = False
    while True:
        try:
            out = fn(bs)
        except Exception as e:  # noqa: BLE001 — filtered to OOM below
            if not is_oom_error(e) or bs <= 1:
                raise
            bs = max(1, bs // 2)
            hit_oom = True
            reg.counter("rowguard_oom_events_total",
                        "RESOURCE_EXHAUSTED caught by adaptive batching",
                        ("key",)).inc(1, key=key)
            logger.warning("rowguard: %s hit RESOURCE_EXHAUSTED; retrying "
                           "with batch size %d", key, bs)
            continue
        if hit_oom:
            # remember only OOM-DISCOVERED ceilings: a small request
            # succeeding at its own (small) size says nothing about the
            # device limit and must not shrink the remembered one
            record_safe_batch(key, bs)
        return out
