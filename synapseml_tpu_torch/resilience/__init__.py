"""Resilience of the PyTorch port: deterministic fault injection, retry
policies and deadlines, circuit breakers, serving health/drain, and the
row guard.

Copies of the JAX package's ``resilience`` modules, imports aside:

- :mod:`.policy` — :class:`RetryPolicy` (exponential backoff + full
  jitter, ``Retry-After`` honoring), :class:`Deadline`,
  :func:`parse_retry_after`, and :class:`RetryBudget`, the token bucket
  behind the QoS plane's per-tenant shed budgets.
- :mod:`.breaker` — per-endpoint :class:`CircuitBreaker` (closed → open
  → half-open) exported to ``/metrics``, the process-wide registry
  behind :func:`breaker_for` / :func:`drop_breaker`; the serving router
  and the prefill pool keep one per replica or worker.
- :mod:`.faults` — the seeded :class:`FaultRegistry` behind
  ``SML_FAULTS``: injectable 429/503s, socket resets, slow responses,
  and mid-write SIGKILL points.
- :mod:`.health` — ``/healthz`` + ``/readyz`` reserved paths, queue-depth
  ``Retry-After`` hints, and the graceful-drain state machine behind
  ``ServingServer.drain()``.
- :mod:`.rowguard` — row-level fault isolation for the data plane:
  ``handleInvalid`` (error|skip|quarantine) on every stage, poison-batch
  bisection, the dead-letter :class:`Quarantine` store with ``replay``,
  OOM-adaptive batching, and the shared :class:`ErrorRecord` /
  :class:`HasErrorCol` error schema.  Its names load on first attribute
  access (the module pulls in numpy and the core Dataset).
"""

from .breaker import (CircuitBreaker, CircuitOpenError, breaker_for,
                      drop_breaker)
from .faults import (FAULTS_ENV, FAULTS_SEED_ENV, FaultRegistry, FaultRule,
                     PoisonRowError, PreemptionError,
                     ResourceExhaustedError, get_faults)
from .health import HealthState, retry_after_from_depth
from .policy import (RETRY_STATUSES, Deadline, RetryBudget, RetryPolicy,
                     parse_retry_after)

#: rowguard names resolved on first access (the module imports the core
#: Dataset, whose pipeline imports the row guard)
_ROWGUARD_NAMES = (
    "ErrorRecord", "HasErrorCol", "Quarantine", "QUARANTINE_DIR_ENV",
    "RowGuardError", "StageContractError", "default_quarantine_dir",
    "guard_context", "guarded_fit", "guarded_transform", "is_oom_error",
    "oom_fault_point", "run_adaptive", "safe_batch_size",
)

__all__ = [
    "RetryPolicy", "RetryBudget", "Deadline", "RETRY_STATUSES",
    "parse_retry_after",
    "CircuitBreaker", "CircuitOpenError", "breaker_for", "drop_breaker",
    "FaultRegistry", "FaultRule", "PreemptionError",
    "ResourceExhaustedError", "PoisonRowError", "get_faults",
    "FAULTS_ENV", "FAULTS_SEED_ENV",
    "HealthState", "retry_after_from_depth",
    *_ROWGUARD_NAMES,
]


def __getattr__(name):
    if name in _ROWGUARD_NAMES:
        from . import rowguard
        return getattr(rowguard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
