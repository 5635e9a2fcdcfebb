"""Resilience of the PyTorch port: deterministic fault injection, the
QoS plane's retry budget, and serving health/drain.

Copies of the JAX package's stdlib-only ``resilience`` modules, imports
aside:

- :mod:`.policy` — :class:`RetryBudget`, the token bucket behind the
  QoS plane's per-tenant shed budgets.
- :mod:`.faults` — the seeded :class:`FaultRegistry` behind
  ``SML_FAULTS``: injectable 429/503s, socket resets, slow responses,
  and mid-write SIGKILL points.
- :mod:`.health` — ``/healthz`` + ``/readyz`` reserved paths, queue-depth
  ``Retry-After`` hints, and the graceful-drain state machine behind
  ``ServingServer.drain()``.

- :mod:`.rowguard` — the row guard's OOM-adaptive batching
  (:func:`~.rowguard.run_adaptive`), which the ONNX runner calls.

The retry policies, deadlines and circuit breakers come over with the
first port module that calls them; the rest of the row guard
(``handleInvalid`` skip/quarantine, poison-row bisection) is ROADMAP A6.
"""

from .faults import (FAULTS_ENV, FAULTS_SEED_ENV, FaultRegistry, FaultRule,
                     PoisonRowError, PreemptionError,
                     ResourceExhaustedError, get_faults)
from .health import HealthState, retry_after_from_depth
from .policy import RetryBudget

__all__ = [
    "RetryBudget",
    "FaultRegistry", "FaultRule", "PreemptionError",
    "ResourceExhaustedError", "PoisonRowError", "get_faults",
    "FAULTS_ENV", "FAULTS_SEED_ENV",
    "HealthState", "retry_after_from_depth",
]
