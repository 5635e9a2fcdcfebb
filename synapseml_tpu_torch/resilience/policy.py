"""The token-bucket retry budget behind the QoS plane's per-tenant shed
budgets (:mod:`synapseml_tpu_torch.serving.qos`).

A copy of :class:`RetryBudget` from the JAX package's
``resilience/policy.py``.  Its retry policies, deadlines and
``Retry-After`` parser have no caller in the port yet and come over
with the first module that uses them.
"""

from __future__ import annotations

import threading
import time

__all__ = ["RetryBudget"]


class RetryBudget:
    """Token-bucket retry budget shared across calls.

    Each retry spends one token; tokens refill at ``refill_per_s`` up to
    ``capacity``.  During an outage the bucket empties and further calls
    fail fast instead of amplifying load by ``max_retries``x — the
    classic retry-budget pattern (e.g. Finagle / gRPC service configs).
    """

    def __init__(self, capacity: float = 10.0, refill_per_s: float = 1.0):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._last) * self.refill_per_s)
        self._last = now

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(time.monotonic())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            self._refill(time.monotonic())
            return self._tokens
