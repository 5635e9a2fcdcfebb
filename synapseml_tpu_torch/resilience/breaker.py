"""Per-endpoint circuit breaker (closed → open → half-open).

A retrying client pointed at a dead endpoint converts one outage into
``max_retries``x the load, from every caller, forever.  The breaker cuts
that loop: after ``failure_threshold`` consecutive failures the circuit
OPENS and calls fail fast (the client fabricates a 503 without touching
the network); after ``cooldown_s`` it goes HALF-OPEN and admits a bounded
number of probe calls — one success recloses it, one failure reopens it.

The PyTorch port's copy of the JAX package's ``resilience/breaker.py``
(stdlib only).  State is exported live to the port's telemetry registry
(visible at ``GET /metrics`` on every
:class:`~synapseml_tpu_torch.serving.ServingServer`):

- ``resilience_breaker_state{breaker}`` — 0 closed, 1 open, 2 half-open
- ``resilience_breaker_transitions_total{breaker, to}``
- ``resilience_breaker_rejected_total{breaker}`` — fast-failed calls
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..telemetry import get_registry

__all__ = ["CircuitBreaker", "CircuitOpenError", "breaker_for",
           "drop_breaker"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitOpenError(RuntimeError):
    """Raised by call sites that prefer an exception to a synthetic 503."""

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(f"circuit {name!r} open; retry after "
                         f"{retry_after_s:.1f}s")
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe window.

    ``clock`` is injectable for tests (defaults to ``time.monotonic``).
    Thread-safe: serving loops and transformer thread pools share one
    breaker per endpoint.
    """

    def __init__(self, name: str = "default", failure_threshold: int = 5,
                 cooldown_s: float = 30.0, half_open_max_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_max_probes = int(half_open_max_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        #: set by drop_breaker: a caller still holding this object keeps
        #: a working state machine but stops writing /metrics, so a late
        #: transition cannot resurrect the removed gauge row (or fight a
        #: successor breaker re-registered under the same name)
        self._dropped = False
        reg = get_registry()
        self._g_state = reg.gauge(
            "resilience_breaker_state",
            "0 closed, 1 open, 2 half-open", ("breaker",))
        self._c_trans = reg.counter(
            "resilience_breaker_transitions_total",
            "state transitions", ("breaker", "to"))
        self._c_rejected = reg.counter(
            "resilience_breaker_rejected_total",
            "calls fast-failed while open", ("breaker",))
        self._g_state.set(0, breaker=self.name)

    # -- state machine (all transitions under the lock) --------------------
    def _transition(self, to: str) -> None:
        self._state = to
        if not self._dropped:
            self._g_state.set(_STATE_CODE[to], breaker=self.name)
            self._c_trans.inc(1, breaker=self.name, to=to)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open(self._clock())
            return self._state

    def _maybe_half_open(self, now: float) -> None:
        if self._state == OPEN and now - self._opened_at >= self.cooldown_s:
            self._transition(HALF_OPEN)
            self._probes = 0

    def retry_after_s(self) -> float:
        """Remaining cooldown (0 when not open) — what a fast-failed
        caller should put in its synthetic Retry-After."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._opened_at + self.cooldown_s - self._clock())

    def allow(self) -> bool:
        """May this call proceed?  False ⇒ fail fast (counted)."""
        with self._lock:
            now = self._clock()
            self._maybe_half_open(now)
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probes < self.half_open_max_probes:
                    self._probes += 1
                    return True
                self._c_rejected.inc(1, breaker=self.name)
                return False
            self._c_rejected.inc(1, breaker=self.name)
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh cooldown
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition(OPEN)

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._probes = 0
            if self._state != CLOSED:
                self._transition(CLOSED)


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(endpoint: str, failure_threshold: int = 5,
                cooldown_s: float = 30.0,
                half_open_max_probes: int = 1) -> CircuitBreaker:
    """Get-or-create the process-wide breaker for ``endpoint`` (clients
    hitting the same host share failure state, which is the point)."""
    with _breakers_lock:
        b = _breakers.get(endpoint)
        if b is None:
            b = CircuitBreaker(endpoint, failure_threshold, cooldown_s,
                               half_open_max_probes)
            _breakers[endpoint] = b
        return b


def drop_breaker(endpoint: str) -> None:
    """Forget the process-wide breaker for ``endpoint`` and remove its
    live state series from /metrics (transition/rejection counters stay —
    they are history).  For surfaces whose membership shrinks: an
    elastic routing-table refresh must not leak one breaker (plus a
    phantom gauge row) per departed replica forever.  No-op when the
    endpoint has no breaker."""
    with _breakers_lock:
        b = _breakers.pop(endpoint, None)
    if b is not None:
        # under the breaker's own lock: an in-flight _transition that
        # already read _dropped == False must finish its gauge write
        # BEFORE the row is removed, or the removal loses the race and
        # the phantom row resurrects permanently
        with b._lock:
            b._dropped = True
            b._g_state.remove(breaker=endpoint)
