"""Composable retry policies, propagating deadlines and the retry budget.

The port's copy of the JAX package's ``resilience/policy.py``:

- **exponential backoff with full jitter** (:class:`RetryPolicy`) —
  delay for attempt k is drawn uniformly from
  ``[0, min(max_backoff, base * mult^k)]``.
- **Retry-After honoring** (:func:`parse_retry_after`) — a 429/503
  carrying ``Retry-After`` names the server's own estimate; the policy
  sleeps at least that long (capped) instead of guessing.
- **retry budgets** (:class:`RetryBudget`) — a token bucket shared
  across calls bounds the retry *amplification* of an outage; the QoS
  plane's per-tenant shed budgets are one.
- **deadlines** (:class:`Deadline`) — absolute remaining time carried
  through nested calls, clamped at 0 when expired.

Consumers in the port: :class:`~synapseml_tpu_torch.serving.continuous.
ContinuousClient` (reconnect backoff) and the QoS plane (budgets).
Everything here is stdlib-only; sleeps route through the fault
registry's recorded :meth:`~synapseml_tpu_torch.resilience.faults.
FaultRegistry.sleep`, so tests assert the schedule itself.
"""

from __future__ import annotations

import email.utils
import random
import threading
import time
from typing import Iterable, List, Optional, Sequence

from .faults import get_faults

__all__ = ["Deadline", "RetryBudget", "RetryPolicy", "RETRY_STATUSES",
           "parse_retry_after"]

#: statuses worth retrying (reference: HTTPClients.scala:65)
RETRY_STATUSES = (429, 500, 502, 503, 504)


class Deadline:
    """Absolute point in time that propagates through nested calls.

    ``remaining()`` is clamped at 0 — an expired deadline yields a valid
    zero timeout, never a negative one (the bug class this replaces:
    ``f.result(timeout=-3)`` raising instead of timing out).
    """

    __slots__ = ("_at",)

    def __init__(self, seconds: float, _absolute: Optional[float] = None):
        self._at = (_absolute if _absolute is not None
                    else time.monotonic() + float(seconds))

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(seconds)

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self._at

    def remaining(self) -> float:
        """Seconds left, clamped to >= 0."""
        return max(0.0, self._at - time.monotonic())

    def limit(self, timeout: Optional[float]) -> float:
        """``timeout`` capped by the remaining time (propagation: a
        nested call may use less than the caller's patience, never
        more)."""
        r = self.remaining()
        return r if timeout is None else min(float(timeout), r)

    def union(self, other: Optional["Deadline"]) -> "Deadline":
        """The tighter of two deadlines."""
        if other is None:
            return self
        return Deadline(0.0, _absolute=min(self._at, other._at))

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


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


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """``Retry-After`` header → seconds (int/float seconds form or
    HTTP-date form; None when absent/unparseable)."""
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        when = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    import datetime
    now = datetime.datetime.now(when.tzinfo or datetime.timezone.utc)
    return max(0.0, (when - now).total_seconds())


class RetryPolicy:
    """Exponential-backoff-with-full-jitter retry policy.

    ``ladder_s`` (a fixed per-attempt delay sequence) overrides the
    exponential curve — the compatibility path for the old
    ``backoffs_ms`` ladder; jitter still applies unless ``jitter='none'``.
    """

    def __init__(self, max_retries: int = 3, base_s: float = 0.1,
                 max_backoff_s: float = 10.0, multiplier: float = 2.0,
                 jitter: str = "full",
                 statuses: Sequence[int] = RETRY_STATUSES,
                 honor_retry_after: bool = True,
                 retry_after_cap_s: float = 60.0,
                 budget: Optional[RetryBudget] = None,
                 ladder_s: Optional[Iterable[float]] = None,
                 seed: Optional[int] = None):
        if jitter not in ("full", "none"):
            raise ValueError(f"jitter must be 'full' or 'none', got {jitter!r}")
        self.max_retries = int(max_retries)
        self.base_s = float(base_s)
        self.max_backoff_s = float(max_backoff_s)
        self.multiplier = float(multiplier)
        self.jitter = jitter
        self.statuses = tuple(statuses)
        self.honor_retry_after = honor_retry_after
        self.retry_after_cap_s = float(retry_after_cap_s)
        self.budget = budget
        self.ladder_s: Optional[List[float]] = (
            list(float(x) for x in ladder_s) if ladder_s is not None else None)
        self._rng = random.Random(seed)

    @classmethod
    def from_ladder(cls, backoffs_ms: Sequence[int], retries: int,
                    **kw) -> "RetryPolicy":
        """The old fixed-ladder shape (`backoffs_ms`), unjittered — keeps
        pre-policy call sites' timing byte-compatible."""
        return cls(max_retries=retries,
                   ladder_s=[b / 1000.0 for b in backoffs_ms],
                   jitter="none", **kw)

    def retryable(self, status: int) -> bool:
        """Retry-worthy response: a transport failure (status 0) or one
        of the configured server-side statuses."""
        return status == 0 or status in self.statuses

    def acquire_retry(self) -> bool:
        """Spend one retry token (True when no budget is configured)."""
        return self.budget is None or self.budget.try_spend()

    def backoff_s(self, attempt: int,
                  retry_after_s: Optional[float] = None) -> float:
        """Delay before retry number ``attempt`` (0-based).

        Full jitter draws uniformly from [0, cap]; a server-provided
        ``Retry-After`` (already parsed to seconds) is a FLOOR on the
        delay — the server knows its own recovery better than our curve —
        capped at ``retry_after_cap_s``.
        """
        if self.ladder_s is not None:
            idx = min(attempt, len(self.ladder_s) - 1) if self.ladder_s else 0
            cap = self.ladder_s[idx] if self.ladder_s else 0.0
        else:
            cap = min(self.max_backoff_s,
                      self.base_s * (self.multiplier ** attempt))
        delay = self._rng.uniform(0.0, cap) if self.jitter == "full" else cap
        if self.honor_retry_after and retry_after_s is not None:
            delay = max(delay, min(retry_after_s, self.retry_after_cap_s))
        return delay

    def sleep(self, seconds: float, site: str = "retry.backoff") -> None:
        """Recorded sleep (see fault registry)."""
        get_faults().sleep(seconds, site=site)

    def __repr__(self) -> str:
        shape = (f"ladder={self.ladder_s}" if self.ladder_s is not None
                 else f"base={self.base_s}s x{self.multiplier} "
                      f"cap={self.max_backoff_s}s jitter={self.jitter}")
        return f"RetryPolicy(max_retries={self.max_retries}, {shape})"
