"""Multi-tenant QoS: the scheduling-policy core of the serving plane.

Millions of users are never one uniform queue.  The decode loop's
original FIFO admits whoever arrived first, so one flooding tenant
degrades every other tenant's TTFT and can starve the prefix/KV tier —
and the aggregate SLO percentiles hide exactly who did it.  This module
is the *policy* half (the *mechanism* — ``SlotEngine.preempt()``/
``resume()`` tickets — is token-exact-pinned):

- **Priority classes** — each tenant (or request) carries an integer
  priority; higher admits first, and only a STRICTLY higher class may
  preempt a running slot.  Within one class, admission is weighted-fair.
- **Token-weighted deficit round robin** — each tenant holds a deficit
  counter refilled per admission round by its WEIGHT SHARE of the
  tokens the whole engine committed since the last round (virtual-time
  DRR: refills track real throughput, so a fast-ticking admission loop
  cannot re-top every tenant between token commits and erase the
  imbalance) and charged by COMMITTED tokens from the engine's
  per-slot accounting (token-weighted, not request-weighted: a
  speculative engine commits several tokens per slot per step, so
  request counts and token shares differ — charging committed tokens
  is what makes the share converge to the configured weights under
  spec decode too).  Deficits are clamped to ``±burst_quanta`` quanta
  of ``quantum_tokens x weight``, so an idle tenant cannot bank
  unbounded credit and a flooding one cannot dig an unbounded hole.
- **Preemption verdicts** — under queue pressure from a higher class,
  :meth:`QosScheduler.preemption_victim` names the lowest-priority,
  longest-remaining running slot; the decode loop evicts it through the
  preempt/resume ticket path and auto-resumes it token-exactly when pressure
  clears.  Verdicts are rate-limited (``preempt_min_interval_s``) so a
  flapping queue cannot thrash the arena.
- **Per-tenant shed budgets** — a tenant's token rate rides the
  token-bucket :class:`~synapseml_tpu_torch.resilience.policy.RetryBudget`;
  an over-budget tenant sheds 429-style with a computed ``Retry-After``
  while every other tenant is untouched.

Deliberately torch-free with an injectable monotonic ``clock`` — the
scheduler is pure bookkeeping and its tests (``tests/test_qos.py``)
drive admission rounds, budget refills, and preemption cooldowns on a
fake clock with no engine at all.

See docs/api/serving.md "Multi-tenant QoS".
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from ..resilience.policy import RetryBudget

__all__ = ["DEFAULT_TENANT", "DEFAULT_PRIORITY", "OVERFLOW_TENANT",
           "TenantPolicy", "QosScheduler", "jain_fairness", "QOS_METRICS"]

#: QoS-plane metric names (the metric-hygiene sweep holds every one to
#: the docs bar, like GANG/SLO/KVTIER_METRICS).  The per-tenant
#: ``tenant`` label additionally rides the existing ``llm_sheds_total``
#: / ``llm_admissions_total`` / ``llm_evictions_total`` counters.
QOS_METRICS = frozenset({"llm_qos_preemptions_total"})

#: the tenant every request without an explicit id belongs to — all
#: pre-QoS traffic lands here, so a single-tenant deployment behaves
#: exactly like the old FIFO (one tenant's DRR order IS arrival order)
DEFAULT_TENANT = "default"

#: the priority class of a request that declares none
DEFAULT_PRIORITY = 1

#: the attribution label a request rejected by the decode loop's
#: dynamic-tenant cap sheds under — tenant ids are client-controlled
#: and unauthenticated, so per-tenant planes/labels/budgets are only
#: materialised for registered tenants plus a bounded number of
#: dynamic ones; everything past the cap is rejected and counted here,
#: keeping metric/SLO cardinality bounded no matter how many ids a
#: client cycles through
OVERFLOW_TENANT = "~other"


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's QoS contract.

    ``weight`` sets the tenant's fair share of committed tokens within
    its priority class; ``priority`` its class (higher admits first and
    may preempt strictly lower classes).  ``rate_tokens_per_s`` arms the
    token-bucket shed budget (None = unlimited); ``burst_tokens``
    is the bucket capacity (default: 4 seconds of refill)."""
    weight: float = 1.0
    priority: int = DEFAULT_PRIORITY
    rate_tokens_per_s: Optional[float] = None
    burst_tokens: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("weight must be > 0")
        if self.rate_tokens_per_s is not None and self.rate_tokens_per_s <= 0:
            raise ValueError("rate_tokens_per_s must be > 0 (or None)")


class _ClockedBudget(RetryBudget):
    """The token bucket, on the scheduler's injectable clock (the
    base class reads ``time.monotonic`` directly, which a fake-clock
    test cannot advance)."""

    def __init__(self, capacity: float, refill_per_s: float,
                 clock: Callable[[], float]):
        super().__init__(capacity, refill_per_s)
        self._clock = clock
        self._last = clock()

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens


def jain_fairness(shares: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant shares: 1.0 = perfectly
    even, 1/n = one tenant holds everything.  NaN-free: empty or
    all-zero input scores 1.0 (nothing was allocated unfairly)."""
    xs = [float(s) for s in shares if s >= 0]
    total = sum(xs)
    if not xs or total <= 0:
        return 1.0
    sq = sum(x * x for x in xs)
    return (total * total) / (len(xs) * sq) if sq > 0 else 1.0


class QosScheduler:
    """Token-weighted DRR + priority classes + shed budgets (see module
    docstring).  Thread-safe; every method is O(waiting) or better.

    Scheduled items are duck-typed: anything with ``.tenant`` (str) and
    ``.priority`` (int) attributes schedules; preemption candidates
    additionally need ``.remaining`` (tokens left in budget).  The
    decode loop's ``_DecodeSeq`` satisfies all three."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 quantum_tokens: float = 32.0, burst_quanta: float = 8.0,
                 preempt_min_interval_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self._policies: Dict[str, TenantPolicy] = dict(policies or {})
        self.default_policy = default_policy or TenantPolicy()
        self.quantum_tokens = float(quantum_tokens)
        self.burst_quanta = float(burst_quanta)
        self.preempt_min_interval_s = float(preempt_min_interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._deficit: Dict[str, float] = {}
        self._committed: Dict[str, int] = {}
        #: total committed tokens at the last admission round — the
        #: virtual-time anchor the per-round refill is computed from
        self._last_total = 0
        self._budgets: Dict[str, Optional[_ClockedBudget]] = {}
        self._last_preempt = float("-inf")
        #: total preemption verdicts issued (the bench reads this)
        self.preemptions = 0
        #: total budget sheds by tenant (attribution beside the metric)
        self.budget_sheds: Dict[str, int] = {}

    # -- policies ----------------------------------------------------------
    def policy(self, tenant: str) -> TenantPolicy:
        return self._policies.get(tenant, self.default_policy)

    def set_policy(self, tenant: str, policy: TenantPolicy) -> None:
        with self._lock:
            self._policies[tenant] = policy
            self._budgets.pop(tenant, None)   # re-arm from the new rate

    def is_registered(self, tenant: str) -> bool:
        """True when ``tenant`` carries an explicit :class:`TenantPolicy`
        (the decode loop's dynamic-tenant cap never applies to these)."""
        with self._lock:
            return tenant in self._policies

    def priority_of(self, item: Any) -> int:
        """The item's effective class: its own ``.priority`` when
        declared, else its tenant's policy."""
        p = getattr(item, "priority", None)
        return int(p) if p is not None else self.policy(item.tenant).priority

    def _cap(self, tenant: str) -> float:
        return self.quantum_tokens * self.policy(tenant).weight \
            * self.burst_quanta

    # -- deficit round robin -----------------------------------------------
    def admission_order(self, waiting: Sequence[Any],
                        cost: Optional[Callable[[Any], float]] = None
                        ) -> List[Any]:
        """One admission round: refill each waiting tenant's deficit by
        its weight share of the tokens committed SINCE THE LAST ROUND
        (virtual-time DRR — total refill equals total charge in steady
        state, so deficits measure each tenant's distance from its fair
        share instead of saturating at the burst cap when the loop
        ticks faster than tokens commit), clamp to the burst cap, then
        emit the round's admission order — priority classes strictly
        descending; within a class, a DRR interleave that repeatedly
        picks the tenant with the largest weight-normalized scratch
        deficit and debits it by the picked item's estimated cost
        (``cost(item)``, default ``item.max_new``), so one tenant
        cannot sweep every free slot in a single round.  FIFO order is
        preserved within a tenant; a single-tenant queue comes back in
        arrival order.  The REAL deficit is only ever charged by
        :meth:`charge` (committed tokens) — the scratch debit exists
        purely to interleave this round."""
        if not waiting:
            return []
        if cost is None:
            cost = lambda it: float(getattr(it, "max_new", 1) or 1)  # noqa: E731
        with self._lock:
            tenants = []
            for it in waiting:
                if it.tenant not in tenants:
                    tenants.append(it.tenant)
            total = sum(self._committed.values())
            delta = float(total - self._last_total)
            self._last_total = total
            wsum = sum(self.policy(t).weight for t in tenants)
            scratch: Dict[str, float] = {}
            for t in tenants:
                cap = self._cap(t)
                refilled = self._deficit.get(t, 0.0) \
                    + delta * self.policy(t).weight / wsum
                self._deficit[t] = max(-cap, min(cap, refilled))
                scratch[t] = self._deficit[t]
            tiers: Dict[int, Dict[str, deque]] = {}
            for i, it in enumerate(waiting):
                tiers.setdefault(self.priority_of(it), {}) \
                    .setdefault(it.tenant, deque()).append(it)
            order: List[Any] = []
            for prio in sorted(tiers, reverse=True):
                queues = tiers[prio]
                while queues:
                    t = max(queues,
                            key=lambda q: (scratch[q]
                                           / self.policy(q).weight, q))
                    item = queues[t].popleft()
                    scratch[t] -= cost(item)
                    order.append(item)
                    if not queues[t]:
                        del queues[t]
            return order

    def charge(self, tenant: str, tokens: int = 1) -> None:
        """Debit COMMITTED tokens against the tenant's deficit (the
        engine's per-slot accounting calls this once per step event —
        a speculative step charges every token it committed)."""
        with self._lock:
            cap = self._cap(tenant)
            self._deficit[tenant] = max(
                -cap, self._deficit.get(tenant, 0.0) - float(tokens))
            self._committed[tenant] = \
                self._committed.get(tenant, 0) + int(tokens)

    def deficit(self, tenant: str) -> float:
        with self._lock:
            return self._deficit.get(tenant, 0.0)

    def committed(self, tenant: str) -> int:
        with self._lock:
            return self._committed.get(tenant, 0)

    def committed_share(self) -> Dict[str, float]:
        """Each tenant's fraction of all committed tokens — the
        weighted-fairness convergence surface the bench pins."""
        with self._lock:
            total = sum(self._committed.values())
            if not total:
                return {t: 0.0 for t in self._committed}
            return {t: n / total for t, n in self._committed.items()}

    # -- shed budgets ------------------------------------------------------
    def _budget(self, tenant: str) -> Optional[_ClockedBudget]:
        if tenant not in self._budgets:
            pol = self.policy(tenant)
            if pol.rate_tokens_per_s is None:
                self._budgets[tenant] = None
            else:
                cap = pol.burst_tokens if pol.burst_tokens is not None \
                    else 4.0 * pol.rate_tokens_per_s
                self._budgets[tenant] = _ClockedBudget(
                    cap, pol.rate_tokens_per_s, self.clock)
        return self._budgets[tenant]

    def shed_verdict(self, tenant: str,
                     tokens: float = 1.0) -> Tuple[bool, float]:
        """Admission-time budget check: ``(admit, retry_after_s)``.
        ``admit=False`` means the tenant's token bucket cannot cover the
        request's budget — shed it 429-style; ``retry_after_s`` is when
        the bucket will have refilled enough (the server's own recovery
        estimate, exactly what ``Retry-After`` is for).

        A request costing MORE than the bucket's whole capacity is
        charged the capacity instead of its true cost: a full bucket
        admits it (draining to empty), so an oversized-but-legitimate
        request is throttled like everything else rather than 429'd
        forever with a Retry-After that can never come true (capacity
        is the most a refill can ever restore, so ``cost > capacity``
        would otherwise be permanently unadmittable)."""
        with self._lock:
            budget = self._budget(tenant)
        if budget is None:
            return True, 0.0
        want = min(float(tokens), budget.capacity)
        if budget.try_spend(want):
            return True, 0.0
        pol = self.policy(tenant)
        rate = pol.rate_tokens_per_s or 1.0
        retry_after = max(0.0, (want - budget.tokens()) / rate)
        with self._lock:
            self.budget_sheds[tenant] = self.budget_sheds.get(tenant, 0) + 1
        return False, retry_after

    # -- preemption --------------------------------------------------------
    def preemption_victim(self, demand_priority: int,
                          active: Iterable[Any]) -> Optional[Any]:
        """The slot to evict for a waiting class-``demand_priority``
        request: the LOWEST-priority, LONGEST-remaining active item
        whose class is STRICTLY below the demand — or None (nothing
        preemptible, or the anti-thrash cooldown has not elapsed).
        The caller routes the verdict through the preempt/resume ticket path,
        flight-records it with the justifying pressure snapshot, and
        calls :meth:`commit_preemption` ONLY once the engine actually
        issued a ticket — a verdict the engine declined (``preempt``
        returned None) neither counts as a preemption nor burns the
        cooldown window, so a legitimate eviction is never delayed by
        a failed attempt."""
        now = self.clock()
        with self._lock:
            if now - self._last_preempt < self.preempt_min_interval_s:
                return None
        cands = [a for a in active
                 if self.priority_of(a) < int(demand_priority)]
        if not cands:
            return None
        return min(cands, key=lambda a: (self.priority_of(a),
                                         -float(getattr(a, "remaining",
                                                        0.0)),
                                         id(a)))

    def commit_preemption(self) -> None:
        """Confirm a :meth:`preemption_victim` verdict went through the
        engine (a ticket was issued): count it and arm the anti-thrash
        cooldown.  Kept separate from the verdict so an eviction the
        engine declined rolls back to 'never happened'."""
        with self._lock:
            self._last_preempt = self.clock()
            self.preemptions += 1

    # -- attribution -------------------------------------------------------
    def pressure_snapshot(self, waiting: Sequence[Any],
                          free_slots: int) -> Dict[str, Any]:
        """The justifying evidence a preemption verdict is
        flight-recorded with: who is waiting at which class, how many
        slots are free, and every known tenant's deficit."""
        by_prio: Dict[int, int] = {}
        for it in waiting:
            p = self.priority_of(it)
            by_prio[p] = by_prio.get(p, 0) + 1
        with self._lock:
            deficits = {t: round(d, 3) for t, d in self._deficit.items()}
        return {"free_slots": int(free_slots),
                "waiting": int(len(waiting)),
                "waiting_by_priority": {str(k): v for k, v
                                        in sorted(by_prio.items())},
                "deficits": deficits}

    def reset(self) -> None:
        with self._lock:
            self._deficit.clear()
            self._committed.clear()
            self._last_total = 0
            self._budgets.clear()
            self._last_preempt = float("-inf")
            self.preemptions = 0
            self.budget_sheds = {}
