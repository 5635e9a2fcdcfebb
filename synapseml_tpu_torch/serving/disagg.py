"""Disaggregated prefill/decode: a prefill pool with a crash-tolerant
KV handoff plane.

The PyTorch port of the JAX package's ``serving/disagg.py``.
DistServe-style: prefill is compute-bound (one big batched forward over
the whole prompt), decode is memory-bound (one token per step per slot)
— colocating them makes each phase's latency hostage to the other's
load.  This module gives prefill its own pool of
dedicated replicas whose finished K/V ships to the decode replica as a
CRC-framed transfer (:func:`~synapseml_tpu_torch.models.llm.kvtier.
pack_kv_transfer`) adopted through the decode engine's host arena, so
each phase scales off its own ``@phase=`` SLO plane.

The robustness contract — the reason this lives beside ``resilience/``
rather than being a plain RPC:

- every handoff runs under a **lease**: a :class:`~synapseml_tpu_torch.
  resilience.policy.Deadline` bounds the whole attempt, so a dead (or
  wedged) prefill replica can never strand the decode slot waiting;
- the transfer carries (session, tenant, token-prefix hash, CRC per
  row): a flipped byte, a torn body, or a frame carrying the wrong
  prompt is detected BEFORE any K/V is adopted;
- worker calls run under :class:`~synapseml_tpu_torch.resilience.
  policy.RetryPolicy` + one :class:`~synapseml_tpu_torch.resilience.
  breaker.CircuitBreaker` per worker, so a flapping prefill replica is ejected
  from rotation instead of absorbing every lease;
- delivery is **idempotent**: adoption is ``arena.put()`` (supersede
  semantics), so a duplicated or re-sent transfer refreshes the entry
  instead of corrupting it;
- and every failure mode lands in the same place — **local colocated
  prefill on the decode replica** — counted by outcome in
  ``disagg_handoffs_total`` and flight-recorded.  A disaggregated turn
  is token-exact vs the colocated reference; the worst case is a cold
  local prefill, never a wrong token.

Degradation table (the tier-1-pinned outcomes):

==============  =========================================================
``ok``          K/V adopted into the decode arena; the decode engine's
                admit restores it token-exactly (warm TTFT)
``corrupt``     a row CRC / header CRC / prefix-hash check failed —
                nothing adopted, local prefill
``timeout``     the worker kept failing until the lease expired, or the
                transfer was dropped in flight (the receiver can only
                observe a drop as its deadline expiring)
``expired``     the transfer arrived after the lease deadline (a slow
                wire) — stale K/V is refused, local prefill
``fallback``    no pool / pool empty / every breaker open / prompt too
                short / retries exhausted inside the lease — handoff
                not attempted or abandoned early, local prefill
==============  =========================================================

Fault sites: ``disagg.prefill`` (the worker call — arm ``kill`` for the
replica-death chaos soak, ``error`` for retry/breaker paths) and
``disagg.transfer`` (the wire — arm ``corrupt``/``drop``/``delay``).
Both pass ``phase="prefill"`` so ``phase=``-gated rules target this
plane alone.

A worker's engine lives on the card it was built for and never moves;
a failed handoff is a local prefill on the decode replica's own card.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..resilience import Deadline, RetryPolicy, breaker_for, drop_breaker
from ..resilience.faults import get_faults
from ..telemetry import get_registry
from ..telemetry.flight import record as flight_record

__all__ = ["DISAGG_METRICS", "HANDOFF_OUTCOMES", "PrefillPool",
           "PrefillWorker"]

#: every handoff resolves to exactly one of these (no silent path)
HANDOFF_OUTCOMES = ("ok", "corrupt", "timeout", "expired", "fallback")

#: every metric this plane registers — held to the docs bar by the
#: metric-hygiene sweep, like GANG_METRICS / KVTIER_METRICS
DISAGG_METRICS = (
    "disagg_handoffs_total",
    "disagg_handoff_latency_seconds",
    "disagg_pool_replicas",
)


def _disagg_metrics():
    reg = get_registry()
    return (
        reg.counter(
            "disagg_handoffs_total",
            "prefill→decode KV handoffs by outcome (every non-ok "
            "outcome fell back to local colocated prefill)",
            ("pool", "outcome")),
        reg.histogram(
            "disagg_handoff_latency_seconds",
            "wall-clock of one handoff attempt, lease start to outcome",
            ("pool",),
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0)),
        reg.gauge(
            "disagg_pool_replicas",
            "prefill workers currently in the pool", ("pool",)),
    )


class PrefillWorker:
    """One dedicated prefill replica: wraps a slot engine (typically a
    few big-bucket slots, built from the SAME model object as the decode
    engines) and turns a prompt into extractable K/V rows.

    ``prefill`` admits the prompt with ``max_new_tokens=1`` — the slot
    engine's admit path prefills the prompt, emits one token, and
    auto-retires, after which the slot's K/V rows still hold the
    prompt's span — then copies the per-layer rows ``layer["k"][slot,
    :span]`` out of the cache (``(span, kv_heads, d_head)`` each, the
    cache's dtype, on the engine's device: they reach the host only when
    the pool frames them).  The copy is taken under the worker's lock,
    so a concurrent handoff's admit cannot overwrite the slot first."""

    def __init__(self, engine: Any):
        self.engine = engine
        self._lock = threading.Lock()

    def prefill(self, ids, tenant: str = "default"
                ) -> List[Dict[str, Any]]:
        ids = [int(t) for t in ids]
        span = len(ids)
        with self._lock:
            res = self.engine.admit(ids, 1, tenant=tenant)
            if res is None:
                raise RuntimeError("every slot of the prefill engine is "
                                   "busy")
            slot = int(res.slot)
            return [{"k": layer["k"][slot, :span].clone(),
                     "v": layer["v"][slot, :span].clone()}
                    for layer in self.engine.cache]


class PrefillPool:
    """The prefill side of the handoff plane (see module docstring).

    ``workers`` are :class:`PrefillWorker`-shaped objects (anything
    with ``prefill(ids, tenant=) -> rows``); ``factory`` (→ one new
    worker) arms :meth:`grow`, making the pool an autoscaler actuator
    with the ``ServingReplicaSet`` duck type (``replica_count`` /
    ``grow`` / ``shrink`` / ``warming_count``), so one
    :class:`~synapseml_tpu_torch.serving.autoscaler.Autoscaler` per phase
    scales prefill and decode independently off their ``@phase=``
    planes.

    Call :meth:`bind` to attach the DECODE replica's arena (where
    adopted K/V lands) and the prefill-phase SLO plane; until bound,
    every handoff is a counted ``fallback``.
    """

    def __init__(self, workers: Optional[List[Any]] = None,
                 factory: Optional[Callable[[], Any]] = None,
                 name: str = "disagg",
                 lease_s: float = 5.0,
                 retry: Optional[RetryPolicy] = None,
                 failure_threshold: int = 3, cooldown_s: float = 5.0,
                 min_prompt: int = 1):
        self.name = str(name)
        self.lease_s = float(lease_s)
        self.retry = retry if retry is not None else RetryPolicy(
            max_retries=2, base_s=0.01, max_backoff_s=0.25)
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.min_prompt = int(min_prompt)
        self.arena: Any = None
        self.slo: Any = None
        self._factory = factory
        self._lock = threading.Lock()
        self._workers: List[Any] = list(workers or [])
        self._rr = 0
        self._inflight = 0
        self._m_handoffs, self._m_latency, self._g_replicas = \
            _disagg_metrics()
        self._g_replicas.set(len(self._workers), pool=self.name)

    # -- pool membership (the autoscaler actuator surface) -----------------
    def _breaker_key(self, idx: int) -> str:
        return f"prefill:{self.name}:{idx}"

    def _breaker(self, idx: int):
        return breaker_for(self._breaker_key(idx),
                           failure_threshold=self.failure_threshold,
                           cooldown_s=self.cooldown_s)

    def replica_count(self) -> int:
        with self._lock:
            return len(self._workers)

    def warming_count(self) -> int:
        return 0

    def grow(self, n: int = 1) -> int:
        """Add up to ``n`` factory-built workers; returns how many."""
        if self._factory is None:
            return 0
        added = 0
        for _ in range(max(0, int(n))):
            worker = self._factory()
            with self._lock:
                self._workers.append(worker)
                count = len(self._workers)
            added += 1
        if added:
            self._g_replicas.set(count, pool=self.name)
            flight_record("disagg_pool", pool=self.name, op="grow",
                          replicas=count)
        return added

    def shrink(self, n: int = 1) -> int:
        """Retire up to ``n`` workers from the tail (their breakers are
        released — a pool resizing every few minutes must not leak one
        breaker per index it ever had)."""
        removed = 0
        with self._lock:
            for _ in range(max(0, int(n))):
                if not self._workers:
                    break
                self._workers.pop()
                drop_breaker(self._breaker_key(len(self._workers)))
                removed += 1
            count = len(self._workers)
            if self._rr >= max(count, 1):
                self._rr = 0
        if removed:
            self._g_replicas.set(count, pool=self.name)
            flight_record("disagg_pool", pool=self.name, op="shrink",
                          replicas=count)
        return removed

    # -- wiring ------------------------------------------------------------
    def bind(self, api_path: str, arena: Any,
             ttft_slo_s: Optional[float] = None,
             slo_store: Any = None) -> None:
        """Attach the decode replica's host arena (handoff destination)
        and create this pool's ``@phase=prefill`` SLO plane for
        ``api_path`` (``/sloz`` serves it; the prefill autoscaler scales
        off it).  ``ttft_slo_s`` declares the prefill-latency objective
        — for this plane "ttft" is the handoff wall-clock, prompt
        arrival to K/V adopted."""
        from ..telemetry.slo import get_slo_store, phase_plane_name
        self.arena = arena
        store = slo_store if slo_store is not None else get_slo_store()
        self.slo = store.window(phase_plane_name(api_path, "prefill"))
        if ttft_slo_s:
            self.slo.set_objective("ttft", float(ttft_slo_s))

    # -- the handoff -------------------------------------------------------
    def _pick(self) -> Optional[int]:
        """Next worker index whose breaker admits a call (None when the
        pool is empty or every breaker refuses)."""
        with self._lock:
            n = len(self._workers)
            for i in range(n):
                idx = (self._rr + i) % n
                if self._breaker(idx).allow():
                    self._rr = (idx + 1) % n
                    return idx
        return None

    def handoff(self, ids, session: Optional[str] = None,
                tenant: str = "default") -> str:
        """Run one prompt through the pool and adopt the K/V into the
        bound decode arena.  Returns the outcome (one of
        :data:`HANDOFF_OUTCOMES`) — NEVER raises: every failure mode is
        an attributed fallback to local prefill, and the caller admits
        the request into its own engine regardless (an ``ok`` outcome
        just means the admit will warm-restore instead of prefill)."""
        t0 = time.monotonic()
        with self._lock:
            self._inflight += 1
            inflight, n = self._inflight, len(self._workers)
        if self.slo is not None:
            self.slo.count("admitted")
            self.slo.observe_occupancy(min(1.0, inflight / max(1, n)))
        try:
            outcome = self._handoff(ids, session, tenant)
        except Exception:  # noqa: BLE001 — degrade, never break admission
            outcome = "fallback"
        finally:
            with self._lock:
                self._inflight -= 1
        dt = time.monotonic() - t0
        self._m_handoffs.inc(1, pool=self.name, outcome=outcome)
        self._m_latency.observe(dt, pool=self.name)
        if self.slo is not None:
            self.slo.observe_ttft(dt)
            self.slo.count("retired" if outcome == "ok" else "shed")
        flight_record("disagg_handoff", pool=self.name, outcome=outcome,
                      tenant=tenant, session=session,
                      tokens=int(len(ids)))
        return outcome

    def _handoff(self, ids, session: Optional[str],
                 tenant: str) -> str:
        ids = [int(t) for t in ids]
        if self.arena is None or len(ids) < self.min_prompt:
            return "fallback"
        from ..models.llm.kvtier import (ChecksumError, pack_kv_transfer,
                                         unpack_kv_transfer)
        faults = get_faults()
        deadline = Deadline.after(self.lease_s)
        blob: Optional[bytes] = None
        attempt = 0
        while blob is None:
            if deadline.expired:
                return "timeout"
            idx = self._pick()
            if idx is None:
                return "fallback"      # pool empty / all breakers open
            with self._lock:
                worker = self._workers[idx] \
                    if idx < len(self._workers) else None
            if worker is None:
                return "fallback"      # shrunk away under us
            brk = self._breaker(idx)
            try:
                # the worker-call fault site: ``kill`` is the prefill
                # replica dying mid-handoff, ``error``/``reset`` are the
                # transient failures the retry/breaker pair absorbs
                faults.kill_point("disagg.prefill", tenant=tenant,
                                  phase="prefill")
                rows = worker.prefill(ids, tenant=tenant)
                blob = pack_kv_transfer(ids, rows, session=session,
                                        tenant=tenant)
                brk.record_success()
            except Exception:  # noqa: BLE001 — any worker failure retries
                brk.record_failure()
                if deadline.expired:
                    return "timeout"
                if attempt >= self.retry.max_retries \
                        or not self.retry.acquire_retry():
                    return "fallback"  # retries exhausted inside the lease
                self.retry.sleep(
                    min(self.retry.backoff_s(attempt), deadline.remaining()),
                    site="disagg.retry")
                attempt += 1
        # the wire: corrupt flips a byte (caught below), drop loses the
        # frame (only the deadline observes it), delay holds it so the
        # lease can expire before adoption
        blob = faults.transfer_point("disagg.transfer", blob,
                                     tenant=tenant, phase="prefill")
        if blob is None:
            return "timeout"           # dropped in flight
        if deadline.expired:
            return "expired"           # arrived after the lease — refuse
        try:
            xfer = unpack_kv_transfer(blob)
        except (ChecksumError, ValueError):
            return "corrupt"
        # idempotent adoption: put() supersedes a shorter/equal resident
        # prefix, so a re-delivered transfer refreshes instead of tearing
        self.arena.put(xfer.ids, xfer.rows, kind="handoff",
                       tenant=xfer.tenant)
        return "ok"
