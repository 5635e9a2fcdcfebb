"""Deterministic, seedable fault injection.

The robustness claims of this stack — retries converge, checkpoints
survive SIGKILL mid-write, drains drop nothing — are only claims until a
test can MAKE the failure happen on demand.  This registry is the one
place failures are manufactured: call sites (``io.http``, ``serving``,
``core.checkpoint``, the trainers, the launcher) consult it at named
**sites**, and a test (or the ``SML_FAULTS`` env var) arms rules that
fire deterministically — same seed + same call order ⇒ same schedule.

Inactive cost is one attribute read per site (no rules ⇒ ``check``
returns immediately), so the hooks stay in production code paths.

Fault kinds:

==============  ============================================================
``http_429``    synthetic 429 response (optionally with ``retry_after``)
``http_503``    synthetic 503 response (optionally with ``retry_after``)
``http_500``    synthetic 500 response
``reset``       ``ConnectionResetError`` at the site
``broken_pipe``  ``BrokenPipeError`` at the site
``error``       generic ``OSError`` (the site decides how to surface it)
``slow``        sleep ``delay`` seconds before proceeding normally
``preempt``     raise :class:`PreemptionError` (a soft TPU preemption)
``kill``        ``SIGKILL`` the current process (a hard preemption)
``oom``         raise :class:`ResourceExhaustedError` (an XLA
                ``RESOURCE_EXHAUSTED`` stand-in — device out of memory)
``poison``      raise :class:`PoisonRowError` (a data-dependent row
                failure, for the ``rowguard.poison_row`` site)
``hang``        block the calling thread for ``delay`` seconds (forever
                when no delay is given) — a wedged collective / silent
                rank, detectable only by a watchdog or heartbeat gap
``kill_rank``   ``SIGKILL`` the current process, but only on the process
                whose registry rank matches the rule's ``rank`` — the
                per-rank form of ``kill`` for gang tests
``slow_rank``   recorded sleep of ``delay`` seconds (a straggler rank)
``corrupt``     deterministic byte-flip on a payload registered at a
                :meth:`FaultRegistry.corrupt_point` site — silent
                bit-rot for checksum/fallback paths (only fires at
                corrupt points; other sites ignore the kind)
``drop``        lose an in-flight payload at a
                :meth:`FaultRegistry.transfer_point` site — the sender
                believes it sent, the receiver never sees it, and only
                a deadline can observe the loss (other sites ignore
                the kind)
``delay``       hold an in-flight payload for ``delay`` seconds at a
                :meth:`FaultRegistry.transfer_point` site, then deliver
                it intact — a slow wire, for lease-expiry paths (a
                recorded sleep, so ``no_sleep`` tests stay fast)
==============  ============================================================

Rule grammar (``SML_FAULTS``, rules joined by ``;``)::

    site=kind[:key=value[:key=value...]]

with keys ``times`` (max firings, default unlimited), ``after`` (skip the
first N matching calls), ``p`` (firing probability, drawn from the seeded
RNG), ``delay`` (seconds, for ``slow``/``slow_rank``/``hang``), ``status``
(override the HTTP code), ``retry_after`` (seconds, emitted as a
``Retry-After`` header), ``rank`` (the rule fires only on the process
whose :attr:`FaultRegistry.rank` matches — workers set it from
``SMLTPU_PROCESS_ID``, so one ``SML_FAULTS`` string shared by a whole
gang can target a single rank), ``tenant`` (the rule fires only for
calls whose context carries that tenant id — the multi-tenant QoS plane
passes ``tenant=`` at its kvtier/journal sites, so a noisy-neighbor
chaos soak can corrupt or kill ONE tenant's spills while the victim
tenant's are untouched) and ``phase`` (the serving mirror of ``tenant``
for the disaggregated prefill/decode plane — sites pass
``phase="prefill"``/``"decode"``, so a chaos soak can drop prefill-side
transfers while decode traffic is untouched).
``SML_FAULTS_SEED`` seeds the RNG (default 0).  Example::

    SML_FAULTS="http.send=http_503:times=2:retry_after=0.05;gbdt.checkpoint=kill:after=1:times=1"

Sites are matched with ``fnmatch`` globs, so ``http.*`` arms every HTTP
site.  Every backoff in the stack routes through :meth:`FaultRegistry.
sleep`, which records ``(site, seconds)`` into :attr:`sleep_log` — tests
assert the retry schedule itself (jitter bounds, Retry-After honoring)
instead of wall-clocking it.

Programmatic rules (``inject``) additionally take a ``when`` predicate
over the call's context dict, so a fault can fire only for calls
touching specific data — e.g. arm ``rowguard.poison_row`` to fail every
stage invocation whose batch CONTAINS source row 3, which is exactly how
the row guard's bisection is exercised without real poison data.  When
:attr:`record_calls` is set, :meth:`note` appends ``(site, ctx)`` to
:attr:`call_log` — the row-guard tests assert their O(log n) bisection
bound on this log.
"""

from __future__ import annotations

import fnmatch
import os
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..telemetry.flight import record as _flight_record

__all__ = ["FaultRule", "FaultRegistry", "PreemptionError",
           "ResourceExhaustedError", "PoisonRowError", "get_faults",
           "FAULTS_ENV", "FAULTS_SEED_ENV"]

FAULTS_ENV = "SML_FAULTS"
FAULTS_SEED_ENV = "SML_FAULTS_SEED"

#: kinds that surface as synthetic HTTP responses
HTTP_KINDS = {"http_429": 429, "http_503": 503, "http_500": 500}


class PreemptionError(RuntimeError):
    """Injected soft preemption — the in-process stand-in for the SIGKILL
    a real TPU preemption delivers (tests that need the hard version use
    kind ``kill`` in a subprocess)."""


class ResourceExhaustedError(RuntimeError):
    """Injected device out-of-memory — message carries the literal
    ``RESOURCE_EXHAUSTED`` marker so it walks the same detection path as
    a real ``XlaRuntimeError`` (see ``rowguard.is_oom_error``)."""


class PoisonRowError(ValueError):
    """Injected data-dependent row failure — what the ``poison`` kind
    raises at ``rowguard.poison_row`` so bisection tests need no real
    poison data."""


@dataclass
class FaultRule:
    """One armed fault: fire ``kind`` at calls matching ``site``."""
    site: str
    kind: str
    times: Optional[int] = None      # max firings (None = unlimited)
    after: int = 0                   # skip the first N matching calls
    p: float = 1.0                   # firing probability (seeded RNG)
    delay_s: float = 0.0             # for kind="slow"
    status: Optional[int] = None     # HTTP code override
    retry_after_s: Optional[float] = None
    #: only fire on the process whose registry rank matches (gang tests)
    rank: Optional[int] = None
    #: only fire for calls whose ctx carries this tenant id (the
    #: multi-tenant mirror of ``rank``; a call with NO tenant in its
    #: ctx never matches a tenant-gated rule)
    tenant: Optional[str] = None
    #: only fire for calls whose ctx carries this serving phase
    #: (``"prefill"``/``"decode"`` — the disaggregation mirror of
    #: ``tenant``; a call with NO phase never matches a phase-gated rule)
    phase: Optional[str] = None
    #: programmatic-only context predicate — the rule fires only for
    #: calls whose ctx satisfies it (a non-matching call does not even
    #: count toward ``after``)
    when: Optional[object] = None
    #: bookkeeping (mutated under the registry lock)
    matched: int = 0
    fired: int = 0


class FaultRegistry:
    """Process-wide fault switchboard (see module docstring)."""

    def __init__(self, seed: int = 0):
        self._lock = threading.RLock()
        self._rules: List[FaultRule] = []
        self._rng = random.Random(seed)
        self._seed = seed
        #: (site, seconds) of every routed sleep, in call order
        self.sleep_log: List[Tuple[str, float]] = []
        #: True ⇒ record sleeps without actually sleeping (fast tests)
        self.no_sleep = False
        #: (site, ctx) of every :meth:`note` while ``record_calls`` is set
        self.call_log: List[Tuple[str, Dict[str, object]]] = []
        #: True ⇒ record instrumented call sites into :attr:`call_log`
        #: (off by default: long-lived servers must not grow the log)
        self.record_calls = False
        #: this process's gang rank (``rank=``-gated rules only fire when
        #: it matches); workers inherit it from ``SMLTPU_PROCESS_ID``
        self.rank: Optional[int] = None
        rank_env = os.environ.get("SMLTPU_PROCESS_ID")
        if rank_env is not None:
            try:
                self.rank = int(rank_env)
            except ValueError:
                pass
        self._env_loaded = False

    # -- arming ------------------------------------------------------------
    def inject(self, site: str, kind: str, times: Optional[int] = None,
               after: int = 0, p: float = 1.0, delay_s: float = 0.0,
               status: Optional[int] = None,
               retry_after_s: Optional[float] = None,
               rank: Optional[int] = None, tenant: Optional[str] = None,
               phase: Optional[str] = None, when=None) -> FaultRule:
        rule = FaultRule(site, kind, times, after, p, delay_s, status,
                         retry_after_s, rank, tenant, phase, when)
        with self._lock:
            self._rules.append(rule)
        return rule

    def configure(self, spec: str, seed: Optional[int] = None) -> None:
        """Arm rules from an ``SML_FAULTS``-grammar string."""
        if seed is not None:
            self.seed(seed)
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, rest = part.partition("=")
            bits = rest.split(":")
            kind = bits[0].strip()
            kw: Dict[str, object] = {}
            for opt in bits[1:]:
                k, _, v = opt.partition("=")
                k = k.strip()
                if k == "times":
                    kw["times"] = int(v)
                elif k == "after":
                    kw["after"] = int(v)
                elif k == "p":
                    kw["p"] = float(v)
                elif k == "delay":
                    kw["delay_s"] = float(v)
                elif k == "status":
                    kw["status"] = int(v)
                elif k == "retry_after":
                    kw["retry_after_s"] = float(v)
                elif k == "rank":
                    kw["rank"] = int(v)
                elif k == "tenant":
                    kw["tenant"] = str(v)
                elif k == "phase":
                    kw["phase"] = str(v)
                else:
                    raise ValueError(f"unknown fault option {k!r} in {part!r}")
            self.inject(site.strip(), kind, **kw)

    def configure_from_env(self) -> None:
        """(Re)load rules from ``SML_FAULTS`` / ``SML_FAULTS_SEED``."""
        spec = os.environ.get(FAULTS_ENV, "")
        seed = int(os.environ.get(FAULTS_SEED_ENV, "0") or 0)
        if spec:
            self.configure(spec, seed=seed)
        self._env_loaded = True

    def seed(self, n: int) -> None:
        with self._lock:
            self._seed = n
            self._rng = random.Random(n)

    def clear(self) -> None:
        """Drop every rule and the sleep log (registrations in telemetry
        are untouched); re-seeds the RNG so schedules restart."""
        with self._lock:
            self._rules = []
            self.sleep_log = []
            self.call_log = []
            self.no_sleep = False
            self.record_calls = False
            self._rng = random.Random(self._seed)

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def rules(self) -> List[FaultRule]:
        with self._lock:
            return list(self._rules)

    # -- firing ------------------------------------------------------------
    def check(self, site: str, **ctx) -> Optional[FaultRule]:
        """First armed rule firing at this call of ``site`` (None when
        nothing fires).  Deterministic: match counters advance per rule,
        probability draws come from the seeded RNG in call order."""
        if not self._rules:            # fast inactive path, no lock
            return None
        with self._lock:
            fired: Optional[FaultRule] = None
            for rule in self._rules:
                if not fnmatch.fnmatch(site, rule.site):
                    continue
                if rule.rank is not None and rule.rank != self.rank:
                    continue           # another rank's fault, not ours
                if rule.tenant is not None \
                        and ctx.get("tenant") != rule.tenant:
                    continue           # another tenant's fault, not ours
                if rule.phase is not None \
                        and ctx.get("phase") != rule.phase:
                    continue           # another phase's fault, not ours
                if rule.when is not None and not rule.when(ctx):
                    continue           # ctx miss: not a matching call at all
                rule.matched += 1
                if rule.matched <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                fired = rule
                break
        if fired is not None:
            # the flight ring sees every injected fault BEFORE it executes
            # — for kill/kill_rank kinds the ring (exported over the gang
            # wire) is the only witness the process leaves behind
            _flight_record("fault", site=site, fault_kind=fired.kind)
            return fired
        return None

    def raise_point(self, site: str, **ctx) -> None:
        """Fire raise-style kinds at this site (``reset``, ``broken_pipe``,
        ``error``, ``preempt``); ``slow`` sleeps; HTTP kinds are ignored
        here (they only make sense where a response can be fabricated)."""
        rule = self.check(site, **ctx)
        if rule is None:
            return
        self._execute_raise(site, rule)

    def kill_point(self, site: str, **ctx) -> None:
        """Fire process-death kinds at this site: ``kill`` SIGKILLs the
        process (no cleanup, no atexit — exactly a preemption), ``preempt``
        raises :class:`PreemptionError`; other raise kinds also apply."""
        rule = self.check(site, **ctx)
        if rule is None:
            return
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        self._execute_raise(site, rule)

    @staticmethod
    def _flip(rule: FaultRule, payload: bytes) -> bytes:
        """Deterministic single-byte flip: Knuth-hash the firing ordinal
        into an offset — stable across runs, scattered across the
        payload."""
        if not len(payload):
            return payload
        buf = bytearray(payload)
        off = ((rule.fired - 1) * 2654435761 + 1) % len(buf)
        buf[off] ^= 0xFF
        return bytes(buf)

    def corrupt_point(self, site: str, payload: bytes, **ctx) -> bytes:
        """Payload-carrying site: returns ``payload``, byte-flipped when
        a ``corrupt`` rule fires (deterministic offset per firing, so a
        seeded chaos run corrupts the same bytes every time).  ``kill``
        SIGKILLs here too — a corrupt point is also a kill point (die
        with the payload unwritten); other raise kinds apply as usual."""
        rule = self.check(site, **ctx)
        if rule is None:
            return payload
        if rule.kind == "corrupt":
            return self._flip(rule, payload)
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        self._execute_raise(site, rule)
        return payload

    def transfer_point(self, site: str, payload: bytes,
                       **ctx) -> Optional[bytes]:
        """In-flight payload site (a wire hop): everything
        :meth:`corrupt_point` does, plus the two kinds only a network
        has — ``drop`` loses the payload (returns ``None``: the sender
        believes it sent, only the receiver's deadline can notice) and
        ``delay`` holds it for ``delay`` seconds before delivering it
        intact (a recorded sleep, so the lease-expiry path is testable
        under ``no_sleep``)."""
        rule = self.check(site, **ctx)
        if rule is None:
            return payload
        if rule.kind == "corrupt":
            return self._flip(rule, payload)
        if rule.kind == "drop":
            return None
        if rule.kind == "delay":
            self.sleep(rule.delay_s, site=site)
            return payload
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        self._execute_raise(site, rule)
        return payload

    def _execute_raise(self, site: str, rule: FaultRule) -> None:
        if rule.kind in ("slow", "slow_rank"):
            self.sleep(rule.delay_s, site=site)
        elif rule.kind == "hang":
            # a wedged thread, NOT a recorded backoff: honors neither
            # no_sleep nor the sleep log — the whole point is that only a
            # watchdog timeout or a heartbeat gap can observe it
            threading.Event().wait(
                rule.delay_s if rule.delay_s > 0 else None)
        elif rule.kind == "kill_rank":
            # record the kill before dying so a call log shared with
            # the parent process (record_calls in-process) sees the
            # event even though the process never returns
            if self.record_calls:
                with self._lock:
                    self.call_log.append((site, {"kind": "kill_rank",
                                                 "rank": self.rank}))
            os.kill(os.getpid(), signal.SIGKILL)
        elif rule.kind == "reset":
            raise ConnectionResetError(f"injected connection reset at {site}")
        elif rule.kind == "broken_pipe":
            raise BrokenPipeError(f"injected broken pipe at {site}")
        elif rule.kind == "error":
            raise OSError(f"injected fault at {site}")
        elif rule.kind == "preempt":
            raise PreemptionError(f"injected preemption at {site}")
        elif rule.kind == "oom":
            raise ResourceExhaustedError(
                f"RESOURCE_EXHAUSTED: injected out-of-memory at {site}")
        elif rule.kind == "poison":
            raise PoisonRowError(f"injected poison row at {site}")

    def http_fault(self, site: str, **ctx) -> Optional[Tuple[int, Dict[str, str]]]:
        """HTTP-shaped firing: returns ``(status, headers)`` for a
        synthetic error response, raises for connection kinds, sleeps for
        ``slow`` (then returns None so the real request proceeds)."""
        rule = self.check(site, **ctx)
        if rule is None:
            return None
        if rule.kind in HTTP_KINDS:
            status = rule.status or HTTP_KINDS[rule.kind]
            headers: Dict[str, str] = {}
            if rule.retry_after_s is not None:
                headers["Retry-After"] = str(rule.retry_after_s)
            return status, headers
        self._execute_raise(site, rule)
        return None

    # -- recorded calls ----------------------------------------------------
    def note(self, site: str, **ctx) -> None:
        """Record an instrumented call (no fault fires here).  A no-op
        unless :attr:`record_calls` is set — the row guard notes every
        guarded stage invocation through this, so tests can assert call
        counts (e.g. the bisection's O(log n) bound) without wrapping
        stages themselves."""
        if not self.record_calls:
            return
        with self._lock:
            self.call_log.append((site, ctx))

    def calls_for(self, site: str) -> List[Dict[str, object]]:
        with self._lock:
            return [ctx for (st, ctx) in self.call_log
                    if fnmatch.fnmatch(st, site)]

    # -- recorded sleep ----------------------------------------------------
    def sleep(self, seconds: float, site: str = "backoff") -> None:
        """The stack's ONE sleep primitive for backoff: records the
        schedule (always) and sleeps (unless ``no_sleep``).  Tests assert
        jitter bounds and Retry-After honoring on :attr:`sleep_log`."""
        seconds = max(0.0, float(seconds))
        with self._lock:
            self.sleep_log.append((site, seconds))
        _flight_record("backoff", site=site, seconds=seconds)
        if seconds > 0 and not self.no_sleep:
            time.sleep(seconds)

    def sleeps_for(self, site: str) -> List[float]:
        with self._lock:
            return [s for (st, s) in self.sleep_log
                    if fnmatch.fnmatch(st, site)]


_registry: Optional[FaultRegistry] = None
_registry_lock = threading.Lock()


def get_faults() -> FaultRegistry:
    """The process-wide registry; arms ``SML_FAULTS`` rules on first use."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                reg = FaultRegistry(
                    seed=int(os.environ.get(FAULTS_SEED_ENV, "0") or 0))
                reg.configure_from_env()
                _registry = reg
    return _registry
