"""SLO-driven autoscaler: the control loop over the live card budget.

The PyTorch port of the JAX package's ``serving/autoscaler.py`` (stdlib
only, as there).  The sensors and actuators a serving control plane needs
are the schema-checked ``GET /sloz`` snapshot (designed as this module's
input contract), ``GangSupervisor.resize(n)``, warming-aware routing and
the compile plane that makes a grown replica useful in seconds; this
module closes the loop:

- :class:`Autoscaler` — a controller that polls a registered ``/sloz``
  source (an in-process :class:`~synapseml_tpu_torch.telemetry.slo.
  SloStore`, an HTTP URL, or any callable returning a snapshot; every
  fetch is validated through :func:`~synapseml_tpu_torch.telemetry.slo.
  check_sloz`, never trusted raw), derives one verdict per poll from
  windowed burn rate, shed ratio and occupancy — **grow** on sustained
  shed or TTFT burn > 1, **shrink** on persistently idle occupancy — and
  actuates through a replica pool (below).  A replica the ``/readyz``
  plane still reports *warming* is capacity-in-flight: the controller
  holds instead of growing again while the previous grow is still
  warming toward useful.
- :class:`CapacityArbiter` — ONE declared card budget shared between a
  training gang and the serving replicas.  Serving growth beyond the
  free pool asks training to *yield* (an elastic shrink through
  ``GangSupervisor.resize``, never below the gang's ``min_ranks``
  floor); off-peak — no serving pressure for ``reclaim_after_s`` — the
  arbiter grows training back toward its preferred size.  Both sides
  move through the same elastic-resize machinery.
- Pools — :class:`ServingReplicaSet` (factory-spawned in-process
  replicas behind a shared :class:`~synapseml_tpu_torch.serving.
  distributed.ReplicaRouter`: grow spawns, shrink removes the departing
  address from the table FIRST and then drains it, the zero-drop order)
  and :class:`SupervisorPool` (gang-worker-hosted serving:
  ``GangSupervisor.resize(n)`` + ``DistributedServingServer.
  refresh_routing_table``).

Guard rails mirror the gang's resize brake: per-direction cooldowns, a
resize budget, sustain requirements (one hot window is noise, N
consecutive are a trend) and a hysteresis band — the shrink thresholds
(``burn_shrink``/``shed_shrink``) sit strictly below the grow
thresholds, so attainment oscillating around the objective parks the
controller at *hold* instead of flapping.  Every decision is
flight-recorded (``autoscale_decide``) and fault-log noted
(``autoscale.decide``) with the exact ``/sloz`` snapshot that justified
it, so a postmortem can replay why the controller acted.  The
arbiter's accounting unit keeps the reference's name, *chips*: one chip
is one card here.
"""

from __future__ import annotations

import json
import math
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

from ..resilience.faults import get_faults
from ..telemetry import get_registry
from ..telemetry.flight import record as flight_record
from ..telemetry.slo import SloStore, check_sloz

__all__ = ["AutoscalePolicy", "Autoscaler", "CapacityArbiter",
           "ScaleDecision", "ServingReplicaSet", "SupervisorPool",
           "sloz_signals", "AUTOSCALE_METRICS"]

#: autoscaler metric names — held to the docs bar by the metric-hygiene
#: sweep, like GANG_METRICS / SLO_METRICS
AUTOSCALE_METRICS = frozenset({
    "autoscale_decisions_total", "autoscale_replicas",
    "autoscale_chips", "autoscale_arbiter_moves_total",
})


# ---------------------------------------------------------------------------
# /sloz input: fetch + signal extraction
# ---------------------------------------------------------------------------

def _fetch_sloz(source, timeout_s: float = 2.0) -> Dict[str, Any]:
    """One validated snapshot from any supported source: an
    :class:`SloStore`, an HTTP(S) URL serving ``GET /sloz``, or a
    callable returning the payload.  ``check_sloz`` is the only door —
    a malformed or foreign-versioned snapshot raises here, before any
    decision logic sees it."""
    if isinstance(source, SloStore):
        snap = source.snapshot()
    elif isinstance(source, str):
        with urllib.request.urlopen(source, timeout=timeout_s) as resp:
            snap = json.loads(resp.read().decode("utf-8"))
    elif callable(source):
        snap = source()
    else:
        raise TypeError(f"unsupported /sloz source: {type(source).__name__}")
    check_sloz(snap)
    return snap


def sloz_signals(snapshot: Dict[str, Any],
                 phase: Optional[str] = None) -> Dict[str, Any]:
    """The decision inputs, reduced across planes: worst (max) burn
    rate over every declared objective, worst (max) shed ratio, lowest
    (min) mean occupancy, and the total evidence count (latency
    observations + occupancy samples — zero means the windows are
    empty and no verdict has support).

    ``phase`` restricts the reduction to one disaggregated pool's
    planes (``<base>@phase=<prefill|decode>``) — two controllers each
    reducing their own phase scale the pools independently: prefill
    burn grows the prefill pool without touching decode, and vice
    versa."""
    from ..telemetry.slo import plane_phase
    max_burn = max_shed = min_occ = None
    samples = 0
    planes = snapshot.get("planes", {})
    if phase is not None:
        planes = {name: plane for name, plane in planes.items()
                  if plane_phase(name) == phase}
    for plane in planes.values():
        for block in plane.get("slo", {}).values():
            burn = block.get("burn_rate")
            if burn is not None:
                max_burn = burn if max_burn is None else max(max_burn, burn)
        shed = plane.get("rates", {}).get("shed_ratio")
        if shed is not None:
            max_shed = shed if max_shed is None else max(max_shed, shed)
        occ = plane.get("occupancy", {}).get("mean")
        if occ is not None:
            min_occ = occ if min_occ is None else min(min_occ, occ)
        samples += int(plane.get("occupancy", {}).get("samples") or 0)
        for sig in plane.get("signals", {}).values():
            samples += int(sig.get("count") or 0)
    return {"max_burn": max_burn, "max_shed": max_shed,
            "min_occupancy": min_occ, "samples": samples,
            "planes": len(planes)}


# ---------------------------------------------------------------------------
# policy + decision record
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds and guard rails for one controller.

    The hysteresis band is structural: ``burn_shrink < burn_grow`` and
    ``shed_shrink < shed_grow``, so a plane oscillating between the
    bands produces *hold*, never a grow/shrink flap.  ``sustain_polls``
    is the trend filter (one bursty window must not resize anything);
    the cooldowns and ``max_resizes`` budget mirror the gang's
    resize brake."""

    min_replicas: int = 1
    max_replicas: int = 8
    #: grow when windowed shed ratio exceeds this...
    shed_grow: float = 0.01
    #: ...or any declared objective burns error budget faster than
    #: sustainable (burn rate 1.0 = exactly sustainable)
    burn_grow: float = 1.0
    #: shrink only while mean occupancy sits below this...
    occ_shrink: float = 0.25
    #: ...AND the plane is quiet: burn/shed under the LOW edge of the
    #: hysteresis band (strictly below the grow thresholds)
    burn_shrink: float = 0.5
    shed_shrink: float = 0.0
    #: consecutive polls a signal must persist before acting
    sustain_polls: int = 3
    grow_cooldown_s: float = 15.0
    shrink_cooldown_s: float = 60.0
    #: lifetime resize budget (None = unlimited) — a runaway control
    #: loop stops moving chips long before it can thrash the gang
    max_resizes: Optional[int] = 64
    grow_step: int = 1
    shrink_step: int = 1

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.burn_shrink >= self.burn_grow:
            raise ValueError(
                f"hysteresis requires burn_shrink < burn_grow "
                f"({self.burn_shrink} >= {self.burn_grow}): equal bands "
                "make attainment oscillation flap the pool")
        if self.shed_shrink > self.shed_grow:
            raise ValueError(
                f"hysteresis requires shed_shrink <= shed_grow "
                f"({self.shed_shrink} > {self.shed_grow})")


@dataclass
class ScaleDecision:
    """One poll's verdict, with the evidence that justified it."""

    ts: float
    verdict: str                  # grow | shrink | hold | error
    reason: str
    replicas: int                 # pool size BEFORE any action
    target: Optional[int]         # pool size AFTER an action (else None)
    signals: Dict[str, Any] = field(default_factory=dict)
    snapshot: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        return {"ts": self.ts, "verdict": self.verdict,
                "reason": self.reason, "replicas": self.replicas,
                "target": self.target, "signals": dict(self.signals)}


# ---------------------------------------------------------------------------
# replica pools (the actuators)
# ---------------------------------------------------------------------------

class ServingReplicaSet:
    """In-process replica pool: ``factory()``-spawned serving replicas
    (anything with ``address``/``drain``/``close`` — a
    :class:`~synapseml_tpu_torch.serving.server.ServingServer`, an
    :class:`~synapseml_tpu_torch.serving.llm.LLMServer`, or a wrapper)
    behind an optional shared :class:`~synapseml_tpu_torch.serving.
    distributed.ReplicaRouter`.

    Shrink follows the zero-drop order: the departing replica
    leaves the routing table FIRST (no new routes can name it), then
    drains every accepted exchange, then closes — a controller-
    initiated shrink drops nothing."""

    def __init__(self, factory: Callable[[], Any], router=None,
                 drain_timeout_s: float = 30.0):
        self._factory = factory
        self.router = router
        self.drain_timeout_s = float(drain_timeout_s)
        self._lock = threading.Lock()
        self._replicas: List[Any] = []

    @staticmethod
    def _addr(replica):
        addr = getattr(replica, "address", None)
        if addr is None:
            addr = replica.server.address
        return addr

    @staticmethod
    def _health(replica):
        health = getattr(replica, "health", None)
        if health is None:
            server = getattr(replica, "server", None)
            health = getattr(server, "health", None)
        return health

    def addresses(self) -> List[Any]:
        with self._lock:
            return [self._addr(r) for r in self._replicas]

    def replicas(self) -> List[Any]:
        with self._lock:
            return list(self._replicas)

    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    def warming_count(self) -> int:
        """Replicas whose compile plane still reports cold/warming —
        the in-process mirror of the router's probe-based count (no
        HTTP needed when the health object is reachable directly)."""
        count = 0
        for r in self.replicas():
            health = self._health(r)
            if health is not None and health.warming:
                count += 1
        return count

    def _refresh_router(self) -> None:
        if self.router is not None:
            self.router.refresh(self.addresses())

    def grow(self, n: int = 1) -> int:
        added = [self._factory() for _ in range(max(1, int(n)))]
        with self._lock:
            self._replicas.extend(added)
        self._refresh_router()
        return self.replica_count()

    def shrink(self, n: int = 1) -> int:
        with self._lock:
            n = min(max(1, int(n)), max(0, len(self._replicas) - 0))
            departing = self._replicas[len(self._replicas) - n:]
            del self._replicas[len(self._replicas) - n:]
        # departed addresses leave the table BEFORE the drain starts:
        # no route() issued after this refresh can name them, and the
        # drain flushes whatever they had already accepted
        self._refresh_router()
        for r in departing:
            drain = getattr(r, "leave", None) or getattr(r, "drain", None)
            if drain is not None:
                drain(timeout_s=self.drain_timeout_s)
            r.close()
        return self.replica_count()

    def close(self) -> None:
        with self._lock:
            replicas, self._replicas = list(self._replicas), []
        for r in replicas:
            try:
                r.close()
            except Exception:
                pass


class SupervisorPool:
    """Gang-worker-hosted serving replicas, one per rank: the pool's
    size IS the gang's world size, so grow/shrink actuate through
    ``GangSupervisor.resize(n)`` (the gang's elastic
    relaunch).  ``refresh_fn`` — typically every
    rank's collective :meth:`~synapseml_tpu_torch.serving.distributed.
    DistributedServingServer.refresh_routing_table` — runs after each
    request so routers re-gather the resized table; ``router`` (any
    object with ``warming_count``) lends the warming visibility."""

    def __init__(self, supervisor, router=None,
                 refresh_fn: Optional[Callable[[], Any]] = None):
        self.supervisor = supervisor
        self.router = router
        self.refresh_fn = refresh_fn

    def replica_count(self) -> int:
        return int(self.supervisor.world_size)

    def warming_count(self) -> int:
        if self.router is None:
            return 0
        return int(self.router.warming_count())

    def _resize(self, n: int) -> int:
        self.supervisor.resize(n)
        if self.refresh_fn is not None:
            self.refresh_fn()
        return n

    def grow(self, n: int = 1) -> int:
        return self._resize(self.replica_count() + max(1, int(n)))

    def shrink(self, n: int = 1) -> int:
        return self._resize(self.replica_count() - max(1, int(n)))


# ---------------------------------------------------------------------------
# the chip-budget arbiter
# ---------------------------------------------------------------------------

class CapacityArbiter:
    """ONE declared chip budget shared between a training gang and the
    serving replicas.

    Accounting is in *entitlements*: ``training_chips`` tracks the rank
    count the arbiter last requested (adopted immediately — the elastic
    teardown is already in flight when ``resize`` returns), and a
    resize listener (:meth:`attach_training` registers it when the
    handle supports ``add_resize_listener``) reconciles the entitlement
    when the gang resizes for its OWN reasons — a failure-driven shrink
    returns its chips to the free pool instead of leaking them.

    Policy: serving acquisitions take free chips first; beyond that,
    training *yields* — an elastic shrink, never below the training
    floor (``min_ranks``).  :meth:`reclaim` (call it every poll) grows
    training back toward ``preferred`` once no serving pressure has
    been seen for ``reclaim_after_s`` — the off-peak reclaim."""

    def __init__(self, total_chips: int, *, chips_per_rank: int = 1,
                 chips_per_replica: int = 1, reclaim_after_s: float = 30.0,
                 name: str = "arbiter",
                 clock: Callable[[], float] = time.monotonic):
        if total_chips < 1:
            raise ValueError(f"total_chips={total_chips}: need >= 1")
        self.total_chips = int(total_chips)
        self.chips_per_rank = max(1, int(chips_per_rank))
        self.chips_per_replica = max(1, int(chips_per_replica))
        self.reclaim_after_s = float(reclaim_after_s)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._serving_chips = 0
        self._training = None          # (handle, preferred, min_ranks)
        self._training_ranks = 0
        self._last_pressure_at: Optional[float] = None
        reg = get_registry()
        self._g_chips = reg.gauge(
            "autoscale_chips", "chip entitlement by side of the shared "
            "budget (serving / training / free)", ("arbiter", "side"))
        self._c_moves = reg.counter(
            "autoscale_arbiter_moves_total",
            "training chip movements: yield (to serving) / reclaim "
            "(off-peak return)", ("arbiter", "direction"))
        self._export_locked()

    # -- wiring ------------------------------------------------------------
    def attach_training(self, handle, preferred_ranks: Optional[int] = None,
                        min_ranks: Optional[int] = None) -> None:
        """Declare the training side: ``handle`` needs ``resize(n)`` and
        ``world_size`` (a :class:`~synapseml_tpu_torch.parallel.supervisor.
        GangSupervisor` fits).  ``preferred_ranks`` is the size training
        reclaims back to off-peak (default: its current size);
        ``min_ranks`` the yield floor (default: the handle's own
        ``min_ranks``, else 1)."""
        preferred = int(preferred_ranks if preferred_ranks is not None
                        else handle.world_size)
        floor = min_ranks if min_ranks is not None else \
            getattr(handle, "min_ranks", None)
        floor = max(1, int(floor if floor is not None else 1))
        if preferred < floor:
            raise ValueError(f"preferred_ranks={preferred} below "
                             f"min_ranks={floor}")
        with self._lock:
            self._training = (handle, preferred, floor)
            self._training_ranks = int(handle.world_size)
            self._export_locked()
        add = getattr(handle, "add_resize_listener", None)
        if add is not None:
            add(self._on_training_resize)

    def register_serving(self, chips: int) -> None:
        """Seed the serving entitlement (replicas already running when
        the arbiter comes up)."""
        with self._lock:
            self._serving_chips = max(0, int(chips))
            self._export_locked()

    def _on_training_resize(self, event: Dict[str, Any]) -> None:
        """Resize-listener reconciliation: a gang resize the arbiter
        did not request (failure-driven shrink, capacity probe) moves
        the training entitlement to the APPLIED size, so the freed (or
        consumed) chips show up in the free pool instead of leaking."""
        with self._lock:
            applied = int(event.get("to", self._training_ranks))
            if applied == self._training_ranks:
                return                   # confirmation of our own request
            self._training_ranks = applied
            self._export_locked()
        flight_record("arbiter_sync", arbiter=self.name,
                      training_ranks=applied,
                      cause=event.get("cause"))

    # -- accounting --------------------------------------------------------
    def serving_chips(self) -> int:
        with self._lock:
            return self._serving_chips

    def training_chips(self) -> int:
        with self._lock:
            return self._training_ranks * self.chips_per_rank

    def free_chips(self) -> int:
        with self._lock:
            return self._free_locked()

    def _free_locked(self) -> int:
        used = (self._serving_chips
                + self._training_ranks * self.chips_per_rank)
        return max(0, self.total_chips - used)

    def _export_locked(self) -> None:
        self._g_chips.set(self._serving_chips, arbiter=self.name,
                          side="serving")
        self._g_chips.set(self._training_ranks * self.chips_per_rank,
                          arbiter=self.name, side="training")
        self._g_chips.set(self._free_locked(), arbiter=self.name,
                          side="free")

    # -- the policy --------------------------------------------------------
    def acquire_serving(self, chips: int,
                        now: Optional[float] = None) -> bool:
        """Serving wants ``chips`` more: free pool first, then a
        training yield (elastic shrink toward — never below — the
        training floor).  False when the budget genuinely cannot cover
        the request; the caller holds instead of growing."""
        chips = max(1, int(chips))
        now = self._clock() if now is None else now
        with self._lock:
            self._last_pressure_at = now
            free = self._free_locked()
            if free >= chips:
                self._serving_chips += chips
                self._export_locked()
                flight_record("arbiter_acquire", arbiter=self.name,
                              chips=chips, source="free")
                return True
            if self._training is None:
                return False
            handle, _, floor = self._training
            need = chips - free
            yield_ranks = math.ceil(need / self.chips_per_rank)
            target = self._training_ranks - yield_ranks
            if target < floor:
                flight_record("arbiter_deny", arbiter=self.name,
                              chips=chips, training_ranks=
                              self._training_ranks, floor=floor)
                return False
            # adopt the entitlement BEFORE the resize, outside the lock:
            # the gang's resize listener re-enters _on_training_resize,
            # which must see a confirmation of OUR request (and must not
            # deadlock on this mutex)
            prev_ranks = self._training_ranks
            self._training_ranks = target
            self._serving_chips += chips
            self._export_locked()
        try:
            handle.resize(target)
        except Exception as exc:  # noqa: BLE001 — a refused resize
            #                       (validation, dead gang) denies the
            #                       grant, never crashes a poll
            with self._lock:
                self._training_ranks = prev_ranks
                self._serving_chips -= chips
                self._export_locked()
            flight_record("arbiter_deny", arbiter=self.name,
                          chips=chips, error=str(exc))
            return False
        self._c_moves.inc(1, arbiter=self.name, direction="yield")
        flight_record("arbiter_yield", arbiter=self.name, chips=chips,
                      yielded_ranks=yield_ranks, training_ranks=target)
        get_faults().note("autoscale.arbiter", direction="yield",
                          chips=chips, training_ranks=target)
        return True

    def release_serving(self, chips: int,
                        now: Optional[float] = None) -> None:
        """Serving shrank: its chips return to the free pool (training
        reclaims them later, through :meth:`reclaim`'s off-peak gate)."""
        chips = max(1, int(chips))
        with self._lock:
            self._serving_chips = max(0, self._serving_chips - chips)
            self._export_locked()
        flight_record("arbiter_release", arbiter=self.name, chips=chips)

    def reclaim(self, now: Optional[float] = None) -> int:
        """Off-peak reclaim: with no serving pressure for
        ``reclaim_after_s``, grow training back toward ``preferred``
        with whatever the free pool covers.  Returns ranks reclaimed
        (0 when gated).  Call once per controller poll."""
        now = self._clock() if now is None else now
        with self._lock:
            if self._training is None:
                return 0
            handle, preferred, _ = self._training
            if self._training_ranks >= preferred:
                return 0
            if (self._last_pressure_at is not None
                    and now - self._last_pressure_at < self.reclaim_after_s):
                return 0
            ranks = min(self._free_locked() // self.chips_per_rank,
                        preferred - self._training_ranks)
            if ranks < 1:
                return 0
            target = self._training_ranks + ranks
            # adopt first, resize outside the lock (see acquire_serving)
            prev_ranks = self._training_ranks
            self._training_ranks = target
            self._export_locked()
        try:
            handle.resize(target)
        except Exception:  # noqa: BLE001 — retried next poll
            with self._lock:
                self._training_ranks = prev_ranks
                self._export_locked()
            return 0
        self._c_moves.inc(1, arbiter=self.name, direction="reclaim")
        flight_record("arbiter_reclaim", arbiter=self.name,
                      reclaimed_ranks=ranks, training_ranks=target)
        get_faults().note("autoscale.arbiter", direction="reclaim",
                          reclaimed_ranks=ranks, training_ranks=target)
        return ranks


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class Autoscaler:
    """One control loop: ``/sloz`` source in, pool resizes out.

    :meth:`poll_once` is the whole step, deterministic under an
    explicit ``now`` (the decision tests drive synthetic snapshot feeds
    through fake clocks with zero real sleeps); :meth:`start` wraps it
    in a daemon thread for production use.  With an ``arbiter``
    attached, every grow first acquires chips (training yields under
    sustained pressure), every shrink releases them, and each poll
    gives the arbiter its off-peak reclaim chance."""

    def __init__(self, pool, source=None,
                 policy: Optional[AutoscalePolicy] = None,
                 arbiter: Optional[CapacityArbiter] = None,
                 name: str = "serving", poll_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 fetch_timeout_s: float = 2.0,
                 keep_decisions: int = 256,
                 phase: Optional[str] = None):
        from ..telemetry.slo import get_slo_store
        self.pool = pool
        self.source = source if source is not None else get_slo_store()
        self.policy = policy or AutoscalePolicy()
        self.arbiter = arbiter
        self.name = name
        #: restrict decision inputs to one disaggregated pool's
        #: ``@phase=`` planes (None = reduce across every plane, the
        #: colocated deployment).  Two controllers — phase="prefill"
        #: over a PrefillPool, phase="decode" over a ServingReplicaSet
        #: — scale the pools independently off one shared /sloz.
        self.phase = phase
        self.poll_interval_s = float(poll_interval_s)
        self.fetch_timeout_s = float(fetch_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._pressure_streak = 0
        self._idle_streak = 0
        self._last_grow_at: Optional[float] = None
        self._last_shrink_at: Optional[float] = None
        self._actions = 0
        #: recent decisions, newest last (each with its justifying
        #: snapshot) — the in-process postmortem surface
        self.decisions: Deque[ScaleDecision] = deque(maxlen=keep_decisions)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._c_decisions = reg.counter(
            "autoscale_decisions_total",
            "controller verdicts per poll", ("scaler", "verdict"))
        self._g_replicas = reg.gauge(
            "autoscale_replicas", "serving replicas under autoscaler "
            "control", ("scaler",))

    # -- one deterministic step --------------------------------------------
    def poll_once(self, now: Optional[float] = None) -> ScaleDecision:
        now = self._clock() if now is None else now
        try:
            snapshot = _fetch_sloz(self.source,
                                   timeout_s=self.fetch_timeout_s)
        except Exception as exc:  # noqa: BLE001 — a broken source is a
            #                       recorded verdict, not a dead loop
            return self._finish(ScaleDecision(
                ts=now, verdict="error", reason=f"sloz fetch: {exc}",
                replicas=self._safe_count(), target=None))
        signals = sloz_signals(snapshot, phase=self.phase)
        decision = self._decide(now, signals, snapshot)
        if self.arbiter is not None:
            self.arbiter.reclaim(now)
        return self._finish(decision)

    def _safe_count(self) -> int:
        try:
            return int(self.pool.replica_count())
        except Exception:  # noqa: BLE001
            return -1

    def _decide(self, now: float, signals: Dict[str, Any],
                snapshot: Dict[str, Any]) -> ScaleDecision:
        p = self.policy
        replicas = int(self.pool.replica_count())
        warming = int(getattr(self.pool, "warming_count", lambda: 0)())

        def hold(reason):
            return ScaleDecision(ts=now, verdict="hold", reason=reason,
                                 replicas=replicas, target=None,
                                 signals=signals, snapshot=snapshot)

        if signals["samples"] == 0:
            with self._lock:
                self._pressure_streak = self._idle_streak = 0
            return hold("no_data: every window is empty")

        burn, shed = signals["max_burn"], signals["max_shed"]
        occ = signals["min_occupancy"]
        pressure = ((shed is not None and shed > p.shed_grow)
                    or (burn is not None and burn > p.burn_grow))
        quiet = ((burn is None or burn < p.burn_shrink)
                 and (shed is None or shed <= p.shed_shrink))
        idle = quiet and occ is not None and occ < p.occ_shrink
        with self._lock:
            if pressure:
                self._pressure_streak += 1
                self._idle_streak = 0
            elif idle:
                self._idle_streak += 1
                self._pressure_streak = 0
            else:
                self._pressure_streak = self._idle_streak = 0
            pressure_streak = self._pressure_streak
            idle_streak = self._idle_streak
            actions = self._actions
            last_grow, last_shrink = self._last_grow_at, self._last_shrink_at

        budget_left = (p.max_resizes is None or actions < p.max_resizes)
        if pressure:
            if pressure_streak < p.sustain_polls:
                return hold(f"sustaining_pressure "
                            f"{pressure_streak}/{p.sustain_polls}")
            if warming > 0:
                # readyz semantics: a warming replica is capacity
                # already in flight, not a reason to grow again
                return hold(f"warming: {warming} replica(s) in flight")
            if replicas >= p.max_replicas:
                return hold(f"at_max: {replicas} replicas")
            if (last_grow is not None
                    and now - last_grow < p.grow_cooldown_s):
                return hold("grow_cooldown")
            if not budget_left:
                return hold(f"budget_spent: {actions} resizes")
            return self._actuate(now, "grow", replicas, signals, snapshot)
        if idle:
            if idle_streak < p.sustain_polls:
                return hold(f"sustaining_idle {idle_streak}/"
                            f"{p.sustain_polls}")
            if replicas <= p.min_replicas:
                return hold(f"at_min: {replicas} replicas")
            if warming > 0:
                return hold(f"warming: {warming} replica(s) in flight")
            if (last_shrink is not None
                    and now - last_shrink < p.shrink_cooldown_s):
                return hold("shrink_cooldown")
            if not budget_left:
                return hold(f"budget_spent: {actions} resizes")
            return self._actuate(now, "shrink", replicas, signals,
                                 snapshot)
        if occ is not None and occ < p.occ_shrink and not quiet:
            return hold("hysteresis: idle occupancy but burn/shed "
                        "between the bands")
        return hold("steady")

    def _actuate(self, now: float, direction: str, replicas: int,
                 signals: Dict[str, Any],
                 snapshot: Dict[str, Any]) -> ScaleDecision:
        p = self.policy
        if direction == "grow":
            step = min(p.grow_step, p.max_replicas - replicas)
            chips = step * (self.arbiter.chips_per_replica
                            if self.arbiter else 1)
            if self.arbiter is not None and \
                    not self.arbiter.acquire_serving(chips, now):
                return ScaleDecision(
                    ts=now, verdict="hold",
                    reason="no_chips: arbiter denied (training at floor)",
                    replicas=replicas, target=None, signals=signals,
                    snapshot=snapshot)
        else:
            step = min(p.shrink_step, replicas - p.min_replicas)
        try:
            if direction == "grow":
                target = int(self.pool.grow(step))
            else:
                target = int(self.pool.shrink(step))
        except Exception as exc:  # noqa: BLE001 — an actuation failure
            #                       is a recorded verdict; chips granted
            #                       for a failed grow go back
            if direction == "grow" and self.arbiter is not None:
                self.arbiter.release_serving(chips, now)
            return ScaleDecision(
                ts=now, verdict="error",
                reason=f"{direction} failed: {exc}", replicas=replicas,
                target=None, signals=signals, snapshot=snapshot)
        if direction == "shrink" and self.arbiter is not None:
            self.arbiter.release_serving(
                step * self.arbiter.chips_per_replica, now)
        with self._lock:
            self._actions += 1
            self._pressure_streak = self._idle_streak = 0
            if direction == "grow":
                self._last_grow_at = now
            else:
                self._last_shrink_at = now
        return ScaleDecision(ts=now, verdict=direction,
                             reason=f"{direction} {replicas}→{target}",
                             replicas=replicas, target=target,
                             signals=signals, snapshot=snapshot)

    def _finish(self, decision: ScaleDecision) -> ScaleDecision:
        self.decisions.append(decision)
        self._c_decisions.inc(1, scaler=self.name,
                              verdict=decision.verdict)
        count = self._safe_count()
        if count >= 0:
            self._g_replicas.set(count, scaler=self.name)
        # the postmortem contract: every decision rides the flight ring
        # and the fault call log WITH the /sloz snapshot that justified
        # it, so "why did the controller act" is replayable
        flight_record("autoscale_decide", scaler=self.name,
                      verdict=decision.verdict, reason=decision.reason,
                      replicas=decision.replicas, target=decision.target,
                      signals=dict(decision.signals),
                      sloz=decision.snapshot)
        get_faults().note("autoscale.decide", scaler=self.name,
                          verdict=decision.verdict,
                          reason=decision.reason,
                          replicas=decision.replicas,
                          target=decision.target,
                          sloz=decision.snapshot)
        return decision

    # -- the thread --------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — the loop must outlive
                    pass           # any single poll's surprise
                self._stop.wait(self.poll_interval_s)

        self._thread = threading.Thread(
            target=loop, name=f"autoscaler-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
