"""The port's SLO autoscaler (``synapseml_tpu_torch.serving.autoscaler``)
held against the JAX package's on the CPU.

The synthetic ``/sloz`` feeds of ``tests/test_autoscaler.py`` go through
both packages' ``Autoscaler`` over fake pools on one injected clock: the
decision sequences (verdict, reason, replicas before and after, the
reduced signals) and the pools' resize calls are equal, with and without
a ``CapacityArbiter``.  Then the port's own versions of the arbiter's
yield / reclaim accounting (also through a real ``GangSupervisor``'s
resize listener), ``SupervisorPool``, the flight-recorded decisions, and
the zero-drop controller-initiated shrink of a ``ServingReplicaSet``
behind a ``ReplicaRouter``.
"""

import itertools
import json
import threading
import urllib.request

import pytest

from synapseml_tpu.serving import autoscaler as JA
from synapseml_tpu.telemetry.slo import SLOZ_SCHEMA_VERSION as J_SLOZ
from synapseml_tpu_torch.parallel import GangSupervisor
from synapseml_tpu_torch.resilience import get_faults
from synapseml_tpu_torch.serving import (AutoscalePolicy, Autoscaler,
                                         CapacityArbiter, ReplicaRouter,
                                         ServingReplicaSet, ServingReply,
                                         ServingServer, SupervisorPool,
                                         sloz_signals)
from synapseml_tpu_torch.serving import autoscaler as PA
from synapseml_tpu_torch.telemetry import get_registry
from synapseml_tpu_torch.telemetry.flight import get_flight
from synapseml_tpu_torch.telemetry.slo import (SLOZ_SCHEMA_VERSION,
                                               check_sloz)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

_names = itertools.count()


def _name(tag):
    return f"pt-as-{tag}-{next(_names)}"


def make_sloz(burn=None, shed=0.0, occ=0.5, samples=10, planes=1):
    """tests/test_autoscaler.py's check_sloz-valid snapshot with the
    decision inputs pinned."""
    def plane():
        sig = {"count": samples, "mean_s": 0.1, "p50_s": 0.1,
               "p95_s": 0.2, "p99_s": 0.3}
        slo = {}
        if burn is not None:
            slo["ttft"] = {"threshold_s": 0.5, "target": 0.95,
                           "attainment": max(0.0, 1.0 - 0.05 * burn),
                           "burn_rate": burn}
        return {"window_s": 60.0, "slices": 6,
                "signals": {"ttft": dict(sig), "token_latency": dict(sig)},
                "occupancy": {"mean": occ, "samples": samples},
                "rates": {"admitted_per_s": 1.0, "shed_per_s": shed,
                          "retired_per_s": 1.0, "shed_ratio": shed},
                "slo": slo}
    snap = {"schema_version": SLOZ_SCHEMA_VERSION, "generated_unix": 0.0,
            "window_s": 60.0,
            "planes": {f"p{i}": plane() for i in range(planes)}}
    check_sloz(snap)
    return snap


class FakePool:
    def __init__(self, n=2, warming=0):
        self.n, self.warming, self.calls = n, warming, []

    def replica_count(self):
        return self.n

    def warming_count(self):
        return self.warming

    def grow(self, k=1):
        self.n += k
        self.calls.append(("grow", k))
        return self.n

    def shrink(self, k=1):
        self.n -= k
        self.calls.append(("shrink", k))
        return self.n


class FakeGang:
    """The arbiter-facing supervisor duck type: resize applies at once
    and listeners see the applied event."""

    def __init__(self, world_size=3, min_ranks=1):
        self.world_size = world_size
        self.min_ranks = min_ranks
        self.resizes = []
        self._listeners = []

    def resize(self, n):
        if n < 1 or n < self.min_ranks:
            raise ValueError(f"resize({n}) below min_ranks={self.min_ranks}")
        self.resizes.append(n)
        old, self.world_size = self.world_size, n
        for fn in self._listeners:
            fn({"from": old, "to": n, "cause": "resize_request"})

    def add_resize_listener(self, fn):
        self._listeners.append(fn)


def scaler(mod, pool, feed, arbiter=None, name="t-scale", **policy_kw):
    policy_kw.setdefault("sustain_polls", 2)
    policy_kw.setdefault("grow_cooldown_s", 10.0)
    policy_kw.setdefault("shrink_cooldown_s", 10.0)
    feed = list(feed)
    state = {"i": 0}

    def source():
        snap = feed[min(state["i"], len(feed) - 1)]
        state["i"] += 1
        if isinstance(snap, Exception):
            raise snap
        return snap

    return mod.Autoscaler(pool, source=source,
                          policy=mod.AutoscalePolicy(**policy_kw),
                          arbiter=arbiter, name=name, clock=lambda: 0.0)


# ---------------------------------------------------------------------------
# the decision table, through both packages
# ---------------------------------------------------------------------------

def _foreign():
    snap = make_sloz(shed=0.5)
    snap["schema_version"] = 99
    return snap


#: (pool kwargs, feed, policy kwargs, poll times, pool changes between
#: polls {poll index: warming count})
FEEDS = {
    "grow_on_shed": (dict(n=2), [make_sloz(shed=0.2)], {}, [0, 1], {}),
    "grow_on_burn": (dict(n=2), [make_sloz(burn=2.0)], {}, [0, 1], {}),
    "one_hot_window": (dict(n=2), [make_sloz(shed=0.5), make_sloz(occ=0.6)],
                       {}, [0, 1, 2, 3, 4], {}),
    "shrink_on_idle": (dict(n=3), [make_sloz(burn=0.1, occ=0.05)], {},
                       [0, 1], {}),
    "hysteresis": (dict(n=3), [make_sloz(burn=0.7, occ=0.05)], {},
                   range(6), {}),
    "grow_cooldown": (dict(n=2), [make_sloz(shed=0.2)],
                      dict(sustain_polls=1), [0, 1, 11], {}),
    "shrink_cooldown": (dict(n=4), [make_sloz(burn=0.1, occ=0.05)],
                        dict(sustain_polls=1), [0, 1, 11], {}),
    "warming_in_flight": (dict(n=2, warming=1), [make_sloz(shed=0.3)],
                          dict(sustain_polls=1), [0, 1], {1: 0}),
    "budget": (dict(n=2), [make_sloz(shed=0.2)],
               dict(sustain_polls=1, max_resizes=1, grow_cooldown_s=0.5),
               [0, 5], {}),
    "at_max": (dict(n=4), [make_sloz(shed=0.2)],
               dict(sustain_polls=1, max_replicas=4), [0], {}),
    "at_min": (dict(n=1), [make_sloz(burn=0.1, occ=0.01)],
               dict(sustain_polls=1), [0], {}),
    "empty_windows": (dict(n=2), [make_sloz(shed=0.2), make_sloz(samples=0),
                                  make_sloz(shed=0.2)], {}, [0, 1, 2], {}),
    "broken_source": (dict(n=2), [RuntimeError("socket down")], {}, [0], {}),
    "foreign_schema": (dict(n=2), [_foreign()], {}, [0], {}),
    "multi_plane": (dict(n=3), [make_sloz(burn=0.3, occ=0.8, planes=3)],
                    dict(sustain_polls=1), [0, 1], {}),
    "mixed_trend": (dict(n=2), [make_sloz(shed=0.2)] * 3
                    + [make_sloz(burn=0.1, occ=0.05)] * 4
                    + [make_sloz(burn=0.7, occ=0.05)],
                    dict(shrink_cooldown_s=0.0), range(9), {}),
}


def _decisions(mod, row):
    pool_kw, feed, policy_kw, times, changes = FEEDS[row]
    pool = FakePool(**pool_kw)
    a = scaler(mod, pool, feed, name=f"pt-as-parity-{row}", **policy_kw)
    out = []
    for i, t in enumerate(times):
        if i in changes:
            pool.warming = changes[i]
        d = a.poll_once(now=float(t))
        out.append((d.verdict, d.reason, d.replicas, d.target,
                    dict(d.signals)))
    return out, pool.calls


@pytest.mark.parametrize("row", sorted(FEEDS))
def test_decision_sequence_equal_to_reference(row):
    assert SLOZ_SCHEMA_VERSION == J_SLOZ
    got = _decisions(PA, row)
    assert got == _decisions(JA, row)
    verdicts = [d[0] for d in got[0]]
    if row in ("grow_on_shed", "grow_on_burn"):
        assert verdicts == ["hold", "grow"]
    if row == "shrink_on_idle":
        assert verdicts == ["hold", "shrink"]
    if row in ("broken_source", "foreign_schema"):
        assert verdicts == ["error"]


def _arbiter_run(mod, reclaim_after_s=5.0):
    gang = FakeGang(world_size=3)
    arb = mod.CapacityArbiter(4, name="pt-as-arb-parity",
                              reclaim_after_s=reclaim_after_s)
    arb.attach_training(gang, preferred_ranks=3, min_ranks=1)
    arb.register_serving(1)
    pool = FakePool(n=1)
    a = scaler(mod, pool, [make_sloz(shed=0.3), make_sloz(shed=0.3),
                           make_sloz(burn=0.1, occ=0.05)],
               arbiter=arb, sustain_polls=1, shrink_cooldown_s=0.0)
    out = []
    for t in (0.0, 1.0, 2.0, 20.0):
        d = a.poll_once(now=t)
        out.append((d.verdict, d.reason, arb.serving_chips(),
                    arb.training_chips(), arb.free_chips(), gang.world_size))
    return out, gang.resizes, pool.calls


def test_arbiter_decisions_equal_to_reference():
    got = _arbiter_run(PA)
    assert got == _arbiter_run(JA)
    assert got[0][0][0] == "grow" and got[1] == [2, 3]


def test_sloz_signals_equal_to_reference():
    snap = make_sloz(burn=0.3, shed=0.0, occ=0.8, planes=1)
    snap["planes"]["hot"] = make_sloz(burn=2.0, shed=0.1,
                                      occ=0.1)["planes"]["p0"]
    snap["planes"]["/a@phase=prefill"] = make_sloz(
        burn=5.0, shed=0.0, occ=0.9)["planes"]["p0"]
    for phase in (None, "prefill", "decode"):
        assert sloz_signals(snap, phase=phase) == \
            JA.sloz_signals(snap, phase=phase)
    sig = sloz_signals(snap)
    assert sig["max_burn"] == 5.0 and sig["min_occupancy"] == 0.1
    assert sloz_signals(snap, phase="prefill")["planes"] == 1
    assert PA.AUTOSCALE_METRICS == JA.AUTOSCALE_METRICS


def test_policy_rejects_flappy_bands():
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscalePolicy(burn_shrink=1.0, burn_grow=1.0)
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscalePolicy(min_replicas=3, max_replicas=2)


def test_every_decision_flight_recorded_with_sloz():
    faults = get_faults()
    faults.clear()
    faults.record_calls = True
    try:
        snap = make_sloz(shed=0.2)
        name = _name("flight")
        a = scaler(PA, FakePool(n=2), [snap], name=name, sustain_polls=1)
        a.poll_once(now=0.0)
        evs = [e for e in get_flight().events()
               if e["kind"] == "autoscale_decide" and e.get("scaler") == name]
        assert evs and evs[-1]["verdict"] == "grow"
        assert evs[-1]["sloz"]["planes"] == snap["planes"]
        notes = faults.calls_for("autoscale.decide")
        assert notes and notes[-1]["verdict"] == "grow"
        assert notes[-1]["sloz"] is snap
        c = get_registry().counter("autoscale_decisions_total", "",
                                   ("scaler", "verdict"))
        assert c.value(scaler=name, verdict="grow") == 1
        g = get_registry().gauge("autoscale_replicas", "", ("scaler",))
        assert g.value(scaler=name) == 3
    finally:
        faults.record_calls = False
        faults.call_log.clear()


def test_start_stop_polls_on_its_thread():
    pool = FakePool(n=2)
    a = Autoscaler(pool, source=lambda: make_sloz(shed=0.3),
                   policy=AutoscalePolicy(sustain_polls=1,
                                          grow_cooldown_s=0.0,
                                          max_replicas=3),
                   name=_name("thread"), poll_interval_s=0.01)
    a.start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            a.start()
        for _ in range(500):
            if pool.n == 3 and len(a.decisions) >= 3:
                break
            threading.Event().wait(0.01)
    finally:
        a.stop()
    assert pool.n == 3 and a._thread is None
    assert a.decisions[-1].reason.startswith("at_max")


# ---------------------------------------------------------------------------
# TestCapacityArbiter, on the port
# ---------------------------------------------------------------------------

def _arb(total=4, gang=None, preferred=3, floor=1, **kw):
    kw.setdefault("reclaim_after_s", 5.0)
    arb = CapacityArbiter(total, name=_name("arb"), **kw)
    if gang is not None:
        arb.attach_training(gang, preferred_ranks=preferred, min_ranks=floor)
    return arb


def test_free_pool_serves_first():
    gang = FakeGang(world_size=2)
    arb = _arb(total=4, gang=gang, preferred=2)
    arb.register_serving(1)
    assert arb.acquire_serving(1, now=0.0)
    assert gang.resizes == []
    assert (arb.serving_chips(), arb.free_chips()) == (2, 0)


def test_training_yields_and_floor_blocks():
    gang = FakeGang(world_size=3)
    arb = _arb(total=4, gang=gang)
    arb.register_serving(1)
    assert arb.acquire_serving(1, now=0.0)
    assert gang.resizes == [2]
    assert arb.training_chips() == 2 and arb.serving_chips() == 2
    gang2 = FakeGang(world_size=2, min_ranks=2)
    arb2 = _arb(total=3, gang=gang2, preferred=2, floor=2)
    arb2.register_serving(1)
    assert not arb2.acquire_serving(1, now=0.0)
    assert gang2.resizes == [] and arb2.serving_chips() == 1


def test_reclaim_gated_until_quiet():
    gang = FakeGang(world_size=3)
    arb = _arb(total=4, gang=gang, reclaim_after_s=5.0)
    arb.register_serving(1)
    arb.acquire_serving(1, now=0.0)
    arb.release_serving(1, now=1.0)
    assert arb.reclaim(now=2.0) == 0
    assert arb.reclaim(now=6.0) == 1
    assert gang.resizes == [2, 3]
    assert arb.training_chips() == 3 and arb.free_chips() == 0


def test_gauges_track_sides():
    gang = FakeGang(world_size=3)
    arb = _arb(total=4, gang=gang)
    arb.register_serving(1)
    g = get_registry().gauge("autoscale_chips", "", ("arbiter", "side"))
    assert g.value(arbiter=arb.name, side="serving") == 1
    assert g.value(arbiter=arb.name, side="training") == 3
    assert g.value(arbiter=arb.name, side="free") == 0


def test_listener_reconciles_a_real_supervisors_resize():
    """``attach_training`` on the port's ``GangSupervisor`` registers the
    resize listener: a resize the gang applies for its own reasons moves
    the training entitlement, and the freed cards show up as free."""
    sup = GangSupervisor("torch_gang_tasks:never_runs", 3, device="cpu",
                         min_ranks=1)
    arb = _arb(total=4, gang=sup, preferred=3)
    assert arb.training_chips() == 3 and arb.free_chips() == 1
    sup._apply_resize(0, 2, cause="exit", automatic=True)
    assert arb.training_chips() == 2 and arb.free_chips() == 2
    with pytest.raises(ValueError):
        sup.resize(0)


# ---------------------------------------------------------------------------
# TestSupervisorPool and TestControllerShrinkZeroDrop, on the port
# ---------------------------------------------------------------------------

def test_supervisor_pool_resizes_and_refreshes():
    gang = FakeGang(world_size=3)
    refreshed = []
    pool = SupervisorPool(gang, refresh_fn=lambda: refreshed.append(1))
    assert pool.replica_count() == 3
    assert pool.grow(1) == 4 and gang.world_size == 4
    assert pool.shrink(2) == 2 and gang.world_size == 2
    assert len(refreshed) == 2

    class R:
        def warming_count(self):
            return 2
    assert SupervisorPool(FakeGang(), router=R()).warming_count() == 2
    assert SupervisorPool(FakeGang()).warming_count() == 0


class _EchoReplica:
    """A live ServingServer + reply thread, shaped for the pool's replica
    duck type (address / health / drain / close)."""

    def __init__(self, i):
        self.i = i
        self.server = ServingServer()
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                for req in self.server.get_batch(max_rows=8,
                                                 timeout_s=0.05):
                    self.server.reply(req.id, ServingReply(
                        200, json.dumps({"replica": i}).encode()))

        threading.Thread(target=loop, daemon=True).start()

    @property
    def address(self):
        return self.server.address

    @property
    def health(self):
        return self.server.health

    def drain(self, timeout_s=10.0):
        return self.server.drain(timeout_s=timeout_s)

    def close(self):
        self._stop.set()
        self.server.close()


def test_controller_shrink_drops_nothing():
    """``ServingReplicaSet.shrink`` takes the departing address out of the
    routing table first, then drains it: every issued request is answered,
    no later route names it, and its breaker and probe row are released."""
    from synapseml_tpu_torch.resilience import breaker as PB
    counter = iter(range(100))
    pool = ServingReplicaSet(lambda: _EchoReplica(next(counter)),
                             drain_timeout_s=10.0)
    try:
        pool.grow(3)
        name = _name("shrink")
        router = ReplicaRouter(pool.addresses(), name=name)
        pool.router = router
        router.probe_all()
        departed = pool.addresses()[-1]
        key = f"replica:{name}:{departed[0]}:{departed[1]}"
        assert key in PB._breakers
        answered, routed_after = [], []
        shrunk = False
        for k in range(60):
            rank, _, url = router.route()[:3]
            if shrunk:
                routed_after.append(url)
            rep = urllib.request.urlopen(urllib.request.Request(
                url, data=json.dumps({"x": k}).encode()), timeout=10)
            answered.append(json.loads(rep.read())["replica"])
            router.report(rank, ok=True)
            if k == 20:
                assert pool.shrink(1) == 2
                shrunk = True
        assert len(answered) == 60
        host = f"http://{departed[0]}:{departed[1]}"
        assert all(host not in u for u in routed_after)
        assert pool.replica_count() == 2
        assert key not in PB._breakers
        g = get_registry().gauge("serving_replica_probe_status", "",
                                 ("router", "rank"))
        assert (name, "2") not in g.series()
    finally:
        pool.close()


def test_warming_count_reads_health_in_process():
    pool = ServingReplicaSet(lambda: _EchoReplica(99))
    try:
        pool.grow(1)
        assert pool.warming_count() == 0
        replica = pool.replicas()[0]
        replica.health.set_warmup(lambda: {"state": "warming"})
        assert pool.warming_count() == 1
        replica.health.set_warmup(None)
    finally:
        pool.close()
