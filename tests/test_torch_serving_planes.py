"""The port's copies of the serving planes held against the JAX package's
modules under the same seeded event sequences and an injected clock, on
the CPU: the metrics registry and its exposition text, the windowed SLO
plane (windows, quantiles, attainment, burn rates, the ``/sloz``
snapshot), the multi-tenant QoS scheduler (admission order, budgets,
preemption verdicts, Jain fairness), the retry budget's token bucket,
``retry_after_from_depth``, the request trace store and the atomic
artifact writer.  Every comparison is exact.
"""

import dataclasses
import random

import numpy as np
import pytest

from synapseml_tpu.resilience import health as JH
from synapseml_tpu.serving import qos as JQ
from synapseml_tpu.telemetry import artifact as JA
from synapseml_tpu.telemetry import exposition as JX
from synapseml_tpu.telemetry import registry as JR
from synapseml_tpu.telemetry import slo as JS
from synapseml_tpu.telemetry import tracing as JT
from synapseml_tpu_torch.resilience import health as PH
from synapseml_tpu_torch.resilience import policy as PP
from synapseml_tpu_torch.serving import qos as PQ
from synapseml_tpu_torch.telemetry import artifact as PA
from synapseml_tpu_torch.telemetry import exposition as PX
from synapseml_tpu_torch.telemetry import registry as PR
from synapseml_tpu_torch.telemetry import slo as PS
from synapseml_tpu_torch.telemetry import tracing as PT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _feed_registry(R, seed):
    """One seeded sequence of counter / gauge / histogram updates."""
    reg = R.MetricsRegistry()
    rng = random.Random(seed)
    c = reg.counter("req_total", "requests", ("api", "code"))
    g = reg.gauge("depth", "queue depth", ("api",))
    h = reg.histogram("lat_seconds", "latency", ("api",),
                      buckets=R.SERVING_TTFT_BUCKETS)
    h2 = reg.histogram("plain_seconds", "default buckets")
    for _ in range(300):
        api = rng.choice(["/a", "/b", '/q"x\\y'])
        c.inc(rng.randint(1, 3), api=api, code=rng.choice([200, 503]))
        g.set(rng.random() * 10, api=api)
        h.observe(rng.expovariate(20.0), api=api)
        h2.observe(rng.random())
    g.set(float("nan"), api="/nan")
    g.set(float("inf"), api="/inf")
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_exposition_identical(seed):
    jr, pr = _feed_registry(JR, seed), _feed_registry(PR, seed)
    assert PX.render_prometheus(pr) == JX.render_prometheus(jr)
    assert PX.render_json(pr) == JX.render_json(jr)
    jh, ph = jr.get("lat_seconds"), pr.get("lat_seconds")
    for api in ("/a", "/b"):
        assert ph.stats(api=api) == jh.stats(api=api)
        for q in (0.5, 0.9, 0.99):
            assert ph.quantile(q, api=api) == jh.quantile(q, api=api)
    jr.reset()
    pr.reset()
    assert PX.render_prometheus(pr) == JX.render_prometheus(jr)


def _feed_slo(S, seed, name):
    rng = random.Random(seed)
    w = S.SloWindow(name, window_s=10.0, slices=5)
    w.set_objective("ttft", 0.05)
    w.set_objective("token_latency", 0.01, target=0.95)
    t = 100.0
    snaps = []
    for i in range(400):
        t += rng.expovariate(30.0)
        w.observe_ttft(rng.expovariate(25.0), now=t)
        w.observe_token_latency(rng.expovariate(150.0), now=t)
        w.observe_occupancy(rng.random(), now=t)
        w.count(rng.choice(S.SloWindow.KINDS), now=t)
        if i % 50 == 49:
            snaps.append((w.snapshot(now=t),
                          w.burn_rate("ttft", now=t),
                          w.attainment("token_latency", now=t)))
    return snaps


@pytest.mark.parametrize("seed", [0, 3])
def test_slo_windows_and_burn_rates_equal(seed):
    assert _feed_slo(PS, seed, f"pt-{seed}") == _feed_slo(JS, seed,
                                                          f"pt-{seed}")


def test_sloz_snapshot_and_plane_names_equal():
    for S in (JS, PS):
        assert S.tenant_plane_name("/g", "t1") == "/g@tenant=t1"
        assert S.plane_tenant("/g@tenant=t1") == "t1"
        assert S.phase_plane_name("/g", "decode") == "/g@phase=decode"
    assert PS.SLOZ_SCHEMA == JS.SLOZ_SCHEMA
    assert PS.SLOZ_SCHEMA_VERSION == JS.SLOZ_SCHEMA_VERSION
    assert PS.SLO_METRICS == JS.SLO_METRICS
    snaps = []
    for S in (JS, PS):
        store = S.SloStore()
        w = store.window("/g")
        w.set_objective("ttft", 0.1)
        w.observe_ttft(0.05, now=5.0)
        w.count("admitted", now=5.0)
        snap = store.snapshot()
        S.check_sloz(snap)
        snap.pop("generated_unix")
        snaps.append(snap)
    # the store's snapshot reads the wall clock: compare its structure
    assert _keys(snaps[1]) == _keys(snaps[0])


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return type(obj).__name__


@dataclasses.dataclass
class Item:
    tenant: str
    priority: object = None
    remaining: int = 0
    slot: int = 0


def _drive_qos(Q, seed):
    """Admission rounds, charges, budgets and preemption verdicts on a
    fake clock → the list of every decision."""
    clock = Clock()
    q = Q.QosScheduler(policies={
        "gold": Q.TenantPolicy(weight=3.0, priority=2),
        "silver": Q.TenantPolicy(weight=1.0, rate_tokens_per_s=50.0,
                                 burst_tokens=80.0),
        "bronze": Q.TenantPolicy(weight=0.5, priority=0)},
        quantum_tokens=16.0, preempt_min_interval_s=0.5, clock=clock)
    rng = random.Random(seed)
    out = []
    tenants = ["gold", "silver", "bronze", "anon"]
    for rnd in range(60):
        clock.t += rng.uniform(0.0, 0.3)
        waiting = [Item(rng.choice(tenants),
                        rng.choice([None, None, 0, 1, 3]),
                        rng.randint(1, 64), i)
                   for i in range(rng.randint(0, 8))]
        order = q.admission_order(waiting)
        out.append(("order", [(w.tenant, w.slot) for w in order]))
        for w in order[:3]:
            q.charge(w.tenant, rng.randint(1, 12))
        t = rng.choice(tenants)
        out.append(("shed", t, q.shed_verdict(t, rng.uniform(1, 100))))
        active = [Item(rng.choice(tenants), rng.choice([None, 0, 1]),
                       rng.randint(1, 64), 100 + i) for i in range(4)]
        v = q.preemption_victim(rng.choice([0, 1, 2, 3]), active)
        out.append(("victim", None if v is None else v.slot))
        if v is not None and rng.random() < 0.7:
            q.commit_preemption()
        out.append(("pressure", q.pressure_snapshot(waiting, 0)))
        out.append(("prio", [q.priority_of(w) for w in waiting]))
    out.append(("sheds", dict(q.budget_sheds), q.preemptions))
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_qos_decisions_equal(seed):
    assert _drive_qos(PQ, seed) == _drive_qos(JQ, seed)


def test_jain_fairness_equal():
    rng = np.random.default_rng(0)
    for shares in ([], [1.0], [0.0, 0.0], [1, 1, 1],
                   list(rng.random(17)), [5.0, 0.0, 0.1]):
        assert PQ.jain_fairness(shares) == JQ.jain_fairness(shares)


def _drive_budget(Q, seed):
    """One seeded sequence of spends and reads on the QoS plane's token
    bucket (the retry budget on the scheduler's clock)."""
    clock = Clock()
    b = Q._ClockedBudget(4.0, 1.5, clock)
    rng = random.Random(seed)
    out = []
    for _ in range(200):
        clock.t += rng.uniform(0.0, 0.9)
        out.append((b.try_spend(rng.choice([0.5, 1.0, 2.0])), b.tokens()))
    return out


@pytest.mark.parametrize("seed", [3, 5, 11])
def test_retry_budget_equal(seed):
    assert _drive_budget(PQ, seed) == _drive_budget(JQ, seed)
    with pytest.raises(ValueError):
        PP.RetryBudget(capacity=0)


def test_retry_after_from_depth_equal():
    for depth in (0, 1, 7, 100, 10_000):
        for rps in (0.0, 0.5, 3.0, 250.0):
            for floor in (1, 2):
                assert PH.retry_after_from_depth(depth, rps, floor) == \
                    JH.retry_after_from_depth(depth, rps, floor)


def test_health_readyz_states_equal():
    warm = {"state": "warming", "programs_warm": 1}
    outs = []
    for H in (JH, PH):
        h = H.HealthState("pt-health")
        seq = [h.healthz(), h.readyz(3, 1.0)]
        h.set_warmup(lambda: warm)
        seq.append(h.readyz(3, 1.0))
        warm_state = dict(warm, state="failed")
        h.set_warmup(lambda: warm_state)
        seq.append(h.readyz(3, 1.0))
        h.set_warmup(None)
        h.begin_drain()
        seq.append(h.readyz(10, 2.0))
        h.finish_drain()
        h.mark_closed()
        seq.append(h.healthz())
        outs.append(seq)
    assert outs[1] == outs[0]


def test_request_traces_equal():
    outs = []
    for T in (JT, PT):
        store = T.RequestTraceStore(max_traces=4, sample_every=2)
        ids = []
        for i in range(7):
            tid = store.begin(None if i % 3 else f"up-{i}", api="/g")
            ids.append(tid)
            store.event(tid, "queued", prompt_tokens=i)
            store.event(tid, "decode", slot=i % 2, tokens=1)
            if i % 2:
                store.finish(tid, "retired", tokens=i)
        snap = store.snapshot(10)
        outs.append([[(e["name"], {k: v for k, v in e.items()
                                   if k != "t_s"})
                      for e in tr["events"]] + [tr.get("outcome"),
                                                tr.get("api")]
                     for tr in snap["traces"]]
                    + [tid is None for tid in ids])
    assert outs[1] == outs[0]


def test_artifact_write_is_atomic_and_equal(tmp_path, monkeypatch):
    """The contract behind the reference's kill-mid-write test (which
    fails under its current jax): the file is either the previous
    version or the new one, never a partial write, and it reads back
    equal to what the reference writes."""
    obj = {"a": [1, 2.5, None], "b": {"c": "x" * 100}}
    jp, pp = tmp_path / "j.json", tmp_path / "p.json"
    JA.write_json(str(jp), obj)
    PA.write_json(str(pp), obj)
    assert pp.read_bytes() == jp.read_bytes()
    assert PA.read_json(str(pp)) == JA.read_json(str(jp)) == obj
    # a failure between the temp write and the replace leaves the old file
    import os

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        PA.write_json(str(pp), {"new": True})
    assert PA.read_json(str(pp)) == obj
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j.json", "p.json"]
    with pytest.raises(PA.SchemaError):
        PA.check_schema({"x": 1}, ("x", "y"))
