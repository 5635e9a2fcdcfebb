"""The port's disaggregated prefill (``synapseml_tpu_torch.serving.
disagg``) held against the JAX package's on the CPU.

- Every row of the handoff outcome table (``ok`` / ``corrupt`` /
  ``timeout`` / ``expired`` / ``fallback``), driven with the JAX test's
  fake worker (``tests/test_disagg.py``) through both packages' pools,
  each under its own fault registry: the outcome sequence, the decode
  arena's entries, the outcome counters and the retry sleeps are equal.
- The pool as an autoscaler actuator: grow / shrink track the replica
  gauge and release the shrunk workers' breakers; two per-phase
  autoscalers scale the prefill and decode pools independently.
- A handoff then an admit on the port's f32 tiny engine
  (``LlamaConfig.tiny(num_layers=2, max_len=96)``, the JAX init carried
  across with ``params_from_reference``): the greedy tokens equal the
  JAX package's ``generate`` exactly, plain and speculative, and under
  every degraded outcome.
- ``LLMServer(prefill_pool=)`` end to end over HTTP, with ``/sloz``
  serving the ``@phase=prefill`` and ``@phase=decode`` planes; the repin
  → journal-resume failover behind a role-aware router; a SIGKILL
  mid-handoff in a subprocess of the port; and a corrupt-wire soak with
  zero wrong tokens.
"""

import itertools
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu.models.llm import kvtier as JK
from synapseml_tpu.resilience import get_faults as j_faults
from synapseml_tpu.serving import disagg as JDG
from synapseml_tpu.telemetry import get_registry as j_registry
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.models.llm import kvtier as PK
from synapseml_tpu_torch.resilience import breaker as PB
from synapseml_tpu_torch.resilience import get_faults as p_faults
from synapseml_tpu_torch.serving import disagg as PDG
from synapseml_tpu_torch.telemetry import get_registry as p_registry
from synapseml_tpu_torch.telemetry.slo import check_sloz, phase_plane_name
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_names = itertools.count()


def _name(tag):
    return f"pt-dsg-{tag}-{next(_names)}"


@pytest.fixture(scope="module")
def pair():
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=jnp.float32)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=torch.float32)
    jm = J.LlamaModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu"))
    return jm, variables, tm


@pytest.fixture
def faults():
    """Both packages' fault registries, cleared, seeded alike and set to
    record sleeps without sleeping."""
    regs = (p_faults(), j_faults())
    for reg in regs:
        reg.clear()
        reg.seed(20260803)
        reg.no_sleep = True
    yield regs
    for reg in regs:
        reg.clear()
        reg.no_sleep = False


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 512, (n, length)).astype(np.int32)


def _metric(registry, name, **labels):
    m = registry().get(name)
    return 0.0 if m is None else m.value(**labels)


def _rows(rng, layers=2, span=6, kh=2, dh=8):
    return [{"k": rng.normal(size=(span, kh, dh)).astype(np.float32),
             "v": rng.normal(size=(span, kh, dh)).astype(np.float32)}
            for _ in range(layers)]


class _FakeWorker:
    """tests/test_disagg.py's deterministic K/V source: rows derived from
    the prompt, so two workers given the same prompt frame alike."""

    def __init__(self, fail_times=0, sleep_s=0.0, exc=RuntimeError):
        self.fail_times = fail_times
        self.sleep_s = sleep_s
        self.exc = exc
        self.calls = 0

    def prefill(self, ids, tenant="default"):
        self.calls += 1
        if self.fail_times > 0:
            self.fail_times -= 1
            raise self.exc("prefill replica unreachable")
        if self.sleep_s:
            time.sleep(self.sleep_s)
        return _rows(np.random.default_rng(sum(ids)), span=len(ids))


class _Bomb:
    def put(self, *a, **k):
        raise RuntimeError("adoption exploded")


# ---------------------------------------------------------------------------
# the outcome table, through both packages
# ---------------------------------------------------------------------------

IDS = list(range(1, 13))

#: (row, pool kwargs, fault rules, handoff prompts, the expected outcomes)
SCENARIOS = {
    "ok": (dict(), [], [IDS], ["ok"]),
    "unbound": (dict(bind=False), [], [[1, 2, 3]], ["fallback"]),
    "short_prompt": (dict(min_prompt=8), [], [[1, 2, 3]], ["fallback"]),
    "empty_pool": (dict(workers=[]), [], [IDS], ["fallback"]),
    "corrupt": (dict(), [("disagg.transfer", "corrupt", {})], [IDS],
                ["corrupt"]),
    "drop": (dict(), [("disagg.transfer", "drop", {})], [IDS], ["timeout"]),
    "late_worker": (dict(worker=dict(sleep_s=0.08), lease_s=0.04), [],
                    [IDS], ["expired"]),
    "delay_fault": (dict(lease_s=0.04, real_sleep=True),
                    [("disagg.transfer", "delay", {"delay_s": 0.08})],
                    [IDS], ["expired"]),
    "retry_then_ok": (dict(worker=dict(fail_times=2), failure_threshold=3),
                      [], [IDS], ["ok"]),
    "down_then_breaker": (dict(worker=dict(fail_times=99),
                               failure_threshold=3), [], [IDS, IDS],
                          ["fallback", "fallback"]),
    "redelivery": (dict(), [], [IDS, IDS], ["ok", "ok"]),
    "phase_decode_rule": (dict(), [("disagg.transfer", "corrupt",
                                    {"phase": "decode"})], [IDS], ["ok"]),
    "phase_prefill_rule": (dict(), [("disagg.transfer", "corrupt",
                                     {"phase": "prefill"})],
                           [list(range(20, 40))], ["corrupt"]),
    "bomb_arena": (dict(arena="bomb"), [], [IDS], ["fallback"]),
}


def _run_scenario(mod, arena_cls, reg, registry, name, spec):
    pool_kw, rules, prompts, _ = spec
    pool_kw = dict(pool_kw)
    reg.no_sleep = not pool_kw.pop("real_sleep", False)
    for site, kind, kw in rules:
        reg.inject(site, kind, **kw)
    bind = pool_kw.pop("bind", True)
    arena_kind = pool_kw.pop("arena", None)
    worker = _FakeWorker(**pool_kw.pop("worker", {}))
    workers = pool_kw.pop("workers", [worker])
    pool = mod.PrefillPool(workers=workers, name=name, cooldown_s=60.0,
                           **pool_kw)
    arena = _Bomb() if arena_kind == "bomb" else arena_cls(1 << 22,
                                                           name=name)
    if bind:
        pool.bind(f"/{name}", arena, ttft_slo_s=0.5)
    outcomes = [pool.handoff(p, session="s") for p in prompts]
    counts = {o: _metric(registry, "disagg_handoffs_total", pool=name,
                         outcome=o) for o in mod.HANDOFF_OUTCOMES}
    lat = registry().get("disagg_handoff_latency_seconds")
    view = {"outcomes": outcomes, "counts": counts,
            "latency_count": lat.stats(pool=name)["count"],
            "worker_calls": worker.calls,
            "retry_sleeps": len(reg.sleeps_for("disagg.retry")),
            "delay_sleeps": reg.sleeps_for("disagg.transfer")}
    if not isinstance(arena, _Bomb):
        view["arena"] = len(arena)
        view["lcp"] = arena.longest_prefix(prompts[0])[1]
    if pool.slo is not None:
        snap = pool.slo.snapshot()
        view["slo"] = (snap["slo"]["ttft"]["threshold_s"],
                       snap["signals"]["ttft"]["count"])
    return view


@pytest.mark.parametrize("row", sorted(SCENARIOS))
def test_outcome_table_equal_to_reference(row, faults):
    preg, jreg = faults
    spec = SCENARIOS[row]
    got = _run_scenario(PDG, PK.HostKVArena, preg, p_registry,
                        _name(row), spec)
    want = _run_scenario(JDG, JK.HostKVArena, jreg, j_registry,
                         _name(row), spec)
    assert got["outcomes"] == spec[3]
    assert got == want
    assert sum(got["counts"].values()) == len(spec[2])
    if row == "retry_then_ok":
        assert got["retry_sleeps"] == 2
    if row == "down_then_breaker":
        # the breaker opened during the first handoff: the second finds
        # no admissible worker and never calls it
        assert got["worker_calls"] == 3
    if row == "redelivery":
        assert got["arena"] == 1 and got["lcp"] == len(IDS)
    if row == "delay_fault":
        assert got["delay_sleeps"] == [0.08]


def test_outcomes_and_metric_names_equal_reference():
    assert PDG.HANDOFF_OUTCOMES == JDG.HANDOFF_OUTCOMES == (
        "ok", "corrupt", "timeout", "expired", "fallback")
    assert PDG.DISAGG_METRICS == JDG.DISAGG_METRICS
    PDG._disagg_metrics()
    for n in PDG.DISAGG_METRICS:
        assert p_registry().get(n) is not None, n


# ---------------------------------------------------------------------------
# the pool as an actuator
# ---------------------------------------------------------------------------

def test_grow_shrink_track_gauge_and_release_breakers():
    made = []

    def factory():
        made.append(_FakeWorker())
        return made[-1]

    name = _name("scale")
    pool = PDG.PrefillPool(factory=factory, name=name, failure_threshold=1,
                           cooldown_s=60.0)
    assert pool.replica_count() == 0 and pool.warming_count() == 0
    assert pool.grow(3) == 3 and pool.replica_count() == 3
    assert _metric(p_registry, "disagg_pool_replicas", pool=name) == 3
    pool._breaker(2).record_failure()
    key = pool._breaker_key(2)
    assert key in PB._breakers
    assert pool.shrink(2) == 2 and pool.replica_count() == 1
    assert key not in PB._breakers
    assert _metric(p_registry, "disagg_pool_replicas", pool=name) == 1
    assert pool.shrink(5) == 1
    assert pool.grow(1) == 1
    nofac = PDG.PrefillPool(workers=[_FakeWorker()], name=_name("nofac"))
    assert nofac.grow(2) == 0 and nofac.replica_count() == 1


def test_per_phase_autoscalers_scale_pools_independently():
    from synapseml_tpu_torch.serving.autoscaler import (AutoscalePolicy,
                                                        Autoscaler)
    from synapseml_tpu_torch.telemetry.slo import SloStore
    store = SloStore()
    pw = store.window(phase_plane_name("/dsg", "prefill"))
    pw.set_objective("ttft", 0.05)
    dw = store.window(phase_plane_name("/dsg", "decode"))
    dw.set_objective("ttft", 0.05)
    for _ in range(60):
        pw.count("admitted"), pw.count("shed")
        pw.observe_ttft(0.2)
        pw.observe_occupancy(1.0)
        dw.count("admitted"), dw.count("retired")
        dw.observe_ttft(0.001)
        dw.observe_occupancy(0.01)
    snap = store.snapshot()
    prefill_pool = PDG.PrefillPool(factory=_FakeWorker, name=_name("pf"))
    prefill_pool.grow(1)
    decode_pool = PDG.PrefillPool(factory=_FakeWorker, name=_name("dc"))
    decode_pool.grow(3)
    policy = AutoscalePolicy(min_replicas=1, max_replicas=4,
                             sustain_polls=1, grow_cooldown_s=0.0,
                             shrink_cooldown_s=0.0)
    a_pf = Autoscaler(prefill_pool, source=lambda: snap, policy=policy,
                      phase="prefill", name=_name("as-pf"),
                      clock=lambda: 1000.0)
    a_dc = Autoscaler(decode_pool, source=lambda: snap, policy=policy,
                      phase="decode", name=_name("as-dc"),
                      clock=lambda: 1000.0)
    d1 = a_pf.poll_once()
    assert d1.verdict == "grow" and prefill_pool.replica_count() == 2
    d2 = a_dc.poll_once()
    assert d2.verdict == "shrink" and decode_pool.replica_count() == 2
    assert d1.signals["planes"] == d2.signals["planes"] == 1


# ---------------------------------------------------------------------------
# token exactness against the JAX package's generate
# ---------------------------------------------------------------------------

def _engine(tm, name, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 96)
    return P.SlotEngine(tm, name=name, device="cpu", **kw)


@pytest.mark.parametrize("spec", [0, 4], ids=["plain", "spec"])
def test_handoff_then_admit_equals_reference_generate(pair, faults, spec):
    """Prefill on a dedicated engine, the K/V framed into the decode
    engine's arena, then the decode engine's admit restores it: the
    greedy tokens equal the JAX ``generate`` exactly (f32)."""
    jm, variables, tm = pair
    name = _name(f"exact{spec}")
    arena = PK.HostKVArena(1 << 22, name=name)
    worker = PDG.PrefillWorker(_engine(tm, f"{name}-pf"))
    pool = PDG.PrefillPool(workers=[worker], name=name)
    pool.bind(f"/{name}", arena)
    dec = _engine(tm, name, min_prefix=8, kv_arena=arena,
                  spec_draft_len=spec)
    p = _prompts(1, 14, seed=100 + spec)[0]
    ref = np.asarray(J.generate(jm, variables, p[None],
                                max_new_tokens=6)[0])
    assert pool.handoff(p, session="conv") == "ok"
    # the worker handed over the prompt's rows in the cache's dtype, as
    # they sit in its slot
    rows = worker.prefill(p)
    cfg = tm.cfg
    assert len(rows) == cfg.num_layers
    assert rows[0]["k"].shape == (14, cfg.num_kv_heads, cfg.d_head)
    assert rows[0]["k"].dtype == torch.float32
    ok0 = _metric(p_registry, "kvtier_restores_total", engine=name,
                  source="host", outcome="ok")
    r = dec.admit(p, 6)
    assert r.reused_tokens > 0
    assert _metric(p_registry, "kvtier_restores_total", engine=name,
                   source="host", outcome="ok") == ok0 + 1
    np.testing.assert_array_equal(dec.run_to_completion()[r.slot], ref)


@pytest.mark.parametrize("kind,want", [("corrupt", "corrupt"),
                                       ("drop", "timeout"),
                                       ("error", "fallback")])
def test_every_degraded_outcome_still_equals_reference(pair, faults, kind,
                                                       want):
    jm, variables, tm = pair
    preg, _ = faults
    name = _name(f"degrade-{kind}")
    arena = PK.HostKVArena(1 << 22, name=name)
    pool = PDG.PrefillPool(
        workers=[PDG.PrefillWorker(_engine(tm, f"{name}-pf"))], name=name,
        failure_threshold=99, cooldown_s=60.0)
    pool.bind(f"/{name}", arena)
    dec = _engine(tm, name, min_prefix=8, kv_arena=arena)
    preg.inject("disagg.prefill" if kind == "error" else "disagg.transfer",
                kind, times=10)
    p = _prompts(1, 12, seed=120 + len(kind))[0]
    ref = np.asarray(J.generate(jm, variables, p[None],
                                max_new_tokens=5)[0])
    assert pool.handoff(p) == want
    assert len(arena) == 0
    assert _metric(p_registry, "disagg_handoffs_total", pool=name,
                   outcome=want) == 1
    r = dec.admit(p, 5)
    assert r.reused_tokens == 0
    np.testing.assert_array_equal(dec.run_to_completion()[r.slot], ref)


# ---------------------------------------------------------------------------
# the server end to end
# ---------------------------------------------------------------------------

def _post(url, payload, timeout=60, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def test_server_turn_equals_reference_and_sloz_phases(pair, faults):
    """A fresh request through ``LLMServer(prefill_pool=)``: the reply is
    the JAX ``generate``'s, the handoff ``ok`` and the admit a restore;
    ``/sloz?phase=`` serves each phase's plane, schema-checked.  Then the
    wire corrupts every transfer: the reply is still the reference, the
    outcome counted ``corrupt``."""
    from synapseml_tpu_torch.serving import LLMServer
    jm, variables, tm = pair
    preg, _ = faults
    name = _name("e2e")
    pool = PDG.PrefillPool(
        workers=[PDG.PrefillWorker(_engine(tm, f"{name}-pf"))], name=name)
    p, p2 = _prompts(2, 14, seed=140)
    refs = np.asarray(J.generate(jm, variables, np.stack([p, p2]),
                                 max_new_tokens=6))
    srv = LLMServer(tm, n_slots=2, max_len=96, api_path=f"/{name}",
                    kv_arena_bytes=1 << 22, prefill_pool=pool,
                    ttft_slo_s=5.0, min_prefix=8, device="cpu",
                    engine_kwargs={"name": name})
    try:
        status, body = _post(srv.url, {"ids": [int(t) for t in p],
                                       "max_new_tokens": 6,
                                       "session": "conv"})
        assert status == 200
        assert json.loads(body)["ids"] == [int(t) for t in refs[0]]
        assert _metric(p_registry, "disagg_handoffs_total", pool=name,
                       outcome="ok") == 1
        assert _metric(p_registry, "kvtier_restores_total", engine=name,
                       source="host", outcome="ok") == 1
        base = srv.url.rsplit("/", 1)[0]
        for phase in ("prefill", "decode"):
            status, raw = _get(f"{base}/sloz?phase={phase}")
            snap = json.loads(raw)
            check_sloz(snap, phase=phase)
            names = list(snap["planes"])
            assert phase_plane_name(f"/{name}", phase) in names
            assert all(n.endswith(f"@phase={phase}") for n in names)
        full = json.loads(_get(f"{base}/sloz")[1])
        check_sloz(full)
        assert f"/{name}" in full["planes"]
        preg.inject("disagg.transfer", "corrupt", times=10)
        status, body = _post(srv.url, {"ids": [int(t) for t in p2],
                                       "max_new_tokens": 6})
        assert status == 200
        assert json.loads(body)["ids"] == [int(t) for t in refs[1]]
        assert _metric(p_registry, "disagg_handoffs_total", pool=name,
                       outcome="corrupt") == 1
    finally:
        srv.close()


def test_repin_triggers_journal_failover_restore(pair, tmp_path):
    """Two decode replicas sharing a journal root behind a role-aware
    router (plus a prefill rank decode traffic must never land on): the
    pinned replica closes mid-conversation, ``route_request(role=
    "decode")`` answers ``repin`` on the survivor, and the survivor's
    ``resume`` equals the JAX ``generate``'s tokens."""
    from synapseml_tpu_torch.models.llm import SessionJournal
    from synapseml_tpu_torch.serving import LLMServer, ReplicaRouter
    from synapseml_tpu_torch.serving.distributed import (
        DistributedServingServer)
    jm, variables, tm = pair
    jdir = str(tmp_path / "jnl")
    p1 = _prompts(1, 12, seed=150)[0]
    ref1 = np.asarray(J.generate(jm, variables, p1[None],
                                 max_new_tokens=5)[0])
    tag = _name("fo")
    replicas = [LLMServer(tm, n_slots=2, max_len=96, device="cpu",
                          journal=SessionJournal(jdir, name=f"{tag}{i}"),
                          api_path=f"/{tag}{i}",
                          engine_kwargs={"name": f"{tag}{i}"})
                for i in range(2)]
    table = [r.server.address for r in replicas] + [("127.0.0.1", 9341)]

    class _Stub:
        router = ReplicaRouter(table, name=tag,
                               roles=["decode", "decode", "prefill"],
                               failure_threshold=1)

    stub = _Stub()
    try:
        res = DistributedServingServer.route_request(stub, session="conv",
                                                     role="decode")
        assert res.outcome == "miss" and res.rank in (0, 1)
        status, body = _post(replicas[res.rank].url, {
            "ids": [int(t) for t in p1], "session": "conv",
            "max_new_tokens": 5}, headers=res.headers)
        assert status == 200
        assert json.loads(body)["ids"] == [int(t) for t in ref1]
        stub.router.report(res.rank, ok=True, addr=res.addr)
        assert DistributedServingServer.route_request(
            stub, session="conv", role="decode").outcome == "hit"
        dead = res.rank
        replicas[dead].close()
        stub.router.report(dead, ok=False, addr=res.addr)
        res2 = DistributedServingServer.route_request(stub, session="conv",
                                                      role="decode")
        assert res2.outcome == "repin" and res2.rank not in (dead, 2)
        status, body = _post(replicas[res2.rank].url,
                             {"session": "conv", "resume": True},
                             headers=res2.headers)
        assert status == 200
        assert json.loads(body)["ids"] == [int(t) for t in ref1]
    finally:
        for r in replicas:
            r.close()


# ---------------------------------------------------------------------------
# SIGKILL mid-handoff, and the corrupt-wire soak
# ---------------------------------------------------------------------------

_KILL_CHILD = textwrap.dedent("""
    import numpy as np
    import torch

    from synapseml_tpu_torch.models.llm import (HostKVArena, LlamaConfig,
                                                LlamaModel, SlotEngine)
    from synapseml_tpu_torch.resilience import get_faults
    from synapseml_tpu_torch.serving.disagg import (PrefillPool,
                                                    PrefillWorker)

    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny(num_layers=2, max_len=96, dtype=torch.float32)
    model = LlamaModel(cfg, device="cpu")
    eng = SlotEngine(model, n_slots=2, max_len=96, name="kill-child-pf",
                     device="cpu")
    pool = PrefillPool(workers=[PrefillWorker(eng)], name="kill-child")
    pool.bind("/kill-child", HostKVArena(1 << 22, name="kill-child"))
    p = np.random.default_rng(160).integers(1, 512, 12).astype(np.int32)
    assert pool.handoff(p, session="conv") == "ok"
    print("HANDOFF1 ok", flush=True)
    get_faults().configure("disagg.prefill=kill")
    pool.handoff(list(p) + [3, 1, 4], session="conv")
    print("UNREACHABLE", flush=True)
""")


def test_sigkill_fires_mid_handoff():
    env = dict(os.environ)
    env.pop("SML_FAULTS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run([sys.executable, "-c", _KILL_CHILD],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=REPO)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "HANDOFF1 ok" in proc.stdout
    assert "UNREACHABLE" not in proc.stdout


def test_dead_prefill_replica_degrades_to_reference(pair, faults):
    jm, variables, tm = pair
    name = _name("deadpf")
    arena = PK.HostKVArena(1 << 22, name=name)

    class _DeadWorker:
        def prefill(self, ids, tenant="default"):
            raise ConnectionError("replica SIGKILLed")

    pool = PDG.PrefillPool(workers=[_DeadWorker()], name=name,
                           failure_threshold=2, cooldown_s=60.0)
    pool.bind(f"/{name}", arena)
    dec = _engine(tm, name, min_prefix=8, kv_arena=arena)
    p = _prompts(1, 12, seed=161)[0]
    ref = np.asarray(J.generate(jm, variables, p[None],
                                max_new_tokens=5)[0])
    assert pool.handoff(p) == "fallback"
    r = dec.admit(p, 5)
    np.testing.assert_array_equal(dec.run_to_completion()[r.slot], ref)


@pytest.mark.fault
def test_corrupt_wire_soak_zero_wrong_tokens(pair, faults):
    """Seeded corrupt transfers at p=0.35 and a worker that fails one call
    in five, over 3 sessions x 2 turns: every turn equals the JAX
    ``generate`` on the conversation so far, and every handoff lands in
    exactly one counted outcome."""
    jm, variables, tm = pair
    preg, _ = faults
    preg.inject("disagg.transfer", "corrupt", p=0.35)
    preg.inject("disagg.prefill", "error", p=0.2)
    name = _name("soak")
    arena = PK.HostKVArena(1 << 22, name=name)
    pool = PDG.PrefillPool(
        workers=[PDG.PrefillWorker(_engine(tm, f"{name}-pf"))], name=name,
        failure_threshold=99, cooldown_s=60.0)
    pool.bind(f"/{name}", arena)
    dec = _engine(tm, name, n_slots=3, min_prefix=8, kv_arena=arena)
    sessions = {i: _prompts(1, 10, seed=170 + i)[0] for i in range(3)}
    seen, handoffs = [], 0
    for rnd in range(2):
        batch = np.stack([sessions[i] for i in range(3)])
        refs = np.asarray(J.generate(jm, variables, batch,
                                     max_new_tokens=5))
        for i in range(3):
            ids = sessions[i]
            seen.append(pool.handoff(ids, session=f"s{i}"))
            handoffs += 1
            r = dec.admit(ids, 5)
            dec.run_to_completion()
            got = dec.generated_ids(r.slot)
            np.testing.assert_array_equal(got, refs[i])
            sessions[i] = np.concatenate(
                [ids, got, _prompts(1, 4, seed=180 + 10 * rnd + i)[0]])
    assert "ok" in seen and len(set(seen)) > 1
    counts = sum(_metric(p_registry, "disagg_handoffs_total", pool=name,
                         outcome=o) for o in PDG.HANDOFF_OUTCOMES)
    assert counts == handoffs
