"""The port's replicated-serving plane (``synapseml_tpu_torch.serving.
distributed``) held against the JAX package's on the CPU.

- The contracts of ``tests/test_gang.py``'s ``TestServingFailover`` and
  ``TestRouterResizeAbsorption`` on the port's ``ServingServer``: drained,
  dead and breaker-open replicas are skipped, a probe never heals an open
  breaker, the healthy gauge follows the probes, a shrink drops no
  in-flight request and never routes to the departed replica, the cursor
  clamps, departed breakers and probe rows are released, and a report for
  a renumbered rank is ignored.
- One seeded sequence of route / report / probe / refresh / warm-up
  toggles with sessions, tenants and roles drives both packages'
  ``ReplicaRouter`` over the same real listeners: the routed rank,
  address, url and affinity outcome (or the refusal's statuses), every
  replica's probe verdict and breaker state, and the router's gauges are
  equal after every step.
- The pin fairness and ``tenant_pin_cap`` contract, the warming probe,
  and ``route_request``'s trace and tenant headers.
- ``exchange_routing_table`` in one process, and over a 2-rank CPU gloo
  gang (addresses at or above 128.0.0.0 survive the int32 halves; a
  wedged gather raises ``CollectiveTimeout`` at its timeout), with the
  ``distributed_serving_roundtrip`` contract on that gang.
- Phase 27b of ``chip_smoke.py`` small on a second 2-rank gang: LLM
  servers with prefill pools behind the gathered table, one leaving.
"""

import itertools
import json
import threading
import urllib.request

import numpy as np
import pytest

from synapseml_tpu.serving import distributed as JD
from synapseml_tpu.telemetry import get_registry as j_registry
from synapseml_tpu_torch.parallel import run_on_local_cluster
from synapseml_tpu_torch.resilience import breaker as PB
from synapseml_tpu_torch.serving import (NoHealthyReplicaError,
                                         ReplicaRouter, RouteResult,
                                         ServingReply, ServingServer)
from synapseml_tpu_torch.serving import distributed as PD
from synapseml_tpu_torch.serving.server import TENANT_HEADER, TRACE_HEADER
from synapseml_tpu_torch.telemetry import get_registry
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

_names = itertools.count()


def _name(tag):
    return f"pt-dsrv-{tag}-{next(_names)}"


def _servers(n=2):
    return [ServingServer() for _ in range(n)]


def _echo_servers(n):
    servers, stops = [], []
    for i in range(n):
        srv = ServingServer()
        stop = threading.Event()

        def loop(srv=srv, stop=stop, i=i):
            while not stop.is_set():
                for req in srv.get_batch(max_rows=8, timeout_s=0.05):
                    srv.reply(req.id, ServingReply(200, json.dumps(
                        {"replica": i}).encode()))

        threading.Thread(target=loop, daemon=True).start()
        servers.append(srv)
        stops.append(stop)
    return servers, stops


def _close(servers, stops=()):
    for stop in stops:
        stop.set()
    for s in servers:
        s.close()


# ---------------------------------------------------------------------------
# tests/test_gang.py TestServingFailover, on the port
# ---------------------------------------------------------------------------

def test_route_skips_drained_replica():
    servers = _servers()
    try:
        router = ReplicaRouter([s.address for s in servers],
                               name=_name("drain"))
        assert router.probe_all() == {0: "healthy", 1: "healthy"}
        servers[0].health.begin_drain()
        assert router.probe(0) == "draining"
        for _ in range(4):
            res = router.route("/api")
            assert res.rank == 1 and res.url.endswith("/api")
    finally:
        _close(servers)


def test_dead_replica_and_recovery_probe():
    servers = _servers()
    router = ReplicaRouter([s.address for s in servers], name=_name("dead"),
                           cooldown_s=60.0)
    servers[0].close()
    assert router.probe(0) == "dead"
    assert all(router.route()[0] == 1 for _ in range(3))
    servers[1].close()
    assert router.probe(1) == "dead"
    with pytest.raises(NoHealthyReplicaError) as ei:
        router.route()
    assert ei.value.statuses == {0: "dead", 1: "dead"}


def test_route_never_returns_open_breaker():
    servers = _servers()
    try:
        router = ReplicaRouter([s.address for s in servers],
                               name=_name("breaker"), failure_threshold=3,
                               cooldown_s=60.0)
        for _ in range(3):
            router.report(0, ok=False)
        assert router.breaker(0).state == "open"
        for _ in range(10):
            assert router.route()[0] == 1
        for _ in range(3):
            router.report(1, ok=False)
        with pytest.raises(NoHealthyReplicaError) as ei:
            router.route()
        assert "breaker open" in ei.value.statuses[0]
    finally:
        _close(servers)


def test_probe_does_not_heal_open_breaker():
    servers = _servers()
    try:
        router = ReplicaRouter([s.address for s in servers],
                               name=_name("noheal"), failure_threshold=2,
                               cooldown_s=60.0)
        router.report(0, ok=False), router.report(0, ok=False)
        assert router.breaker(0).state == "open"
        assert router.probe(0) == "healthy"
        assert router.breaker(0).state == "open"
        assert all(router.route()[0] == 1 for _ in range(4))
    finally:
        _close(servers)


def test_healthy_gauge_tracks_probes_and_refresh_adopts_table():
    servers = _servers(3)
    try:
        name = _name("gauge")
        router = ReplicaRouter([s.address for s in servers[:2]], name=name)
        g = get_registry().gauge("serving_replicas_healthy", "",
                                 ("router",))
        router.probe_all()
        assert g.value(router=name) == 2
        servers[0].health.begin_drain()
        router.probe_all()
        assert g.value(router=name) == 1
        router.refresh([s.address for s in servers])
        assert len(router.table) == 3
        assert sorted(router.statuses()) == [0, 1, 2]
    finally:
        _close(servers)


# ---------------------------------------------------------------------------
# tests/test_gang.py TestRouterResizeAbsorption, on the port
# ---------------------------------------------------------------------------

def test_shrink_drops_no_inflight_and_never_routes_departed():
    servers, stops = _echo_servers(3)
    try:
        table = [s.address for s in servers]
        router = ReplicaRouter(table, name=_name("resize"))
        answered, routed_after = [], []
        refreshed = False
        for k in range(60):
            rank, _, url = router.route()[:3]
            if refreshed:
                routed_after.append(rank)
            rep = urllib.request.urlopen(urllib.request.Request(
                url, data=json.dumps({"x": k}).encode()), timeout=10)
            answered.append(json.loads(rep.read())["replica"])
            router.report(rank, ok=True)
            if k == 20:
                router.refresh(table[:2])
                refreshed = True
                assert servers[2].drain(timeout_s=10.0)
        assert len(answered) == 60
        assert 2 not in routed_after and set(routed_after) == {0, 1}
    finally:
        _close(servers, stops)


def test_cursor_clamps_and_stale_breakers_released():
    servers, stops = _echo_servers(3)
    try:
        table = [s.address for s in servers]
        name = _name("clamp")
        router = ReplicaRouter(table, name=name)
        for _ in range(5):
            router.route()
        assert router.route()[0] in (0, 1, 2)
        h, p = table[2]
        key = f"replica:{name}:{h}:{p}"
        assert key in PB._breakers
        router.refresh(table[:2])
        assert router._rr < 2
        assert key not in PB._breakers
        router.report(2, ok=False)                 # late report: ignored
        assert {router.route()[0] for _ in range(4)} == {0, 1}
        router.refresh(table)
        assert sorted(router.statuses()) == [0, 1, 2]
        assert key in PB._breakers
    finally:
        _close(servers, stops)


def test_addr_report_ignored_when_rank_renumbered():
    servers, stops = _echo_servers(3)
    try:
        table = [s.address for s in servers]
        router = ReplicaRouter(table, name=_name("renumber"),
                               failure_threshold=1)
        old_addr = table[0]
        res = router.route_addr()
        assert res.addr == table[res.rank] and res.url.startswith(
            f"http://{res.addr[0]}:{res.addr[1]}")
        router.refresh(table[1:])
        router.report(0, ok=False, addr=old_addr)     # stale: dropped
        assert router.breaker(0).state == "closed"
        router.report(0, ok=False, addr=table[1])     # current: lands
        assert router.breaker(0).state == "open"
        router.report(7, ok=False, addr=old_addr)
        router.report(7, ok=False)
    finally:
        _close(servers, stops)


def test_probe_gauge_rows_removed_on_shrink():
    servers, stops = _echo_servers(2)
    try:
        table = [s.address for s in servers]
        name = _name("rows")
        router = ReplicaRouter(table, name=name)
        router.probe_all()
        g = get_registry().gauge("serving_replica_probe_status", "",
                                 ("router", "rank"))
        assert (name, "1") in g.series()
        router.refresh(table[:1])
        assert (name, "1") not in g.series()
    finally:
        _close(servers, stops)


# ---------------------------------------------------------------------------
# one seeded sequence through both packages' routers
# ---------------------------------------------------------------------------

def _route_view(router, **kw):
    try:
        res = router.route_addr("/gen", **kw)
        return ("ok", res.rank, tuple(res.addr), res.url, res.outcome)
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, getattr(e, "statuses", None))


def _router_view(router, registry):
    healthy = registry().gauge("serving_replicas_healthy", "", ("router",))
    probe = registry().gauge("serving_replica_probe_status", "",
                             ("router", "rank"))
    aff = registry().counter("serving_affinity_total", "",
                             ("router", "outcome"))
    return (router.statuses(), list(router.table), list(router.roles),
            [router.breaker(r).state for r in range(len(router.table))],
            router.warming_count(), healthy.value(router=router.name),
            {k: v for k, v in probe.series().items() if k[0] == router.name},
            {o: aff.value(router=router.name, outcome=o)
             for o in ("hit", "miss", "repin")})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sequence_equal_to_reference(seed):
    """Five listeners (one closed), seeded ops: route with or without a
    session, tenant and role; report a rank (by index or by address);
    probe one or all; refresh to a seeded subset of the table with roles;
    toggle a listener's warm-up or drain.  The port's router and the JAX
    router answer identically at every step."""
    rng = np.random.default_rng(seed)
    servers = _servers(5)
    servers[4].close()
    full = [s.address for s in servers]
    roles_all = ["decode", "decode", "prefill", "decode", "prefill"]
    name = _name(f"seq{seed}")
    kw = dict(name=name, failure_threshold=2, cooldown_s=600.0,
              probe_timeout_s=2.0, session_cache_size=6, tenant_pin_cap=4)
    pr = ReplicaRouter(full, roles=roles_all, **kw)
    jr = JD.ReplicaRouter(full, roles=roles_all, **kw)
    warming = {}
    try:
        for step in range(120):
            op = rng.choice(["route", "route", "route", "report", "probe",
                             "probe_all", "refresh", "warm"],
                            p=[.2, .2, .2, .14, .08, .06, .06, .06])
            if op == "route":
                args = {}
                if rng.random() < 0.7:
                    args["session"] = f"s{int(rng.integers(0, 5))}"
                if rng.random() < 0.4:
                    args["tenant"] = f"t{int(rng.integers(0, 3))}"
                if rng.random() < 0.5:
                    args["role"] = str(rng.choice(["decode", "prefill"]))
                got, want = _route_view(pr, **args), _route_view(jr, **args)
                assert got == want, (step, args)
            elif op == "report":
                r = int(rng.integers(0, len(full)))
                ok = bool(rng.random() < 0.4)
                addr = tuple(full[r]) if rng.random() < 0.5 else None
                pr.report(r, ok, addr=addr)
                jr.report(r, ok, addr=addr)
            elif op == "probe":
                r = int(rng.integers(0, len(full)))
                assert pr.probe(r) == jr.probe(r), step
            elif op == "probe_all":
                assert pr.probe_all() == jr.probe_all(), step
            elif op == "refresh":
                keep = sorted(rng.choice(len(full), int(rng.integers(2, 6)),
                                         replace=False).tolist())
                table = [full[i] for i in keep]
                roles = [roles_all[i] for i in keep]
                pr.refresh(table, roles=roles)
                jr.refresh(table, roles=roles)
            else:
                i = int(rng.integers(0, 4))
                if i == 3 and rng.random() < 0.3:
                    servers[3].health.begin_drain()
                elif warming.pop(i, None):
                    servers[i].health.set_warmup(None)
                else:
                    warming[i] = True
                    servers[i].health.set_warmup(
                        lambda: {"state": "warming"})
            assert _router_view(pr, get_registry) == \
                _router_view(jr, j_registry), (step, op)
            assert dict(pr._sessions) == dict(jr._sessions), step
    finally:
        _close(servers)


# ---------------------------------------------------------------------------
# pin fairness, warming, headers (tests/test_qos_serving.py,
# tests/test_llm_warmup.py, tests/test_kvtier.py contracts)
# ---------------------------------------------------------------------------

def test_flooding_tenant_cannot_strip_other_pins():
    r = ReplicaRouter([("127.0.0.1", 9001), ("127.0.0.1", 9002)],
                      name=_name("qos"), session_cache_size=4)
    r.route("/g", session="keep", tenant="victim")
    for i in range(20):
        r.route("/g", session=f"s{i}", tenant="flood")
    assert ("victim", "keep") in r._sessions
    assert sum(1 for (t, _) in r._sessions if t == "flood") == 3
    assert ("flood", "s19") in r._sessions


def test_tenant_pin_cap_self_evicts_own_oldest():
    r = ReplicaRouter([("127.0.0.1", 9001)], name=_name("cap"),
                      session_cache_size=64, tenant_pin_cap=2)
    r.route("/g", session="other", tenant="b")
    for s in ("s0", "s1", "s2"):
        r.route("/g", session=s, tenant="a")
    assert ("a", "s0") not in r._sessions
    assert ("a", "s1") in r._sessions and ("a", "s2") in r._sessions
    assert ("b", "other") in r._sessions


def test_warming_replica_probes_warming_without_breaker_signal():
    srv = ServingServer(port=0)
    state = {"state": "warming", "programs_warm": 0, "programs_total": 5}
    srv.health.set_warmup(lambda: dict(state))
    host, port = srv.address
    try:
        assert PD.probe_replica(host, port) == "warming"
        assert JD.probe_replica(host, port) == "warming"
        router = ReplicaRouter([(host, port)], name=_name("warm"))
        router.probe_all()
        assert router.statuses() == {0: "warming"}
        assert router.warming_count() == 1
        assert router.breaker(0).state != "open"
        with pytest.raises(NoHealthyReplicaError) as ei:
            router.route()
        assert ei.value.statuses == {0: "warming"}
        srv.health.set_warmup(None)
        assert router.probe_all() == {0: "healthy"}
        assert router.route().rank == 0 and router.warming_count() == 0
    finally:
        srv.close()


def test_route_request_headers_and_outcomes():
    """``route_request`` mints a trace id (or keeps the caller's), adds the
    tenant header for a non-default tenant only, threads the affinity
    outcome through and records the ``route`` flight entry."""
    from synapseml_tpu_torch.telemetry.flight import get_flight

    class _Stub:
        router = ReplicaRouter([("127.0.0.1", 9011), ("127.0.0.1", 9012)],
                               name=_name("req"))

    stub = _Stub()
    res = PD.DistributedServingServer.route_request(stub, session="conv2")
    assert isinstance(res, RouteResult) and res.outcome == "miss"
    assert set(res.headers) == {TRACE_HEADER} and res.headers[TRACE_HEADER]
    res2 = PD.DistributedServingServer.route_request(
        stub, session="conv2", trace_id="abc")
    assert res2.outcome == "hit" and res2.rank == res.rank
    assert res2.headers == {TRACE_HEADER: "abc"}
    # pins are per tenant: another tenant's same session id is a miss
    res3 = PD.DistributedServingServer.route_request(
        stub, session="conv2", trace_id="def", tenant="acme")
    assert res3.outcome == "miss"
    assert res3.headers == {TRACE_HEADER: "def", TENANT_HEADER: "acme"}
    evs = [e for e in get_flight().events()
           if e["kind"] == "route" and e.get("router") == stub.router.name]
    assert [e["affinity"] for e in evs[-3:]] == ["miss", "hit", "miss"]
    assert evs[-1]["trace_id"] == "def" and evs[-1]["tenant"] == "acme"
    # a failed replica repins the session
    stub.router.report(res.rank, ok=False, addr=res.addr)
    stub.router.report(res.rank, ok=False, addr=res.addr)
    stub.router.report(res.rank, ok=False, addr=res.addr)
    assert PD.DistributedServingServer.route_request(
        stub, session="conv2").outcome == "repin"


# ---------------------------------------------------------------------------
# the routing table
# ---------------------------------------------------------------------------

def test_single_process_exchange_and_addr_codec():
    for host, port, role in (("127.0.0.1", 9321, 1),
                             ("200.255.1.129", 65535, 0)):
        assert PD.exchange_routing_table(host, port, role=role,
                                         device="cpu") == \
            JD.exchange_routing_table(host, port, role=role)
        assert PD._encode_addr(host, port) == JD._encode_addr(host, port)
        ip, p = PD._encode_addr(host, port)
        assert PD._decode_addr(ip, p) == (host, port)
    assert PD.ROLE_NAMES == JD.ROLE_NAMES
    with pytest.raises(ValueError, match="unknown replica role"):
        PD._role_index("ghost")


def test_server_alone_routes_to_itself():
    srv = PD.DistributedServingServer(device="cpu", role="prefill")
    try:
        assert srv.routing_table == [srv.address]
        assert srv.routing_roles == ["prefill"]
        assert srv.router.name == "dserv-p0"
        assert srv.route(role="prefill").rank == 0
        assert srv.refresh_routing_table() == [srv.address]
        assert srv.probe_replicas() == {0: "healthy"}
        assert srv.leave(timeout_s=5.0)
    finally:
        srv.close()


def test_routing_table_over_two_rank_gloo_gang():
    """The ``distributed_serving_roundtrip`` contract on a 2-rank CPU gloo
    gang: one table on both ranks in rank order, the roles gathered, rank
    0 reaches every rank's listener; a table of addresses at or above
    128.0.0.0 comes through the int32 halves unchanged; and a gather whose
    dispatch wedges raises ``CollectiveTimeout`` on both ranks."""
    results = run_on_local_cluster(
        "torch_gang_tasks:distributed_serving_roundtrip", 2,
        task_args={"device": "cpu"}, device="cpu", timeout_s=120.0)
    r0, r1 = results
    assert r0["table"] == r1["table"] and len(r0["table"]) == 2
    assert r0["roles"] == r1["roles"] == ["decode", "prefill"]
    assert (r0["router"], r1["router"]) == ("dserv-p0", "dserv-p1")
    assert [r["rank"] for r in r0["results"]] == [0, 1]
    assert [r["echo"] for r in r0["results"]] == [0, 10]
    assert r1["results"] == []
    want = [["200.0.255.128", 40000], ["201.1.255.129", 40001]]
    assert r0["fake_table"] == r1["fake_table"] == want
    assert r0["timed_out"] and r1["timed_out"]
    assert r0["fake_roles"] == r1["fake_roles"] == [0, 1]


def test_llm_servers_behind_the_gathered_table_small(tmp_path):
    """Phase 27b of ``chip_smoke.py`` small on a 2-rank CPU gloo gang
    (``torch_gang_tasks.llm_serving_gang`` on each rank): a tiny bf16
    ``LLMServer`` a rank behind the gathered table, first with a
    ``PrefillPool``, then without; rank 1 leaves after the first sessions
    in each pass.  Every request answered, ``repin`` for the sessions on
    rank 1 (each resumed equal to its first turn), ``hit`` for the rest,
    every fresh turn's handoff ``ok`` with one frame packed for each;
    rank 1's echo server leaves clean."""
    jdir = tmp_path / "journal"
    jdir.mkdir()
    args = dict(seed=0, device="cpu",
                cfg=dict(kind="tiny", num_layers=2, max_len=256,
                         dtype="bfloat16"),
                journal_dir=str(jdir), arena_bytes=32 << 20, sessions=6,
                threads=3, before_leave=3, prompt=[16, 48], new=5,
                append=[4, 8], direct=False)
    r0, r1 = run_on_local_cluster("torch_gang_tasks:llm_serving_gang", 2,
                                  task_args=args, device="cpu",
                                  timeout_s=120.0)
    assert r0["weights"] == r1["weights"]
    for label in ("pool", "nopool"):
        drive = r0[label]["drive"]
        assert r0[label]["table"] == r1[label]["table"]
        assert drive["statuses_after_leave"] == {"0": "healthy",
                                                 "1": "draining"}
        on1 = drive["on_rank1"]
        assert on1 and drive["repin"] == len(on1)
        assert drive["hit"] == 6 - len(on1)
        assert all(drive["first_rank"][str(i)] == 0 for i in range(3, 6))
        assert r1[label]["left"]
    on1 = r0["pool"]["drive"]["on_rank1"]
    assert r0["handoffs"]["ok"] == len(r0["frame_bytes"]) == 6 + 6 - len(on1)
    assert r1["handoffs"]["ok"] == len(r1["frame_bytes"]) == len(on1)
    assert sum(r1["handoffs"].values()) == len(on1)
    assert r1["echo_left"]
    assert r0["echoes"] == [{"rank": 0, "echo": 0},
                            {"rank": 1, "echo": 10}]
