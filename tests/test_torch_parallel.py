"""The port's parallel layer in one process, held against the JAX
package on the CPU: placement, padding and row blocks, the planner's
decision table and plans, the bf16 and int8 codecs (bit for bit), the
wire accounting, the error-feedback helpers, the launcher's cause map,
the heartbeat and telemetry wires, the heartbeat monitor's verdicts
under an injected clock, and the watchdog.  The collectives themselves
run across processes in tests/test_torch_gang.py."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.parallel import compression as JZ
from synapseml_tpu.parallel import heartbeat as JH
from synapseml_tpu.parallel import launcher as JL
from synapseml_tpu.parallel import mesh as JM
from synapseml_tpu.parallel import placement as JP
from synapseml_tpu.parallel import planner as JPl
from synapseml_tpu.parallel import supervisor as JS
from synapseml_tpu.telemetry import autotune as JA
from synapseml_tpu.telemetry import gangplane as JG
from synapseml_tpu_torch.parallel import collectives as TC
from synapseml_tpu_torch.parallel import compression as TZ
from synapseml_tpu_torch.parallel import heartbeat as TH
from synapseml_tpu_torch.parallel import launcher as TL
from synapseml_tpu_torch.parallel import mesh as TM
from synapseml_tpu_torch.parallel import placement as TP
from synapseml_tpu_torch.parallel import planner as TPl
from synapseml_tpu_torch.parallel import supervisor as TS
from synapseml_tpu_torch.resilience.faults import get_faults
from synapseml_tpu_torch.telemetry import autotune as TA
from synapseml_tpu_torch.telemetry import gangplane as TG
from synapseml_tpu_torch.telemetry.tunetable import TunePlane, set_tuneplane
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


# -- placement, padding, blocks ----------------------------------------------

@pytest.mark.parametrize("strategy", ["block", "round_robin"])
def test_partition_assignment_equals_reference(strategy):
    for parts in (0, 1, 5, 12, 13, 64):
        for ranks in (1, 2, 3, 4, 8):
            t = TP.partition_assignment(parts, ranks, strategy)
            j = JP.partition_assignment(parts, ranks, strategy)
            assert (t.partition_to_rank, t.rank_to_partitions,
                    t.num_ranks) == (j.partition_to_rank,
                                     j.rank_to_partitions, j.num_ranks)


def test_rows_for_rank_equals_reference():
    from synapseml_tpu.core.dataset import Dataset as JDataset
    from synapseml_tpu_torch.core import Dataset as TDataset
    for n, parts, ranks in ((100, 7, 3), (64, 8, 4), (10, 3, 4)):
        cols = {"x": np.arange(n, dtype=np.float64)}
        jd = JDataset(cols).repartition(parts)
        td = TDataset(cols).repartition(parts)
        pm_t = TP.partition_assignment(parts, ranks)
        pm_j = JP.partition_assignment(parts, ranks)
        for r in range(ranks):
            assert TP.rows_for_rank(td, pm_t, r) == JP.rows_for_rank(
                jd, pm_j, r)
    with pytest.raises(ValueError, match="non-contiguous"):
        TP.rows_for_rank(TDataset({"x": np.arange(9.0)}).repartition(4),
                         TP.partition_assignment(4, 2, "round_robin"), 0)


@pytest.mark.parametrize("n,size", [(10, 2), (11, 2), (13, 4), (3, 8),
                                    (64, 8)])
def test_padding_and_blocks_equal_batch_sharding(n, size):
    """Axis index i holds the rows jax.device_put gives shard i under
    batch_sharding after shard_batch's zero padding."""
    mesh = JM.data_parallel_mesh(size)
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2) + 1
    arr, n_out = JM.shard_batch(mesh, x)
    assert n_out == n
    assert TM.pad_to_multiple(n, size) == JM.pad_to_multiple(n, size) \
        == arr.shape[0]
    padded = np.asarray(arr)
    for shard in arr.addressable_shards:
        i = list(mesh.devices.flat).index(shard.device)
        lo, hi = TM.block_bounds(n, size, i)
        assert (lo, hi) == (shard.index[0].start or 0, shard.index[0].stop)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      padded[lo:hi])


def test_mesh_axis_sizes_resolve_like_reference():
    assert TM._resolve_sizes(None, 4) == {"data": 4}
    assert TM._resolve_sizes({"data": -1, "model": 2}, 8) == {"data": 4,
                                                              "model": 2}
    for bad in ({"data": -1, "model": -1}, {"data": 3}, {"model": 3,
                                                         "data": -1}):
        with pytest.raises(ValueError):
            TM._resolve_sizes(bad, 8)
    assert (TM.DATA_AXIS, TM.MODEL_AXIS, TM.SEQ_AXIS, TM.EXPERT_AXIS,
            TM.PIPE_AXIS) == (JM.DATA_AXIS, JM.MODEL_AXIS, JM.SEQ_AXIS,
                              JM.EXPERT_AXIS, JM.PIPE_AXIS)


def test_process_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        TM.ProcessMesh(device="cpu")


# -- the planner --------------------------------------------------------------

_SPECS = [None, dict(n_hosts=1, devices_per_host=4),
          dict(n_hosts=2, devices_per_host=2),
          dict(n_hosts=4, devices_per_host=2),
          dict(n_hosts=2, devices_per_host=3, source="discovered")]
_CONFIGS = [None] + [dict(compression=c, strategy=s)
                     for c in ("none", "bf16", "int8")
                     for s in ("auto", "flat", "ring", "tree",
                               "hierarchical")]


def _both(spec_kw, cfg_kw):
    ts = TPl.TopologySpec(**spec_kw) if spec_kw is not None else None
    js = JPl.TopologySpec(**spec_kw) if spec_kw is not None else None
    tc = TZ.CollectiveConfig(**cfg_kw) if cfg_kw is not None else None
    jc = JZ.CollectiveConfig(**cfg_kw) if cfg_kw is not None else None
    return ts, js, tc, jc


@pytest.mark.parametrize("spec_kw", _SPECS)
def test_decide_equals_reference(spec_kw):
    fitted = [(None, None),
              (TA.CollectiveCostModel(2e-5, 1e-9, "fitted"),
               JA.CollectiveCostModel(2e-5, 1e-9, "fitted"))]
    for cfg_kw in _CONFIGS:
        ts, js, tc, jc = _both(spec_kw, cfg_kw)
        for world in (1, 2, 3, 4, 6, 8):
            for payload in (64, 4096, 8191, 8192, 1 << 18, (1 << 18) + 1,
                            1 << 22):
                for tm, jm in fitted:
                    assert TPl._decide(payload, world, ts, tc, tm) == \
                        JPl._decide(payload, world, js, jc, jm), (
                            spec_kw, cfg_kw, world, payload)


def test_plans_phases_and_wire_equal_reference():
    shapes = [(2048,), (16, 28, 32, 3), (3, 8, 256, 3), (7, 5)]
    for cfg_kw in _CONFIGS[1:]:
        _, _, tc, jc = _both(None, cfg_kw)
        for strategy in ("flat", "ring", "tree", "hierarchical"):
            for world, inner in ((4, 2), (8, 4), (2, 2)):
                kw = dict(strategy=strategy, reason="r", world=world,
                          inner=inner, payload_bucket=1 << 12)
                tp = TPl.ReductionPlan(config=tc, **kw)
                jp = JPl.ReductionPlan(config=jc, **kw)
                for shape in shapes:
                    x = np.zeros(shape, np.float32)
                    codec = tp.wire_codec(shape, torch.float32)
                    assert codec == jp.wire_codec(shape, jnp.float32)
                    assert tp.phases(codec) == jp.phases(codec)
                    assert tp.pad_unit(codec) == jp.pad_unit(codec)
                    for cm in (False, True):
                        assert tp.wire_nbytes(torch.zeros(shape), codec,
                                              channel_major=cm) == \
                            jp.wire_nbytes(x, codec, channel_major=cm)


def test_planner_cache_epoch_and_routing_equal_reference():
    for spec_kw in _SPECS[1:4]:
        ts, js, _, _ = _both(spec_kw, None)
        tpl, jpl = TPl.CollectivePlanner(ts), JPl.CollectivePlanner(js)
        for cfg_kw in _CONFIGS:
            _, _, tc, jc = _both(None, cfg_kw)
            for world in (None, 1, 2, 3, 4, 8):
                assert tpl.resolved_routing(tc, world) == \
                    jpl.resolved_routing(jc, world)
            a = tpl.plan(5000, 4, tc)
            b = jpl.plan(5000, 4, jc)
            assert (a.strategy, a.reason, a.inner, a.payload_bucket) == (
                b.strategy, b.reason, b.inner, b.payload_bucket)
            assert tpl.plan(6000, 4, tc) is a          # one bucket
        size, epoch = tpl.cache_size(), tpl.epoch()
        tpl.refresh("relaunch", world_size=4)
        assert (tpl.cache_size(), tpl.epoch()) == (0, epoch + 1) and size
        assert tpl.spec() is ts                        # injected survives


def test_planner_consults_a_fitted_cost_model(tmp_path):
    """A fitted α-β entry in the tuning table (``COST_MODEL_SPACE``)
    prices the auto tree cutoff (model label ``fitted``); without one the
    spec constant does, as in the reference."""
    plane = TunePlane(directory=str(tmp_path))
    prev = set_tuneplane(plane)
    try:
        assert TPl._resolve_cost_model().source == "spec"
        plane.record(TA.COST_MODEL_SPACE, TA.COST_MODEL_GEOMETRY,
                     {"alpha_s": 2e-5, "beta_s_per_byte": 1e-9},
                     measured_ms=1.0, trials=4, device="cpu")
        model = TPl._resolve_cost_model()
        assert model.source == "fitted"
        spec = TPl.TopologySpec(n_hosts=1, devices_per_host=4)
        cfg = TZ.CollectiveConfig(compression="none", strategy="auto")
        jm = JA.CollectiveCostModel(2e-5, 1e-9, "fitted")
        for payload in (1 << 10, 1 << 16, 1 << 20, 1 << 24):
            got = TPl.CollectivePlanner(spec).plan(payload, 4, cfg)
            want = JPl._decide(payload, 4, JPl.TopologySpec(
                n_hosts=1, devices_per_host=4), JZ.CollectiveConfig(
                    compression="none", strategy="auto"), jm)
            assert (got.strategy, got.reason) == want[:2]
    finally:
        set_tuneplane(prev)


def test_discovered_spec_is_untrusted_so_auto_plans_flat():
    pl = TPl.CollectivePlanner()
    spec = pl.spec()
    assert spec.source == "discovered" and not spec.trusted
    p = pl.plan(1 << 20, 4, TZ.CollectiveConfig(compression="int8"))
    assert (p.strategy, p.reason) == ("flat", "unknown_topology")


# -- the codecs, bit for bit ---------------------------------------------------

def _codec_inputs():
    rng = np.random.default_rng(3)
    out = [rng.normal(size=4096).astype(np.float32) * s
           for s in (1.0, 1e-3, 1e4)]
    ties = (np.arange(-300, 300, dtype=np.float32) + 0.5) / 127 * 3
    x = np.zeros(1024, np.float32)
    x[:600] = ties
    x[600] = 3.0                                  # amax of the chunks
    out.append(x)
    y = rng.normal(size=1024).astype(np.float32)
    y[5], y[300], y[700] = np.nan, np.inf, -np.inf
    y[512:768] = 0.0                              # an all-zero chunk
    out.append(y)
    return out


def _bits(a, dtype):
    return np.asarray(a).view(dtype)


def _same_bits(t, j):
    """Equal bit for bit, NaNs aside (a NaN's sign and payload carry no
    value: both must be NaN at the same places)."""
    t, j = np.asarray(t), np.asarray(j)
    tn, jn = np.isnan(t.astype(np.float32)), np.isnan(j.astype(np.float32))
    np.testing.assert_array_equal(tn, jn)
    ut = {2: np.uint16, 4: np.uint32}[t.dtype.itemsize]
    np.testing.assert_array_equal(t.view(ut)[~tn], j.view(ut)[~jn])


def test_bf16_codec_bit_exact():
    for x in _codec_inputs():
        t = TZ.bf16_encode(torch.as_tensor(x))
        j = JZ.bf16_encode(jnp.asarray(x))
        _same_bits(t.float().numpy().astype(j.dtype), np.asarray(j))
        _same_bits(TZ.bf16_decode(t).numpy(), np.asarray(JZ.bf16_decode(j)))


@pytest.mark.parametrize("chunk", [8, 64, 256])
def test_int8_codec_bit_exact(chunk):
    for x in _codec_inputs():
        tq, ts = TZ.int8_encode(torch.as_tensor(x), chunk)
        jq, js = JZ.int8_encode(jnp.asarray(x), chunk)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        _same_bits(ts.numpy(), np.asarray(js))
        _same_bits(TZ.int8_decode(tq, ts).numpy(),
                   np.asarray(JZ.int8_decode(jq, js)))
        # the reference's eager functions (its jitted round trip lets
        # XLA rewrite the divide: up to 2 ulps off its own eager codec)
        _same_bits(TZ.int8_roundtrip(torch.as_tensor(x), chunk).numpy(),
                   np.asarray(JZ.int8_decode(jq, js)))


@pytest.mark.parametrize("shape", [(16, 28, 32, 3), (5, 7), (100,)])
def test_channel_major_layout_equals_reference(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    tf, tper, tpp = TZ._channel_major_padded(torch.as_tensor(x), 256)
    jf, jper, jpp = JZ._channel_major_padded(jnp.asarray(x), 256)
    assert (tper, tpp) == (jper, jpp)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    back = TZ._channel_major_padded_inv(tf, shape, tper, tpp)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(TZ._pad_to(tf, 1000).numpy(),
                                  np.asarray(JZ._pad_to(jf, 1000)))


def test_wire_and_logical_bytes_equal_reference():
    leaves = [np.zeros((16, 28, 32, 3), np.float32), np.zeros(100, np.float32),
              np.zeros((3000,), np.int32), np.zeros((4, 1000), np.float32)]
    for cfg_kw in [None] + _CONFIGS[1:]:
        _, _, tc, jc = _both(None, cfg_kw)
        for cm in (False, True):
            for pick in ([0], [1], [2], [3], [0, 1, 2, 3]):
                xs = [leaves[i] for i in pick]
                txs = [torch.as_tensor(a) for a in xs]
                assert TZ.wire_nbytes(txs, tc, channel_major=cm) == \
                    JZ.wire_nbytes(xs, jc, channel_major=cm)
                assert TZ.logical_nbytes(txs) == JZ.logical_nbytes(xs)
                for a, ta in zip(xs, txs):
                    assert TZ.codec_eligible(ta.shape, ta.dtype, tc) == \
                        JZ.codec_eligible(a.shape, a.dtype, jc)


def test_error_feedback_helpers_equal_reference():
    rng = np.random.default_rng(5)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((40, 3), (7,), (2, 5, 6))]
    res = [rng.normal(size=a.shape).astype(np.float32) * 0.01
           for a in leaves]
    big = [0, 2]
    size = sum(leaves[i].size for i in big)
    tf = TZ.flatten_with_residuals([torch.as_tensor(a) for a in leaves], big,
                                   [torch.as_tensor(r) for r in res],
                                   size + 13)
    jf = JZ.flatten_with_residuals([jnp.asarray(a) for a in leaves], big,
                                   [jnp.asarray(r) for r in res], size + 13)
    _same_bits(tf.numpy(), np.asarray(jf))
    err = rng.normal(size=size).astype(np.float32)
    tu = TZ.unpack_residuals(torch.as_tensor(err), big,
                             [torch.as_tensor(a) for a in leaves],
                             [torch.as_tensor(r) for r in res])
    ju = JZ.unpack_residuals(jnp.asarray(err), big,
                             [jnp.asarray(a) for a in leaves],
                             [jnp.asarray(r) for r in res])
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    stacked = rng.normal(size=(3, 10)).astype(np.float32)
    np.testing.assert_array_equal(TZ.canonical_residuals(stacked),
                                  JZ.canonical_residuals(stacked))
    np.testing.assert_array_equal(TZ.reshard_residuals(stacked[0], 4),
                                  JZ.reshard_residuals(stacked[0], 4))
    np.testing.assert_array_equal(TZ.reshard_flat_stream(stacked[0], 8, 12),
                                  JZ.reshard_flat_stream(stacked[0], 8, 12))
    with pytest.raises(ValueError):
        TZ.reshard_flat_stream(stacked[0], 11, 12)


def test_compressed_tree_sync_alone_equals_reference():
    """No axis: the codec's round trip and the error feedback on one
    rank (the DL consumer waits; the module is held whole)."""
    rng = np.random.default_rng(9)
    tree = {"w": rng.normal(size=(64, 64)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}
    res = {k: np.zeros_like(v) for k, v in tree.items()}
    for codec in ("bf16", "int8"):
        tcfg = TZ.CollectiveConfig(compression=codec, error_feedback=True,
                                   strategy="flat")
        jcfg = JZ.CollectiveConfig(compression=codec, error_feedback=True,
                                   strategy="flat")
        tr, tres = TZ.compressed_tree_sync(
            {k: torch.as_tensor(v) for k, v in tree.items()}, None, None,
            tcfg, residuals={k: torch.as_tensor(v) for k, v in res.items()})
        jr, jres = JZ.compressed_tree_sync(
            {k: jnp.asarray(v) for k, v in tree.items()}, None, jcfg,
            residuals={k: jnp.asarray(v) for k, v in res.items()})
        for k in tree:
            np.testing.assert_array_equal(np.asarray(tr[k]),
                                          np.asarray(jr[k]))
            np.testing.assert_array_equal(np.asarray(tres[k]),
                                          np.asarray(jres[k]))


def test_resolve_collective_config_equals_reference(tmp_path):
    for v in (None, "none", "", "bf16", "int8",
              dict(compression="int8", chunk=64, junk=1)):
        t, j = TZ.resolve_collective_config(v), JZ.resolve_collective_config(v)
        assert (t is None) == (j is None)
        if t is not None:
            assert (t.compression, t.chunk, t.error_feedback, t.strategy) \
                == (j.compression, j.chunk, j.error_feedback, j.strategy)
    for bad in ("fp8", 3):
        with pytest.raises((ValueError, TypeError)):
            TZ.resolve_collective_config(bad)
    with pytest.raises(ValueError):
        TZ.CollectiveConfig(chunk=4)
    # the int8 shorthand takes the tuned chunk for this device
    plane = TunePlane(directory=str(tmp_path))
    prev = set_tuneplane(plane)
    try:
        res = TA.Autotuner(plane, blocks=1).run(
            TA.registered_spaces()["int8_codec_chunk"], numel=1 << 12,
            candidates=(64, 128), device="cpu", reps=1)
        assert res["winner"]["chunk"] in (64, 128)
        assert TZ._tuned_int8_chunk(device="cpu") is None  # other geometry
        plane.record(TZ.INT8_CHUNK_SPACE, "numel=262144", {"chunk": 512},
                     measured_ms=1.0, trials=2, device="cpu")
        assert TZ._tuned_int8_chunk(device="cpu") == 512
    finally:
        set_tuneplane(prev)


# -- the launcher's causes and the wires ---------------------------------------

def test_rank_causes_equal_reference():
    cases = [({0: 0, 1: -9}, [], [], None),
             ({0: None, 1: 1}, [0], [], {1: "hang at step 3"}),
             ({0: 0, 1: 0}, [], [1], None),
             ({0: 2, 1: None, 2: 0}, [1], [2], {0: "straggler at step 1"})]
    for rc, to, miss, extra in cases:
        assert TL._rank_causes(rc, to, miss, extra) == JL._rank_causes(
            rc, to, miss, extra)
    e = TL.WorkerFailure("boom", {0: "log0"}, causes={1: "exit -9"})
    assert e.causes == {1: "exit -9"} and "rank 1: exit -9" in str(e)


def test_wire_parsers_equal_reference():
    lines = ['SMLMP_HB:{"rank": 1, "step": 4, "ts": 1.5}', "SMLMP_HB:[1]",
             "SMLMP_HB:{bad", "hello", 'SMLMP_TM:{"rank": 0, "seq": 2}',
             "SMLMP_TM:7", "SMLMP_TM:"]
    for line in lines:
        assert TH.parse_heartbeat(line) == JH.parse_heartbeat(line)
        assert TG.parse_telemetry(line) == JG.parse_telemetry(line)
    assert (TH.HB_MARKER, TG.TM_MARKER) == (JH.HB_MARKER, JG.TM_MARKER)


def test_heartbeat_and_telemetry_emitters_write_parseable_lines():
    import io
    buf = io.StringIO()
    TH.beat(3)
    em = TH.HeartbeatEmitter(2, 10.0, stream=buf)
    em._emit()
    hb = TH.parse_heartbeat(buf.getvalue().splitlines()[0])
    assert hb["rank"] == 2 and hb["step"] >= 3
    TH.reset_step()
    buf = io.StringIO()
    tm = TG.TelemetryEmitter(1, 10.0, stream=buf)
    tm.emit_now(final=True)
    batch = TG.parse_telemetry(buf.getvalue().splitlines()[0])
    assert batch["rank"] == 1 and batch["final"] and "metrics" in batch
    plane = TG.GangPlane(2)
    plane.ingest(1, batch)
    assert plane.batches(1) == 1 and plane.saw_final(1)
    assert plane.metrics_for(1) is not None


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


_BEATS = [(0.5, 0, 1), (0.5, 1, 1), (1.0, 0, 2), (1.0, 1, 1), (2.0, 0, 3),
          (2.0, 2, 1), (3.1, 0, 4), (4.2, 0, 5), (5.0, None, None),
          (7.0, 0, 6), (9.5, None, None), (40.0, None, None)]


def test_heartbeat_monitor_verdicts_equal_reference():
    """One scripted sequence of beats (seconds, rank, step) under an
    injected clock: ages, suspicion, verdicts and stragglers agree with
    the reference's at every instant."""
    tc, jc = _Clock(), _Clock()
    kw = dict(hang_intervals=3.0, startup_grace_s=30.0,
              straggler_lag_steps=2)
    tm = TS.HeartbeatMonitor(3, 1.0, clock=tc, **kw)
    jm = JS.HeartbeatMonitor(3, 1.0, clock=jc, **kw)
    seen = []
    for t, rank, step in _BEATS:
        tc.t = jc.t = 100.0 + t
        if rank is not None:
            tm.observe(rank, step=step)
            jm.observe(rank, step=step)
        assert tm.verdicts() == jm.verdicts()
        assert tm.stragglers() == jm.stragglers()
        assert tm.ages() == jm.ages()
        assert tm.last_steps() == jm.last_steps()
        assert [tm.suspicion(r) for r in range(3)] == \
            [jm.suspicion(r) for r in range(3)]
        seen.append(dict(tm.verdicts()))
    assert any(seen) and any("hang at step" in v for d in seen
                             for v in d.values())
    tm.mark_done(0)
    jm.mark_done(0)
    assert tm.verdicts() == jm.verdicts()


def test_postmortem_bundle_is_schema_checked(tmp_path):
    plane = TG.GangPlane(2)
    out = TG.write_postmortem(str(tmp_path / "pm.json"), task="t",
                              causes={1: "exit -9"}, attempt=0, n_ranks=2,
                              plane=plane, last_steps={0: 3, 1: None},
                              obs_dir=str(tmp_path))
    TG.check_postmortem(out)
    assert out["verdict"] == "rank 1: exit -9"
    assert out["last_durable_step"] == 3
    with pytest.raises(Exception):
        TG.check_postmortem({"task": "t"})


# -- the watchdog ----------------------------------------------------------------

def test_watchdog_turns_a_hang_into_collective_timeout():
    faults = get_faults()
    faults.inject("collective.dispatch", "hang", times=1)
    release = threading.Event()
    try:
        import time
        t0 = time.perf_counter()
        with pytest.raises(TC.CollectiveTimeout) as ei:
            TC.dispatch_watchdog(release.wait, op="psum", axis="data",
                                 timeout_s=0.3, payload_bytes=64)
        assert time.perf_counter() - t0 < 5.3
        e = ei.value
        assert (e.op, e.axis, e.payload_bytes, e.timeout_s) == (
            "psum", "data", 64, 0.3)
        assert "64 payload bytes" in str(e)
    finally:
        faults.clear()
        release.set()
    # inline without a timeout; errors surface on the caller's thread
    assert TC.dispatch_watchdog(lambda: 5, op="x") == 5
    with pytest.raises(KeyError):
        TC.dispatch_watchdog(lambda: {}["k"], op="x", timeout_s=5.0)


def test_elastic_arguments_refused_before_any_process(monkeypatch):
    """Elastic resize is ported (tests/test_torch_elastic.py); the
    arguments the JAX package refuses are refused before any process
    starts: ``min_ranks`` outside ``[1, n_processes]``, and ``resize``
    below one rank or below ``min_ranks``."""
    def no_spawn(*a, **k):
        raise AssertionError("a process started")
    monkeypatch.setattr("subprocess.Popen", no_spawn)
    for kw in (dict(min_ranks=0), dict(min_ranks=3, capacity_fn=lambda: 2),
               dict(min_ranks=5, checkpoint_dir="/tmp/x")):
        with pytest.raises(ValueError, match="min_ranks"):
            TL.run_on_local_cluster("m:f", 2, device="cpu", **kw)
    sup = TS.GangSupervisor("m:f", 2, device="cpu", min_ranks=2)
    for n in (0, 1):
        with pytest.raises(ValueError, match="resize"):
            sup.resize(n)
    # nccl with more ranks than cards raises before the rendezvous
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        TL.run_on_local_cluster("m:f", 2, device="cuda", backend="nccl")


def test_reserved_port_holds_its_bind():
    import socket
    with TL.ReservedPort() as rp:
        assert rp.held
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 0)
        with pytest.raises(OSError):
            s.bind(("127.0.0.1", rp.port))
        s.close()
    assert not rp.held and TL.find_free_port() > 0
