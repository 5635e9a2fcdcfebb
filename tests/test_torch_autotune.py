"""The port's autotuner held against the JAX package's on the CPU: the
harness (winner = the measured minimum, persisted; error candidates
dropped; an empty space claims nothing; ``persist=False``) gives the same
results in both packages for the same self-timed candidates; the fitted
collective cost model gives equal numbers; every registered space's entry
point resolves and an unregistered one raises; and the three builtin
spaces run here over the kernels' plain versions, keyed ``cpu``, and
their winners reach the construction sites: a ``gbdt_hist_geometry``
winner re-gates and changes the launch geometry but not the histogram (a
rejected winner keeps the default), ``paged_attn_variant`` picks the
engine's K3 kernel before any graph is captured, and ``llm_bucket_grid``
retunes the engine's prefill grid.
"""

import math

import numpy as np
import pytest
import torch

from synapseml_tpu.telemetry import autotune as JA
from synapseml_tpu.telemetry import tunetable as JT
from synapseml_tpu_torch.models.gbdt import hist as H
from synapseml_tpu_torch.models.llm import paged_attn as PA
from synapseml_tpu_torch.telemetry import autotune as TA
from synapseml_tpu_torch.telemetry import tunetable as TT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


@pytest.fixture
def plane(tmp_path):
    """A table-backed port plane pinned as the process default for the
    test, and always restored."""
    fresh = TT.TunePlane(directory=str(tmp_path / "port"))
    prev = TT.set_tuneplane(fresh)
    try:
        yield fresh
    finally:
        TT.set_tuneplane(prev)


def _space(mod, trials, name):
    entry = ("synapseml_tpu.parallel.compression:int8_roundtrip_jit"
             if mod is JA else
             "synapseml_tpu_torch.models.gbdt.hist:build_hist_nodes_limbs")
    return mod.TuneSpace(name=name, entry_point=entry,
                         build=lambda **ctx: ("g=test", list(trials)))


def _boom():
    raise RuntimeError("candidate cannot run here")


HARNESS_CASES = {
    "minimum": [({"x": 1}, lambda: 0.005), ({"x": 2}, lambda: 0.002),
                ({"x": 3}, lambda: 0.004)],
    "error-dropped": [({"x": 1}, _boom), ({"x": 2}, lambda: 0.002)],
    "tie-first": [({"x": 1}, lambda: 0.001), ({"x": 2}, lambda: 0.001)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(HARNESS_CASES))
def test_harness_equals_reference(tmp_path, case):
    results = []
    for mod, tmod in ((JA, JT), (TA, TT)):
        p = tmod.TunePlane(directory=str(tmp_path / mod.__name__),
                           kind="cpu")
        name = f"synthetic_{case}"
        res = mod.Autotuner(plane=p).run(
            _space(mod, HARNESS_CASES[case], name))
        won = p.consult("s", name, "g=test")
        if res is not None:
            res = {k: res[k] for k in ("winner", "measured_ms",
                                       "trial_count", "trials_ms")}
        results.append((res, won))
    assert results[0] == results[1]
    if case == "empty":
        assert results[1] == (None, None)


def test_persist_false_leaves_the_table_alone(plane):
    space = _space(TA, [({"x": 1}, lambda: 0.001)], "synthetic_nopersist")
    assert TA.Autotuner(plane=plane).run(space, persist=False) is not None
    assert plane.consult("s", "synthetic_nopersist", "g=test") is None


def test_trial_counter_counts_outcomes(plane):
    from synapseml_tpu_torch.telemetry import get_registry
    c = get_registry().counter("autotune_trials_total", "", ("space",
                                                              "outcome"))
    before = (c.value(space="synthetic_cnt", outcome="error"),
              c.value(space="synthetic_cnt", outcome="ok"))
    TA.Autotuner(plane=plane).run(_space(
        TA, HARNESS_CASES["error-dropped"], "synthetic_cnt"))
    assert (c.value(space="synthetic_cnt", outcome="error"),
            c.value(space="synthetic_cnt", outcome="ok")) == (
                before[0] + 1, before[1] + 1)
    assert TA.AUTOTUNE_METRICS == JA.AUTOTUNE_METRICS


def test_every_registered_space_entry_point_resolves():
    spaces = TA.registered_spaces()
    assert {"gbdt_hist_geometry", "paged_attn_variant",
            "llm_bucket_grid"} <= set(spaces)
    # the JAX package's names tune other knobs: never registered here
    assert not {"gbdt_hist_chunk", "paged_attn_tile",
                "int8_chunk"} & set(spaces)
    for space in spaces.values():
        assert callable(TA.resolve_entry_point(space.entry_point))


@pytest.mark.parametrize("spec", [
    "synapseml_tpu_torch.models.gbdt.hist:route_rows",
    "synapseml_tpu_torch.models.gbdt.hist:nope", "not_a_spec",
    "synapseml_tpu.models.gbdt.pallas_hist:build_hist_nodes_pallas"])
def test_unregistered_entry_points_raise(spec):
    with pytest.raises(ValueError):
        TA.resolve_entry_point(spec)


# -- the fitted collective cost model -----------------------------------------

@pytest.mark.parametrize("samples", [
    [(1e5, 2e-4 + 3e-9 * 1e5), (1e6, 2e-4 + 3e-9 * 1e6),
     (1e7, 2e-4 + 3e-9 * 1e7)],
    [(1024, 1e-5), (4096, 2.5e-5), (65536, 3e-4), (1 << 20, 4.1e-3)],
    [(10, 5.0), (20, 7.0)]])
def test_fit_alpha_beta_equals_reference(samples):
    assert TA.fit_alpha_beta(samples) == JA.fit_alpha_beta(samples)
    jm = JA.CollectiveCostModel.fitted(samples)
    tm = TA.CollectiveCostModel.fitted(samples)
    for w in (2, 4, 8, 16, 64):
        assert tm.tree_cutoff_bytes(w) == jm.tree_cutoff_bytes(w)
    assert tm.predict_s(12345) == jm.predict_s(12345)
    assert tm.describe() == jm.describe()


@pytest.mark.parametrize("bad", [
    [(1e6, 1.0)], [(1e6, 1.0), (1e6, 2.0)],
    [(1e6, float("nan")), (2e6, 1.0)]])
def test_fit_refusals_equal_reference(bad):
    for mod in (JA, TA):
        with pytest.raises(ValueError):
            mod.fit_alpha_beta(bad)


def test_cost_model_refusals_and_spec_equal_reference():
    for mod in (JA, TA):
        with pytest.raises(ValueError):
            mod.CollectiveCostModel.fitted([(1e5, 2.0), (1e6, 1.0)])
        with pytest.raises(ValueError):
            mod.CollectiveCostModel(alpha_s=1e-4, beta_s_per_byte=0.0,
                                    source="fitted")
        with pytest.raises(ValueError):
            mod.CollectiveCostModel(source="measured")
        m = mod.CollectiveCostModel.spec(12345)
        assert m.tree_cutoff_bytes(8) == 12345 and m.predict_s(1) is None
    m = TA.CollectiveCostModel(alpha_s=2e-4, beta_s_per_byte=3e-9,
                               source="fitted")
    for w in (4, 8, 16):
        n = m.tree_cutoff_bytes(w)
        L, hops = math.ceil(math.log2(w)), 2 * (w - 1)
        tree = L * (m.alpha_s + m.beta_s_per_byte * n)
        ring = hops * (m.alpha_s + m.beta_s_per_byte * n / w)
        assert tree == pytest.approx(ring, rel=1e-6)
    assert (TA.COST_MODEL_SPACE, TA.COST_MODEL_GEOMETRY) == (
        JA.COST_MODEL_SPACE, JA.COST_MODEL_GEOMETRY)


# -- gbdt_hist_geometry -------------------------------------------------------

def test_hist_candidates_pass_the_gate_and_include_the_default():
    for F, B, S in ((28, 256, 16), (28, 32, 16), (8, 256, 1), (3, 501, 16),
                    (64, 64, 4)):
        cands = H.rows_geometry_candidates(F, B, S)
        assert cands and all(H.rows_geometry_ok(F, B, S, f, t)
                             for f, t in cands)
        assert len(set(cands)) == len(cands)
        fpb, tile = H.rows_geometry(F, B, S)[:2]
        assert H.rows_geometry_ok(F, B, S, fpb, tile)
    assert not H.rows_geometry_ok(28, 256, 16, 29, 256)     # fpb > F
    assert not H.rows_geometry_ok(28, 256, 16, 14, 96)      # not a pow2
    assert not H.rows_geometry_ok(28, 256, 16, 28, 2048)    # smem
    assert not H.rows_geometry_ok(28, 256, 16, True, 256)   # a bool


def test_hist_space_on_the_cpu_records_a_cpu_winner_the_launch_loads(plane):
    space = TA.registered_spaces()["gbdt_hist_geometry"]
    res = TA.Autotuner(plane=plane, blocks=1).run(
        space, num_features=5, total_bins=16, n_slots=4, n_rows=2048,
        device="cpu", reps=1)
    assert res["trial_count"] == len(H.rows_geometry_candidates(5, 16, 4))
    entry, = plane.snapshot()["entries"]
    assert entry["device_kind"] == "cpu"
    assert entry["geometry"] == H.hist_geometry_key(5, 16, 4)
    won = (res["winner"]["fpb"], res["winner"]["tile"])
    assert H.launch_geometry(5, 16, 4, torch.device("cpu")) == won
    assert plane.snapshot()["consults"][-1]["outcome"] == "loaded"
    # one consult per plane, device kind and geometry
    n = len(plane.snapshot()["consults"])
    H.launch_geometry(5, 16, 4, torch.device("cpu"))
    assert len(plane.snapshot()["consults"]) == n


def test_a_rejected_hist_winner_keeps_the_default(plane):
    geo = H.hist_geometry_key(28, 256, 16)
    plane.record("gbdt_hist_geometry", geo, {"fpb": 28, "tile": 2048},
                 measured_ms=0.1, trials=3, device="cpu")
    assert H.launch_geometry(28, 256, 16, torch.device("cpu")) == \
        H.rows_geometry(28, 256, 16)[:2]
    assert plane.snapshot()["consults"][-1]["outcome"] == "invalid"


def test_hist_winner_changes_geometry_not_histogram(plane):
    rng = np.random.default_rng(0)
    F, B, S, N = 6, 32, 4, 3000
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32))
    slot = torch.as_tensor(rng.integers(-1, S, N).astype(np.int32))
    vals, _ = H.prep_hist_vals(torch.as_tensor(rng.normal(size=N),
                                               dtype=torch.float32),
                               torch.ones(N), torch.ones(N))
    want = H.build_hist_nodes_limbs(bins, slot, vals, S, B)
    plane.record("gbdt_hist_geometry", H.hist_geometry_key(F, B, S),
                 {"fpb": 2, "tile": 256}, measured_ms=0.1, trials=3,
                 device="cpu")
    assert H.launch_geometry(F, B, S, torch.device("cpu")) == (2, 256)
    assert H.launch_geometry(F, B, S, torch.device("cpu")) != \
        H.rows_geometry(F, B, S)[:2]
    for g in H.rows_geometry_candidates(F, B, S):
        assert torch.equal(H.build_hist_nodes_limbs(bins, slot, vals, S, B,
                                                    geometry=g), want)


def test_tuned_gbdt_fit_equals_untuned(plane):
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    rng = np.random.default_rng(1)
    X = rng.normal(size=(800, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    cfg = BoostingConfig(objective="binary", num_iterations=3, num_leaves=7,
                         max_bin=15)
    prev = TT.set_tuneplane(TT.TunePlane(directory=None))
    try:
        base, _ = train(X, y, cfg, device="cpu")
    finally:
        TT.set_tuneplane(prev)
    for w in (16, 4):
        plane.record("gbdt_hist_geometry", H.hist_geometry_key(5, w, 1),
                     {"fpb": 1, "tile": 128}, measured_ms=0.1, trials=1,
                     device="cpu")
    tuned, _ = train(X, y, cfg, device="cpu")
    for ta, tb in zip(base.trees, tuned.trees):
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- paged_attn_variant and llm_bucket_grid -----------------------------------

@pytest.fixture(scope="module")
def tiny():
    from synapseml_tpu_torch.models.llm import LlamaConfig, LlamaModel
    return {dt: LlamaModel(LlamaConfig.tiny(num_layers=2, max_len=64,
                                            dtype=dt), device="cpu", seed=0)
            for dt in (torch.float32, torch.bfloat16)}


def _engine(model, **kw):
    from synapseml_tpu_torch.models.llm import SlotEngine
    return SlotEngine(model, n_slots=2, max_len=64, device="cpu",
                      name="pt_autotune_engine", **kw)


def test_variant_space_on_the_cpu(plane):
    space = TA.registered_spaces()["paged_attn_variant"]
    res = TA.Autotuner(plane=plane, blocks=1).run(
        space, max_len=64, num_heads=4, num_kv_heads=2, d_head=16,
        n_slots=2, span=2, device="cpu", reps=1)
    assert set(res["trials_ms"]) == {"variant=split", "variant=single"}
    res = TA.Autotuner(plane=plane, blocks=1).run(
        space, max_len=64, num_heads=4, num_kv_heads=2, d_head=16,
        n_slots=2, dtype="float32", device="cpu", reps=1)
    assert res["winner"] == {"variant": "single"} and res["trial_count"] == 1
    assert {e["device_kind"] for e in plane.snapshot()["entries"]} == {"cpu"}


@pytest.mark.parametrize("dtype,winner,want,outcome", [
    (torch.bfloat16, "single", "single", "loaded"),
    (torch.bfloat16, "split", "split", "loaded"),
    (torch.float32, "split", None, "invalid"),
    (torch.float32, "single", "single", "loaded")])
def test_engine_takes_the_variant_winner(plane, tiny, dtype, winner, want,
                                         outcome):
    m = tiny[dtype]
    geo = PA.paged_geometry_key(64, m.cfg.num_kv_heads, m.cfg.d_head, dtype,
                                1)
    plane.record(PA.VARIANT_SPACE, geo, {"variant": winner},
                 measured_ms=0.01, trials=2, device="cpu")
    eng = _engine(m, attention_backend="paged")
    assert eng.paged_variant == want
    c = [c for c in plane.snapshot()["consults"]
         if c["space"] == PA.VARIANT_SPACE][-1]
    assert (c["site"], c["outcome"]) == ("SlotEngine", outcome)


def test_no_table_keeps_the_dtype_default(tiny):
    prev = TT.set_tuneplane(TT.TunePlane(directory=None))
    try:
        eng = _engine(tiny[torch.bfloat16], attention_backend="paged")
        assert eng.paged_variant is None and eng._buckets[0] == 8
        assert _engine(tiny[torch.float32],
                       attention_backend="dense").paged_variant is None
    finally:
        TT.set_tuneplane(prev)
    assert PA.default_variant(torch.bfloat16) == "split"
    assert PA.default_variant(torch.float32) == "single"
    q = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="variant"):
        PA.paged_decode_attention(q, torch.zeros(1, 8, 1, 16),
                                  torch.zeros(1, 8, 1, 16),
                                  torch.ones(1, dtype=torch.int32),
                                  variant="split")


def test_variant_is_chosen_before_the_graphs(plane, tiny):
    m = tiny[torch.float32]
    plane.record(PA.VARIANT_SPACE,
                 PA.paged_geometry_key(64, m.cfg.num_kv_heads, m.cfg.d_head,
                                       torch.float32, 4),
                 {"variant": "single"}, measured_ms=0.01, trials=2,
                 device="cpu")
    eng = _engine(m, attention_backend="paged", spec_draft_len=3,
                  warmup="sync")
    assert eng.paged_variant == "single" and eng.compile_plane.is_warm
    with pytest.raises(RuntimeError, match="before any graph"):
        eng._consult_paged_variant(4)


def test_bucket_grid_space_and_winner_retune_the_engine(plane, tiny):
    space = TA.registered_spaces()["llm_bucket_grid"]
    res = TA.Autotuner(plane=plane, blocks=1).run(space, device="cpu")
    assert res["trial_count"] == 3
    won = res["winner"]["min_bucket"]
    eng = _engine(tiny[torch.float32])
    assert eng._buckets[0] == won and eng._buckets[-1] == 64
    plane.record("llm_bucket_grid", TT.geometry_key(max_len=64),
                 {"min_bucket": 16}, measured_ms=0.5, trials=3, device="cpu")
    assert _engine(tiny[torch.float32])._buckets == (16, 32, 64)
    assert _engine(tiny[torch.float32], min_bucket=4)._buckets[0] == 4
    plane.record("llm_bucket_grid", TT.geometry_key(max_len=64),
                 {"min_bucket": 12}, measured_ms=0.5, trials=3, device="cpu")
    assert _engine(tiny[torch.float32])._buckets[0] == 8     # not a pow2
