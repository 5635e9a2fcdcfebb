"""The port's profiling plane held against the JAX package on the CPU:
``core.profiling`` (``PhaseTimer``, ``trace``), the roofline blocks and
the cost capture, ``StepProfiler`` (``measure``'s statistics under one
injected clock, the begin/mark/segment accounting under one scripted
``time.perf_counter``, the histogram series) and the profiled loops of
``booster.train``, ``SlotEngine`` and the DL classifiers, which give the
trees, tokens and weights of their unprofiled runs, ``capture_xla``
included.

A GBDT fit of the port cannot equal the JAX package's bit for bit on the
CPU (the JAX package histograms f32 gradients by scatter-add, the port
sums exact int8 limbs): across packages the profiled fits agree on the
first split and the step accounting, within a package they are equal.
"""

import os
import time

import numpy as np
import pytest
import torch

from synapseml_tpu.core import profiling as jprof
from synapseml_tpu.telemetry import gangplane as jgp
from synapseml_tpu.telemetry import roofline as jroof
from synapseml_tpu.telemetry.registry import MetricsRegistry as JRegistry
from synapseml_tpu_torch.core import profiling as tprof
from synapseml_tpu_torch.telemetry import gangplane as tgp
from synapseml_tpu_torch.telemetry import roofline as troof
from synapseml_tpu_torch.telemetry.registry import MetricsRegistry
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

PACKAGES = [("jax", jgp, JRegistry), ("port", tgp, MetricsRegistry)]


def _both(fn):
    """fn(gangplane module, registry class) in each package → results."""
    return [fn(gp, reg) for _, gp, reg in PACKAGES]


# -- StepProfiler.measure ----------------------------------------------------

PAIRED_CASES = {
    "min-block": ([1.0] * 6, [1.5, 1.2, 1.9, 1.1, 1.4, 1.3], 2, 3),
    "one-block": ([2.0, 1.0, 3.0, 2.5], [2.5, 1.0, 3.5, 2.0], 1, 4),
    "drift": ([1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6, 1.7],
              [1.2, 1.3, 1.4, 1.5, 1.6, 1.7, 1.8, 1.9], 2, 4),
}


@pytest.mark.parametrize("case", sorted(PAIRED_CASES))
def test_measure_paired_equals_reference(case):
    base, other, blocks, pairs = PAIRED_CASES[case]

    def run(gp, _):
        b, o = iter(base), iter(other)
        calls = []

        def leg(it, tag):
            def f():
                calls.append(tag)
                return next(it)
            return f
        out = gp.StepProfiler.measure((leg(b, "b"), leg(o, "o")),
                                      blocks=blocks, pairs=pairs)
        return out, calls
    (jo, jc), (to, tc) = _both(run)
    assert to == pytest.approx(jo) and tc == jc


@pytest.mark.parametrize("form", ["self-timed", "clock", "bool-leg"])
def test_measure_multi_equals_reference(form):
    def run(gp, _):
        order = []
        if form == "self-timed":
            vals = {"x": iter([3.0, 1.0, 2.0]), "y": iter([2.0, 4.0, 0.5])}

            def mk(n):
                def f():
                    order.append(n)
                    return next(vals[n])
                return f
            return gp.StepProfiler.measure({n: mk(n) for n in vals},
                                           blocks=3), order
        ticks = iter([0.0, 2.0, 2.0, 5.0, 5.0, 6.0, 6.0, 10.0])
        legs = ({"a": lambda: None, "b": lambda: None} if form == "clock"
                else {"t": lambda: True, "u": lambda: False})
        return gp.StepProfiler.measure(legs, blocks=2,
                                       timer=lambda: next(ticks)), order
    (jo, jord), (to, tord) = _both(run)
    assert to == pytest.approx(jo) and tord == jord


@pytest.mark.parametrize("legs", [42, (lambda: None,), "ab",
                                  (lambda: None, 3)])
def test_measure_refuses_bad_legs_like_reference(legs):
    for gp in (jgp, tgp):
        with pytest.raises(TypeError):
            gp.StepProfiler.measure(legs)


# -- begin / mark / segment accounting under one scripted clock ---------------

def _scripted_profile(gp, registry_cls, monkeypatch):
    """One sequence of steps under a scripted ``time.perf_counter``: →
    (summary without its wall-clock-free parts, the histogram buckets)."""
    ticks = iter(np.cumsum([0.0] + [0.001 * (i % 7 + 1)
                                    for i in range(200)]).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    reg = registry_cls()
    prof = gp.StepProfiler("parity_model", registry=reg)
    for i in range(3):
        prof.step_begin(i)
        prof.mark("data")
        prof.mark("compute")
        prof.step_end()
    with prof.step(3):
        with prof.segment("data"):
            pass
        with prof.segment("compute"):
            pass
    prof.step_begin(4)
    prof.mark("compute")
    gp.observe_collective(0.25, 1024)
    prof.step_begin(5)             # closes step 4
    prof.finish()
    monkeypatch.undo()
    hist = prof._hist
    buckets = {seg: hist.stats(model="parity_model", segment=seg)
               for seg in ("data", "compute", "collective", "other",
                           "total")}
    return prof.summary(), buckets


def test_step_accounting_equals_reference(monkeypatch):
    (js, jb), (ts, tb) = [_scripted_profile(gp, reg, monkeypatch)
                          for _, gp, reg in PACKAGES]
    assert ts["steps"] == js["steps"] == 6
    for key in ("seconds", "per_step_avg_seconds"):
        assert ts[key] == pytest.approx(js[key])
    assert ts["collective_bytes"] == js["collective_bytes"] == 1024
    assert ts["last_steps"] == pytest.approx(js["last_steps"])
    assert tb.keys() == jb.keys()
    for seg in tb:
        assert tb[seg]["buckets"] == jb[seg]["buckets"], seg
        assert tb[seg]["count"] == jb[seg]["count"], seg
        assert tb[seg]["sum"] == pytest.approx(jb[seg]["sum"]), seg
    assert ts["seconds"]["total"] == pytest.approx(
        sum(ts["seconds"][s] for s in ("data", "compute", "other")))


def test_nested_profilers_and_dangling_steps_like_reference():
    for _, gp, reg in PACKAGES:
        outer = gp.StepProfiler("o", registry=reg())
        inner = gp.StepProfiler("i", registry=reg())
        outer.step_begin(0)
        inner.step_begin(0)
        assert gp.current_profiler() is inner
        inner.step_end()
        assert gp.current_profiler() is outer
        outer.step_end()
        assert gp.current_profiler() is None
        outer.step_begin(1)
        outer.step_begin(2)
        outer.finish()
        outer.finish()
        assert outer.steps == 3


def test_check_profiler_refuses_what_is_not_one():
    tgp.check_profiler(None, "x")
    tgp.check_profiler(tgp.StepProfiler("ok", registry=MetricsRegistry()),
                       "x")
    with pytest.raises(TypeError, match="StepProfiler"):
        tgp.check_profiler(object(), "x")


def test_export_writes_the_summary(tmp_path):
    prof = tgp.StepProfiler("export_model", registry=MetricsRegistry())
    with prof.step(0):
        pass
    out = prof.export(str(tmp_path / "prof.json"))
    assert out and os.path.exists(tmp_path / "prof.json")


# -- core.profiling -----------------------------------------------------------

def test_phase_timer_equals_reference(monkeypatch):
    got = []
    for mod in (jprof, tprof):
        ticks = iter([0.0, 0.5, 1.0, 3.0, 3.0, 3.25])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t = mod.PhaseTimer()
        with t.phase("binning"):
            pass
        with t.phase("train"):
            pass
        with t.phase("binning"):
            pass
        monkeypatch.undo()
        got.append((t.report(), t.counts()))
        t.reset()
        assert t.report() == {} and t.counts() == {}
    assert got[0] == got[1] == ({"binning": 0.75, "train": 2.0},
                                {"binning": 2, "train": 1})


def test_trace_writes_a_trace_and_nests_as_a_no_op(tmp_path):
    d = str(tmp_path / "trace")
    with tprof.trace(d):
        with tprof.trace(d):          # a second session is a no-op
            torch.ones(8).add_(1)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with pytest.raises(KeyError):
        with tprof.trace(d):
            raise KeyError("body exceptions propagate")
    assert len(os.listdir(d)) == 2


# -- roofline -----------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (1024.0, 2048.0, 1.5, 4.0), (None, 10.0, None, 1.0),
    (8.0, None, 0.25, 2.0), (0.0, 0.0, 0.0, 1.0)])
def test_roofline_block_equals_reference(args):
    bps, fps, ms, samples = args
    jb = jroof.roofline_block(bps, fps, ms, device=None, samples=samples)
    tb = troof.roofline_block(bps, fps, ms, device=None, samples=samples)
    assert tb == jb
    troof.check_roofline_block(tb)
    assert troof.paired_roofline("leg", tb, tb) == jroof.paired_roofline(
        "leg", jb, jb)


@pytest.mark.parametrize("bad", [[], {"bytes_per_sample": 1.0},
                                 dict.fromkeys(troof.ROOFLINE_BLOCK_KEYS,
                                               "x")])
def test_check_roofline_block_refuses_like_reference(bad):
    for mod in (jroof, troof):
        with pytest.raises(ValueError):
            mod.check_roofline_block(bad)


def test_spec_tables_hold_only_the_card():
    assert set(troof.CHIP_PEAK_FLOPS) == set(troof.CHIP_HBM_BW) == {
        "NVIDIA H100 80GB HBM3"}
    assert troof.chip_peak_flops(torch.device("cpu")) is None
    assert troof.chip_hbm_bw("cpu") is None

    class _Dev:
        device_kind = "NVIDIA H100 80GB HBM3"
    assert troof.chip_peak_flops(_Dev()) == 989e12
    assert troof.chip_hbm_bw(_Dev()) == 3.35e12
    block = troof.roofline_block(1e6, 1e9, 1.0, device=_Dev())
    assert block["bandwidth_ms"] == pytest.approx(1e6 / 3.35e12 * 1e3)


def test_capture_counts_flops_and_bytes_and_propagates_nothing():
    a = torch.randn(16, 32)
    b = torch.randn(32, 8)
    cost = troof.capture(lambda x, y: torch.relu(x @ y), a, b)
    assert cost["matmul_flops"] == 2 * 16 * 32 * 8
    # relu writes 16 x 8 elements
    assert cost["flops"] == 2 * 16 * 32 * 8 + 16 * 8
    # mm reads a and b and writes 16 x 8; relu reads and writes 16 x 8
    assert cost["bytes_accessed"] == 4 * (16 * 32 + 32 * 8 + 3 * 16 * 8)
    assert cost["top_ops"][0]["name"] == "mm"

    def boom():
        raise RuntimeError("x")
    assert troof.capture(boom) is None
    audit = troof.audit("k", lambda: a @ b, samples=16.0)
    assert audit["bytes_per_sample"] == pytest.approx(
        4 * (16 * 32 + 32 * 8 + 16 * 8) / 16)
    assert audit["block"]["bandwidth_ms"] is None       # the CPU: no bound


def test_capture_hears_the_kernels_byte_reports():
    from synapseml_tpu_torch.kernels import launches
    ten = torch.zeros(10)
    cost = troof.capture(lambda: launches.io_bytes("k", ten, 100, None))
    assert cost["bytes_accessed"] == 140.0
    assert cost["top_ops"] == [{"name": "k", "mbytes": 140 / 1e6}]
    assert not launches.wants_bytes()


def test_summary_exports_the_gauges_only_with_a_peak():
    reg = MetricsRegistry()
    prof = tgp.StepProfiler("g_model", registry=reg, capture_xla=True)
    prof.capture_cost("k", lambda x: x @ x, torch.ones(8, 8), items=4)
    prof.step_begin(0)
    prof.mark("compute")
    prof.step_end()
    roof = prof.summary()["roofline"]["k"]
    assert roof["flops"] == 2 * 8 ** 3
    assert roof["bytes_per_sample"] == roof["bytes_accessed"] / 4
    assert prof._g_bytes.value(model="g_model", key="k") > 0
    # no spec-sheet peak for the CPU: no MFU is claimed
    assert prof._g_mfu.value(model="g_model", key="k") == 0


# -- the profiled loops -------------------------------------------------------

def _gbdt_data(n=1200, F=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.normal(scale=0.3, size=n) > 0).astype(
        np.float32)
    return X, y


def _trees_equal(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        for xa, xb in zip(ta, tb):
            np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))


@pytest.mark.parametrize("capture", [False, True])
def test_profiled_gbdt_fit_equals_unprofiled_and_reference(capture):
    from synapseml_tpu.models.gbdt.booster import BoostingConfig as JConfig
    from synapseml_tpu.models.gbdt.booster import train as jtrain
    from synapseml_tpu_torch.models.gbdt.booster import (BoostingConfig,
                                                         train)
    X, y = _gbdt_data()
    kw = dict(objective="binary", num_iterations=4, num_leaves=7,
              min_data_in_leaf=5, max_bin=31)
    plain, _ = train(X, y, BoostingConfig(**kw), device="cpu")
    prof = tgp.StepProfiler("pt_gbdt", registry=MetricsRegistry(),
                            capture_xla=capture)
    profiled, _ = train(X, y, BoostingConfig(**kw), device="cpu",
                        step_profiler=prof)
    _trees_equal(plain.trees, profiled.trees)
    jprof_ = jgp.StepProfiler("jx_gbdt", registry=JRegistry(),
                              capture_xla=capture)
    jb = jtrain(X, y, JConfig(**kw), step_profiler=jprof_)
    jb = jb[0] if isinstance(jb, tuple) else jb
    assert int(profiled.trees[0].split_feature[0]) == int(
        jb.trees[0].split_feature[0])
    for p in (prof, jprof_):
        assert p.steps == 4 and p.totals["compute"] > 0
        assert set(p.summary()["last_steps"][-1]) == {
            "step", "total", "data", "compute", "collective", "other"}
        assert tgp.current_profiler() is None and p._open is None
    if capture:
        for p in (prof, jprof_):
            cost = p.summary()["roofline"]["gbdt_step"]
            assert cost["flops"] > 0 and cost["bytes_accessed"] > 0


def test_profiled_gbdt_fit_closes_its_step_on_an_exception(monkeypatch):
    from synapseml_tpu_torch.models.gbdt import booster as B
    X, y = _gbdt_data(n=400)
    prof = tgp.StepProfiler("pt_gbdt_err", registry=MetricsRegistry())
    calls = {"n": 0}
    real = B._write_checkpoint

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("preempted mid-checkpoint")
    monkeypatch.setattr(B, "_write_checkpoint", boom)
    with pytest.raises(RuntimeError, match="preempted"):
        B.train(X, y, B.BoostingConfig(objective="binary", num_iterations=3,
                                       num_leaves=4),
                checkpoint_dir="unused-dir", checkpoint_interval=1,
                device="cpu", step_profiler=prof)
    assert calls["n"] == 1 and real is not boom
    assert prof._open is None and prof.steps == 1
    assert tgp.current_profiler() is None


@pytest.fixture(scope="module")
def tiny_llm():
    from synapseml_tpu_torch.models.llm import LlamaConfig, LlamaModel
    cfg = LlamaConfig.tiny(num_layers=2, max_len=64, dtype=torch.float32)
    return LlamaModel(cfg, device="cpu", seed=0)


def _decode(model, prof, spec=0, warmup="off", seed=0):
    from synapseml_tpu_torch.models.llm import SlotEngine
    rng = np.random.default_rng(seed)
    eng = SlotEngine(model, n_slots=4, max_len=64, device="cpu",
                     step_profiler=prof, spec_draft_len=spec, warmup=warmup,
                     name="pt_prof_engine")
    prompts = [rng.integers(1, model.cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 13)]
    slots = [eng.admit(p, 8).slot for p in prompts]
    out = eng.run_to_completion()
    return [out[s] for s in slots], eng


@pytest.mark.parametrize("spec,warmup,capture", [
    (0, "off", False), (0, "off", True), (3, "sync", True)])
def test_profiled_engine_gives_the_unprofiled_tokens(tiny_llm, spec,
                                                     warmup, capture):
    want, _ = _decode(tiny_llm, None, spec, warmup)
    prof = tgp.StepProfiler("pt_llm", registry=MetricsRegistry(),
                            capture_xla=capture)
    got, eng = _decode(tiny_llm, prof, spec, warmup)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert prof.steps == eng.steps_run > 0
    assert prof.totals["compute"] > 0
    if capture:
        keys = set(prof.costs)
        assert "llm_decode_step_paged" in keys or spec
        assert all(c and c["flops"] > 0 and c["bytes_accessed"] > 0
                   for c in prof.costs.values())
    if warmup == "sync":
        assert eng.compile_plane.snapshot()["replays"] == eng.steps_run


@pytest.mark.parametrize("cls", ["text", "vision"])
def test_profiled_dl_fit_gives_the_unprofiled_weights(cls):
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.dl import (DeepTextClassifier,
                                               DeepVisionClassifier)
    rng = np.random.default_rng(5)
    if cls == "text":
        words = ["good", "bad", "fine", "poor", "great", "awful"]
        texts = [" ".join(rng.choice(words, 6)) for _ in range(32)]
        ds = Dataset({"text": texts, "label": rng.integers(0, 2, 32)})

        def make(prof):
            return DeepTextClassifier(
                modelSize="tiny", maxEpochs=1, batchSize=16, maxTokenLen=8,
                vocabSize=64, device="cpu", stepProfiler=prof,
                precision="f32")
    else:
        ds = Dataset({"image": [rng.random((16, 16, 3)).astype(np.float32)
                                for _ in range(16)],
                      "label": rng.integers(0, 2, 16)})

        def make(prof):
            return DeepVisionClassifier(
                backbone="resnet18", maxEpochs=1, batchSize=8,
                optimizer="sgd", learningRate=1e-2, device="cpu",
                stepProfiler=prof, precision="f32")
    prof = tgp.StepProfiler(f"pt_dl_{cls}", registry=MetricsRegistry(),
                            capture_xla=True)
    plain = make(None).fit(ds)
    profiled = make(prof).fit(ds)
    pa = plain.get("modelPayload")["variables"]
    pb = profiled.get("modelPayload")["variables"]
    flat_a = {k: v for k, v in _flatten(pa)}
    flat_b = {k: v for k, v in _flatten(pb)}
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    assert prof.steps == 2
    key = f"dl_{cls}_step"
    cost = prof.summary()["roofline"][key]
    assert cost["matmul_flops"] > 0 and cost["bytes_per_sample"] > 0


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_excluded_time_is_left_out_of_the_step(monkeypatch):
    ticks = iter([0.0, 1.0, 1.5, 4.5, 5.0, 6.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    prof = tgp.StepProfiler("excl_model", registry=MetricsRegistry())
    prof.step_begin(0)          # 0.0
    prof.mark("data")           # 1.0
    with prof.excluded():       # 1.5 .. 4.5: 3 s left out
        pass
    prof.mark("compute")        # 5.0: 4.0 - 3.0 since the data mark
    prof.step_end()             # 6.0: total 6.0 - 3.0
    monkeypatch.undo()
    assert prof.totals["data"] == pytest.approx(1.0)
    assert prof.totals["compute"] == pytest.approx(1.0)
    assert prof.totals["other"] == pytest.approx(1.0)
    assert prof.totals["total"] == pytest.approx(3.0)
    with prof.excluded():       # no open step: nothing to move
        pass
