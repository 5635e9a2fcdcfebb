"""The port's row guard against the JAX package's.

Each case runs the same stage, data and fault schedule through both
packages (``handleInvalid`` semantics, first-failure bisection, the
dead-letter quarantine, OOM-adaptive batching and ingest hardening) and
compares what each produced: the surviving rows with their source-row
provenance, the ``ErrorRecord``s (row, error class, verb, message), the
guarded stage's invocation counts (probes), and the quarantine's
on-disk batches, which each package reads from the other.  The stages
are a small ``inputCol``/``outputCol`` transformer defined here once for
each package (the JAX package's ``UDFTransformer`` lives in ``ops/``,
which the port does not have).
"""

import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import synapseml_tpu.core.dataset as jds
import synapseml_tpu.core.params as jparams
import synapseml_tpu.core.pipeline as jpl
import synapseml_tpu.resilience.faults as jfaults
import synapseml_tpu.resilience.rowguard as jrg
import synapseml_tpu_torch.core.dataset as tds
import synapseml_tpu_torch.core.params as tparams
import synapseml_tpu_torch.core.pipeline as tpl
import synapseml_tpu_torch.resilience.faults as tfaults
import synapseml_tpu_torch.resilience.rowguard as trg
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.guard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _udf_stage(pl, params, screen_nan=True):
    """An inputCol → outputCol stage applying ``udf`` to the input column
    as one vector, built on package ``pl``'s Transformer."""

    class _Udf(pl.Transformer):
        inputCol = params.StringParam(doc="input column", default="x")
        outputCol = params.StringParam(doc="output column", default="y")
        udf = params.PyObjectParam(doc="vectorized function")
        _guard_screen_nan = screen_nan

        def _transform(self, ds):
            return ds.with_column(self.outputCol,
                                  self.get("udf")(ds[self.inputCol]))

    return _Udf


class Pkg:
    """One package's handles: Dataset, pipeline, row guard, faults and
    the test stages built on its own Transformer."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.ds, self.pl, self.rg, self.faults = jds, jpl, jrg, jfaults
            params = jparams
        else:
            self.ds, self.pl, self.rg, self.faults = tds, tpl, trg, tfaults
            params = tparams
        self.Dataset = self.ds.Dataset
        self.Udf = _udf_stage(self.pl, params)
        self.NanUdf = _udf_stage(self.pl, params, screen_nan=False)

    def nan_intolerant(self, inputCol="x", outputCol="y", **kw):
        def udf(x):
            if not np.isfinite(np.asarray(x, dtype=np.float64)).all():
                raise ValueError("non-finite value in batch")
            return np.asarray(x, dtype=np.float64) * 2.0
        return self.Udf(inputCol=inputCol, outputCol=outputCol, udf=udf,
                        **kw)

    def value_poisoned(self, poison, inputCol="x", outputCol="y", **kw):
        def udf(x):
            if (np.asarray(x) == poison).any():
                raise ValueError(f"poison value {poison}")
            return np.asarray(x, dtype=np.float64) + 1.0
        return self.Udf(inputCol=inputCol, outputCol=outputCol, udf=udf,
                        **kw)

    def raising(self, exc_fn, **kw):
        return self.Udf(udf=lambda v: (_ for _ in ()).throw(exc_fn()), **kw)


PKGS = {n: Pkg(n) for n in ("jax", "torch")}


@pytest.fixture
def faults():
    """Both packages' fault registries, cleared, seeded and recording
    every guarded call."""
    regs = {n: p.faults.get_faults() for n, p in PKGS.items()}
    for r in regs.values():
        r.clear()
        r.seed(20260803)
        r.no_sleep = True
        r.record_calls = True
    yield regs
    for r in regs.values():
        r.clear()


def _records(recs):
    return sorted((r.row_index, r.error_class, r.verb, r.error_message)
                  for r in recs)


def _survivors(out, *cols):
    return ([np.asarray(out[c]).tolist() for c in cols],
            np.asarray(out.source_index).tolist())


def _poisoned(P, n=12, bad=(3, 7)):
    x = np.arange(float(n))
    for b in bad:
        x[b] = np.nan
    return P.Dataset({"x": x}), x


def _both(fn):
    """fn(P) for each package → {name: result}; the results must be
    equal, and the port's is returned."""
    got = {n: fn(p) for n, p in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# --------------------------------------------------------------------------
# handleInvalid semantics
# --------------------------------------------------------------------------


class TestHandleInvalidSemantics:
    def test_error_mode_raises_and_is_default(self):
        for P in PKGS.values():
            ds, _ = _poisoned(P)
            stage = P.nan_intolerant()
            assert stage.get_or_default("handleInvalid") == "error"
            with pytest.raises(ValueError, match="non-finite"):
                stage.transform(ds)

    def test_skip_drops_only_bad_rows(self):
        def run(P):
            ds, _ = _poisoned(P)
            return _survivors(P.nan_intolerant(
                handleInvalid="skip").transform(ds), "y")
        vals, src = _both(run)
        x = np.arange(12.0)
        keep = np.ones(12, bool)
        keep[[3, 7]] = False
        assert vals == [(x[keep] * 2.0).tolist()]
        assert src == np.flatnonzero(keep).tolist()

    def test_quarantine_stores_rows_with_provenance(self, tmp_path):
        def run(P):
            ds, _ = _poisoned(P)
            stage = P.nan_intolerant(handleInvalid="quarantine",
                                     quarantineDir=str(tmp_path / P.name))
            out = stage.transform(ds)
            store = P.rg.Quarantine(str(tmp_path / P.name))
            recs = store.records(stage.uid)
            assert all(r.stage_uid == stage.uid for r in recs)
            rows = store.rows(stage.uid)
            assert np.isnan(rows["x"]).all()
            return (out.num_rows, _records(recs),
                    sorted(rows.source_index.tolist()))
        n, recs, src = _both(run)
        assert n == 10 and src == [3, 7]
        assert [r[:3] for r in recs] == [(3, "StageContractError",
                                          "transform"),
                                         (7, "StageContractError",
                                          "transform")]

    def test_clean_path_identical_across_modes(self, tmp_path):
        def run(P):
            ds = P.Dataset({"x": np.arange(32.0)})
            outs = [P.nan_intolerant(
                handleInvalid=m, quarantineDir=str(tmp_path / P.name))
                .transform(ds)["y"].tolist()
                for m in ("error", "skip", "quarantine")]
            assert P.rg.Quarantine(str(tmp_path / P.name)).stage_uids() == []
            return outs
        outs = _both(run)
        assert outs[0] == outs[1] == outs[2]

    def test_missing_input_column_is_contract_error(self):
        for P in PKGS.values():
            with pytest.raises(P.rg.StageContractError,
                               match="requires input"):
                P.nan_intolerant(handleInvalid="skip").transform(
                    P.Dataset({"other": np.arange(4.0)}))

    def test_all_rows_poison_raises_rowguard_error(self, tmp_path):
        def run(P):
            stage = P.nan_intolerant(handleInvalid="quarantine",
                                     quarantineDir=str(tmp_path / P.name))
            with pytest.raises(P.rg.RowGuardError,
                               match="no rows survived") as ei:
                stage.transform(P.Dataset({"x": np.full(4, np.nan)}))
            assert ei.value.all_rows_invalid
            rows = P.rg.Quarantine(str(tmp_path / P.name)).rows(stage.uid)
            return _records(ei.value.records), rows.num_rows
        recs, n = _both(run)
        assert len(recs) == 4 and n == 4

    def test_pipeline_mode_propagates_to_stages(self):
        def run(P):
            ds, _ = _poisoned(P)
            model = P.pl.PipelineModel(
                stages=[P.nan_intolerant(),
                        P.value_poisoned(poison=8.0, inputCol="y",
                                         outputCol="z")],
                handleInvalid="skip")
            return _survivors(model.transform(ds), "z")
        vals, src = _both(run)
        x = np.arange(12.0)
        keep = np.isin(np.arange(12), (3, 7), invert=True) & (x != 4.0)
        assert src == np.flatnonzero(keep).tolist()
        assert vals == [(x[keep] * 2.0 + 1.0).tolist()]

    def test_explicit_stage_setting_beats_pipeline_mode(self):
        for P in PKGS.values():
            ds, _ = _poisoned(P)
            model = P.pl.PipelineModel(
                stages=[P.nan_intolerant(handleInvalid="error")],
                handleInvalid="skip")
            with pytest.raises(ValueError, match="non-finite"):
                model.transform(ds)

    def test_guard_context_nesting_inner_wins(self):
        def run(P):
            seen = []
            with P.rg.guard_context("skip"):
                with P.rg.guard_context("quarantine"):
                    seen.append(P.rg.effective_mode(P.nan_intolerant()))
                seen.append(P.rg.effective_mode(P.nan_intolerant()))
            seen.append(P.rg.effective_mode(P.nan_intolerant()))
            return seen
        assert _both(run) == ["quarantine", "skip", "error"]

    def test_nan_consumers_opt_out_of_screen(self):
        # a stage whose job is consuming NaN keeps its rows under a
        # pipeline-level skip: the screen stays off, bisection stays on
        def run(P):
            x = np.arange(8.0)
            x[2] = np.nan
            stage = P.NanUdf(udf=lambda v: np.nan_to_num(v, nan=-1.0))
            pipe = P.pl.Pipeline(stages=[stage], handleInvalid="skip")
            ds = P.Dataset({"x": x})
            return _survivors(pipe.fit(ds).transform(ds), "y")
        vals, src = _both(run)
        assert src == list(range(8)) and vals[0][2] == -1.0

    def test_fit_screens_the_label(self):
        # fit adds the declared labelCol to the screened columns
        def run(P):
            class Est(P.pl.Estimator):
                inputCol = (jparams if P.name == "jax" else tparams) \
                    .StringParam(doc="in", default="x")
                labelCol = (jparams if P.name == "jax" else tparams) \
                    .StringParam(doc="label", default="label")

                def _fit(self, ds):
                    seen.append(ds.source_index.tolist())
                    return P.Udf(udf=lambda v: v)
            seen = []
            y = np.arange(6.0)
            y[4] = np.inf
            Est(handleInvalid="skip").fit(P.Dataset({"x": np.arange(6.0),
                                                     "label": y}))
            return seen
        assert _both(run) == [[0, 1, 2, 3, 5]]


# --------------------------------------------------------------------------
# first-failure bisection
# --------------------------------------------------------------------------


def _calls(reg, stage):
    return [c for c in reg.calls_for("rowguard.call")
            if c["stage"] == stage.uid]


@pytest.mark.fault
class TestBisection:
    @pytest.mark.parametrize("n,poison", [(64, 13.0), (64, 0.0),
                                          (64, 63.0), (100, 37.0),
                                          (2, 1.0)])
    def test_single_poison_isolated_within_log2_bound(self, faults, n,
                                                      poison):
        def run(P):
            stage = P.value_poisoned(poison=poison, handleInvalid="skip")
            out = stage.transform(P.Dataset({"x": np.arange(float(n))}))
            return (_survivors(out, "y"),
                    len(_calls(faults[P.name], stage)))
        (vals, src), calls = _both(run)
        x = np.arange(float(n))
        assert vals == [(np.delete(x, int(poison)) + 1.0).tolist()]
        assert calls - 1 <= math.ceil(math.log2(n)) + 1, calls

    def test_injected_poison_row_site(self, faults):
        def run(P):
            faults[P.name].inject("rowguard.poison_row", "poison",
                                  when=lambda c: 5 in c["rows"])
            stage = P.Udf(udf=lambda x: x * 3.0, handleInvalid="skip")
            out = stage.transform(P.Dataset({"x": np.arange(16.0)}))
            return (_survivors(out, "y"),
                    len(_calls(faults[P.name], stage)))
        (_, src), calls = _both(run)
        assert 5 not in src and len(src) == 15
        assert calls - 1 <= math.ceil(math.log2(16)) + 1

    def test_multiple_poison_rows_all_isolated(self, faults, tmp_path):
        def run(P):
            stage = P.Udf(
                udf=lambda v: (_ for _ in ()).throw(ValueError("poison"))
                if np.isin(v, (5.0, 21.0)).any() else v * 2.0,
                handleInvalid="quarantine",
                quarantineDir=str(tmp_path / P.name))
            out = stage.transform(P.Dataset({"x": np.arange(32.0)}))
            recs = P.rg.Quarantine(str(tmp_path / P.name)).records(stage.uid)
            return (out.num_rows, _records(recs),
                    len(_calls(faults[P.name], stage)))
        n, recs, _ = _both(run)
        assert n == 30 and [r[0] for r in recs] == [5, 21]

    @pytest.mark.parametrize("kind", ["oom", "torch_oom", "preempt"])
    def test_non_row_errors_never_attributed(self, faults, tmp_path, kind):
        def run(P):
            exc = {"oom": lambda: P.faults.ResourceExhaustedError(
                       "RESOURCE_EXHAUSTED: oom"),
                   "torch_oom": lambda: torch.OutOfMemoryError(
                       "CUDA out of memory. Tried to allocate 2.00 GiB"),
                   "preempt": lambda: P.faults.PreemptionError("evicted")
                   }[kind]
            stage = P.raising(exc, handleInvalid="quarantine",
                              quarantineDir=str(tmp_path / P.name))
            with pytest.raises(Exception) as ei:
                stage.transform(P.Dataset({"x": np.arange(8.0)}))
            assert P.rg.Quarantine(str(tmp_path / P.name)).stage_uids() == []
            return type(ei.value).__name__, len(_calls(faults[P.name],
                                                       stage))
        name, calls = _both(run)
        assert calls == 1, calls
        assert name == {"oom": "ResourceExhaustedError",
                        "torch_oom": "OutOfMemoryError",
                        "preempt": "PreemptionError"}[kind]

    def test_batch_independent_failure_bounded(self, faults, tmp_path):
        n = 256

        def run(P):
            stage = P.raising(lambda: RuntimeError("broken"),
                              handleInvalid="quarantine",
                              quarantineDir=str(tmp_path / P.name))
            with pytest.raises(P.rg.RowGuardError,
                               match="batch-independently"):
                stage.transform(P.Dataset({"x": np.arange(float(n))}))
            recs = P.rg.Quarantine(str(tmp_path / P.name)).records(stage.uid)
            return len(_calls(faults[P.name], stage)), _records(recs)
        calls, recs = _both(run)
        assert calls <= 4 * math.ceil(math.log2(n)) + 16
        assert 0 < len(recs) < 10

    def test_isolation_budget_equal(self):
        for n in (1, 2, 3, 64, 65, 1 << 20):
            assert trg.isolation_budget(n) == jrg.isolation_budget(n)

    def test_probe_counter_counts_the_bisection(self):
        from synapseml_tpu.telemetry import get_registry as jreg
        from synapseml_tpu_torch.telemetry import get_registry as treg

        def run(P):
            reg = (jreg if P.name == "jax" else treg)()
            stage = P.value_poisoned(poison=41.0, handleInvalid="skip")
            stage.transform(P.Dataset({"x": np.arange(64.0)}))
            return reg.counter("rowguard_bisection_probes_total", "",
                               ("stage",)).value(stage=stage.uid)
        assert 0 < _both(run) <= 6


# --------------------------------------------------------------------------
# dead-letter quarantine store
# --------------------------------------------------------------------------


def _mixed(P):
    return P.Dataset({"f32": np.arange(3, dtype=np.float32) + 0.5,
                      "f64": np.arange(3, dtype=np.float64),
                      "txt": ["a", "b", "c"]},
                     row_index=np.asarray([10, 20, 30]))


class TestQuarantine:
    @pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                               ("torch", "jax"),
                                               ("jax", "torch")])
    def test_batches_read_across_packages(self, tmp_path, writer, reader):
        W, R = PKGS[writer], PKGS[reader]
        ds = _mixed(W)
        recs = [W.rg.ErrorRecord("u1", "T", i, "ValueError", f"bad {i}")
                for i in (10, 20, 30)]
        path = W.rg.Quarantine(str(tmp_path)).add("u1", ds, recs,
                                                  stage_class="T")
        assert sorted(os.listdir(path)) == ["errors.json", "rows.pkl",
                                            "rows.smlc"]
        store = R.rg.Quarantine(str(tmp_path))
        back = store.rows("u1")
        assert back.columns == ["f32", "f64", "txt"]
        for c in ("f32", "f64"):
            assert back[c].dtype == ds[c].dtype
            np.testing.assert_array_equal(back[c], ds[c])
        assert list(back["txt"]) == ["a", "b", "c"]
        np.testing.assert_array_equal(back.source_index, [10, 20, 30])
        assert _records(store.records("u1")) == _records(recs)

    def test_colstore_bytes_equal(self, tmp_path):
        paths = {}
        for n, P in PKGS.items():
            rec = [P.rg.ErrorRecord("u1", "T", 10, "E", "m")]
            paths[n] = P.rg.Quarantine(str(tmp_path / n)).add(
                "u1", _mixed(P), rec)
        blobs = [open(os.path.join(p, "rows.smlc"), "rb").read()
                 for p in paths.values()]
        assert blobs[0] == blobs[1]

    @pytest.mark.fault
    def test_sigkill_mid_write_leaves_no_partial_batch(self, tmp_path):
        qdir = str(tmp_path / "q")
        code = (
            "import numpy as np\n"
            "from synapseml_tpu_torch.core.dataset import Dataset\n"
            "from synapseml_tpu_torch.resilience.rowguard import (\n"
            "    Quarantine, ErrorRecord)\n"
            f"store = Quarantine({qdir!r})\n"
            "ds = Dataset({'x': np.arange(3.0)}).with_source_index()\n"
            "store.add('u1', ds, [ErrorRecord('u1', 'T', 0, 'E', 'm')])\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=ROOT, SML_FAULTS="quarantine.write=kill:times=1")
        p = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, timeout=120)
        assert p.returncode == -signal.SIGKILL, p.stderr.decode()
        for P in PKGS.values():
            store = P.rg.Quarantine(qdir)
            assert store.batches("u1") == [] and store.records("u1") == []
        env.pop("SML_FAULTS")
        p = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, timeout=120)
        assert p.returncode == 0, p.stderr.decode()
        for P in PKGS.values():
            store = P.rg.Quarantine(qdir)
            assert len(store.batches("u1")) == 1
            assert store.rows("u1").num_rows == 3

    def test_replay_round_trips_and_clears(self, tmp_path):
        def run(P):
            ds, _ = _poisoned(P, n=10, bad=(2, 6))
            broken = P.nan_intolerant(handleInvalid="quarantine",
                                      quarantineDir=str(tmp_path / P.name))
            broken.transform(ds)
            store = P.rg.Quarantine(str(tmp_path / P.name))
            assert store.rows(broken.uid).num_rows == 2
            fixed = P.Udf(udf=lambda v: np.nan_to_num(
                np.asarray(v, np.float64)) * 2.0)
            out = store.replay(fixed, stage_uid=broken.uid)
            assert store.rows(broken.uid) is None
            assert store.replay(fixed, stage_uid=broken.uid) is None
            return _survivors(out, "y")
        vals, src = _both(run)
        assert sorted(src) == [2, 6] and vals == [[0.0, 0.0]]


# --------------------------------------------------------------------------
# OOM-adaptive batching
# --------------------------------------------------------------------------


@pytest.mark.fault
class TestOOMAdaptive:
    def test_converges_under_injected_oom(self, faults):
        def run(P):
            faults[P.name].inject("oom", "oom", when=lambda c: c["batch"] > 4)
            seen = []

            def work(bs):
                for start in range(0, 32, bs):
                    P.rg.oom_fault_point("test:conv", min(bs, 32 - start))
                seen.append(bs)
                return bs
            try:
                final = P.rg.run_adaptive("test:conv", 32, work)
                return final, seen, P.rg.safe_batch_size("test:conv", 32)
            finally:
                P.rg.reset_safe_batch("test:conv")
        assert _both(run) == (4, [4], 4)

    def test_oom_at_batch_one_reraises(self, faults):
        for n, P in PKGS.items():
            faults[n].inject("oom", "oom")
            with pytest.raises(P.faults.ResourceExhaustedError):
                P.rg.run_adaptive("test:dead", 8, lambda bs: (
                    P.rg.oom_fault_point("test:dead", bs), bs)[1])
            P.rg.reset_safe_batch("test:dead")

    def test_non_oom_errors_propagate(self):
        for P in PKGS.values():
            with pytest.raises(KeyError):
                P.rg.run_adaptive("test:other", 8, lambda bs: {}[bs])

    def test_real_torch_oom_halves(self):
        # a real torch.OutOfMemoryError (raised the way the CUDA
        # allocator raises it) is an OOM to the port's batchers
        seen = []

        def work(bs):
            seen.append(bs)
            if bs > 8:
                raise torch.OutOfMemoryError(
                    f"CUDA out of memory. Tried to allocate {bs} GiB")
            return bs
        try:
            assert trg.run_adaptive("test:torch", 64, work) == 8
            assert seen == [64, 32, 16, 8]
            assert trg.safe_batch_size("test:torch", 64) == 8
        finally:
            trg.reset_safe_batch("test:torch")

    def test_small_request_does_not_shrink_remembered_ceiling(self):
        def run(P):
            try:
                P.rg.record_safe_batch("test:ceiling", 512)
                out = P.rg.run_adaptive("test:ceiling", 4, lambda bs: bs)
                return out, P.rg.safe_batch_size("test:ceiling", 10_000)
            finally:
                P.rg.reset_safe_batch("test:ceiling")
        assert _both(run) == (4, 512)

    def test_onnx_runner_halves_the_batch(self, faults):
        from synapseml_tpu.models.onnx import compile_onnx as jcompile
        from synapseml_tpu.models.onnx.graph import GraphBuilder as JB
        from synapseml_tpu_torch.models.onnx import compile_onnx as tcompile
        from synapseml_tpu_torch.models.onnx.graph import GraphBuilder as TB
        x = np.linspace(-1, 1, 24, dtype=np.float32).reshape(8, 3)
        outs = {}
        for n, B, compile_onnx, kw in (("jax", JB, jcompile, {}),
                                       ("torch", TB, tcompile,
                                        {"device": "cpu"})):
            b = B("g")
            b.output(b.node("Relu", [b.input("x", (None, 3))]))
            fn = compile_onnx(b.build(), **kw)
            faults[n].inject("oom", "oom", when=lambda c: str(
                c["key"]).startswith("onnx:") and c["batch"] > 2)
            try:
                outs[n] = np.asarray(fn(x=x)[fn.output_names[0]])
            finally:
                PKGS[n].rg.reset_safe_batch()
        np.testing.assert_array_equal(outs["torch"], np.maximum(x, 0.0))
        np.testing.assert_array_equal(outs["torch"], outs["jax"])

    def test_is_oom_error_detection(self):
        cases = [RuntimeError("RESOURCE_EXHAUSTED: out of memory "
                              "allocating 2.5G"), MemoryError(),
                 ValueError("bad row"), KeyError("x"),
                 RuntimeError("CUDA out of memory. Tried to allocate")]
        for e in cases:
            assert trg.is_oom_error(e) == jrg.is_oom_error(e)
        assert trg.is_oom_error(torch.OutOfMemoryError("CUDA out of memory"))
        assert trg.is_oom_error(tfaults.ResourceExhaustedError(
            "RESOURCE_EXHAUSTED: x"))
        assert not trg.is_oom_error(ValueError("bad row"))


# --------------------------------------------------------------------------
# ingest hardening (Dataset.from_csv / from_rows)
# --------------------------------------------------------------------------


class TestIngestHardening:
    CSV = ("a,b\n"
           "1,2\n"
           "3,4,5\n"          # ragged
           "oops,6\n"         # unparseable
           "7,8\n")

    def test_permissive_skips_ragged_and_unparseable(self, tmp_path):
        p = tmp_path / "dirty.csv"
        p.write_text(self.CSV)

        def run(P):
            ds = P.Dataset.from_csv(str(p), handle_invalid="skip")
            return _survivors(ds, "a", "b")
        vals, src = _both(run)
        assert vals == [[1.0, 7.0], [2.0, 8.0]] and src == [0, 3]

    def test_permissive_quarantines_with_line_numbers(self, tmp_path):
        p = tmp_path / "dirty.csv"
        p.write_text(self.CSV)

        def run(P):
            store = P.rg.Quarantine(str(tmp_path / P.name))
            ds = P.Dataset.from_csv(str(p), handle_invalid="quarantine",
                                    quarantine=store)
            raw = store.rows("Dataset.from_csv")
            return (ds.num_rows, _records(store.records("Dataset.from_csv")),
                    list(raw["raw"]), raw.source_index.tolist())
        n, recs, raw, src = _both(run)
        assert n == 2 and raw == ["3,4,5", "oops,6"] and src == [1, 2]
        msgs = " | ".join(r[3] for r in recs)
        assert "line 3" in msgs and "line 4" in msgs

    def test_from_rows_non_dict_first_row(self):
        def run(P):
            rows = [["not", "a", "dict"], {"x": 1.0}, {"x": 2.0}]
            return _survivors(P.Dataset.from_rows(rows,
                                                  handle_invalid="skip"),
                              "x")
        assert _both(run) == ([[1.0, 2.0]], [1, 2])

    def test_from_rows_permissive(self, tmp_path):
        rows = [{"x": 1, "y": 2}, {"x": 3}, {"x": 4, "y": 5, "z": 6},
                {"x": 7, "y": 8}]

        def run(P):
            with pytest.raises(KeyError):
                P.Dataset.from_rows(rows)
            ds = P.Dataset.from_rows(rows, handle_invalid="skip")
            store = P.rg.Quarantine(str(tmp_path / P.name))
            P.Dataset.from_rows(rows, handle_invalid="quarantine",
                                quarantine=store)
            return (_survivors(ds, "x", "y"),
                    _records(store.records("Dataset.from_rows")))
        (vals, src), recs = _both(run)
        assert vals == [[1, 4, 7], [2, 5, 8]] and src == [0, 2, 3]
        assert [r[:3] for r in recs] == [(1, "ParseError", "ingest")]

    def test_bad_mode_refused(self):
        for P in PKGS.values():
            with pytest.raises(ValueError, match="handle_invalid"):
                P.Dataset.from_rows([{"x": 1}, 3], handle_invalid="drop")


# --------------------------------------------------------------------------
# every stage of the port carries the contract
# --------------------------------------------------------------------------


def test_every_port_stage_carries_handle_invalid():
    """Importing every stage module of the port registers its stages;
    each carries ``handleInvalid`` and ``quarantineDir``, and no stage
    refuses a mode: ``fit``/``transform`` are the base class's."""
    import importlib
    for m in ("models.gbdt.estimators", "models.dl.estimators",
              "models.onnx.model", "models.online.estimators",
              "models.online.generic", "models.online.bandit",
              "models.online.featurizer", "models.llm.stage", "image.stages",
              "explainers", "nn", "isolationforest", "recommendation",
              "cyber"):
        importlib.import_module(f"synapseml_tpu_torch.{m}")
    stages = [c for n, c in tpl._STAGE_REGISTRY.items()
              if n.startswith("synapseml_tpu_torch.")]
    assert len(stages) > 40
    for cls in stages:
        po = cls.param_objs()
        assert "handleInvalid" in po and "quarantineDir" in po, cls
        assert po["handleInvalid"].default == "error"
        if issubclass(cls, tpl.Transformer):
            assert cls.transform is tpl.Transformer.transform, cls
        if issubclass(cls, tpl.Estimator):
            assert cls.fit is tpl.Estimator.fit, cls


def test_guard_declarations_match_the_reference():
    """The port's stages declare the same guarded columns as their
    counterparts (the DL estimators add textCol/imageCol)."""
    from synapseml_tpu.models.dl import estimators as jdl
    from synapseml_tpu_torch.models.dl import estimators as tdl
    for name in ("DeepTextClassifier", "DeepVisionClassifier"):
        j, t = getattr(jdl, name), getattr(tdl, name)
        for attr in ("_guard_input_params", "_guard_fit_params",
                     "_guard_screen_nan", "_guard_exempt"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)
    for attr in ("_guard_input_params", "_guard_fit_params",
                 "_guard_screen_nan", "_guard_exempt"):
        assert getattr(tpl.PipelineStage, attr) == \
            getattr(jpl.PipelineStage, attr)
        assert getattr(tpl.Pipeline, attr) == getattr(jpl.Pipeline, attr)
