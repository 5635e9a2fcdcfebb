"""Generic fuzzing harness for the PyTorch port's pipeline stages: a copy
of ``tests/fuzzing.py`` (which holds the JAX package's stages) over the
port's Dataset, stages and ``load_stage``.

Python re-design of the reference's signature test pattern
(core/src/test/.../core/test/fuzzing/Fuzzing.scala:619-796): every stage's
test suite subclasses :class:`TransformerFuzzing` or :class:`EstimatorFuzzing`
and implements ``fuzzing_objects()``; the harness then auto-derives

- **experiment fuzzing** — fit/transform round trips (Fuzzing.scala:619-649)
- **serialization fuzzing** — save/load + transform equality
  (Fuzzing.scala:651-739)
- **getter/setter fuzzing** — param set/get consistency (Fuzzing.scala:741-796)
- **invalid-input fuzzing** — every suite's first scenario re-runs on
  one-row-poisoned datasets (NaN / Inf / None / wrong-dtype): the stage
  must either raise a clean typed error or complete (and under
  ``handleInvalid='skip'`` complete with the poison row gone) — never
  crash, hang, or silently emit fewer/garbled rows
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass, field
from typing import Generic, List, Optional, TypeVar

import numpy as np

from synapseml_tpu_torch.core import (Dataset, Estimator, PipelineStage,
                                      Transformer)
from synapseml_tpu_torch.core.pipeline import load_stage

S = TypeVar("S", bound=PipelineStage)


@dataclass
class TestObject(Generic[S]):
    """One fuzzing scenario (reference: Fuzzing.scala TestObject)."""
    __test__ = False  # not itself a pytest collectible
    stage: S
    fit_ds: Dataset
    transform_ds: Optional[Dataset] = None

    @property
    def tds(self) -> Dataset:
        return self.transform_ds if self.transform_ds is not None else self.fit_ds


def assert_datasets_close(a: Dataset, b: Dataset, rtol=1e-4, atol=1e-5):
    assert set(a.columns) == set(b.columns), (a.columns, b.columns)
    assert a.num_rows == b.num_rows
    for c in a.columns:
        ca, cb = a[c], b[c]
        if ca.dtype == object or cb.dtype == object:
            for va, vb in zip(ca, cb):
                if np.asarray(va).dtype.kind == "f":
                    np.testing.assert_allclose(np.asarray(va, dtype=np.float64),
                                               np.asarray(vb, dtype=np.float64),
                                               rtol=rtol, atol=atol)
                else:
                    assert str(va) == str(vb), (c, va, vb)
        elif ca.dtype.kind == "f":
            np.testing.assert_allclose(ca, cb, rtol=rtol, atol=atol, err_msg=c)
        else:
            np.testing.assert_array_equal(ca, cb, err_msg=c)


def poison_variants(ds: Dataset):
    """One-row-poisoned copies of ``ds``: (poisoned_ds, description).

    - ``nan`` / ``inf``: row 0 of every float column
    - ``none``: row 0 of the first column becomes None (object dtype)
    - ``wrong-dtype``: row 0 of the first float column becomes a string
    """
    float_cols = [c for c in ds.columns if ds[c].dtype.kind == "f"]
    for kind, val in (("nan", np.nan), ("inf", np.inf)):
        if float_cols:
            bad = {c: np.where(np.arange(ds.num_rows) == 0, val, ds[c])
                   for c in float_cols}
            yield ds.with_columns(bad), f"{kind} in {float_cols}"
    first = ds.columns[0]
    col = np.empty(ds.num_rows, dtype=object)
    col[:] = list(ds[first])
    col[0] = None
    yield ds.with_column(first, col), f"None in {first!r}"
    if float_cols:
        col = np.empty(ds.num_rows, dtype=object)
        col[:] = list(ds[float_cols[0]])
        col[0] = "not-a-number"
        yield ds.with_column(float_cols[0], col), \
            f"wrong dtype in {float_cols[0]!r}"


class _FuzzingBase:
    """Shared getter/setter fuzzing."""

    #: suites whose stage is too slow (or too stochastic) for the full
    #: poison sweep can trim the kinds here
    invalid_input_kinds = ("nan", "inf", "None", "wrong dtype")

    def fuzzing_objects(self) -> List[TestObject]:
        raise NotImplementedError

    @staticmethod
    def _poison_base(obj: TestObject) -> Dataset:
        """Estimators get poisoned at FIT (their ingest boundary);
        transformers at transform."""
        return obj.fit_ds if isinstance(obj.stage, Estimator) else obj.tds

    @staticmethod
    def _run_stage(stage, obj: TestObject, ds: Dataset) -> Dataset:
        if isinstance(stage, Estimator):
            return stage.fit(ds).transform(obj.tds)
        return stage.transform(ds)

    def _invoke_poisoned(self, stage, obj: TestObject, pds: Dataset,
                         desc: str):
        """Run one poisoned scenario; returns the output Dataset or None
        when the stage (cleanly) raised."""
        from synapseml_tpu_torch.resilience.rowguard import RowGuardError
        try:
            return self._run_stage(stage, obj, pds)
        except (RowGuardError, ValueError, TypeError, KeyError,
                ArithmeticError, OSError, RuntimeError, IndexError) as e:
            # a clean typed error IS an acceptable answer to poison —
            # but it must carry a message an operator can act on
            assert str(e), f"{desc}: empty error message from {type(e)}"
            return None

    # invalid-input axis (SynapseML Fuzzing discipline extended: poison
    # one row and the stage must degrade cleanly, never crash/hang)
    def test_invalid_input_fuzzing(self):
        objs = self.fuzzing_objects()
        if not objs:
            return
        obj = objs[0]
        base = self._poison_base(obj)
        ref = self._run_stage(obj.stage.copy(), obj, base)
        for pds, desc in poison_variants(base):
            if not any(k in desc for k in self.invalid_input_kinds):
                continue
            out = self._invoke_poisoned(obj.stage.copy(), obj, pds, desc)
            if out is not None:
                assert isinstance(out, Dataset), desc
                if ref.num_rows == base.num_rows:
                    # a row-preserving stage must not silently drop rows
                    # in default ('error') mode
                    assert out.num_rows == ref.num_rows, \
                        f"{desc}: silent row loss in default mode"

    def test_invalid_input_skip_mode(self):
        """Under handleInvalid='skip' the poison row may leave, but the
        stage must still complete or raise cleanly — and never emit MORE
        rows than the clean run."""
        objs = self.fuzzing_objects()
        if not objs:
            return
        obj = objs[0]
        base = self._poison_base(obj)
        for pds, desc in poison_variants(base):
            if "nan" not in desc:         # one kind: bounds suite runtime
                continue
            stage = obj.stage.copy()
            stage.set("handleInvalid", "skip")
            out = self._invoke_poisoned(stage, obj, pds, desc)
            if out is not None:
                assert isinstance(out, Dataset), desc

    # reference: GetterSetterFuzzing (Fuzzing.scala:741-796)
    def test_getter_setter_fuzzing(self):
        for obj in self.fuzzing_objects():
            stage = obj.stage
            for p in stage.params:
                if stage.is_set(p.name):
                    val = stage.get(p.name)
                    stage.set(p.name, val)
                    got = stage.get(p.name)
                    if isinstance(val, np.ndarray):
                        np.testing.assert_array_equal(val, got)
                    else:
                        assert got == val or got is val, p.name
                elif p.default is not None:
                    assert stage.get_or_default(p.name) is not None

    def test_copy_independent(self):
        for obj in self.fuzzing_objects():
            clone = obj.stage.copy()
            assert clone.uid == obj.stage.uid
            assert clone._paramMap == obj.stage._paramMap
            # mutating the clone must not leak into the original
            simple = [p for p in clone.params
                      if clone.is_set(p.name) and isinstance(clone.get(p.name), bool)]
            for p in simple[:1]:
                clone.set(p.name, not clone.get(p.name))
                assert obj.stage.get(p.name) != clone.get(p.name)


class TransformerFuzzing(_FuzzingBase):
    """reference: Fuzzing.scala:818 TransformerFuzzing."""

    #: loosened per-suite when a stage is stochastic-but-seeded
    rtol = 1e-4
    atol = 1e-5

    def test_experiment_fuzzing(self):
        for obj in self.fuzzing_objects():
            out = obj.stage.transform(obj.tds)
            assert out.num_rows >= 0
            assert len(out.columns) >= 1

    def test_serialization_fuzzing(self):
        for obj in self.fuzzing_objects():
            with tempfile.TemporaryDirectory() as tmp:
                obj.stage.save(tmp + "/stage")
                loaded = load_stage(tmp + "/stage")
                assert type(loaded) is type(obj.stage)
                a = obj.stage.transform(obj.tds)
                b = loaded.transform(obj.tds)
                assert_datasets_close(a, b, self.rtol, self.atol)


class EstimatorFuzzing(_FuzzingBase):
    """reference: Fuzzing.scala:826 EstimatorFuzzing."""

    rtol = 1e-4
    atol = 1e-5

    def test_experiment_fuzzing(self):
        for obj in self.fuzzing_objects():
            model = obj.stage.fit(obj.fit_ds)
            out = model.transform(obj.tds)
            assert out.num_rows == obj.tds.num_rows

    def test_serialization_fuzzing(self):
        for obj in self.fuzzing_objects():
            with tempfile.TemporaryDirectory() as tmp:
                # estimator round trip
                obj.stage.save(tmp + "/est")
                est2 = load_stage(tmp + "/est")
                assert type(est2) is type(obj.stage)
                # model round trip + transform equality
                model = obj.stage.fit(obj.fit_ds)
                model.save(tmp + "/model")
                model2 = load_stage(tmp + "/model")
                a = model.transform(obj.tds)
                b = model2.transform(obj.tds)
                assert_datasets_close(a, b, self.rtol, self.atol)
