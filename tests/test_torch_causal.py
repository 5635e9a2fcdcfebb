"""The port's double-ML stages (``causal/dml.py``) under the contracts
``tests/test_causal.py`` holds the JAX package's to: a known ATE
recovered, heterogeneous effects ordered, the fuzzing suites, with every
model on ``device="cpu"`` (the orthogonal forest's default forest runs on
the card, so these tests pass the same forest on the CPU)."""

import numpy as np
import pytest

from torch_fuzzing import EstimatorFuzzing, TestObject
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.causal import (DoubleMLEstimator, OrthoForestDMLEstimator,
                                  ResidualTransformer)
from synapseml_tpu_torch.models.gbdt.estimators import GBDTRegressor
from synapseml_tpu_torch.models.online import OnlineSGDRegressor
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _vec(mat):
    col = np.empty(len(mat), dtype=object)
    for i, row in enumerate(mat):
        col[i] = np.asarray(row, np.float32)
    return col


def _causal_data(rng, n=800, effect=2.0, heterogeneous=False):
    x = rng.normal(size=(n, 4)).astype(np.float32)
    # confounded continuous treatment
    t = 0.8 * x[:, 0] + rng.normal(0, 1, n)
    tau = effect * (1 + (x[:, 1] > 0)) if heterogeneous else effect
    y = tau * t + 1.5 * x[:, 0] - x[:, 2] + rng.normal(0, 0.3, n)
    return Dataset({"features": _vec(x),
                    "treatment": t.astype(np.float32),
                    "outcome": y.astype(np.float32)})


def _nuisance():
    return GBDTRegressor(device="cpu", numIterations=24, maxDepth=3, learningRate=0.2)


def _forest():
    """The estimator's default heterogeneity forest, on the CPU."""
    return GBDTRegressor(boostingType="rf", numIterations=32, maxDepth=4,
                         device="cpu")


class TestResidualTransformer:
    def test_numeric_residual(self):
        ds = Dataset({"label": np.array([1.0, 2.0, 3.0]),
                      "prediction": np.array([0.5, 2.0, 2.0])})
        out = ResidualTransformer().transform(ds)
        np.testing.assert_allclose(out["residual"], [0.5, 0.0, 1.0])

    def test_probability_vector_residual(self):
        probs = np.empty(2, dtype=object)
        probs[0] = np.array([0.3, 0.7])
        probs[1] = np.array([0.9, 0.1])
        ds = Dataset({"label": np.array([1.0, 0.0]), "prediction": probs})
        out = ResidualTransformer(classIndex=1).transform(ds)
        np.testing.assert_allclose(out["residual"], [0.3, -0.1], atol=1e-6)


class TestDoubleML:
    def test_recovers_known_ate(self, rng):
        ds = _causal_data(rng, effect=2.0)
        dml = DoubleMLEstimator(
            treatmentModel=_nuisance(), outcomeModel=_nuisance(),
            treatmentCol="treatment", outcomeCol="outcome", maxIter=3,
            seed=1)
        model = dml.fit(ds)
        ate = model.get_avg_treatment_effect()
        assert abs(ate - 2.0) < 0.35
        lo, hi = model.get_confidence_interval()
        assert lo <= ate <= hi
        assert model.get_pvalue() < 0.2
        out = model.transform(ds.take(5))
        np.testing.assert_allclose(out["treatmentEffect"], ate)

    def test_null_effect_not_significant(self, rng):
        ds = _causal_data(rng, effect=0.0)
        dml = DoubleMLEstimator(
            treatmentModel=_nuisance(), outcomeModel=_nuisance(),
            treatmentCol="treatment", outcomeCol="outcome", maxIter=4,
            seed=2)
        model = dml.fit(ds)
        assert abs(model.get_avg_treatment_effect()) < 0.3

    def test_requires_models(self):
        with pytest.raises(ValueError):
            DoubleMLEstimator().fit(Dataset({"treatment": [1.0],
                                             "outcome": [1.0]}))


class TestOrthoForest:
    def test_heterogeneous_effects_ordered(self, rng):
        ds = _causal_data(rng, n=1200, effect=1.5, heterogeneous=True)
        est = OrthoForestDMLEstimator(
            heterogeneityModel=_forest(),
            treatmentModel=_nuisance(), outcomeModel=_nuisance(),
            treatmentCol="treatment", outcomeCol="outcome", seed=3)
        model = est.fit(ds)
        out = model.transform(ds)
        eff = out["treatmentEffect"]
        x1 = np.stack([np.asarray(v) for v in ds["features"]])[:, 1]
        # group with x1>0 has true effect 3.0 vs 1.5 below
        assert eff[x1 > 0].mean() > eff[x1 <= 0].mean() + 0.3


class TestDoubleMLFuzzing(EstimatorFuzzing):
    def fuzzing_objects(self):
        rng = np.random.default_rng(4)
        ds = _causal_data(rng, n=150)
        est = DoubleMLEstimator(
            treatmentModel=OnlineSGDRegressor(numPasses=2, device="cpu"),
            outcomeModel=OnlineSGDRegressor(numPasses=2, device="cpu"),
            treatmentCol="treatment", outcomeCol="outcome", maxIter=1)
        return [TestObject(est, ds)]


class TestOrthoForestRecovery:
    def test_recovers_group_effect_magnitudes(self, rng):
        """Quantitative CATE recovery: per-group mean predicted effect
        within tolerance of the true group effects (reference behavior:
        OrthoForestDMLEstimator.scala heterogeneous-effect output)."""
        ds = _causal_data(rng, n=2400, effect=1.5, heterogeneous=True)
        est = OrthoForestDMLEstimator(
            heterogeneityModel=_forest(),
            treatmentModel=_nuisance(), outcomeModel=_nuisance(),
            treatmentCol="treatment", outcomeCol="outcome", seed=5)
        eff = est.fit(ds).transform(ds)["treatmentEffect"]
        x1 = np.stack([np.asarray(v) for v in ds["features"]])[:, 1]
        hi, lo = eff[x1 > 0].mean(), eff[x1 <= 0].mean()
        assert abs(hi - 3.0) < 1.0, hi          # true effect 3.0 for x1>0
        assert abs(lo - 1.5) < 1.0, lo          # true effect 1.5 otherwise


class TestOrthoForestFuzzing(EstimatorFuzzing):
    def fuzzing_objects(self):
        rng = np.random.default_rng(6)
        ds = _causal_data(rng, n=150)
        est = OrthoForestDMLEstimator(
            heterogeneityModel=_forest(),
            treatmentModel=OnlineSGDRegressor(numPasses=2, device="cpu"),
            outcomeModel=OnlineSGDRegressor(numPasses=2, device="cpu"),
            treatmentCol="treatment", outcomeCol="outcome", seed=1)
        return [TestObject(est, ds)]


class TestDefaultForestDevice:
    def test_default_forest_needs_a_card(self, rng):
        """The default heterogeneity forest is the port's GBDTRegressor on
        its default device, the card: without one the fit raises and
        never falls back to the CPU."""
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        ds = _causal_data(rng, n=150)
        est = OrthoForestDMLEstimator(
            treatmentModel=_nuisance(), outcomeModel=_nuisance(),
            treatmentCol="treatment", outcomeCol="outcome", seed=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est.fit(ds)
