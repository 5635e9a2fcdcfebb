"""The port's AutoML stages (``automl/space.py``, ``automl/tune.py``)
under the contracts ``tests/test_automl.py`` holds the JAX package's to,
every GBDT on ``device="cpu"``.  The tuner against the JAX package's and
at parallelism 1 against 4 is in ``test_torch_automl_parity.py``."""

import numpy as np
import pytest

from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.automl import (DiscreteHyperParam, FindBestModel,
                                  GridSpace, HyperparamBuilder, RandomSpace,
                                  RangeHyperParam, TuneHyperparameters)
from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _cls_data(rng, n=400, d=6):
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    feats = np.empty(n, dtype=object)
    for i in range(n):
        feats[i] = x[i]
    return Dataset({"features": feats, "label": y})


class TestSpaces:
    def test_discrete_grid(self):
        assert DiscreteHyperParam([1, 2, 3]).grid_values() == [1, 2, 3]

    def test_range_int_grid(self):
        vals = RangeHyperParam(2, 10, n_grid=5).grid_values()
        assert all(isinstance(v, int) for v in vals)
        assert vals[0] == 2 and vals[-1] == 10

    def test_range_log_sample(self):
        rng = np.random.default_rng(0)
        r = RangeHyperParam(1e-4, 1.0, log=True)
        draws = [r.sample(rng) for _ in range(200)]
        assert min(draws) >= 1e-4 and max(draws) <= 1.0
        # log-uniform: about half the draws below geometric mid 1e-2
        below = sum(d < 1e-2 for d in draws)
        assert 60 < below < 140

    def test_grid_space_product(self):
        est = GBDTClassifier(device="cpu")
        b = (HyperparamBuilder()
             .add_hyperparam(est, "numIterations", DiscreteHyperParam([4, 8]))
             .add_hyperparam(est, "maxDepth", DiscreteHyperParam([2, 3])))
        maps = list(GridSpace(b.build()).param_maps())
        assert len(maps) == 4

    def test_unknown_param_rejected(self):
        with pytest.raises(AttributeError):
            HyperparamBuilder().add_hyperparam(GBDTClassifier(device="cpu"), "nope",
                                               DiscreteHyperParam([1]))


class TestTuneHyperparameters:
    def test_random_search_improves(self, rng):
        ds = _cls_data(rng)
        est = GBDTClassifier(device="cpu", numIterations=8)
        b = (HyperparamBuilder()
             .add_hyperparam(est, "maxDepth", DiscreteHyperParam([1, 3]))
             .add_hyperparam(est, "learningRate",
                             RangeHyperParam(0.05, 0.3)))
        tuner = TuneHyperparameters(
            models=[est], paramSpace=RandomSpace(b.build(), seed=1),
            numRuns=4, parallelism=2, evaluationMetric="accuracy")
        model = tuner.fit(ds)
        assert model.get("bestMetric") >= max(
            m for m in model.get("allMetrics")) - 1e-9
        assert model.get("bestMetric") > 0.8
        out = model.transform(ds.take(10))
        assert "prediction" in out
        assert set(model.get("bestParams")) == {"maxDepth", "learningRate"}

    def test_grid_search_all_trials(self, rng):
        ds = _cls_data(rng, n=200)
        est = GBDTClassifier(device="cpu", numIterations=4)
        b = HyperparamBuilder().add_hyperparam(
            est, "maxDepth", DiscreteHyperParam([2, 4]))
        tuner = TuneHyperparameters(models=[est],
                                    paramSpace=GridSpace(b.build()),
                                    parallelism=1)
        model = tuner.fit(ds)
        assert len(model.get("allMetrics")) == 2

    def test_unreferenced_model_gets_default_trial(self, rng):
        ds = _cls_data(rng, n=200)
        est_a = GBDTClassifier(device="cpu", numIterations=4)
        est_b = GBDTClassifier(device="cpu", numIterations=2, maxDepth=2)
        b = HyperparamBuilder().add_hyperparam(
            est_a, "maxDepth", DiscreteHyperParam([2, 4]))
        tuner = TuneHyperparameters(models=[est_a, est_b],
                                    paramSpace=GridSpace(b.build()),
                                    parallelism=1)
        model = tuner.fit(ds)
        # 2 grid trials for est_a + 1 defaults trial for est_b
        assert len(model.get("allMetrics")) == 3


class TestFindBestModel:
    def test_picks_better_model(self, rng):
        ds = _cls_data(rng)
        train, test = ds.random_split([0.7, 0.3], seed=0)
        weak = GBDTClassifier(device="cpu", numIterations=1, maxDepth=1).fit(train)
        strong = GBDTClassifier(device="cpu", numIterations=16, maxDepth=4).fit(train)
        fbm = FindBestModel(models=[weak, strong],
                            evaluationMetric="accuracy")
        best = fbm.fit(test)
        metrics = best.get("allModelMetrics")
        assert best.get("bestModelMetrics") == max(metrics)
        assert best.get("bestModel") is strong or metrics[1] <= metrics[0]
