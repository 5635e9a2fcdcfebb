"""The port's TuneHyperparameters / FindBestModel held against the JAX
package's, and the port's threaded search against its serial one.

The same grid through both packages with host (numpy ridge) candidates
gives equal ``allMetrics``, ``bestParams`` and ``bestMetric`` at
parallelism 1 and 4.  With the port's GBDT on the CPU, parallelism 4
equals parallelism 1 exactly (the trials' fits do not share state), and
against the JAX package's GBDT search the metrics agree to the whole-fit
tolerance of ``tests/test_torch_gbdt_slice.py`` (0.005: the JAX CPU fit
sums f32 gradients by scatter-add, the port the kernels' exact int8
limbs) with the same winner.
"""

import numpy as np
import pytest

from synapseml_tpu.automl import (DiscreteHyperParam as JDiscrete,
                                  FindBestModel as JFindBest,
                                  GridSpace as JGrid,
                                  HyperparamBuilder as JBuilder,
                                  RandomSpace as JRandom,
                                  RangeHyperParam as JRange,
                                  TuneHyperparameters as JTune)
from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.gbdt.estimators import GBDTClassifier as JClf
from synapseml_tpu_torch.automl import (DefaultHyperparams,
                                        DiscreteHyperParam, FindBestModel,
                                        GridSpace, HyperparamBuilder,
                                        RandomSpace, RangeHyperParam,
                                        TuneHyperparameters)
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
from torch_host_models import ridge_classes
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _cols(seed=0, n=400, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.normal(scale=.6, size=n) > 0
         ).astype(np.float32)
    feats = np.empty(n, dtype=object)
    for i in range(n):
        feats[i] = x[i]
    return {"features": feats, "label": y}


def _results(model):
    return (model.get("allMetrics"), model.get("bestParams"),
            model.get("bestMetric"))


@pytest.mark.parametrize("parallelism", [1, 4])
@pytest.mark.parametrize("metric", ["accuracy", "AUC", "precision"])
def test_grid_search_equals_jax_with_host_models(parallelism, metric):
    TR, TC = ridge_classes("torch")
    JR, JC = ridge_classes("jax")
    cols = _cols(1)
    t_est, j_est = TC(), JC()
    t_space = GridSpace(HyperparamBuilder().add_hyperparam(
        t_est, "alpha", DiscreteHyperParam([0.01, 10.0, 1e3, 1e5])).build())
    j_space = JGrid(JBuilder().add_hyperparam(
        j_est, "alpha", JDiscrete([0.01, 10.0, 1e3, 1e5])).build())
    kw = dict(parallelism=parallelism, evaluationMetric=metric, seed=3)
    t = TuneHyperparameters(models=[t_est], paramSpace=t_space, **kw).fit(
        Dataset(dict(cols)))
    j = JTune(models=[j_est], paramSpace=j_space, **kw).fit(
        JDataset(dict(cols)))
    assert _results(t) == _results(j)
    assert len(t.get("allMetrics")) == 4


def test_random_search_equals_jax_with_host_models():
    TR, TC = ridge_classes("torch")
    JR, JC = ridge_classes("jax")
    cols = _cols(2)
    t_est, j_est = TR(), JR()
    t_space = RandomSpace(HyperparamBuilder().add_hyperparam(
        t_est, "alpha", RangeHyperParam(1e-3, 1e4, log=True)).build(),
        seed=5)
    j_space = JRandom(JBuilder().add_hyperparam(
        j_est, "alpha", JRange(1e-3, 1e4, log=True)).build(), seed=5)
    kw = dict(parallelism=3, numRuns=6, evaluationMetric="rmse")
    t = TuneHyperparameters(models=[t_est], paramSpace=t_space, **kw).fit(
        Dataset(dict(cols)))
    j = JTune(models=[j_est], paramSpace=j_space, **kw).fit(
        JDataset(dict(cols)))
    assert _results(t) == _results(j)


def test_find_best_model_equals_jax_with_host_models():
    TR, TC = ridge_classes("torch")
    JR, JC = ridge_classes("jax")
    cols = _cols(3)
    t_ds, j_ds = Dataset(dict(cols)), JDataset(dict(cols))
    t_models = [TC(alpha=a).fit(t_ds) for a in (0.1, 1e4, 1e6)]
    j_models = [JC(alpha=a).fit(j_ds) for a in (0.1, 1e4, 1e6)]
    for metric in ("accuracy", "AUC", "recall"):
        t = FindBestModel(models=t_models, evaluationMetric=metric).fit(t_ds)
        j = JFindBest(models=j_models, evaluationMetric=metric).fit(j_ds)
        assert t.get("allModelMetrics") == j.get("allModelMetrics")
        assert t.get("bestModelMetrics") == j.get("bestModelMetrics")


def _gbdt_grid(est, builder, discrete):
    return (builder().add_hyperparam(est, "numLeaves", discrete([2, 7]))
            .add_hyperparam(est, "learningRate", discrete([0.05, 0.3]))
            .build())


@pytest.fixture(scope="module")
def gbdt_serial():
    est = GBDTClassifier(numIterations=6, minDataInLeaf=20, device="cpu")
    return est, TuneHyperparameters(
        models=[est], paramSpace=GridSpace(_gbdt_grid(
            est, HyperparamBuilder, DiscreteHyperParam)),
        parallelism=1, evaluationMetric="AUC").fit(Dataset(_cols(n=2000)))


def test_gbdt_threaded_search_equals_serial(gbdt_serial):
    est, serial = gbdt_serial
    threaded = TuneHyperparameters(
        models=[est], paramSpace=GridSpace(_gbdt_grid(
            est, HyperparamBuilder, DiscreteHyperParam)),
        parallelism=4, evaluationMetric="AUC").fit(Dataset(_cols(n=2000)))
    assert _results(threaded) == _results(serial)
    X = np.stack(_cols(9, n=100)["features"])
    ds = Dataset({"features": list(X)})
    np.testing.assert_array_equal(
        np.stack(threaded.transform(ds)["rawPrediction"]),
        np.stack(serial.transform(ds)["rawPrediction"]))


def test_gbdt_search_matches_jax(gbdt_serial):
    _, serial = gbdt_serial
    jest = JClf(numIterations=6, minDataInLeaf=20, numShards=1)
    j = JTune(models=[jest], paramSpace=JGrid(_gbdt_grid(
        jest, JBuilder, JDiscrete)), parallelism=4,
        evaluationMetric="AUC").fit(JDataset(_cols(n=2000)))
    t_all, t_best, t_metric = _results(serial)
    j_all, j_best, j_metric = _results(j)
    assert t_best == j_best
    np.testing.assert_allclose(t_all, j_all, rtol=0, atol=0.005)
    assert abs(t_metric - j_metric) <= 0.005


def test_default_tables_equal_jax():
    from synapseml_tpu.automl import DefaultHyperparams as JDefaults
    t = DefaultHyperparams.for_stage(GBDTClassifier(device="cpu"))
    j = JDefaults.for_stage(JClf())
    assert [n for _, n, _ in t] == [n for _, n, _ in j]
    assert [d.grid_values() for _, _, d in t] == \
        [d.grid_values() for _, _, d in j]


def test_tuned_and_best_models_survive_save_and_load(gbdt_serial, tmp_path):
    """The fitted search's model (its winner a GBDT in a PyObjectParam)
    and FindBestModel's survive the port's save / load_stage."""
    from synapseml_tpu_torch.core.pipeline import load_stage
    est, serial = gbdt_serial
    ds = Dataset(_cols(8, n=200))
    serial.save(str(tmp_path / "tuned"))
    back = load_stage(str(tmp_path / "tuned"))
    assert _results(back) == _results(serial)
    np.testing.assert_array_equal(
        np.stack(back.transform(ds)["probability"]),
        np.stack(serial.transform(ds)["probability"]))
    best = FindBestModel(models=[serial.get("bestModel")],
                         evaluationMetric="AUC").fit(ds)
    best.save(str(tmp_path / "best"))
    again = load_stage(str(tmp_path / "best"))
    assert again.get("allModelMetrics") == best.get("allModelMetrics")
    assert list(again.transform(ds)["prediction"]) == \
        list(best.transform(ds)["prediction"])
