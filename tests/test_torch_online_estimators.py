"""The port's online estimators held against the JAX package's on the CPU:
``OnlineSGDClassifier`` (logistic, hinge) and ``OnlineSGDRegressor``
(squared, quantile, poisson) fit → transform on the same Dataset, models
saved by either package loaded in the other (``state.npz``), the mesh
refused, and the two accuracy fixtures of
``tests/benchmarks/fixtures.csv`` reached the way
``tests/test_benchmark_fixtures.py`` computes them.

Tolerances: states and outputs within 1e-5 of their scale (the SGD core's
tolerance, ``tests/test_torch_online_sgd.py``); the fixtures within their
±0.005.
"""

import csv
import os

import numpy as np
import pytest

from synapseml_tpu import Dataset as JDataset
from synapseml_tpu.models.gbdt.metrics import auc, rmse
from synapseml_tpu.models.online import (OnlineSGDClassificationModel as
                                         JClfModel)
from synapseml_tpu.models.online import OnlineSGDClassifier as JClf
from synapseml_tpu.models.online import OnlineSGDRegressor as JReg
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.core.pipeline import load_stage
from synapseml_tpu_torch.models.online import (OnlineSGDClassificationModel,
                                               OnlineSGDClassifier,
                                               OnlineSGDRegressor,
                                               state_to_numpy)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

TOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "benchmarks",
                        "fixtures.csv")


def _data(n=800, d=6, seed=0, classification=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    m = x @ rng.normal(size=d)
    y = ((m > 0).astype(np.int64) if classification
         else (m + 0.05 * rng.normal(size=n)).astype(np.float32))
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    cols = {"features": [r for r in x], "label": y, "w": w}
    return JDataset(cols, num_partitions=4), TDataset(cols)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _states_close(tmodel, jmodel):
    got = state_to_numpy(tmodel.state)
    for f, v in got.items():
        _close(v, np.asarray(getattr(jmodel.state, f)))


@pytest.mark.parametrize("loss", ["logistic", "hinge"])
def test_classifier_equals_jax(loss):
    jds, tds = _data(classification=True)
    kw = dict(lossFunction=loss, numPasses=3, weightCol="w", l2=1e-4)
    jm = JClf(**kw).fit(jds)
    tm = OnlineSGDClassifier(device="cpu", **kw).fit(tds)
    _states_close(tm, jm)
    jo, to = jm.transform(jds), tm.transform(tds)
    assert to.columns == jo.columns
    _close(to["rawPrediction"], jo["rawPrediction"])
    _close(np.stack(to["probability"]), np.stack(jo["probability"]))
    agree = to["prediction"] == jo["prediction"]
    assert agree.mean() >= 0.995
    assert tm.training_stats["average_loss"] == pytest.approx(
        jm.training_stats["average_loss"], rel=TOL)


@pytest.mark.parametrize("loss", ["squared", "quantile", "poisson"])
def test_regressor_equals_jax(loss):
    jds, tds = _data(seed=1)
    if loss == "poisson":
        lab = np.random.default_rng(2).poisson(1.5, 800).astype(np.float32)
        jds = jds.with_column("label", lab)
        tds = tds.with_column("label", lab)
    kw = dict(lossFunction=loss, numPasses=4, quantileTau=0.7,
              learningRate=0.3)
    jm = JReg(**kw).fit(jds)
    tm = OnlineSGDRegressor(device="cpu", **kw).fit(tds)
    _states_close(tm, jm)
    _close(tm.transform(tds)["prediction"], jm.transform(jds)["prediction"])


def test_models_load_across_packages(tmp_path):
    """``state.npz`` is the interchange: the JAX package's saved model
    loads in the port (as the port's class) with its state bit for bit,
    and the port's state loads into the JAX package's model; both score
    the same within the tolerance (their matvecs sum in other orders)."""
    jds, tds = _data(classification=True, seed=3)
    jm = JClf(numPasses=2).fit(jds)
    jm.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    assert isinstance(loaded, OnlineSGDClassificationModel)
    loaded.set("device", "cpu")
    for f, v in state_to_numpy(loaded.state).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm.state, f)))
    _close(loaded.transform(tds)["rawPrediction"],
           jm.transform(jds)["rawPrediction"])

    tm = OnlineSGDClassifier(numPasses=2, device="cpu").fit(tds)
    tm.save(str(tmp_path / "port"))
    again = load_stage(str(tmp_path / "port"))
    np.testing.assert_array_equal(again.transform(tds)["rawPrediction"],
                                  tm.transform(tds)["rawPrediction"])
    jload = JClfModel()
    jload._load_extra(str(tmp_path / "port"))
    _close(jload.transform(jds)["rawPrediction"],
           tm.transform(tds)["rawPrediction"])


@pytest.mark.parametrize("est", [OnlineSGDClassifier, OnlineSGDRegressor])
def test_mesh_refused_before_any_work(est, monkeypatch):
    _, tds = _data(classification=True)

    def no_work(*a, **k):
        raise AssertionError("the data was read")
    monkeypatch.setattr(est, "_xyw", no_work)
    # the mesh trains now (tests/test_torch_online_mesh.py); anything but
    # a ProcessMesh is refused before the data is read
    for kw in (dict(mesh=object()), dict(mesh=object(), numSyncsPerPass=2)):
        with pytest.raises(TypeError, match="ProcessMesh"):
            est(device="cpu", **kw).fit(tds)


def test_sync_schedule_without_mesh_trains_like_jax():
    """Without a mesh both packages ignore ``numSyncsPerPass``."""
    jds, tds = _data(classification=True, seed=4)
    jm = JClf(numSyncsPerPass=2).fit(jds)
    tm = OnlineSGDClassifier(numSyncsPerPass=2, device="cpu").fit(tds)
    _states_close(tm, jm)


def _fixture(name):
    with open(FIXTURES) as f:
        for row in csv.DictReader(f):
            if row["name"] == name:
                return float(row["value"])
    raise KeyError(name)


def test_fixture_online_sgd_regressor_rmse():
    rng = np.random.default_rng(17)
    X = rng.normal(size=(2000, 6)).astype(np.float32)
    w = rng.normal(size=6)
    y = (X @ w + 0.05 * rng.normal(size=2000)).astype(np.float32)
    ds = TDataset({"features": [r for r in X], "label": y}, num_partitions=4)
    model = OnlineSGDRegressor(numPasses=12, device="cpu").fit(ds)
    got = float(rmse(y, np.asarray(model.transform(ds)["prediction"])))
    assert abs(got - _fixture("online_sgd_regressor_rmse")) <= 0.005, got


def test_fixture_online_sgd_classifier_auc():
    rng = np.random.default_rng(19)
    X = rng.normal(size=(2500, 8)).astype(np.float32)
    w = rng.normal(size=8)
    y = (X @ w + 0.3 * rng.normal(size=2500) > 0).astype(np.int64)
    ds = TDataset({"features": [r for r in X], "label": y}, num_partitions=4)
    model = OnlineSGDClassifier(numPasses=8, device="cpu").fit(ds)
    margins = np.asarray(model.transform(ds)["rawPrediction"], np.float64)
    got = float(auc(y.astype(np.float64), margins))
    assert abs(got - _fixture("online_sgd_classifier_auc")) <= 0.005, got
