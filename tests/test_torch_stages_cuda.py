"""The JAX-free stages over the GBDT (ROADMAP A8) on the card against the
same stages on the CPU.

The ``gpu`` tests skip where no card is present.  Run on a machine with
a card:

    python -m pytest -m gpu tests/test_torch_stages_cuda.py

Limits: ``TrainClassifier``'s inner trees equal (``chip_smoke.
split_digest``), margins within 1e-6 and equal labels; the tuner at
parallelism 4 equal to parallelism 1 (results and K1/K2 launch counts
by shape, exactly); DML's raw effects within 1e-6; the orthogonal
forest's default forest (on the card) within 1e-6 of the same forest on
the CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

CARD = torch.device("cuda", 0)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CARD


@pytest.mark.gpu
def test_train_classifier_card_equals_cpu(card):
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.kernels import launches as L
    rng = np.random.default_rng(1)
    cols, hold = chip_smoke.a8_frame(rng, 20_000), chip_smoke.a8_frame(
        rng, 4096)
    r, mc = chip_smoke.a8_train(cols, hold, card, 10)
    assert sum(r["shapes"].values()) > 0, r["shapes"]
    assert any(k.startswith("route_and_hist[") for k in r["shapes"])
    _, mp = chip_smoke.a8_train(cols, hold, CPU, 10)
    assert chip_smoke.split_digest(mc.innerModel.booster) == \
        chip_smoke.split_digest(mp.innerModel.booster)
    oc, op = mc.transform(Dataset(dict(hold))), mp.transform(
        Dataset(dict(hold)))
    np.testing.assert_allclose(np.stack(oc["rawPrediction"]),
                               np.stack(op["rawPrediction"]), rtol=0,
                               atol=1e-6)
    assert list(oc["prediction"]) == list(op["prediction"])
    assert r["auc"] > 0.9
    L.reset()


@pytest.mark.gpu
def test_tuner_threads_equal_serial_on_the_card(card):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40_000, 28)).astype(np.float32)
    y = chip_smoke.gbdt_labels(rng, X)
    one = chip_smoke.a8_tune(X, y, card, 1, 6)
    four = chip_smoke.a8_tune(X, y, card, 4, 6)
    for k in ("all_metrics", "best_params", "best_metric"):
        assert one[k] == four[k], k
    assert one["shapes"] == four["shapes"] and one["shapes"]
    assert len(one["all_metrics"]) == 4


@pytest.mark.gpu
def test_dml_card_equals_cpu(card):
    cols = chip_smoke.a8_causal_rows(np.random.default_rng(3), 20_000)
    kw = dict(nuisance=chip_smoke.P30_CHECK_NUISANCE)
    c = chip_smoke.a8_dml(cols, card, **kw).get("rawTreatmentEffects")
    p = chip_smoke.a8_dml(cols, CPU, **kw).get("rawTreatmentEffects")
    np.testing.assert_allclose(c, p, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_default_forest_runs_on_the_card(card):
    """The orthogonal forest's default heterogeneity forest is the card's;
    the same forest on the CPU gives the same effects."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTRegressor
    cols = chip_smoke.a8_causal_rows(np.random.default_rng(4), 20_000,
                                     heterogeneous=True)
    mc = chip_smoke.a8_forest(cols, card)
    assert mc.get("forestModel").device.startswith("cuda")
    mp = chip_smoke.a8_forest(cols, CPU, forest=GBDTRegressor(
        boostingType="rf", numIterations=32, maxDepth=4, device="cpu"))
    ec = mc.transform(Dataset(dict(cols)))["treatmentEffect"]
    ep = mp.transform(Dataset(dict(cols)))["treatmentEffect"]
    np.testing.assert_allclose(ec, ep, rtol=0, atol=1e-6)
