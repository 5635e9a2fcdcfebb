"""The port's double-ML stages held against the JAX package's.

With host (numpy ridge) nuisance models both packages run the same
splits, residuals and effect sums: the raw effects agree within 1e-6 (in
fact exactly).  With GBDT nuisance models on the CPU the fits agree only
to their quantization (the JAX CPU fit sums f32 gradients by
scatter-add, the port the kernels' exact int8 limbs), so the ATE agrees
within 0.05 there.  A model the JAX package fitted, carried across
(``convert.dml_model_from_reference`` /
``ortho_forest_model_from_reference``), reports and transforms the same
effects (within 1e-6 through the forest).
"""

import json

import numpy as np
import pytest

from synapseml_tpu.causal import DoubleMLEstimator as JDML
from synapseml_tpu.causal import OrthoForestDMLEstimator as JOrtho
from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.gbdt.estimators import GBDTClassifier as JClf
from synapseml_tpu.models.gbdt.estimators import GBDTRegressor as JReg
from synapseml_tpu_torch.causal import (DoubleMLEstimator,
                                        OrthoForestDMLEstimator)
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.models.gbdt.convert import (
    dml_model_from_reference, ortho_forest_model_from_reference)
from synapseml_tpu_torch.models.gbdt.estimators import (GBDTClassifier,
                                                        GBDTRegressor)
from torch_host_models import ridge_classes
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _cols(seed, n=800, effect=2.0, binary=False, heterogeneous=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    if binary:
        t = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float64)
    else:
        t = 0.8 * x[:, 0] + rng.normal(0, 1, n)
    tau = np.where(x[:, 1] > 0, 2 * effect, effect) if heterogeneous \
        else effect
    y = tau * t + 1.5 * x[:, 0] - x[:, 2] + rng.normal(0, 0.3, n)
    feats = np.empty(n, dtype=object)
    for i in range(n):
        feats[i] = x[i]
    return {"features": feats, "treatment": t.astype(np.float32),
            "outcome": y.astype(np.float32)}


_COLS = dict(treatmentCol="treatment", outcomeCol="outcome")


@pytest.mark.parametrize("max_iter", [1, 3])
@pytest.mark.parametrize("binary", [False, True])
def test_dml_with_host_models_equals_jax(max_iter, binary):
    TR, TC = ridge_classes("torch")
    JR, JC = ridge_classes("jax")
    cols = _cols(max_iter, binary=binary)
    t = DoubleMLEstimator(
        treatmentModel=TC() if binary else TR(), outcomeModel=TR(),
        maxIter=max_iter, seed=4, **_COLS).fit(Dataset(dict(cols)))
    j = JDML(treatmentModel=JC() if binary else JR(), outcomeModel=JR(),
             maxIter=max_iter, seed=4, **_COLS).fit(JDataset(dict(cols)))
    np.testing.assert_allclose(t.get("rawTreatmentEffects"),
                               j.get("rawTreatmentEffects"), rtol=0,
                               atol=1e-6)
    assert t.get_confidence_interval() == pytest.approx(
        j.get_confidence_interval(), abs=1e-6)


def test_dml_with_gbdt_models_matches_jax():
    """Binary treatment (GBDTClassifier) and continuous outcome
    (GBDTRegressor) nuisance models, as the card path runs them."""
    cols = _cols(7, n=2000, binary=True)
    kw = dict(numIterations=20, maxDepth=3, learningRate=0.2)
    t = DoubleMLEstimator(
        treatmentModel=GBDTClassifier(device="cpu", **kw),
        outcomeModel=GBDTRegressor(device="cpu", **kw), maxIter=2,
        seed=1, **_COLS).fit(Dataset(dict(cols)))
    j = JDML(treatmentModel=JClf(numShards=1, **kw),
             outcomeModel=JReg(numShards=1, **kw), maxIter=2, seed=1,
             **_COLS).fit(JDataset(dict(cols)))
    assert abs(t.get_avg_treatment_effect()
               - j.get_avg_treatment_effect()) < 0.05
    assert abs(t.get_avg_treatment_effect() - 2.0) < 0.3


def _jax_dml(cols):
    JR, _ = ridge_classes("jax")
    return JDML(treatmentModel=JR(), outcomeModel=JR(), maxIter=4, seed=2,
                confidenceLevel=0.9, **_COLS).fit(JDataset(dict(cols)))


def test_carried_dml_model_reports_jax_effects():
    cols = _cols(11)
    j = _jax_dml(cols)
    state = json.loads(json.dumps({
        "rawTreatmentEffects": j.get("rawTreatmentEffects"),
        "confidenceLevel": j.get("confidenceLevel"),
        "treatmentCol": j.treatmentCol, "outcomeCol": j.outcomeCol}))
    t = dml_model_from_reference(state)
    assert t.get("rawTreatmentEffects") == j.get("rawTreatmentEffects")
    assert t.get_avg_treatment_effect() == j.get_avg_treatment_effect()
    assert t.get_confidence_interval() == j.get_confidence_interval()
    assert t.get_pvalue() == j.get_pvalue()
    np.testing.assert_array_equal(
        t.transform(Dataset(dict(cols)))["treatmentEffect"],
        j.transform(JDataset(dict(cols)))["treatmentEffect"])


def test_carried_ortho_forest_transforms_like_jax(tmp_path):
    TR, _ = ridge_classes("torch")
    JR, _ = ridge_classes("jax")
    cols = _cols(12, n=1200, effect=1.5, heterogeneous=True)
    j = JOrtho(treatmentModel=JR(), outcomeModel=JR(), seed=3,
               **_COLS).fit(JDataset(dict(cols)))
    forest = j.get("forestModel")
    state = json.loads(json.dumps({
        "booster": forest.booster.to_dict(), "featuresCol": j.featuresCol,
        "outputCol": j.outputCol, **_COLS}))
    t = ortho_forest_model_from_reference(state, device="cpu")
    rows = _cols(13, n=300, heterogeneous=True)
    te = t.transform(Dataset(dict(rows)))["treatmentEffect"]
    je = j.transform(JDataset(dict(rows)))["treatmentEffect"]
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-6)
    t.save(str(tmp_path / "of"))
    from synapseml_tpu_torch.core.pipeline import load_stage
    np.testing.assert_allclose(
        load_stage(str(tmp_path / "of")).transform(
            Dataset(dict(rows)))["treatmentEffect"], je, rtol=0, atol=1e-6)


def test_ortho_forest_with_host_models_matches_jax():
    """The same residuals (host ridge nuisance fits) into each package's
    rf forest on the CPU: the group effects agree to the forest fits'
    quantization and are ordered as the data makes them."""
    TR, _ = ridge_classes("torch")
    JR, _ = ridge_classes("jax")
    cols = _cols(14, n=2000, effect=1.5, heterogeneous=True)
    t = OrthoForestDMLEstimator(
        treatmentModel=TR(), outcomeModel=TR(), seed=3,
        heterogeneityModel=GBDTRegressor(boostingType="rf",
                                         numIterations=32, maxDepth=4,
                                         device="cpu"),
        **_COLS).fit(Dataset(dict(cols)))
    j = JOrtho(treatmentModel=JR(), outcomeModel=JR(), seed=3,
               **_COLS).fit(JDataset(dict(cols)))
    te = t.transform(Dataset(dict(cols)))["treatmentEffect"]
    je = j.transform(JDataset(dict(cols)))["treatmentEffect"]
    x1 = np.stack(cols["features"])[:, 1]
    for grp in (x1 > 0, x1 <= 0):
        assert abs(te[grp].mean() - je[grp].mean()) < 0.05
    assert te[x1 > 0].mean() > te[x1 <= 0].mean() + 0.3
