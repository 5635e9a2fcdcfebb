"""The port's isolation forest (``synapseml_tpu_torch.isolationforest``)
against the JAX package's on the CPU.

Tree construction is the same host numpy code on the same
``default_rng(seed)`` draws, so the trees are equal array for array.
Scoring walks them with batched gathers in both packages; the mean path
length is a float32 mean over the trees.  Tolerances: trees equal,
scores within 1e-6 (reading: <= 1.2e-7, one f32 step), labels equal.
"""

import numpy as np
import pytest
import torch

import synapseml_tpu.isolationforest as JI
import synapseml_tpu_torch.isolationforest as TI
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu_torch.core import Dataset as TDataset
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

TREE = ("treeFeature", "treeThreshold", "treeLeft", "treeRight",
        "treeLeafAdj")


def _data(seed=0, n=600, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:12] += 6.0                                  # outliers
    x[20:40, 1] = 0.5                              # a constant block
    return x


@pytest.mark.parametrize("params", [
    {"numEstimators": 20, "maxSamples": 64},
    {"numEstimators": 12, "maxSamples": 128, "maxFeatures": 0.6,
     "bootstrap": True, "contamination": 0.05, "seed": 7},
], ids=["default", "subspace_bootstrap_contamination"])
def test_forest_matches_jax(params):
    x = _data()
    outs, models = [], []
    for I, D, kw in ((JI, JDataset, {}), (TI, TDataset, {"device": "cpu"})):
        m = I.IsolationForest(**params, **kw).fit(D({"features": list(x)}))
        models.append(m)
        outs.append(m.transform(D({"features": list(x)})))
    jm, tm = models
    for name in TREE:
        np.testing.assert_array_equal(np.asarray(tm.get(name)),
                                      np.asarray(jm.get(name)))
    assert (tm.maxDepth, tm.subsampleSize) == (jm.maxDepth, jm.subsampleSize)
    np.testing.assert_allclose(tm.threshold, jm.threshold, rtol=0, atol=1e-6)
    want, got = outs
    assert got["outlierScore"].dtype == want["outlierScore"].dtype
    np.testing.assert_allclose(got["outlierScore"], want["outlierScore"],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["predictedLabel"],
                                  want["predictedLabel"])
    assert got["outlierScore"][:12].mean() > got["outlierScore"][12:].mean()


def test_iforest_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.IsolationForest().fit(TDataset({"features": list(_data(n=8))}))
