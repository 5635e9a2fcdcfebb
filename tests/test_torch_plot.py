"""The port's ``plot.py`` under the contracts ``tests/test_plot.py``
holds the JAX package's to, and its numbers against the JAX package's
on the same inputs."""

import numpy as np
import pytest

from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.core import assert_models_equal
from synapseml_tpu_torch.plot import confusion_matrix, roc_curve
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def test_confusion_matrix_counts_and_accuracy():
    ds = Dataset.from_dict({
        "y":     [0, 0, 1, 1, 1, 2],
        "y_hat": [0, 1, 1, 1, 0, 2],
    })
    out = confusion_matrix(ds, "y", "y_hat", labels=[0, 1, 2], plot=False)
    assert out["matrix"].tolist() == [[1, 1, 0], [1, 2, 0], [0, 0, 1]]
    assert out["accuracy"] == pytest.approx(4 / 6)
    # rows normalize to 1 where the class occurs
    assert np.allclose(out["normalized"].sum(axis=1), 1.0)


def test_roc_perfect_and_random():
    n = 200
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, n)
    perfect = roc_curve({"y": y, "s": y.astype(float)}, "y", "s", plot=False)
    assert perfect["auc"] == pytest.approx(1.0)
    # anti-correlated scores → AUC 0
    worst = roc_curve({"y": y, "s": 1.0 - y}, "y", "s", plot=False)
    assert worst["auc"] == pytest.approx(0.0)
    # monotonic curve from 0 to 1
    assert perfect["fpr"][0] == 0.0 and perfect["tpr"][-1] == 1.0
    assert np.all(np.diff(perfect["fpr"]) >= 0)


def test_roc_matches_rank_statistic():
    # AUC must equal the Mann-Whitney U statistic on untied scores
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, 500)
    s = rng.normal(size=500) + y * 0.7
    out = roc_curve({"y": y, "s": s}, "y", "s", plot=False)
    pos, neg = s[y == 1], s[y == 0]
    u = np.mean(pos[:, None] > neg[None, :])
    assert out["auc"] == pytest.approx(float(u), abs=1e-9)


def test_assert_models_equal():
    from synapseml_tpu_torch.ops.stages import DropColumns

    a = DropColumns(cols=["x"])
    b = DropColumns(cols=["x"])
    assert_models_equal(a, b)
    c = DropColumns(cols=["z"])
    with pytest.raises(AssertionError):
        assert_models_equal(a, c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plots_equal_jax(seed):
    """Both packages' numbers on the same rows: the confusion matrix and
    ROC curve exactly, the AUC (each package's metrics module) to 1e-12."""
    from synapseml_tpu.plot import confusion_matrix as j_cm
    from synapseml_tpu.plot import roc_curve as j_roc
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, 300)
    y_hat = np.where(rng.random(300) < 0.7, y, rng.integers(0, 3, 300))
    cols = {"y": y, "y_hat": y_hat}
    t, j = (confusion_matrix(cols, "y", "y_hat", labels=[0, 1, 2],
                             plot=False),
            j_cm(cols, "y", "y_hat", labels=[0, 1, 2], plot=False))
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    s = np.round(rng.normal(size=300) + (y == 2), 1)     # ties included
    cols = {"y": (y == 2).astype(float), "s": s}
    t, j = roc_curve(cols, "y", "s", plot=False), j_roc(cols, "y", "s",
                                                        plot=False)
    for k in ("fpr", "tpr", "thresholds"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["auc"] == pytest.approx(j["auc"], abs=1e-12)
