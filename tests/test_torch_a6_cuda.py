"""The explainers and the classic estimators (ROADMAP A6's first three
bullets) on the card against the same code on the CPU, and phase 22 of
``chip_smoke.py`` run small on the CPU.

The ``gpu`` tests skip where no card is present (the check runs inside
the fixture, so every worker collects the same tests).  Run on a machine
with a card:

    python -m pytest -m gpu tests/test_torch_a6_cuda.py

Each check is ``chip_smoke.a6_card_vs_cpu``'s (phase 22a), with its
limit: the solvers, LIME and Kernel SHAP within 1e-6 of scale (the
solves run in float64 on both devices) with SHAP's efficiency sum within
1e-4 of the outputs' scale, KNN's neighbours equal
with distances within 1e-6 relative, isolation-forest scores within
1e-6, SAR's similarity and scores within 1e-6 relative with equal top-10
lists, ALS anomaly scores within 1e-4 of max(1, |score|).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

CHECKS = ("least_squares", "lasso", "tabular_lime", "tabular_shap",
          "tabular_shap_efficiency", "vector_lime", "vector_shap",
          "vector_shap_efficiency", "text_lime", "text_shap",
          "text_shap_efficiency", "image_lime", "image_shap",
          "image_shap_efficiency", "ice", "knn", "isolation_forest",
          "sar_similarity", "sar_scores", "als_scores")


@pytest.fixture(scope="module")
def card_vs_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return chip_smoke.a6_card_vs_cpu(torch.device("cuda", 0), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("check", CHECKS)
def test_card_equals_cpu(card_vs_cpu, check):
    r = card_vs_cpu[check]
    assert r["err"] <= r["limit"], (check, r)


def test_phase22_paths_run_small_on_the_cpu():
    """22b-g end to end on the CPU at tiny sizes (a small CNN in place of
    ResNet-50): every check the card run makes passes, and each sub-phase
    reports its rates."""
    res = chip_smoke.a6_paths(
        0, torch.device("cpu"), "cpu", chip_smoke.onnx_small_cnn(0),
        n_images=1, lime_samples=8, img_hw=16, lime_class=3, gbdt_rows=1024, gbdt_iters=1, n_explain=2, tab_samples=32,
        knn_n=3000, knn_q=32, knn_k=10, knn_check=8, cknn_q=16,
        fraud_n=3000, ml=(200, 150, 5000), aa=(200, 80, 4000))
    assert res["knn"]["sets_equal"]
    assert res["tabular_shap"]["max_efficiency_residual"] <= 1e-3
    assert set(res) == {"image_lime", "gbdt", "tabular_shap",
                        "tabular_lime", "knn", "iforest", "sar",
                        "access_anomaly"}
    assert np.isfinite(res["access_anomaly"]["als_ms_per_iteration"])
