"""Voting- and feature-parallel GBDT across real processes on the CPU:
one module-scoped gang of 2 gloo ranks and one of 4 (F=11 over 4 ranks
pads one feature), launched by ``run_on_local_cluster``; the tasks are
``tests/torch_gang_tasks.py:gbdt_modes``.

- Every rank returns the same model (trees bit for bit).
- The voting pick against the JAX package's ``_best_split_voting`` under
  ``shard_map`` on the same per-rank histograms: equal feature, bin and
  left count; gain and left sums within 1e-6 (relative).
- The voting fit against the JAX package's voting fit on a 2-device
  mesh: the same first split and tree count, holdout AUC within 0.005
  (the JAX CPU fit histograms f32 by scatter, the port int8 limbs);
  with ``top_k`` = F it grows the port's data-parallel lossguide trees.
- Feature-parallel (F=11, EFB with lossguide, dart with monotone
  constraints): the trees equal the port's one-process fit bit for bit
  (the feature-parallel grower builds at full resolution, as the
  one-process fit does below 500k rows), and the margins are within
  1e-4 of the JAX package's feature-parallel fit.
- The estimators' ``parallelism``, ``topK`` and ``numShards``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu.models.gbdt.metrics import auc
from synapseml_tpu.models.gbdt.trainer import GrowthParams as JGrowth
from synapseml_tpu.models.gbdt.trainer import _best_split_voting as jvote
from synapseml_tpu.parallel import data_parallel_mesh as jmesh
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
from synapseml_tpu_torch.models.gbdt.estimators import (GBDTClassifier,
                                                        GBDTRegressor)
from synapseml_tpu_torch.parallel import run_on_local_cluster
from torch_gang_tasks import (MODE_FITS, binary_data, mode_data,
                              tree_digest, vote_hists)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

#: every gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 120.0
FP_FITS = ("fp", "fp_efb_lossguide", "fp_dart_mono")


def _gang(n, **args):
    return run_on_local_cluster("torch_gang_tasks:gbdt_modes", n,
                                task_args={"device": "cpu", **args},
                                device="cpu", timeout_s=GANG_TIMEOUT_S)


@pytest.fixture(scope="module")
def two():
    return _gang(2, pick=True, fits=list(MODE_FITS), estimators=True)


@pytest.fixture(scope="module")
def four():
    return _gang(4, fits=["fp", "vote"])


def _config(name, **over):
    kw, _ = MODE_FITS[name]
    return dict(objective="binary", min_data_in_leaf=5, **{**kw, **over})


def _jax_fit(name, ranks):
    X, y = mode_data(MODE_FITS[name][1])
    jb, _ = jtrain(X, y, JConfig(**_config(name)), mesh=jmesh(ranks))
    return jb


@pytest.mark.parametrize("name", list(MODE_FITS) + ["estimators"])
def test_every_rank_returns_one_model(two, name):
    assert two[0][name] == two[1][name]


@pytest.mark.parametrize("name", ["fp", "vote"])
def test_every_rank_of_four_returns_one_model(four, name):
    assert all(r[name] == four[0][name] for r in four)


def test_voting_pick_matches_jax(two):
    """Equal feature, bin and left count; gain and left sums to 1e-6."""
    hists = np.stack([vote_hists(r) for r in range(2)])   # (rank, node, ..)
    tot = np.asarray(two[0]["pick_tot"], np.float32)
    p = JGrowth(min_data_in_leaf=3.0, total_bins=16, voting_k=3)
    nb = jnp.full((12,), 16, jnp.int32)
    fm = jnp.ones(12, bool)
    got = two[0]["pick"]
    for node in range(2):
        g, h, c = (jnp.float32(v) for v in tot[node])

        def pick(lh):
            return jvote(lh[0], g, h, c, nb, fm, jnp.zeros((), jnp.int32), p,
                         "data")
        want = jax.jit(jax.shard_map(pick, mesh=jmesh(2),
                                     in_specs=P("data"), out_specs=P(),
                                     check_vma=False))(
            jnp.asarray(hists[:, node]))
        gain, feat, b, gl, hl, cl = (float(v) for v in want)
        assert (got[1][node], got[2][node], got[5][node]) == (feat, b, cl)
        np.testing.assert_allclose(
            [got[0][node], got[3][node], got[4][node]], [gain, gl, hl],
            rtol=1e-6)
    assert two[0]["pick"] == two[1]["pick"]


def test_voting_fit_matches_jax_mesh_fit(two):
    jb = _jax_fit("vote", 2)
    t0 = jb.trees[0]
    r = two[0]["vote"]
    assert r["first_split"] == [int(t0.split_feature[0]),
                                float(t0.threshold[0])]
    assert r["num_trees"] == jb.num_trees
    X, y = mode_data("binary")
    a_port = auc(y[:512], np.asarray(r["margin"]))
    a_jax = auc(y[:512], np.asarray(jb.predict_margin(X[:512])))
    assert abs(a_port - a_jax) <= 0.005, (a_port, a_jax)


def test_voting_with_every_feature_is_data_parallel_lossguide(two):
    """top_k = F aggregates every feature: the splits (features, bins,
    thresholds) of the port's data-parallel lossguide fit on the same
    gang.  The leaf values agree to f32 rounding, 1e-6: voting sums each
    rank's right child (parent minus left) across the ranks, the
    data-parallel grower subtracts the summed left child from the summed
    parent."""
    vote, dp = two[0]["vote_all"], two[0]["dp_lossguide"]
    assert vote["splits"] == dp["splits"]
    np.testing.assert_allclose(vote["margin"], dp["margin"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", FP_FITS)
def test_feature_parallel_equals_one_process_and_jax(two, name):
    X, y = mode_data(MODE_FITS[name][1])
    cfg = _config(name, parallelism="data_parallel")
    one, _ = ttrain(X, y, BoostingConfig(**cfg), device="cpu")
    assert two[0][name]["digest"] == tree_digest(one)
    jb = _jax_fit(name, 2)
    np.testing.assert_allclose(two[0][name]["margin"],
                               jb.predict_margin(X[:512]), atol=1e-4)


def test_feature_parallel_pads_eleven_features_over_four_ranks(four):
    X, y = mode_data("modes")
    one, _ = ttrain(X, y, BoostingConfig(**_config(
        "fp", parallelism="data_parallel")), device="cpu")
    assert four[0]["fp"]["digest"] == tree_digest(one)
    jb = _jax_fit("fp", 4)
    np.testing.assert_allclose(four[0]["fp"]["margin"],
                               jb.predict_margin(X[:512]), atol=1e-4)
    # voting over 4 ranks: 6 votes a rank of 12 features
    assert four[0]["vote"]["num_trees"] == 8


def test_estimators_take_parallelism_topk_and_num_shards(two):
    est = two[0]["estimators"]
    X, y = binary_data(n=1500)
    ds = Dataset({"features": list(X), "label": y})
    kw = dict(numIterations=6, numLeaves=15, minDataInLeaf=5, device="cpu")
    # feature_parallel over the gang = the one-process fit
    one = GBDTClassifier(numShards=1, **kw).fit(ds)
    assert est["clf_fp"]["digest"] == tree_digest(one.booster)
    assert est["clf_fp"]["parallelism"] == "feature_parallel"
    assert (est["clf_vote"]["parallelism"], est["clf_vote"]["top_k"]) == (
        "voting_parallel", 4)
    assert auc(y[:200], np.asarray(est["clf_vote"]["pred"])) > 0.9
    # numShards=1 trains locally on each rank
    local = GBDTRegressor(parallelism="feature_parallel", numShards=1,
                          **kw).fit(ds)
    assert est["reg_fp_local"]["digest"] == tree_digest(local.booster)


def test_voting_without_a_mesh_grows_lossguide_at_full_resolution():
    """No mesh: voting_parallel trains the one-process lossguide trees,
    two-level off (the JAX package's rule)."""
    X, y = mode_data("binary")
    kw = _config("vote", parallelism="data_parallel",
                 growth_policy="lossguide", two_level_hist="off")
    want, _ = ttrain(X, y, BoostingConfig(**kw), device="cpu")
    got, _ = ttrain(X, y, BoostingConfig(**_config("vote")), device="cpu")
    assert tree_digest(got) == tree_digest(want)
    assert got.config.two_level_hist == "off"
