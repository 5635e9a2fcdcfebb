"""The port's lambdarank ranker held against the JAX package on the CPU:
the objective's gradients, NDCG, the first tree, the fixture fit and the
``GBDTRanker`` estimator with early stopping.

The port evaluates the objective in float64 and rounds it to float32
(the JAX package computes in float32), so gradients agree within rtol
1e-5 and atol 1e-6; whole fits agree to the histogram quantization (the
JAX package's CPU fit sums f32 gradients by scatter-add, the port sums
the kernels' int8 limbs), so the first tree is held node for node and
the fixture's NDCG within 0.005.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import ranking as jranking
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu.models.gbdt.estimators import GBDTRanker as JRanker
from synapseml_tpu.models.gbdt.metrics import ndcg_at as jndcg_at
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.models.gbdt import metrics as tmetrics
from synapseml_tpu_torch.models.gbdt import ranking as tranking
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
from synapseml_tpu_torch.models.gbdt.estimators import (GBDTRanker,
                                                        GBDTRankerModel)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

#: tests/benchmarks/fixtures.csv: lambdarank_ndcg10
FIXTURE_NDCG10 = 0.9862
TOLERANCE = 0.005


def _fixture_data():
    """tests/test_benchmark_fixtures.py's ranking task: 60 queries of 12
    rows, relevance 0-3 from a noisy linear score."""
    rng = np.random.default_rng(21)
    Q, D = 60, 12
    X = rng.normal(size=(Q * D, 5)).astype(np.float32)
    rel = np.clip(X[:, 0] + 0.5 * X[:, 1]
                  + rng.normal(scale=0.3, size=Q * D), 0, None)
    y = np.digitize(rel, [0.5, 1.2, 2.0]).astype(np.float64)
    return X, y, np.full(Q, D)


FIXTURE_KW = dict(objective="lambdarank", num_iterations=20, num_leaves=15,
                  min_data_in_leaf=3, seed=5)


@pytest.fixture(scope="module")
def fixture_fits():
    X, y, sizes = _fixture_data()
    tb, _ = ttrain(X, y, BoostingConfig(**FIXTURE_KW), group=sizes,
                   device="cpu")
    jb, _ = jtrain(X, y, JConfig(**FIXTURE_KW), group=sizes)
    return X, y, sizes, tb, jb


def _grad_case(case):
    rng = np.random.default_rng(3)
    sizes = {"long": np.array([200, 129, 128, 40]),
             "ties": rng.integers(2, 30, 12),
             "label_gain": rng.integers(1, 60, 10),
             "weights": rng.integers(1, 60, 10),
             "single": np.array([1, 1, 7, 1, 3, 1])}[case]
    n = int(sizes.sum())
    s = rng.normal(size=n).astype(np.float32)
    if case == "ties":
        s = np.round(s).astype(np.float32)        # many tied scores
    lab = rng.integers(0, 5, n).astype(np.float32)
    w = (rng.uniform(0.2, 3.0, n).astype(np.float32) if case == "weights"
         else np.ones(n, np.float32))
    gain = (np.array([0.0, 1.0, 2.5, 6.0, 20.0], np.float32)
            if case == "label_gain" else None)
    return sizes, s, lab, w, gain


@pytest.mark.parametrize("case", ["long", "ties", "label_gain", "weights",
                                  "single"])
def test_lambdarank_gradients_match_jax(case):
    """Groups longer than 128 (rows past 128 get grad 0 and hess 1e-9),
    tied scores, label_gain, weights and single-row groups."""
    sizes, s, lab, w, gain = _grad_case(case)
    n = len(s)
    q, m = jranking.build_group_index(sizes)
    tq, tm = tranking.build_group_index(sizes)
    np.testing.assert_array_equal(tq, q)
    np.testing.assert_array_equal(tm, m)
    jg, jh = jranking.make_lambdarank_objective(q, m, n, label_gain=gain)(
        jnp.asarray(s), jnp.asarray(lab), jnp.asarray(w))
    fn = tranking.make_lambdarank_objective(tq, tm, n, label_gain=gain)
    tg, th = fn(torch.from_numpy(s).double(), torch.from_numpy(lab),
                torch.from_numpy(w))
    np.testing.assert_allclose(tg.float().numpy(), np.asarray(jg),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-6)
    if case == "long":
        past = np.concatenate([np.arange(128, 200), [200 + 128]])
        assert np.all(tg.numpy()[past] == 0)
        assert np.all(th.numpy()[past] == 1e-9)


def test_lambdarank_query_chunks_give_identical_results(monkeypatch):
    """The objective processes the grid in query chunks under a pair
    budget; any chunking gives the same bits."""
    sizes, s, lab, w, gain = _grad_case("weights")
    q, m = tranking.build_group_index(sizes)
    args = (torch.from_numpy(s).double(), torch.from_numpy(lab),
            torch.from_numpy(w))
    whole = tranking.make_lambdarank_objective(q, m, len(s))(*args)
    monkeypatch.setattr(tranking, "_PAIR_BUDGET", 3 * q.shape[1] ** 2)
    chunked = tranking.make_lambdarank_objective(q, m, len(s))(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def _ndcg_data():
    rng = np.random.default_rng(1)
    sizes = np.concatenate([rng.integers(1, 300, 30), [1, 5, 0, 3, 150]])
    n = int(sizes.sum())
    y = rng.integers(0, 5, n).astype(np.float64)
    y[:sizes[0]] = 0                             # a group of zero labels
    s = np.round(rng.normal(size=n), 1)          # ties
    return y, s, sizes


@pytest.mark.parametrize("k", [1, 3, 10, 1000])
def test_ndcg_matches_jax(k):
    y, s, sizes = _ndcg_data()
    want = jndcg_at(k)(y, s, sizes)
    assert abs(tmetrics.ndcg_at(k)(y, s, sizes) - want) <= 1e-9
    grid = tmetrics.GroupGrid(sizes)
    got = tmetrics.ndcg_at(k)(torch.tensor(y), torch.tensor(s), grid)
    assert torch.is_tensor(got) and abs(float(got) - want) <= 1e-9
    # every group of zero labels counts 1.0
    zero = tmetrics.ndcg_at(k)(np.zeros_like(y), s, sizes)
    assert zero == jndcg_at(k)(np.zeros_like(y), s, sizes) == 1.0


def test_first_tree_matches_jax(fixture_fits):
    """The fixture's first tree: split features, bins and children equal
    node for node, leaf values within 1e-5."""
    *_, tb, jb = fixture_fits
    ta, tj = tb.trees[0], jb.trees[0]
    n = int(tj.num_nodes)
    assert int(ta.num_nodes) == n and n > 9
    for f in ("split_feature", "split_bin", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(ta, f)[:n],
                                      np.asarray(getattr(tj, f))[:n],
                                      err_msg=f)
    np.testing.assert_allclose(ta.leaf_value[:n],
                               np.asarray(tj.leaf_value)[:n], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb.init_score, np.asarray(jb.init_score),
                               rtol=1e-6)


def test_fixture_ndcg_matches_jax(fixture_fits):
    """20 iterations reach the fixture's ndcg@10 within 0.005, and the
    JAX model's within 0.005."""
    X, y, sizes, tb, jb = fixture_fits
    got = tmetrics.ndcg_at(10)(y, tb.predict_margin(X, device="cpu"), sizes)
    want = jndcg_at(10)(y, jb.predict_margin(X), sizes)
    assert abs(got - FIXTURE_NDCG10) <= TOLERANCE, got
    assert abs(got - want) <= TOLERANCE, (got, want)


def _ranker_rows(seed, Q, shuffle=True):
    """Q queries of 2-30 rows with query ids 0..Q-1, rows shuffled (the
    estimator sorts them by query), relevance from a noisy score."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 31, Q)
    qid = np.repeat(np.arange(Q), sizes)
    X = rng.normal(size=(len(qid), 6)).astype(np.float32)
    rel = X[:, 0] + 0.6 * X[:, 1] - 0.3 * X[:, 2] \
        + rng.normal(scale=0.8, size=len(qid))
    y = np.digitize(rel, [-0.5, 0.5, 1.5]).astype(np.float64)
    if shuffle:
        p = rng.permutation(len(qid))
        qid, X, y = qid[p], X[p], y[p]
    return qid, X, y


def _ranker_columns(seed, Q, n_valid):
    qid, X, y = _ranker_rows(seed, Q)
    return {"features": list(X), "label": y, "query": qid.astype(np.float64),
            "isValid": qid >= Q - n_valid}


def test_ranker_early_stopping_matches_jax():
    """``GBDTRanker`` with a validation set flagged by
    ``validationIndicatorCol`` and early stopping: the JAX ranker's
    best iteration, and NDCG histories within 0.005."""
    cols = _ranker_columns(11, 120, 30)
    kw = dict(numIterations=40, numLeaves=7, learningRate=0.3,
              minDataInLeaf=5, earlyStoppingRound=3,
              validationIndicatorCol="isValid", maxPosition=5)
    tm = GBDTRanker(device="cpu", **kw).fit(TDataset(cols))
    jm = JRanker(**kw).fit(JDataset(cols))
    th, jh = tm._eval_history, jm._eval_history
    assert tm.booster.best_iteration == jm.booster.best_iteration
    assert len(th) == len(jh) < 40
    assert max(abs(a.value - b.value) for a, b in zip(th, jh)) <= TOLERANCE
    assert th[0].metric == "ndcg"


def test_ranker_transform_and_label_gain():
    """The ranker writes the margin; ``labelGain`` reaches the objective
    and the JAX ranker's NDCG is matched within 0.005."""
    qid, X, y = _ranker_rows(12, 80)
    cols = {"features": list(X), "label": y, "query": qid}
    kw = dict(numIterations=6, numLeaves=7, minDataInLeaf=5,
              labelGain=[0.0, 1.0, 4.0, 9.0])
    tm = GBDTRanker(device="cpu", **kw).fit(TDataset(cols))
    jm = JRanker(**kw).fit(JDataset(cols))
    assert isinstance(tm, GBDTRankerModel)
    assert tm.booster.config.label_gain == [0.0, 1.0, 4.0, 9.0]
    out = tm.transform(TDataset(cols))
    pred = np.asarray(out["prediction"])
    np.testing.assert_allclose(pred, tm.booster.predict_margin(
        X, device="cpu"), rtol=0, atol=0)
    order = np.argsort(qid, kind="stable")
    sizes = np.unique(qid, return_counts=True)[1]
    got = tmetrics.ndcg_at(10)(y[order], pred[order], sizes)
    want = jndcg_at(10)(y[order], np.asarray(
        jm.transform(JDataset(cols))["prediction"])[order], sizes)
    assert abs(got - want) <= TOLERANCE, (got, want)


def test_mesh_is_refused_naming_a5(tmp_path):
    """Distributed lambdarank trains over a gang
    (tests/test_torch_gbdt_rank_parallel.py), checkpoints included
    (tests/test_torch_elastic.py), and so does the step profiler's cost
    capture (tests/test_torch_dl_mesh_elastic.py): with a capture, a mesh
    that is not a ProcessMesh is refused on its type before any work."""
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    X, y, sizes = _fixture_data()
    with pytest.raises(TypeError, match="ProcessMesh"):
        ttrain(X, y, BoostingConfig(**FIXTURE_KW), group=sizes,
               mesh=object(), checkpoint_dir=str(tmp_path),
               checkpoint_interval=1,
               step_profiler=StepProfiler("rank", capture_xla=True),
               device="cpu")


@pytest.mark.parametrize("group,valid_group,err", [
    (None, None, "requires group sizes"),
    (np.full(59, 12), None, "sum to 708"),
    (np.full(60, 12), None, "ndcg eval requires valid_group"),
])
def test_group_errors(group, valid_group, err):
    X, y, _ = _fixture_data()
    with pytest.raises(ValueError, match=err):
        ttrain(X, y, BoostingConfig(**{**FIXTURE_KW, "num_iterations": 1}),
               group=group, valid=(X[:24], y[:24], None),
               valid_group=valid_group, device="cpu")
