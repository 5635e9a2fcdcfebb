"""The port's SAR and ranking tools (``synapseml_tpu_torch.recommendation``)
against the JAX package's on the CPU.

The interaction data hold deliberate ties: items 0-3 are bought by the
same users (equal co-occurrence columns, so equal scores), items under
``supportThreshold`` score exactly 0, and every seen item is -inf.  Both
packages rank equal scores by the lower item index first (``lax.top_k``;
a stable descending sort in the port).  Tolerances: similarity and
scores within 1e-6 relative (reading: similarity and scores equal bit for
bit at this size), top-k item lists equal, ranking metrics
equal (the same numpy code on the same lists).
"""

import numpy as np
import pytest
import torch

import synapseml_tpu.recommendation as JR
import synapseml_tpu_torch.recommendation as TR
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu_torch.core import Dataset as TDataset
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _ratings(seed=0, n_users=40, n_items=25, n=420):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n)
    items = rng.integers(4, n_items, n)
    # items 0-3: bought by the same users (tied similarity columns)
    tied = np.repeat(np.arange(0, n_users, 3), 4)
    users = np.concatenate([users, tied])
    items = np.concatenate([items, np.tile(np.arange(4), len(tied) // 4)])
    ratings = rng.integers(1, 6, len(users)).astype(np.float32)
    times = (1.6e9 + rng.uniform(0, 90 * 86400, len(users)))
    return {"user": np.array([f"u{u:03d}" for u in users]),
            "item": np.array([f"i{i:03d}" for i in items]),
            "rating": ratings, "time": times}


CONFIGS = [("jaccard", 2, True), ("lift", 3, False),
           ("cooccurrence", 1, True)]


@pytest.fixture(scope="module")
def fitted():
    out = {}
    data = _ratings()
    for fn, support, timed in CONFIGS:
        kw = {"similarityFunction": fn, "supportThreshold": support}
        if timed:
            kw["timeCol"] = "time"
        jm = JR.SAR(**kw).fit(JDataset(dict(data)))
        tm = TR.SAR(device="cpu", **kw).fit(TDataset(dict(data)))
        out[fn] = (jm, tm)
    return out


@pytest.mark.parametrize("fn", [c[0] for c in CONFIGS])
def test_sar_fit_matches_jax(fitted, fn):
    jm, tm = fitted[fn]
    for name in ("userVocabulary", "itemVocabulary", "userAffinity",
                 "seenItems"):
        np.testing.assert_array_equal(np.asarray(tm.get(name)),
                                      np.asarray(jm.get(name)))
    js, ts = (np.asarray(m.get("itemSimilarity")) for m in (jm, tm))
    assert ts.dtype == np.float32
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)


@pytest.mark.parametrize("fn", [c[0] for c in CONFIGS])
def test_sar_recommendations_match_jax_under_ties(fitted, fn):
    jm, tm = fitted[fn]
    for remove_seen in (True, False):
        want = jm.recommend_for_all_users(6, remove_seen=remove_seen)
        got = tm.recommend_for_all_users(6, remove_seen=remove_seen)
        np.testing.assert_array_equal(got["user"], want["user"])
        for w, g in zip(want["recommendations"], got["recommendations"]):
            assert [r["item"] for r in g] == [r["item"] for r in w]
            scale = max([abs(r["rating"]) for r in w] + [1e-30])
            np.testing.assert_allclose([r["rating"] for r in g],
                                       [r["rating"] for r in w], rtol=0,
                                       atol=1e-6 * scale)
    # the tied items: a user who bought none of 0-3 sees them in order
    recs = tm.recommend_for_all_users(25, remove_seen=True)
    for row in recs["recommendations"]:
        tied = [r["item"] for r in row if r["item"] in
                ("i000", "i001", "i002", "i003")]
        assert tied == sorted(tied)


def test_sar_pair_scores_match_jax(fitted):
    jm, tm = fitted["jaccard"]
    data = _ratings(5, n=60)
    data["user"][:3] = "nobody"                   # unknown users score 0
    want = jm.transform(JDataset(dict(data)))["prediction"]
    got = tm.transform(TDataset(dict(data)))["prediction"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert np.all(got[:3] == 0)


def test_ranking_split_and_adapter_match_jax():
    data = _ratings(2)
    outs = []
    for R, D, kw in ((JR, JDataset, {}), (TR, TDataset, {"device": "cpu"})):
        ev = R.RankingEvaluator(k=5, metricName="ndcgAt")
        split = R.RankingTrainValidationSplit(
            estimator=R.SAR(supportThreshold=1, **kw), evaluator=ev,
            trainRatio=0.7, seed=3).fit(D(dict(data)))
        adapter = R.RankingAdapter(recommender=R.SAR(supportThreshold=1, **kw),
                                   k=5).fit(D(dict(data)))
        ranked = adapter.transform(D(dict(data)))
        metrics = [R.RankingEvaluator(k=5, metricName=name).evaluate(ranked)
                   for name in ("ndcgAt", "map", "precisionAtk", "recallAtK",
                                "diversityAtK", "maxDiversity")]
        outs.append((split.validationMetric, metrics, list(ranked["prediction"])))
    assert outs[1][0] == pytest.approx(outs[0][0], abs=1e-12)
    assert outs[1][1] == pytest.approx(outs[0][1], abs=1e-12)
    assert outs[1][2] == outs[0][2]


def test_indexer_and_metrics_are_the_reference_code():
    data = _ratings(4, n=50)
    jm = JR.RecommendationIndexer().fit(JDataset(dict(data)))
    tm = TR.RecommendationIndexer().fit(TDataset(dict(data)))
    j, t = jm.transform(JDataset(dict(data))), tm.transform(TDataset(dict(data)))
    np.testing.assert_array_equal(t["userIdx"], j["userIdx"])
    np.testing.assert_array_equal(t["itemIdx"], j["itemIdx"])
    np.testing.assert_array_equal(tm.recover_item(t["itemIdx"]), data["item"])
    pred, act = [[1, 2, 3], [4, 5]], [[2, 9], [4]]
    for f in ("ndcg_at_k", "precision_at_k", "recall_at_k"):
        assert getattr(TR, f)(pred, act, 2) == getattr(JR, f)(pred, act, 2)
    assert TR.mean_average_precision(pred, act) == \
        JR.mean_average_precision(pred, act)
    assert TR.diversity_at_k(pred, 10, 2) == JR.diversity_at_k(pred, 10, 2)


def test_ranking_evaluator_subclasses_the_ports_evaluator():
    from synapseml_tpu_torch.core.pipeline import Evaluator
    assert issubclass(TR.RankingEvaluator, Evaluator)
    assert Evaluator.__module__ == "synapseml_tpu_torch.core.pipeline"
    assert TR.RankingEvaluator().is_larger_better()
    with pytest.raises(NotImplementedError):
        Evaluator().evaluate(None)


def test_sar_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.SAR().fit(TDataset(_ratings(n=10)))
