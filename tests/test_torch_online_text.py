"""The port's host text path and the learners over it held against the
JAX package on the CPU: murmur hashes bit for bit, the native VW parser
against the port's plain Python parser and against the JAX package,
``HashingFeaturizer``, ``FeatureInteractions``, ``VectorZipper``,
ds-json, policy evaluation, ``OnlineGeneric`` / ``OnlineGenericModel`` /
``OnlineGenericProgressive`` and ``ContextualBandit``.

Tolerances: hashes, parsed matrices and featurized vectors exactly;
policy-evaluation values exactly (the same numpy code); learned states
and predictions within 1e-5 of their scale (the SGD core's tolerance,
``tests/test_torch_online_sgd.py``).
"""

import json

import numpy as np
import pytest

from synapseml_tpu import Dataset as JDataset
from synapseml_tpu.core import hashing as JH
from synapseml_tpu.models import online as J
from synapseml_tpu.models.online import generic as JG
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.core import hashing as TH
from synapseml_tpu_torch.models import online as T
from synapseml_tpu_torch.models.online import generic as TG
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

TOL = 1e-5

TOKENS = ["", "a", "ab", "abc", "abcd", "abcde", "feature_17", "ünïcødé",
          "x" * 1000, "w pos", "\t", "col=value"]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 7])
def test_murmur_bits_equal_jax(seed):
    want = [JH.murmurhash3_32(t, seed) for t in TOKENS]
    assert [TH.murmurhash3_32(t, seed) for t in TOKENS] == want
    np.testing.assert_array_equal(TH.murmurhash3_column(TOKENS, seed),
                                  np.asarray(want, np.uint32))
    assert TH.MurmurWithPrefix("col").hash("v", seed) == \
        JH.MurmurWithPrefix("col").hash("v", seed)
    np.testing.assert_array_equal(TH.hash_features(TOKENS, 64, seed),
                                  JH.hash_features(TOKENS, 64, seed))


VW_LINES = [
    "1 |a b c", "-1 2.0 |ns:0.5 f:3 g |other h:-1.5", "|f a",
    "0.5 'tag |x y:1e-3 z", "1 | bare ns", "abc |w pos", "2 |a:nan b:x",
    "1 |a b_1:2_0 c:0x10", "-1 |s t u", "3 1.5", "", "1 |a |b |c d",
]


@pytest.mark.parametrize("num_bits,seed", [(8, 0), (12, 3)])
def test_vw_parser_native_equals_plain_and_jax(num_bits, seed):
    x, y, w = TG.vectorize_vw_lines(VW_LINES, num_bits, seed)
    xp, yp, wp = TG.vectorize_vw_lines_plain(VW_LINES, num_bits, seed)
    np.testing.assert_array_equal(x, xp)
    np.testing.assert_array_equal(y, yp)
    np.testing.assert_array_equal(w, wp)
    xj, yj, wj = JG.vectorize_vw_lines(VW_LINES, num_bits, seed)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(w, wj)
    for line in VW_LINES:
        assert repr(TG.parse_vw_line(line)) == repr(JG.parse_vw_line(line))


def _cat_ds(n=300, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"num": rng.normal(size=n).astype(np.float32),
            "cat": np.asarray([f"c{v}" for v in rng.integers(0, 40, n)],
                              object),
            # a ragged tail element keeps numpy from making the lists a
            # 2-D array; the slice drops it
            "toks": np.asarray([[f"t{v}" for v in rng.integers(0, 9, 3)]
                                for _ in range(n)] + [None], object)[:n]}
    return cols


@pytest.mark.parametrize("kw", [
    dict(numBits=8), dict(numBits=10, seed=5, signedMode=True),
    dict(numBits=6, sumCollisions=False)])
def test_hashing_featurizer_equals_jax(kw):
    cols = _cat_ds()
    jo = J.HashingFeaturizer(inputCols=["num", "cat", "toks"], **kw) \
        .transform(JDataset(cols))
    to = T.HashingFeaturizer(inputCols=["num", "cat", "toks"], **kw) \
        .transform(TDataset(cols))
    np.testing.assert_array_equal(np.stack(to["features"]),
                                  np.stack(jo["features"]))


@pytest.mark.parametrize("sum_collisions", [True, False])
def test_feature_interactions_equal_jax(sum_collisions):
    rng = np.random.default_rng(1)
    cols = {"a": [r for r in rng.normal(size=(20, 5)).astype(np.float32)],
            "b": [r for r in rng.normal(size=(20, 7)).astype(np.float32)],
            "c": [r for r in rng.normal(size=(20, 3)).astype(np.float32)]}
    kw = dict(inputCols=["a", "b", "c"], numBits=6,
              sumCollisions=sum_collisions)
    jo = J.FeatureInteractions(**kw).transform(JDataset(cols))
    to = T.FeatureInteractions(**kw).transform(TDataset(cols))
    np.testing.assert_array_equal(np.stack(to["interactions"]),
                                  np.stack(jo["interactions"]))


def test_vector_zipper_equals_jax():
    cols = {"a": [1.0, 2.0], "b": [3.0, 4.0]}
    jo = J.VectorZipper(inputCols=["a", "b"], outputCol="z") \
        .transform(JDataset(cols))
    to = T.VectorZipper(inputCols=["a", "b"], outputCol="z") \
        .transform(TDataset(cols))
    assert [list(v) for v in to["z"]] == [list(v) for v in jo["z"]]


def test_dsjson_equals_jax():
    evs = [{"EventId": "abc", "_label_cost": -1.0,
            "_label_probability": 0.25, "_labelIndex": 2, "c": {"x": 1}},
           {"EventId": "def", "_label_cost": "bad"},
           {"c": {}}]
    cols = {"value": np.asarray([json.dumps(e) for e in evs], object)}
    kw = dict(rewards={"reward": "_label_cost", "p": "_label_probability"})
    jo = J.DSJsonTransformer(**kw).transform(JDataset(cols))
    to = T.DSJsonTransformer(**kw).transform(TDataset(cols))
    assert list(to["EventId"]) == list(jo["EventId"])
    assert json.dumps(list(to["rewards"])) == json.dumps(list(jo["rewards"]))
    np.testing.assert_array_equal(to["probLog"], jo["probLog"])
    np.testing.assert_array_equal(to["chosenActionIndex"],
                                  jo["chosenActionIndex"])


def test_policy_eval_equals_jax():
    rng = np.random.default_rng(32)
    n = 300
    r = rng.uniform(0, 1, n)
    pl = rng.uniform(0.2, 0.8, n)
    pt = rng.uniform(0.1, 0.9, n)
    for fn in ("ips", "snips", "cressie_read"):
        assert getattr(T, fn)(r, pl, pt) == getattr(J, fn)(r, pl, pt)
    assert T.bernstein_bound(r, pl, pt) == J.bernstein_bound(r, pl, pt)
    assert T.CressieReadInterval().interval(r, pl, pt) == \
        J.CressieReadInterval().interval(r, pl, pt)
    cols = {"reward": r, "probLog": pl, "probPred": pt,
            "count": rng.integers(1, 3, n)}
    jo = J.PolicyEvalTransformer().transform(JDataset(cols))
    to = T.PolicyEvalTransformer().transform(TDataset(cols))
    assert to.columns == jo.columns
    for c in jo.columns:
        np.testing.assert_array_equal(to[c], jo[c])


def _vw_corpus(n=200, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        cls = rng.integers(0, 2)
        lines.append(f"{1 if cls else -1} |w {'pos' if cls else 'neg'} "
                     f"n{rng.integers(0, 5)}:{rng.uniform(0.5, 2):.3f}")
    return np.asarray(lines, object)


@pytest.mark.parametrize("loss", ["logistic", "squared", "hinge"])
def test_online_generic_equals_jax(loss):
    lines = _vw_corpus()
    kw = dict(lossFunction=loss, numPasses=3, numBits=10, hashSeed=7)
    jm = J.OnlineGeneric(**kw).fit(JDataset({"value": lines}))
    tm = T.OnlineGeneric(device="cpu", **kw).fit(TDataset({"value": lines}))
    for f, v in T.state_to_numpy(tm.get("state")).items():
        _close(v, np.asarray(getattr(jm.get("state"), f)))
    probe = np.asarray(["|w pos", "|w neg n3:1.5", "1 |w pos"], object)
    _close(tm.transform(TDataset({"value": probe}))["prediction"],
           jm.transform(JDataset({"value": probe}))["prediction"])


def test_online_generic_progressive_equals_jax():
    lines = _vw_corpus(n=150, seed=1)
    kw = dict(lossFunction="logistic", numBits=10, batchSize=16)
    jo = J.OnlineGenericProgressive(**kw).transform(JDataset({"value": lines}))
    to = T.OnlineGenericProgressive(device="cpu", **kw).transform(
        TDataset({"value": lines}))
    _close(to["prediction"], jo["prediction"])


def _bandit_rows(n=300, seed=21):
    rng = np.random.default_rng(seed)
    shared = rng.normal(size=(n, 2)).astype(np.float32)
    acts = np.eye(3, dtype=np.float32)
    rows = []
    for i in range(n):
        probs = np.array([0.5, 0.3, 0.2])
        a = rng.choice(3, p=probs)
        cost = {0: -shared[i, 0], 1: shared[i, 0], 2: 0.5}[a]
        rows.append({"shared": shared[i], "features": [acts[k] for k in
                                                       range(3)],
                     "chosenAction": a + 1, "label": np.float32(cost),
                     "probability": np.float32(probs[a])})
    return rows


@pytest.mark.parametrize("kw", [dict(numPasses=4),
                                dict(numPasses=2, useInteractions=False,
                                     ipsClip=3.0, epsilon=0.2)])
def test_contextual_bandit_equals_jax(kw, tmp_path):
    rows = _bandit_rows()
    jds, tds = JDataset.from_rows(rows), TDataset.from_rows(rows)
    jm = J.ContextualBandit(**kw).fit(jds)
    tm = T.ContextualBandit(device="cpu", **kw).fit(tds)
    for f, v in T.state_to_numpy(tm.state).items():
        _close(v, np.asarray(getattr(jm.state, f)))
    jo, to = jm.transform(jds), tm.transform(tds)
    _close(np.stack(to["prediction"]), np.stack(jo["prediction"]))
    assert (to["chosenActionOut"] == jo["chosenActionOut"]).mean() >= 0.99
    np.testing.assert_allclose(np.stack(to["probabilities"]).sum(1), 1.0)
    tm.save(str(tmp_path / "m"))
    from synapseml_tpu_torch.core.pipeline import load_stage
    back = load_stage(str(tmp_path / "m"))
    np.testing.assert_array_equal(np.stack(back.transform(tds)["prediction"]),
                                  np.stack(to["prediction"]))


def test_mesh_refused_for_generic_and_bandit():
    """Both take a ProcessMesh now; anything else is refused."""
    with pytest.raises(TypeError, match="ProcessMesh"):
        T.OnlineGeneric(device="cpu", mesh=object()).fit(
            TDataset({"value": _vw_corpus(20)}))
    with pytest.raises(TypeError, match="ProcessMesh"):
        T.ContextualBandit(device="cpu", mesh=object()).fit(
            TDataset.from_rows(_bandit_rows(20)))


def test_all_names_match_jax():
    """The package exports the reference's names, plus the two that carry
    states across the packages."""
    assert T.__all__[:4] == J.__all__[:4]
    assert set(T.__all__) - set(J.__all__) == {"state_from_jax",
                                               "state_to_numpy"}
