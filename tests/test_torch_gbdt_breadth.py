"""GBDT breadth in the port held against the JAX package on the CPU: the
lossguide grower (exact, against the JAX grower on its Pallas kernel in
interpret mode), the objectives and metrics, whole fits of every boosting
type, multiclass and the regression objectives, the estimators, and
models carried across.

The JAX package's CPU fit histograms f32 gradients by scatter-add, while
the port always builds the kernels' exact int8-limb histograms, so whole
fits agree to the quantization: the holdout metric within 0.005 and the
first split equal.  The grower, fed the same gradients, agrees node for
node.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import metrics as jmetrics
from synapseml_tpu.models.gbdt import objectives as jobj
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu.models.gbdt import trainer as jt
from synapseml_tpu.models.gbdt.estimators import GBDTClassifier as JClf
from synapseml_tpu.models.gbdt.estimators import GBDTRegressor as JReg
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.models.gbdt import metrics as tmetrics
from synapseml_tpu_torch.models.gbdt import objectives as tobj
from synapseml_tpu_torch.models.gbdt import trainer as tt
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
from synapseml_tpu_torch.models.gbdt.convert import booster_from_reference
from synapseml_tpu_torch.models.gbdt.estimators import (GBDTClassifier,
                                                        GBDTRegressor)

from test_benchmark_fixtures import TOLERANCE, _load_fixture_values
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

# -- the lossguide grower -----------------------------------------------------


def _grow_setup(seed, N, F, B, rows, fmask_off):
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, B, (F, N)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    hess = (np.abs(grad) * 0.5 + 0.2).astype(np.float32)
    if rows == "bag":
        rv = (rng.random(N) < 0.8).astype(np.float32)
    elif rows == "goss":
        # GOSS weights: 1 for the top rows, (1 - a) / b for the sampled
        # rest, 0 elsewhere
        top = np.abs(grad) >= np.quantile(np.abs(grad), 0.8)
        rv = np.where(top, 1.0, np.where(rng.random(N) < 0.1, 8.0, 0.0))
        rv = rv.astype(np.float32)
    else:
        rv = np.ones(N, np.float32)
    fmask = np.ones(F, bool)
    fmask[list(fmask_off)] = False
    ub = np.sort(rng.normal(size=(F, B - 1)).astype(np.float32), axis=1)
    nb = rng.integers(B // 2, B + 1, F).astype(np.int32)
    return bins_t, grad, hess, rv, fmask, ub, nb


GROW_CASES = {
    "plain": (dict(B=64, rows="all", fmask_off=()), dict()),
    "two_level": (dict(B=256, rows="all", fmask_off=()),
                  dict(two_level="on", refine_k=4)),
    "two_level_off": (dict(B=256, rows="all", fmask_off=()),
                      dict(two_level="off", refine_k=4)),
    "bag_mask": (dict(B=64, rows="bag", fmask_off=()), dict()),
    "goss_weights": (dict(B=256, rows="goss", fmask_off=()),
                     dict(two_level="on", refine_k=4)),
    "feature_mask": (dict(B=64, rows="all", fmask_off=(1, 4)),
                     dict(lambda_l1=0.5, lambda_l2=1.0, max_depth=5)),
}


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_lossguide_grower_matches_jax_interpret(case):
    shape, extra = GROW_CASES[case]
    arrays = _grow_setup(5, N=4096, F=9, **shape)
    pkw = dict(num_leaves=15, min_data_in_leaf=5.0,
               total_bins=shape["B"], **extra)
    t_j, nid_j = jt.grow_tree(*[jnp.asarray(a) for a in arrays], 0.1,
                              p=jt.GrowthParams(**pkw),
                              use_pallas="interpret")
    t_t, nid_t = tt.grow_tree(*[torch.from_numpy(a) for a in arrays], 0.1,
                              tt.GrowthParams(**pkw))
    n = int(t_j.num_nodes)
    assert int(t_t.num_nodes) == n and n > 9
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_j))
    for f in ("split_feature", "split_bin", "left_child", "right_child",
              "threshold"):
        np.testing.assert_array_equal(getattr(t_t, f).numpy()[:n],
                                      np.asarray(getattr(t_j, f))[:n],
                                      err_msg=f)
    for f in ("leaf_value", "node_value", "node_count"):
        np.testing.assert_allclose(getattr(t_t, f).numpy()[:n],
                                   np.asarray(getattr(t_j, f))[:n],
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(t_t.split_gain.numpy()[:n],
                               np.asarray(t_j.split_gain)[:n], rtol=1e-6)


def test_predict_binned_tree_matches_jax():
    """DART's rescoring traversal on the binned matrix."""
    from synapseml_tpu.models.gbdt.booster import _predict_binned_tree
    arrays = _grow_setup(3, N=2048, F=6, B=64, rows="all", fmask_off=())
    tree, _ = tt.grow_tree(*[torch.from_numpy(a) for a in arrays], 0.3,
                           tt.GrowthParams(num_leaves=15, total_bins=64,
                                           min_data_in_leaf=5.0))
    got = tt.predict_binned_tree(torch.from_numpy(arrays[0]), tree, 15)
    want = _predict_binned_tree(jnp.asarray(arrays[0]),
                                jt.Tree(*[jnp.asarray(a.numpy())
                                          for a in tree]), 15,
                                total_bins=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- objectives and metrics ---------------------------------------------------

OBJ_KW = {"huber": dict(alpha=0.7), "quantile": dict(alpha=0.3),
          "fair": dict(c=1.5), "tweedie": dict(rho=1.3)}


@pytest.mark.parametrize("name", sorted(tobj.OBJECTIVES))
def test_objective_matches_reference(name):
    rng = np.random.default_rng(1)
    s = rng.normal(size=500).astype(np.float32)
    y = (np.abs(rng.normal(size=500)) * 2).astype(np.float32)
    if name == "binary":
        y = (y > 1).astype(np.float32)
    w = rng.uniform(0.5, 2, 500).astype(np.float32)
    kw = OBJ_KW.get(name, {})
    jg, jh = jobj.get_objective(name)(jnp.asarray(s), jnp.asarray(y),
                                      jnp.asarray(w), **kw)
    tg, th = tobj.get_objective(name)(torch.from_numpy(s),
                                      torch.from_numpy(y),
                                      torch.from_numpy(w), **kw)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tobj.initial_score(name, y, w),
                               jobj.initial_score(name, y, w), rtol=1e-12)


@pytest.mark.parametrize("ova", [False, True])
def test_multiclass_grad_hess_matches_reference(ova):
    """Softmax and the multiclassova sigmoid branch (the JAX package's
    step, ``booster.py``)."""
    import jax
    rng = np.random.default_rng(2)
    s = rng.normal(size=(400, 4)).astype(np.float32)
    lab = rng.integers(0, 4, 400)
    oh = np.eye(4, dtype=np.float32)[lab]
    w = rng.uniform(0.5, 2, 400).astype(np.float32)
    if ova:
        pk = jax.nn.sigmoid(jnp.asarray(s))
        jg = (pk - oh) * w[:, None]
        jh = jnp.maximum(pk * (1.0 - pk), 1e-16) * w[:, None]
        tg, th = tobj.ova_grad_hess(torch.from_numpy(s), torch.from_numpy(oh),
                                    torch.from_numpy(w))
    else:
        jg, jh = jobj.softmax_grad_hess(jnp.asarray(s), jnp.asarray(oh),
                                        jnp.asarray(w))
        tg, th = tobj.softmax_grad_hess(torch.from_numpy(s),
                                        torch.from_numpy(oh),
                                        torch.from_numpy(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)


@pytest.mark.parametrize("name", sorted(tmetrics.METRICS))
def test_metric_matches_reference(name):
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 2, 300)
    if name.startswith("multi"):
        y = rng.integers(0, 3, 300).astype(np.float64)
        m = rng.normal(size=(300, 3))
    else:
        y = (rng.random(300) < 0.4).astype(np.float64) * rng.uniform(
            0.5, 3, 300)
        if name in ("auc", "binary_logloss", "binary_error"):
            y = (y > 0).astype(np.float64)
        m = rng.normal(size=300)
    for ww in (None, w):
        got = tmetrics.METRICS[name][0](y, m, ww)
        want = jmetrics.METRICS[name][0](y, m, ww)
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    assert tmetrics.METRICS[name][1] == jmetrics.METRICS[name][1]


@pytest.mark.parametrize("objective,K", [
    ("binary", 1), ("multiclass", 3), ("multiclassova", 3),
    ("regression_l1", 1), ("mae", 1), ("huber", 1), ("poisson", 1)])
def test_default_metric_matches_reference(objective, K):
    assert (tmetrics.default_metric(objective, K)
            == jmetrics.default_metric(objective, K))


# -- whole fits against the JAX package ---------------------------------------


def _binary_data(n=3000, F=8, seed=0):
    """tests/test_benchmark_fixtures.py's binary task."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    logit = 2 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return X, y


def _three_class_data(n=3000, F=8, seed=0):
    """Three classes from the tertiles of the binary task's concept."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    s = 2 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3] + rng.normal(
        scale=0.5, size=n)
    return X, np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(
        np.float64)


def _regression_data(objective, n=3000, F=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    if objective == "poisson":
        y = np.exp(0.5 * X[:, 0] + 0.2 * X[:, 1]) * rng.gamma(2.0, 0.5, n)
    else:
        y = (0.3 * (2 * X[:, 0] + np.sin(X[:, 1]))
             + 0.1 * rng.normal(size=n))
        y[::50] += 3.0                               # outliers
    return X, y


def _fixture_cfg(boosting):
    """tests/test_benchmark_fixtures.py's fit."""
    return dict(objective="binary", boosting_type=boosting,
                num_iterations=30, num_leaves=15, learning_rate=0.2,
                min_data_in_leaf=5, bagging_fraction=0.8, bagging_freq=1,
                seed=7)


_SMALL = dict(num_iterations=20, num_leaves=15, learning_rate=0.2,
              min_data_in_leaf=5, seed=7)
FITS = {
    # the fixture fits: every boosting type with bagging 0.8
    "gbdt_bagging": ("binary", _fixture_cfg("gbdt")),
    "goss": ("binary", _fixture_cfg("goss")),
    "dart": ("binary", _fixture_cfg("dart")),
    "rf": ("binary", _fixture_cfg("rf")),
    "lossguide": ("binary", dict(objective="binary",
                                 growth_policy="lossguide",
                                 bagging_fraction=0.8, bagging_freq=2,
                                 **_SMALL)),
    "multiclass": ("multi", dict(objective="multiclass", num_class=3,
                                 **_SMALL)),
    "multiclassova": ("multi", dict(objective="multiclassova", num_class=3,
                                    **_SMALL)),
    "multiclass_dart_bagging": ("multi", dict(
        objective="multiclass", num_class=3, boosting_type="dart",
        bagging_fraction=0.8, bagging_freq=1, **_SMALL)),
    # huber's 1e-2 hessian on outliers makes a leaf of them alone jump by
    # lr * alpha / 1e-2: a hessian floor per leaf keeps both fits stable
    "huber": ("huber", dict(objective="huber", alpha=0.9,
                            min_sum_hessian_in_leaf=1.0, **_SMALL)),
    "poisson": ("poisson", dict(objective="poisson", **_SMALL)),
}


def _data(kind):
    if kind == "binary":
        return _binary_data()
    if kind == "multi":
        return _three_class_data()
    return _regression_data(kind)


def _holdout_metric(kind, y, margin):
    if kind == "binary":
        return tmetrics.auc(y, margin)
    if kind == "multi":
        return tmetrics.multi_logloss(y, margin)
    if kind == "poisson":
        return tmetrics.l2(y, np.exp(margin))
    return tmetrics.l2(y, margin)


@functools.lru_cache(maxsize=None)
def _fits(name):
    """(port booster, JAX booster, port metric, JAX metric) of one fit on
    2400 rows, measured on the 600 held out."""
    kind, cfg = FITS[name]
    X, y = _data(kind)
    tb, _ = ttrain(X[:2400], y[:2400], BoostingConfig(**cfg), device="cpu")
    jb, _ = jtrain(X[:2400], y[:2400], JConfig(**cfg))
    return (tb, jb, _holdout_metric(kind, y[2400:],
                                    tb.predict_margin(X[2400:])),
            _holdout_metric(kind, y[2400:], jb.predict_margin(X[2400:])))


@pytest.mark.parametrize("name", sorted(FITS))
def test_train_matches_jax(name):
    tb, jb, tm, jm = _fits(name)
    assert abs(tm - jm) <= 0.005, (tm, jm)
    assert len(tb.trees) == len(jb.trees)
    assert tb.tree_class == jb.tree_class
    for k in range(tb.num_class):
        assert tb.trees[k].split_feature[0] == jb.trees[k].split_feature[0]
        assert tb.trees[k].split_bin[0] == jb.trees[k].split_bin[0]
    if FITS[name][1].get("boosting_type") == "dart":
        assert any(w != 1.0 for w in tb.tree_weights)
    else:
        assert tb.tree_weights == jb.tree_weights


@pytest.mark.parametrize("boosting,fixture", [
    ("gbdt_bagging", "gbdt_binary_auc"), ("goss", "goss_binary_auc"),
    ("dart", "dart_binary_auc"), ("rf", "rf_binary_auc")])
def test_fixture_fits_within_tolerance(boosting, fixture):
    """The reference's pinned accuracy fixtures
    (tests/benchmarks/fixtures.csv), reached by the port's fits."""
    recorded = _load_fixture_values()[fixture]
    auc = _fits(boosting)[2]
    assert abs(auc - recorded) <= TOLERANCE, (auc, recorded)


def test_bagging_freq_holds_the_mask():
    """bagging_freq=3: the bag is drawn from ``fold_in(key, it // 3)``, so
    the trees of one window see the same rows: their roots count the same
    rows."""
    X, y = _binary_data()
    b, _ = ttrain(X, y, BoostingConfig(
        objective="binary", num_iterations=6, bagging_fraction=0.7,
        bagging_freq=3, bagging_seed=11), device="cpu")
    counts = [float(t.node_count[0]) for t in b.trees]
    assert counts[0] == counts[1] == counts[2] != counts[3]
    assert counts[3] == counts[4] == counts[5]
    assert 0.65 * len(y) < counts[0] < 0.75 * len(y)


def test_lossguide_two_level_fit_matches_jax_split_order():
    """growth_policy='lossguide' with two-level histograms on: the port's
    first tree against the JAX grower (in interpret mode) fed the port's
    first-iteration gradients."""
    X, y = _binary_data(n=4096)
    cfg = BoostingConfig(objective="binary", growth_policy="lossguide",
                         num_iterations=1, num_leaves=15, two_level_hist="on",
                         refine_features=4, min_data_in_leaf=5)
    b, _ = ttrain(X, y, cfg, device="cpu")
    assert b.config.two_level_hist == "on"
    from synapseml_tpu_torch.models.gbdt.binning import bin_features
    bins = bin_features(X, b.bin_mapper, torch.device("cpu")).numpy()
    from synapseml_tpu_torch.models.gbdt.booster import _grad_hess
    s0 = np.full(len(y), b.init_score[0], np.float32)
    g, h = _grad_hess(tobj.binary, torch.from_numpy(s0),
                      torch.from_numpy(y.astype(np.float32)),
                      torch.ones(len(y)))
    g = jnp.asarray(g.numpy()).astype(jnp.bfloat16)
    h = jnp.asarray(h.numpy()).astype(jnp.bfloat16)
    t_j, _ = jt.grow_tree(
        jnp.asarray(bins), g, h, jnp.ones(len(y)), jnp.ones(8, bool),
        jnp.asarray(b.bin_mapper.upper_bounds),
        jnp.asarray(b.bin_mapper.num_bins), 0.1,
        p=jt.GrowthParams(**cfg.growth_params()._asdict()),
        use_pallas="interpret")
    t = b.trees[0]
    n = int(t.num_nodes)
    assert n == int(t_j.num_nodes)
    np.testing.assert_array_equal(t.split_feature[:n],
                                  np.asarray(t_j.split_feature)[:n])
    np.testing.assert_array_equal(t.split_bin[:n],
                                  np.asarray(t_j.split_bin)[:n])
    # the root's total is the one sum whose order differs (XLA's reduce
    # against the port's pairwise scan); a chain of right-child
    # subtractions carries its last bit down to small leaves, so values
    # compare to 1e-4, as the depthwise grower's test holds them
    np.testing.assert_allclose(t.leaf_value[:n],
                               np.asarray(t_j.leaf_value)[:n], atol=1e-4)


# -- estimators ---------------------------------------------------------------


def test_multiclass_classifier_matches_jax():
    """A three-class label column makes the binary classifier multiclass,
    with the JAX package's output columns."""
    X, y = _three_class_data()
    y = y * 2 + 1                          # labels 1, 3, 5
    common = dict(numIterations=10, numLeaves=15, minDataInLeaf=5, seed=7)
    jm = JClf(numShards=1, **common).fit(
        JDataset({"features": list(X[:2400]), "label": y[:2400]}))
    tm = GBDTClassifier(device="cpu", **common).fit(
        TDataset({"features": list(X[:2400]), "label": y[:2400]}))
    jout = jm.transform(JDataset({"features": list(X[2400:])}))
    tout = tm.transform(TDataset({"features": list(X[2400:])}))
    assert tout.columns == jout.columns
    assert tm.booster.num_class == 3 and tm.numClasses == 3
    tp, jp = np.stack(tout["probability"]), np.stack(jout["probability"])
    assert tp.shape == (600, 3)
    lab = (y[2400:] - 1) / 2
    assert abs(tmetrics.multi_logloss(lab, np.log(tp))
               - tmetrics.multi_logloss(lab, np.log(jp))) <= 0.005
    assert set(np.unique(tout["prediction"])) <= {1.0, 3.0, 5.0}
    assert np.mean(np.asarray(tout["prediction"])
                   == np.asarray(jout["prediction"])) > 0.95


@pytest.mark.parametrize("objective", ["poisson", "huber"])
def test_regressor_matches_jax(objective):
    X, y = _regression_data(objective)
    common = dict(objective=objective, numIterations=20, numLeaves=15,
                  minDataInLeaf=5, minSumHessianInLeaf=1.0, seed=7)
    jm = JReg(numShards=1, **common).fit(
        JDataset({"features": list(X[:2400]), "label": y[:2400]}))
    tm = GBDTRegressor(device="cpu", **common).fit(
        TDataset({"features": list(X[:2400]), "label": y[:2400]}))
    jp = np.asarray(jm.transform(JDataset({"features": list(X[2400:])}))[
        "prediction"])
    tp = np.asarray(tm.transform(TDataset({"features": list(X[2400:])}))[
        "prediction"])
    if objective == "poisson":
        assert np.all(tp > 0)              # the exp link
    assert abs(tmetrics.l2(y[2400:], tp) - tmetrics.l2(y[2400:], jp)) <= 0.005


# -- models carried across ----------------------------------------------------


@pytest.mark.parametrize("name", ["multiclass", "multiclass_dart_bagging",
                                  "dart", "rf"])
def test_reference_model_predicts_same_margins(name):
    """Multiclass, DART-weighted and RF models of the JAX package predict
    the same margins in the port, and back."""
    from synapseml_tpu.models.gbdt.booster import Booster as JBooster
    _, jb, _, _ = _fits(name)
    X, _ = _data(FITS[name][0])
    tb = booster_from_reference(json.loads(json.dumps(jb.to_dict())),
                                device="cpu")
    assert tb.tree_class == jb.tree_class
    assert tb.tree_weights == jb.tree_weights
    jm = jb.predict_margin(X[2400:])
    np.testing.assert_allclose(tb.predict_margin(X[2400:]), jm, rtol=0,
                               atol=1e-5)
    back = JBooster.from_dict(json.loads(tb.to_json()))
    np.testing.assert_allclose(back.predict_margin(X[2400:]), jm, rtol=0,
                               atol=1e-5)


def test_lossguide_card_width_check_counts_one_slot():
    """A lossguide build holds one slot, so the card takes maxBin 1023 at
    31 leaves, which a depthwise wave of 16 slots does not fit.  The
    check needs no card."""
    from synapseml_tpu_torch.models.gbdt.booster import _check_ported_on
    wide = dict(max_bin=1023, num_leaves=31)
    _check_ported_on(BoostingConfig(growth_policy="lossguide", **wide),
                     torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="maxBin on the card"):
        _check_ported_on(BoostingConfig(**wide), torch.device("cuda"))


@pytest.mark.parametrize("kw,err", [
    (dict(boosting_type="bogus"), ValueError),
    (dict(growth_policy="bogus"), ValueError),
    (dict(objective="multiclass", num_class=1), ValueError),
    (dict(objective="bogus"), NotImplementedError),
])
def test_bad_config_raises(kw, err):
    X, y = _binary_data(n=200)
    with pytest.raises(err):
        ttrain(X, y, BoostingConfig(**{"objective": "binary", **kw}),
               device="cpu")
