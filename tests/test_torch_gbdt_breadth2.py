"""GBDT breadth II in the port held against the JAX package on the CPU:
validation sets and early stopping, checkpoints and warm starts,
categorical features, exclusive feature bundling (EFB) and monotone
constraints.

Whole fits cannot match the JAX package bit for bit on the CPU (it
histograms f32 gradients by scatter-add, the port builds the kernels'
exact int8-limb histograms), so they compare holdout metrics within
0.005; the growers, fed the same gradients as the JAX growers on their
Pallas kernels in interpret mode, compare node for node, and models and
checkpoints carried across predict the same margins within 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import binning as jbin
from synapseml_tpu.models.gbdt import booster as jbooster
from synapseml_tpu.models.gbdt import metrics as jmetrics
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu.models.gbdt import trainer as jt
from synapseml_tpu.models.gbdt.booster import Booster as JBooster
from synapseml_tpu.models.gbdt.estimators import GBDTClassifier as JClf
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.models.gbdt import binning as tbin
from synapseml_tpu_torch.models.gbdt import booster as tbooster
from synapseml_tpu_torch.models.gbdt import metrics as tmetrics
from synapseml_tpu_torch.models.gbdt import trainer as tt
from synapseml_tpu_torch.models.gbdt.booster import Booster as TBooster
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
from synapseml_tpu_torch.models.gbdt.estimators import (GBDTClassifier,
                                                        GBDTRegressor)

from test_gbdt_efb import onehot_data
from test_torch_gbdt_cuda import random_tree_arrays
from test_gbdt_monotone import CONS, max_violation, mono_data, sweep_margins
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

CPU = torch.device("cpu")


def _binary_data(n=3000, F=8, seed=0):
    """tests/test_benchmark_fixtures.py's binary task."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    logit = 2 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return X, y


def _same_trees(a, b):
    """Equal splits node for node, leaf values equal."""
    assert a.num_trees == b.num_trees
    for ta, tb in zip(a.trees, b.trees):
        for f in ("split_feature", "split_bin", "left_child", "right_child",
                  "leaf_value"):
            np.testing.assert_array_equal(np.asarray(getattr(ta, f)),
                                          np.asarray(getattr(tb, f)),
                                          err_msg=f)


# -- validation and early stopping --------------------------------------------


def _valid_margins(kind):
    """(labels, validation margins of a JAX-trained model, weights)."""
    if kind == "multi":
        rng = np.random.default_rng(4)
        X = rng.normal(size=(1500, 5)).astype(np.float32)
        y = np.digitize(X[:, 0] + X[:, 1] * X[:, 2],
                        [-0.5, 0.5]).astype(np.float64)
        cfg = JConfig(objective="multiclass", num_class=3,
                      num_iterations=4, num_leaves=7)
    elif kind == "binary":
        X, y = _binary_data(n=1500)
        cfg = JConfig(objective="binary", num_iterations=4, num_leaves=7)
    else:
        X, yb = _binary_data(n=1500)
        y = X[:, 0] * 2 + yb
        cfg = JConfig(objective="regression", num_iterations=4,
                      num_leaves=7)
    b, _ = jtrain(X[:1000], y[:1000], cfg)
    w = np.random.default_rng(1).uniform(0.5, 2, 500).astype(np.float32)
    return (y[1000:].astype(np.float32),
            np.asarray(b.predict_margin(X[1000:]), np.float32), w)


@pytest.mark.parametrize("name,kind", [
    ("auc", "binary"), ("binary_logloss", "binary"),
    ("binary_error", "binary"), ("multi_logloss", "multi"),
    ("multi_error", "multi"), ("l2", "reg"), ("rmse", "reg"), ("l1", "reg"),
    ("mape", "reg")])
@pytest.mark.parametrize("weighted", [False, True])
def test_device_metric_matches_jax(name, kind, weighted):
    """The port's device metric over a JAX-trained model's validation
    margins equals the JAX package's host metric."""
    y, m, w = _valid_margins(kind)
    w = w if weighted else None
    want = jmetrics.METRICS[name][0](y, m, w)
    fn, larger = tmetrics.DEVICE_METRICS[name]
    got = fn(torch.from_numpy(y), torch.from_numpy(m),
             None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float64 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6
    assert larger == jmetrics.METRICS[name][1]


@pytest.mark.parametrize("history,rounds,larger", [
    ([0.5, 0.4, 0.45, 0.41, 0.42, 0.39, 0.40, 0.40, 0.41, 0.38], 3, False),
    ([0.6, 0.7, 0.7, 0.69, 0.71, 0.71, 0.70, 0.70, 0.72, 0.73], 2, True),
    ([0.3] * 10, 4, False),
    ([0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1, 0.05], 1, False),
])
def test_early_stopping_rule_stops_where_jax_stops(monkeypatch, history,
                                                   rounds, larger):
    """Fed the same eval history (the JAX fit's metric scripted), the
    port's rule stops at the JAX fit's last iteration, with the same best
    iteration."""
    it = iter(history)
    monkeypatch.setitem(jmetrics.METRICS, "l2",
                        (lambda *_: next(it), larger))
    X, y = _binary_data(n=600)
    jb, jh = jtrain(X[:400], y[:400],
                    JConfig(objective="regression", num_iterations=10,
                            num_leaves=4, early_stopping_round=rounds),
                    valid=(X[400:], y[400:], None))
    stop = tbooster.EarlyStopping(rounds, larger)
    stopped = next((i for i, v in enumerate(history) if stop.update(i, v)),
                   len(history) - 1)
    assert [r.value for r in jh] == history[:stopped + 1]
    assert stop.best_iter == jb.best_iteration


@pytest.mark.parametrize("objective,metric", [
    ("binary", "auc"), ("binary", ""), ("regression", "l1")])
def test_early_stopped_fit_matches_jax(objective, metric):
    """A whole early-stopped fit: the holdout metric within 0.005 of the
    JAX fit's, the eval history one record an iteration."""
    X, y = _binary_data(n=5000, seed=3)
    if objective == "regression":
        y = X[:, 0] * 2 - X[:, 1] + y
    kw = dict(objective=objective, num_iterations=80, num_leaves=15,
              learning_rate=0.3, early_stopping_round=4, metric=metric)
    valid = (X[3000:4000], y[3000:4000], None)
    tb, th = ttrain(X[:3000], y[:3000], BoostingConfig(**kw), valid=valid,
                    device="cpu")
    jb, jh = jtrain(X[:3000], y[:3000], JConfig(**kw), valid=valid)
    assert len(th) == tb.num_trees and [r.iteration for r in th] == \
        list(range(len(th)))
    assert th[tb.best_iteration].value == (
        max if th[0].metric == "auc" else min)(r.value for r in th)
    name = th[0].metric
    assert name == jh[0].metric
    fn = tmetrics.METRICS[name][0]
    hold = slice(4000, None)
    assert abs(fn(y[hold], tb.predict_margin(X[hold]))
               - fn(y[hold], jb.predict_margin(X[hold]))) <= 0.005


def test_validation_indicator_col_through_the_estimator():
    """Rows flagged by ``validationIndicatorCol`` are evaluated, not
    trained on: the eval history and the holdout AUC agree with the JAX
    estimator's."""
    X, y = _binary_data(n=4000, seed=5)
    flag = np.arange(4000) >= 3000
    cols = {"features": list(X), "label": y, "isVal": flag}
    kw = dict(numIterations=150, numLeaves=31, learningRate=0.5,
              earlyStoppingRound=3, metric="auc",
              validationIndicatorCol="isVal")
    tm = GBDTClassifier(device="cpu", **kw).fit(TDataset(dict(cols)))
    jm = JClf(numShards=1, **kw).fit(JDataset(dict(cols)))
    th, jh = tm._eval_history, jm._eval_history
    assert th and th[0].metric == "auc"
    assert tm.booster.num_trees == len(th) < 150
    assert abs(len(th) - len(jh)) <= 3
    assert abs(max(r.value for r in th) - max(r.value for r in jh)) <= 0.005
    # the validation rows were not trained on: a fit on the training rows
    # alone grows the same first tree
    alone, _ = ttrain(X[:3000], y[:3000], BoostingConfig(
        objective="binary", num_iterations=1, num_leaves=31,
        learning_rate=0.5), device="cpu")
    np.testing.assert_array_equal(alone.trees[0].split_bin,
                                  tm.booster.trees[0].split_bin)


def test_validation_in_regressor_and_multiclass():
    X, y = _binary_data(n=3000, seed=6)
    flag = np.arange(3000) >= 2400
    r = GBDTRegressor(device="cpu", numIterations=6, numLeaves=7,
                      validationIndicatorCol="v", metric="l1").fit(
        TDataset({"features": list(X), "label": X[:, 0] + y, "v": flag}))
    assert [h.metric for h in r._eval_history] == ["l1"] * 6
    y3 = np.digitize(X[:, 0] + X[:, 1], [-0.5, 0.5]).astype(np.float64)
    m = GBDTClassifier(device="cpu", numIterations=4, numLeaves=7,
                       validationIndicatorCol="v").fit(
        TDataset({"features": list(X), "label": y3, "v": flag}))
    hist = m._eval_history
    assert [h.metric for h in hist] == ["multi_logloss"] * 4
    assert hist[-1].value < hist[0].value


@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_validation_of_dart_and_rf_matches_the_final_model(boosting):
    """The eval history's last value is the metric of the final model's
    own margins: DART's re-weighted trees and RF's average included."""
    X, y = _binary_data(n=3000, seed=8)
    kw = dict(objective="binary", num_iterations=6, num_leaves=7,
              boosting_type=boosting, metric="binary_logloss",
              bagging_fraction=0.7, bagging_freq=1, skip_drop=0.0,
              drop_rate=0.5)
    b, h = ttrain(X[:2000], y[:2000], BoostingConfig(**kw),
                  valid=(X[2000:], y[2000:], None), device="cpu")
    want = tmetrics.binary_logloss(y[2000:], b.predict_margin(X[2000:]))
    assert abs(h[-1].value - want) <= 1e-5


# -- checkpoints and warm starts ----------------------------------------------


def _ckpt_cfg(boosting, iters, cls=BoostingConfig):
    kw = dict(objective="binary", num_iterations=iters, num_leaves=7,
              min_data_in_leaf=5, boosting_type=boosting, seed=3)
    if boosting == "rf":
        kw.update(bagging_fraction=0.6, bagging_freq=1)
    return cls(**kw)


@pytest.mark.parametrize("boosting", ["gbdt", "goss", "rf"])
def test_resume_equals_uninterrupted(tmp_path, boosting):
    """Stopped after 6 of 12 iterations with checkpoints every 3, the
    resumed fit grows the uninterrupted fit's trees, tree for tree."""
    X, y = _binary_data(n=2000)
    ck = str(tmp_path / "ck")
    full, _ = ttrain(X, y, _ckpt_cfg(boosting, 12), device="cpu")
    ttrain(X, y, _ckpt_cfg(boosting, 6), checkpoint_dir=ck,
           checkpoint_interval=3, device="cpu")
    assert sorted(os.listdir(ck)) == ["iter_00000003.json",
                                      "iter_00000006.json"]
    resumed, _ = ttrain(X, y, _ckpt_cfg(boosting, 12), checkpoint_dir=ck,
                        checkpoint_interval=3, device="cpu")
    _same_trees(full, resumed)
    assert resumed.tree_weights == full.tree_weights
    np.testing.assert_array_equal(resumed.predict_margin(X),
                                  full.predict_margin(X))
    # asking for no more iterations than were trained returns the model
    again, hist = ttrain(X, y, _ckpt_cfg(boosting, 10), checkpoint_dir=ck,
                         checkpoint_interval=3, device="cpu")
    assert again.num_trees == 12 and hist == []
    # the newest three checkpoints are kept
    assert sorted(os.listdir(ck)) == ["iter_00000006.json",
                                      "iter_00000009.json",
                                      "iter_00000012.json"]


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint the JAX package writes resumes in the port, and one
    the port writes is read and resumed by the JAX package; the carried
    models predict the same margins in both."""
    X, y = _binary_data(n=1500)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrain(X, y, _ckpt_cfg("gbdt", 4, JConfig), checkpoint_dir=jdir,
           checkpoint_interval=2)
    with open(os.path.join(jdir, "iter_00000004.json")) as f:
        j4 = JBooster.from_string(f.read())
    t4 = tbooster._latest_checkpoint(jdir, "cpu")
    np.testing.assert_allclose(t4.predict_margin(X), j4.predict_margin(X),
                               rtol=0, atol=1e-5)
    resumed, _ = ttrain(X, y, _ckpt_cfg("gbdt", 8), checkpoint_dir=jdir,
                        checkpoint_interval=2, device="cpu")
    assert resumed.num_trees == 8
    for a, b in zip(resumed.trees[:4], j4.trees):
        np.testing.assert_array_equal(a.split_bin, np.asarray(b.split_bin))

    ttrain(X, y, _ckpt_cfg("gbdt", 4), checkpoint_dir=tdir,
           checkpoint_interval=2, device="cpu")
    with open(os.path.join(tdir, "iter_00000004.json")) as f:
        text = f.read()
    back = JBooster.from_string(text)
    np.testing.assert_allclose(back.predict_margin(X),
                               TBooster.from_json(text, "cpu")
                               .predict_margin(X), rtol=0, atol=1e-5)
    jres, _ = jtrain(X, y, _ckpt_cfg("gbdt", 6, JConfig),
                     checkpoint_dir=tdir, checkpoint_interval=2)
    assert jres.num_trees == 6
    assert json.loads(text)["config"]["pass_through"] == {
        "_codec_wire_key": None, "_fused_ingest": True,
        "_fit_world_size": 1}


def test_resume_guards_refuse_another_ingest(tmp_path):
    X, y = _binary_data(n=800)
    ck = str(tmp_path / "ck")
    ttrain(X, y, _ckpt_cfg("gbdt", 2), checkpoint_dir=ck,
           checkpoint_interval=2, device="cpu")
    cfg = _ckpt_cfg("gbdt", 4)
    cfg.fused_ingest = False
    with pytest.raises(ValueError, match="fused_ingest"):
        ttrain(X, y, cfg, checkpoint_dir=ck, checkpoint_interval=2,
               device="cpu")
    assert tbooster._effective_wire_key(cfg) is None
    assert jbooster._effective_wire_key(_ckpt_cfg("gbdt", 4, JConfig),
                                        None) is None


def test_init_model_warm_start_continues_the_margin():
    """A warm start from a 5-tree model grows the 5 trees the 10-tree fit
    grows after its first 5 (gbdt without bagging)."""
    X, y = _binary_data(n=1500)
    full, _ = ttrain(X, y, _ckpt_cfg("gbdt", 10), device="cpu")
    first, _ = ttrain(X, y, _ckpt_cfg("gbdt", 5), device="cpu")
    more, _ = ttrain(X, y, _ckpt_cfg("gbdt", 5), init_model=first,
                     device="cpu")
    _same_trees(full, more)


def test_num_batches_matches_jax():
    X, y = _binary_data(n=3600, seed=9)
    kw = dict(numIterations=8, numLeaves=15, numBatches=3)
    tr = {"features": list(X[:3000]), "label": y[:3000]}
    tm = GBDTClassifier(device="cpu", **kw).fit(TDataset(dict(tr)))
    jm = JClf(numShards=1, **kw).fit(JDataset(dict(tr)))
    assert tm.booster.num_trees == 24 == jm.booster.num_trees
    hold = X[3000:]
    assert abs(tmetrics.auc(y[3000:], tm.booster.predict_margin(hold))
               - tmetrics.auc(y[3000:], jm.booster.predict_margin(hold))
               ) <= 0.005


def test_checkpoint_dir_with_num_batches_raises(tmp_path):
    X, y = _binary_data(n=300)
    ds = TDataset({"features": list(X), "label": y})
    with pytest.raises(ValueError, match="numBatches"):
        GBDTClassifier(device="cpu", numIterations=2, numBatches=3,
                       checkpointDir=str(tmp_path), checkpointInterval=1
                       ).fit(ds)
    # a checkpoint manager is a checkpoint directory: the same refusal
    from synapseml_tpu_torch.core.checkpoint import CheckpointManager
    with pytest.raises(ValueError, match="numBatches"):
        GBDTClassifier(device="cpu", numIterations=2, numBatches=3,
                       checkpointManager=CheckpointManager(
                           str(tmp_path / "m")), checkpointInterval=1
                       ).fit(ds)


# -- categorical features -----------------------------------------------------


def _cat_data(n=4000, seed=0, levels=(30, 300)):
    """Two categorical columns (codes) among numeric ones; the label
    depends on category subsets."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[:, 1] = rng.integers(0, levels[0], n)
    X[:, 3] = rng.integers(0, levels[1], n)
    s = (X[:, 1] % 3 == 0) * 1.5 - (X[:, 3] % 5 == 1) * 1.2 + X[:, 0]
    y = (s + rng.normal(scale=0.5, size=n) > 0.3).astype(np.float64)
    return X, y


@pytest.mark.parametrize("max_bin,seed", [(255, 0), (63, 1), (15, 2)])
def test_bin_features_categorical_matches_transform(max_bin, seed):
    """Categorical binning on the device equals ``BinMapper.transform``,
    unseen categories and NaN included (bin 0); beyond ``max_bin``
    categories the rarest fall into bin 0."""
    X, y = _cat_data(n=3000, seed=seed)
    X[::17, 1] = np.nan
    fit = X[:2000]
    jm = jbin.fit_bin_mapper(fit, max_bin, categorical_features=[1, 3],
                             y=y[:2000])
    tm = tbin.fit_bin_mapper(fit, max_bin, categorical_features=[1, 3],
                             y=y[:2000])
    X[2000:2050, 1] = 1000.0                          # unseen categories
    X[2050:2100, 3] = -7.0
    got = tbin.bin_features(X, tm, CPU).numpy()
    np.testing.assert_array_equal(got, jm.transform(X).T)
    assert (got[1, 2000:2050] == 0).all() and (got[1, ::17] == 0).all()


def test_reference_categorical_model_predicts_same_margins():
    X, y = _cat_data()
    jb, _ = jtrain(X[:3000], y[:3000], JConfig(
        objective="binary", num_iterations=10, num_leaves=15,
        categorical_feature=[1, 3]))
    tb = TBooster.from_dict(json.loads(json.dumps(jb.to_dict())), "cpu")
    Xh = X[3000:].copy()
    Xh[:20, 1] = 99.0                                 # unseen
    Xh[20:40, 3] = np.nan
    np.testing.assert_allclose(tb.predict_margin(Xh),
                               np.asarray(jb.predict_margin(Xh)), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tb.predict_leaf(Xh),
                                  np.asarray(jb.predict_leaf(Xh)))
    back = JBooster.from_dict(json.loads(tb.to_json()))
    np.testing.assert_allclose(np.asarray(back.predict_margin(Xh)),
                               tb.predict_margin(Xh), rtol=0, atol=1e-5)


@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_categorical_fit_matches_jax(policy):
    X, y = _cat_data(seed=4)
    kw = dict(objective="binary", num_iterations=15, num_leaves=15,
              categorical_feature=[1, 3], growth_policy=policy)
    tb, _ = ttrain(X[:3000], y[:3000], BoostingConfig(**kw), device="cpu")
    jb, _ = jtrain(X[:3000], y[:3000], JConfig(**kw))
    assert tb.bin_mapper.has_categorical
    ta = tmetrics.auc(y[3000:], tb.predict_margin(X[3000:]))
    ja = tmetrics.auc(y[3000:], np.asarray(jb.predict_margin(X[3000:])))
    assert ta > 0.8 and abs(ta - ja) <= 0.005


def test_categorical_slot_indexes_through_the_estimator():
    X, y = _cat_data(seed=5)
    m = GBDTClassifier(device="cpu", numIterations=10, numLeaves=15,
                       categoricalSlotIndexes=[1, 3]).fit(
        TDataset({"features": list(X[:3000]), "label": y[:3000]}))
    assert set(m.booster.bin_mapper.cat_features) == {1, 3}
    out = m.transform(TDataset({"features": list(X[3000:])}))
    assert tmetrics.auc(y[3000:],
                        np.stack(out["probability"])[:, 1]) > 0.8


# -- EFB ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,conflict,max_bin", [
    (0, 0.0, 255), (1, 0.0, 63), (2, 0.02, 255), (3, 0.1, 31)])
def test_feature_bundler_matches_jax(seed, conflict, max_bin):
    X, _ = onehot_data(n=3000, seed=seed)
    mapper = jbin.fit_bin_mapper(X, max_bin)
    binned = mapper.transform(X)
    jb = jbin.FeatureBundler.fit(binned[:2000], mapper.num_bins,
                                 max_total_bins=max_bin + 1,
                                 max_conflict_rate=conflict)
    tb = tbin.FeatureBundler.fit(binned[:2000], mapper.num_bins,
                                 max_total_bins=max_bin + 1,
                                 max_conflict_rate=conflict)
    for f in ("bundle_of", "offset_of", "default_bin", "num_bins"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    assert tb.num_bundles < X.shape[1]
    got = tbin.bundle_bins(torch.from_numpy(binned.T.copy()), tb)
    np.testing.assert_array_equal(got.numpy(), jb.transform(binned).T)
    for k, v in jb.route_tables(mapper.num_bins, max_bin + 1).items():
        np.testing.assert_array_equal(
            tb.route_tables(mapper.num_bins, max_bin + 1)[k], v)


def _bundle_map(seed=0, max_bin=63):
    X, _ = onehot_data(n=2000, seed=seed)
    mapper = jbin.fit_bin_mapper(X, max_bin)
    b = jbin.FeatureBundler.fit(mapper.transform(X), mapper.num_bins,
                                max_total_bins=max_bin + 1)
    return {k: v.astype(np.int32) for k, v in
            b.route_tables(mapper.num_bins, max_bin + 1).items()}, b


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_route_params_matches_jax(seed):
    bm, _ = _bundle_map(seed)
    rng = np.random.default_rng(seed)
    F = len(bm["col"])
    feat = rng.integers(0, F, 64).astype(np.int32)
    tbin_ = rng.integers(0, 12, 64).astype(np.int32)
    for m in (None, bm):
        want = jt._slot_route_params(
            jnp.asarray(feat), jnp.asarray(tbin_), 64,
            None if m is None else {k: jnp.asarray(v) for k, v in m.items()})
        got = tt._slot_route_params(
            torch.from_numpy(feat), torch.from_numpy(tbin_), 64,
            None if m is None else {k: torch.from_numpy(v)
                                    for k, v in m.items()})
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_unbundle_hists_matches_jax(lead):
    """Integer-valued f32 histograms, so every sum is exact and the two
    packages agree bit for bit."""
    bm, b = _bundle_map(2)
    rng = np.random.default_rng(3)
    hists = rng.integers(-50, 50, lead + (b.num_bundles, 64, 3)).astype(
        np.float32)
    tot = rng.integers(0, 1000, lead + (3,)).astype(np.float32)
    want = jt._unbundle_hists(jnp.asarray(hists), jnp.asarray(
        bm["gather_src"]), jnp.asarray(tot))
    got = tt._unbundle_hists(torch.from_numpy(hists), torch.from_numpy(
        bm["gather_src"]), torch.from_numpy(tot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_efb_fit_equals_unbundled(policy, boosting):
    """The JAX package's EFB property (tests/test_gbdt_efb.py), held by
    the port against its own unbundled fit, and in fact exceeded: the
    growers unbundle in the kernels' int limb space, where the default
    bin's residual is exact, so the trees and margins are equal."""
    X, y = onehot_data(n=2500)
    kw = dict(objective="binary", num_iterations=8, num_leaves=15,
              min_data_in_leaf=5, growth_policy=policy,
              boosting_type=boosting, skip_drop=0.0, drop_rate=0.5)
    plain, _ = ttrain(X, y, BoostingConfig(**kw), device="cpu")
    efb, _ = ttrain(X, y, BoostingConfig(enable_bundle=True, **kw),
                    device="cpu")
    assert efb.bundler is not None and efb.bundler.num_bundles < 20
    for tp, te in zip(plain.trees, efb.trees):
        np.testing.assert_array_equal(tp.split_feature, te.split_feature)
        assert np.abs(tp.split_bin - te.split_bin).max() <= 1
    np.testing.assert_allclose(plain.predict_margin(X[:512]),
                               efb.predict_margin(X[:512]), atol=1e-3)
    _same_trees(plain, efb)


def test_efb_grower_routes_through_bundle_ranges(monkeypatch):
    """Under EFB every wave after the root hands K2 the bundled columns
    and each split feature's range inside its bundle."""
    seen = []
    real = tt.route_and_hist_ids_limbs

    def spy(bins_t, node_id, leaf, feat, t1, rlo, rhi, dflt, l_id, *a,
            **k):
        # the root pass is a degenerate all-left split into child id 0
        seen.append((bins_t.shape[0], int(rlo.min()),
                     int(l_id.max()) == 0))
        return real(bins_t, node_id, leaf, feat, t1, rlo, rhi, dflt, l_id,
                    *a, **k)
    monkeypatch.setattr(tt, "route_and_hist_ids_limbs", spy)
    X, y = onehot_data(n=2500)
    b, _ = ttrain(X, y, BoostingConfig(objective="binary", num_iterations=2,
                                       num_leaves=31, min_data_in_leaf=5,
                                       enable_bundle=True), device="cpu")
    Fb = b.bundler.num_bundles
    roots = [s for s in seen if s[2]]
    waves = [s for s in seen if not s[2]]
    assert roots == [(Fb, -1, True)] * 2              # all rows left
    assert waves and all(s[0] == Fb and s[1] >= 0 for s in waves)


def test_reference_efb_model_predicts_same_margins():
    X, y = onehot_data(n=2500, seed=1)
    jb, _ = jtrain(X, y, JConfig(objective="binary", num_iterations=6,
                                 num_leaves=15, min_data_in_leaf=5,
                                 enable_bundle=True))
    tb = TBooster.from_dict(json.loads(json.dumps(jb.to_dict())), "cpu")
    assert tb.bundler.num_bundles == jb.bundler.num_bundles
    np.testing.assert_allclose(tb.predict_margin(X),
                               np.asarray(jb.predict_margin(X)), rtol=0,
                               atol=1e-5)
    back = JBooster.from_dict(json.loads(tb.to_json()))
    assert back.bundler.num_bundles == tb.bundler.num_bundles


def test_efb_through_the_estimator_matches_jax():
    X, y = onehot_data(n=3000, seed=2)
    kw = dict(numIterations=10, numLeaves=15, minDataInLeaf=5,
              enableBundle=True)
    tr = {"features": list(X[:2400]), "label": y[:2400]}
    tm = GBDTClassifier(device="cpu", **kw).fit(TDataset(dict(tr)))
    jm = JClf(numShards=1, **kw).fit(JDataset(dict(tr)))
    assert tm.booster.bundler.num_bundles == jm.booster.bundler.num_bundles
    assert abs(tmetrics.auc(y[2400:], tm.booster.predict_margin(X[2400:]))
               - tmetrics.auc(y[2400:], np.asarray(
                   jm.booster.predict_margin(X[2400:])))) <= 0.005


# -- monotone constraints -----------------------------------------------------


def _mono_grow_setup(seed=5, N=4096, F=6, B=64):
    """Bins with a non-monotone signal on features 0 and 1, so the
    constraints bind."""
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, B, (F, N)).astype(np.int32)
    x0, x1 = bins_t[0] / B * 4 - 2, bins_t[1] / B * 4 - 2
    grad = -(1.2 * x0 + 1.5 * np.sin(3 * x0) - x1 + 1.2 * np.sin(4 * x1)
             + 0.3 * (bins_t[3] / B * 4 - 2) ** 2
             + rng.normal(0, 0.3, N)).astype(np.float32)
    hess = np.ones(N, np.float32)
    ub = np.sort(rng.normal(size=(F, B - 1)).astype(np.float32), axis=1)
    nb = rng.integers(B // 2, B + 1, F).astype(np.int32)
    return (bins_t, grad, hess, np.ones(N, np.float32), np.ones(F, bool),
            ub, nb)


@pytest.mark.parametrize("method", ["basic", "intermediate", "advanced"])
@pytest.mark.parametrize("grower", ["depthwise", "lossguide"])
@pytest.mark.parametrize("penalty", [0.0, 1.0])
def test_monotone_grower_matches_jax_interpret(method, grower, penalty):
    """Fed the same gradients, the port's grower equals the JAX grower
    on its Pallas kernel in interpret mode node for node."""
    arrays = _mono_grow_setup()
    pkw = dict(num_leaves=15, min_data_in_leaf=5.0, total_bins=64,
               monotone_constraints=(1, -1, 0, 0, 0, 0),
               monotone_method=method, monotone_penalty=penalty)
    ja = [jnp.asarray(a) for a in arrays]
    ta = [torch.from_numpy(a) for a in arrays]
    if grower == "lossguide":
        t_j, nid_j = jt.grow_tree(*ja, 0.1, p=jt.GrowthParams(**pkw),
                                  use_pallas="interpret")
        t_t, nid_t = tt.grow_tree(*ta, 0.1, tt.GrowthParams(**pkw))
    else:
        t_j, nid_j = jt.grow_tree_depthwise(
            *ja, 0.1, p=jt.GrowthParams(**pkw), use_pallas="interpret",
            n_slots=8)
        t_t, nid_t = tt.grow_tree_depthwise(*ta, 0.1, tt.GrowthParams(**pkw),
                                            n_slots=8)
    n = int(t_j.num_nodes)
    assert int(t_t.num_nodes) == n and n > 9
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_j))
    for f in ("split_feature", "split_bin", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(t_t, f).numpy()[:n],
                                      np.asarray(getattr(t_j, f))[:n],
                                      err_msg=f)
    for f in ("leaf_value", "node_value"):
        np.testing.assert_allclose(getattr(t_t, f).numpy()[:n],
                                   np.asarray(getattr(t_j, f))[:n],
                                   rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
@pytest.mark.parametrize("seed", [2, 7])
def test_tree_bounds_match_jax(method, seed):
    """The whole-tree refresh over a grown tree, on random node values."""
    arrays = _mono_grow_setup(seed=seed)
    p = dict(num_leaves=15, min_data_in_leaf=5.0, total_bins=64,
             monotone_constraints=(1, -1, 0, 0, 0, 0),
             monotone_method=method)
    t, _ = tt.grow_tree(*[torch.from_numpy(a) for a in arrays], 1.0,
                        tt.GrowthParams(**p))
    raw = np.random.default_rng(seed).normal(size=30).astype(np.float32)
    mono = np.asarray(p["monotone_constraints"], np.int32)
    got = tt._tree_bounds(t.split_feature, t.split_bin, t.left_child,
                          t.right_child, torch.from_numpy(raw),
                          torch.from_numpy(mono), tt.GrowthParams(**p))
    want = jt._tree_bounds(*[jnp.asarray(a.numpy()) for a in (
        t.split_feature, t.split_bin, t.left_child, t.right_child)],
        jnp.asarray(raw), jnp.asarray(mono), jt.GrowthParams(**p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("method", ["basic", "intermediate", "advanced"])
@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_monotone_fit_has_no_sweep_violation(method, policy):
    X, y = mono_data(n=3000)
    kw = dict(objective="regression", num_iterations=12, num_leaves=15,
              min_data_in_leaf=5, growth_policy=policy)
    free, _ = ttrain(X, y, BoostingConfig(**kw), device="cpu")
    mono, _ = ttrain(X, y, BoostingConfig(
        monotone_constraints=CONS, monotone_constraints_method=method,
        **kw), device="cpu")
    assert max_violation(sweep_margins(free, 0), +1) > 1e-3
    assert max_violation(sweep_margins(mono, 0), +1) <= 1e-6
    assert max_violation(sweep_margins(mono, 1), -1) <= 1e-6
    jb, _ = jtrain(X, y, JConfig(monotone_constraints=CONS,
                                 monotone_constraints_method=method, **kw))
    Xh, yh = mono_data(n=1000, seed=9)
    assert abs(tmetrics.l2(yh, mono.predict_margin(Xh))
               - tmetrics.l2(yh, np.asarray(jb.predict_margin(Xh)))) <= 0.05


def test_monotone_composes_with_efb():
    rng = np.random.default_rng(3)
    X, y = mono_data(n=2500)
    oh = np.eye(8, dtype=np.float32)[rng.integers(0, 8, len(X))]
    Xc = np.concatenate([X, oh], axis=1)
    kw = dict(objective="regression", num_iterations=6, num_leaves=15,
              min_data_in_leaf=5, monotone_constraints=CONS + [0] * 8)
    plain, _ = ttrain(Xc, y, BoostingConfig(**kw), device="cpu")
    efb, _ = ttrain(Xc, y, BoostingConfig(enable_bundle=True, **kw),
                    device="cpu")
    _same_trees(plain, efb)


def test_monotone_config_errors_match_jax():
    """tests/test_gbdt_monotone.py's config errors, raised the same."""
    X, y = mono_data(n=500)
    bad = [(dict(monotone_constraints=[1, -1]), "entries"),
           (dict(monotone_constraints=[2, 0, 0, 0]), "-1, 0, or 1"),
           (dict(monotone_constraints=CONS,
                 monotone_constraints_method="strict"),
            "monotone_constraints_method"),
           (dict(monotone_constraints=CONS, categorical_feature=[0]),
            "categorical"),
           (dict(monotone_constraints=CONS,
                 monotone_constraints_method="advanced",
                 pass_through={"advanced_mask_bytes": 1000}), "budget")]
    for kw, match in bad:
        cfg = dict(objective="regression", num_iterations=1, **kw)
        with pytest.raises(ValueError, match=match):
            ttrain(X, y, BoostingConfig(**cfg), device="cpu")
        with pytest.raises(ValueError, match=match):
            jtrain(X, y, JConfig(**cfg))


@pytest.mark.parametrize("meminfo,free_pages", [
    ("MemTotal: 99999999 kB\nMemAvailable: 8000000 kB\n", 10_000),
    (None, 3_000_000), (None, None)])
def test_advanced_mask_budget_matches_jax(monkeypatch, meminfo, free_pages):
    """The advanced method's mask budget reads the host as the JAX
    package does: /proc/meminfo's MemAvailable, then sysconf's free
    pages, then nothing (the 1 GiB floor)."""
    import io

    def fake_open(path, *a, **k):
        if meminfo is None:
            raise OSError(path)
        return io.StringIO(meminfo)

    def fake_sysconf(name):
        if free_pages is None:
            raise ValueError(name)
        return free_pages if name == "SC_AVPHYS_PAGES" else 4096

    monkeypatch.setattr(os, "sysconf", fake_sysconf)
    for mod in (tbooster, jbooster):
        monkeypatch.setattr(mod, "open", fake_open, raising=False)
    want = jbooster._available_host_bytes()
    assert tbooster._available_host_bytes() == want
    assert want == (8000000 * 1024 if meminfo else (free_pages or 0) * 4096)
    assert (tbooster._advanced_mask_budget_bytes(BoostingConfig())
            == jbooster._advanced_mask_budget_bytes(JConfig()))


@pytest.mark.parametrize("seed,M,F", [(0, 31, 4), (1, 61, 9), (2, 125, 3)])
def test_advanced_bounds_matches_jax(seed, M, F):
    """The advanced method's whole-tree bounds equal the JAX package's on
    random trees."""
    arrs = random_tree_arrays(seed, M, F, 64)
    want = jt._advanced_bounds(*[jnp.asarray(a) for a in arrs], 64)
    got = tt._advanced_bounds(*[torch.from_numpy(a) for a in arrs], 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
