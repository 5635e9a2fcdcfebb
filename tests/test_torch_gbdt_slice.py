"""The port's GBDT slice as a whole held against the JAX package on the
CPU: binning, the model JSON in both directions, and the classifier's
fit → transform.

The JAX package's CPU fit histograms f32 gradients by scatter-add, while
the port always builds the kernels' exact int8-limb histograms, so whole
fits agree to the quantization (holdout AUC within 0.005, the first
split equal) rather than bit for bit; a model carried across predicts
the same margins to 1e-6.
"""

import json

import numpy as np
import pytest

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import binning as jbin
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu.models.gbdt.booster import Booster as JBooster
from synapseml_tpu.models.gbdt.estimators import GBDTClassifier as JClf
from synapseml_tpu.models.gbdt.metrics import auc as jauc
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.core import Pipeline as TPipeline
from synapseml_tpu_torch.models.gbdt import binning as tbin
from synapseml_tpu_torch.models.gbdt.booster import Booster as TBooster
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
from synapseml_tpu_torch.models.gbdt.convert import booster_from_reference
from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
from synapseml_tpu_torch.models.gbdt.metrics import auc
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _binary_data(n=3000, F=8, seed=0):
    """tests/test_benchmark_fixtures.py's binary task."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    logit = 2 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("max_bin,n", [(255, 3000), (63, 3000), (15, 500),
                                       (255, 250_000)])
def test_bin_mapper_and_bins_match(max_bin, n):
    import torch
    rng = np.random.default_rng(2)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[:, 3] = np.round(X[:, 3] * 2)          # few distinct values
    X[::13, 1] = np.nan
    kw = dict(sample_count=200_000, seed=4)
    jm = jbin.fit_bin_mapper(X, max_bin, **kw)
    tm = tbin.fit_bin_mapper(X, max_bin, **kw)
    np.testing.assert_array_equal(tm.upper_bounds, jm.upper_bounds)
    np.testing.assert_array_equal(tm.num_bins, jm.num_bins)
    t_bins = tbin.bin_features(X, tm, torch.device("cpu"))
    np.testing.assert_array_equal(t_bins.numpy(), jm.transform(X).T)


def test_reference_booster_round_trip():
    """A JAX-trained model → the port: margins to 1e-6 on rows with NaN;
    the port's JSON → the JAX package's reader: the same margins."""
    X, y = _binary_data()
    X[::29, 2] = np.nan
    cfg = JConfig(objective="binary", num_iterations=12, num_leaves=15,
                  min_data_in_leaf=5, learning_rate=0.2)
    jb, _ = jtrain(X[:2400], y[:2400], cfg)
    d = json.loads(json.dumps(jb.to_dict()))
    tb = booster_from_reference(d, device="cpu")
    jm = jb.predict_margin(X[2400:])
    tm = tb.predict_margin(X[2400:])
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-6)
    back = JBooster.from_dict(json.loads(json.dumps(tb.to_dict())))
    np.testing.assert_allclose(back.predict_margin(X[2400:]), jm, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tb.predict_leaf(X[:50]),
                                  jb.predict_leaf(X[:50]))


def test_port_model_read_by_jax():
    """A port-trained model's JSON predicts the same margins in the JAX
    package."""
    X, y = _binary_data(seed=1)
    b, _ = ttrain(X[:2400], y[:2400], BoostingConfig(
        objective="binary", num_iterations=6, num_leaves=15,
        min_data_in_leaf=5), device="cpu")
    jb = JBooster.from_dict(json.loads(b.to_json()))
    np.testing.assert_allclose(jb.predict_margin(X[2400:]),
                               b.predict_margin(X[2400:]), rtol=0,
                               atol=1e-6)


def test_classifier_fit_transform_matches_jax():
    """tests/test_benchmark_fixtures.py's data with bagging off: the two
    packages' classifiers agree on holdout AUC, the first split and the
    output columns (JAX on one shard: the test session fakes 8
    devices)."""
    X, y = _binary_data()
    common = dict(numIterations=30, numLeaves=15, learningRate=0.2,
                  minDataInLeaf=5, seed=7)
    jm = JClf(numShards=1, **common).fit(
        JDataset({"features": list(X[:2400]), "label": y[:2400]}))
    tm = TPipeline(stages=[GBDTClassifier(device="cpu", **common)]).fit(
        TDataset({"features": list(X[:2400]), "label": y[:2400]}))
    jout = jm.transform(JDataset({"features": list(X[2400:]),
                                  "label": y[2400:]}))
    tout = tm.transform(TDataset({"features": list(X[2400:]),
                                  "label": y[2400:]}))
    assert tout.columns == jout.columns
    ja = jauc(y[2400:], np.stack(jout["probability"])[:, 1])
    ta = auc(y[2400:], np.stack(tout["probability"])[:, 1])
    assert ta > 0.9 and abs(ta - ja) <= 0.005, (ta, ja)
    jt0 = jm.booster.trees[0]
    tt0 = tm.get_or_default("stages")[0].booster.trees[0]
    assert tt0.split_feature[0] == jt0.split_feature[0]
    assert tt0.split_bin[0] == jt0.split_bin[0]
    np.testing.assert_array_equal(np.stack(tout["prediction"]) >= 0, True)


def test_two_level_fit_on_cpu_is_close_to_full_resolution():
    """two_level_hist='on' (what 'auto' picks at >= 500k rows) keeps
    holdout quality at this size (the JAX package's own bar)."""
    X, y = _binary_data(n=20_000, F=12, seed=3)
    aucs = {}
    for tl in ("on", "off"):
        b, _ = ttrain(X[:16_000], y[:16_000], BoostingConfig(
            objective="binary", num_iterations=10, two_level_hist=tl),
            device="cpu")
        assert b.config.two_level_hist == tl
        aucs[tl] = auc(y[16_000:], b.predict_margin(X[16_000:]))
    assert abs(aucs["on"] - aucs["off"]) <= 0.005, aucs


class _CheckpointManager:
    """Stands in for something that is not a
    ``core.checkpoint.CheckpointManager``: an object without a
    ``directory``."""


#: the step profiler's cost capture over a mesh is ported
#: (tests/test_torch_dl_mesh_elastic.py): a capture with a mesh that is
#: not a ProcessMesh fails on the mesh's type, before any work
_A5 = (TypeError, "ProcessMesh")
#: checkpoints over a mesh and through a manager are ported; an object
#: that is not a manager is refused before any work
_NOT_A_MANAGER = (TypeError, "CheckpointManager")


@pytest.mark.parametrize("kw,train_kw,item", [
    # lambdarank and the voting/feature-parallel modes train over a mesh
    # (tests/test_torch_gbdt_parallel_modes.py, _rank_parallel.py), with
    # checkpoints (tests/test_torch_elastic.py) and the step profiler's
    # cost capture; the mesh itself must be a ProcessMesh
    (dict(objective="lambdarank"), dict(group=[100, 100], mesh=object(),
                                        checkpoint_dir="unused",
                                        checkpoint_interval=1,
                                        step_profiler="capture"), _A5),
    (dict(parallelism="voting_parallel"), dict(mesh=object(),
                                               checkpoint_dir="unused",
                                               step_profiler="capture"),
     _A5),
    ({}, dict(checkpoint_dir=_CheckpointManager(), checkpoint_interval=1),
     _NOT_A_MANAGER),
    # kw None: the estimator's knobs (train_kw), checked before the data
    # is read; numShards, collectiveCompression and parallelism
    # themselves train now (test_num_shards_are_the_group_ranks); the
    # checkpoint manager is checked with them
    (None, dict(numShards=2, parallelism="feature_parallel",
                checkpointManager=_CheckpointManager()), _NOT_A_MANAGER),
    (None, dict(collectiveCompression="int8",
                parallelism="voting_parallel",
                checkpointManager=_CheckpointManager()), _NOT_A_MANAGER),
])
def test_unported_config_raises(kw, train_kw, item, monkeypatch):
    X, y = _binary_data(n=200)
    exc, match = item
    if kw is None:
        def no_work(*a, **k):
            raise AssertionError("the features were read")
        monkeypatch.setattr(GBDTClassifier, "_features_matrix", no_work)
        ds = TDataset({"features": list(X), "label": y})
        with pytest.raises(exc, match=match):
            GBDTClassifier(device="cpu", numIterations=2, **train_kw).fit(ds)
        return
    if train_kw.get("step_profiler") == "capture":
        from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
        train_kw = dict(train_kw, step_profiler=StepProfiler(
            "unported", capture_xla=True))
    cfg = BoostingConfig(**{"objective": "binary", **kw})
    with pytest.raises(exc, match=match):
        ttrain(X, y, cfg, device="cpu", **train_kw)


@pytest.mark.parametrize("est_kw", [
    dict(numShards=0), dict(numShards=1),
    dict(numShards=1, collectiveCompression="none"),
    dict(collectiveCompression=None)])
def test_one_card_mesh_knobs_train(est_kw):
    """numShards 0 or 1 and codec None/'none' train on the one card, as
    the JAX package's calls with those values do."""
    X, y = _binary_data(n=600)
    m = GBDTClassifier(device="cpu", numIterations=3, **est_kw).fit(
        TDataset({"features": list(X), "label": y}))
    assert len(m.booster.trees) == 3


def test_num_shards_are_the_group_ranks(monkeypatch):
    """Without a process group the world is one rank: numShards=2 raises
    naming the ranks before the data is read, and a codec without a mesh
    is ignored (the fit equals the uncompressed one), as in the JAX
    package, which applies it only where the histogram psum exists."""
    X, y = _binary_data(n=600)
    ds = TDataset({"features": list(X), "label": y})
    plain = GBDTClassifier(device="cpu", numIterations=3).fit(ds)
    coded = GBDTClassifier(device="cpu", numIterations=3,
                           collectiveCompression="int8").fit(ds)
    assert plain.get_model_string() == coded.get_model_string()

    def no_work(*a, **k):
        raise AssertionError("the features were read")
    monkeypatch.setattr(GBDTClassifier, "_features_matrix", no_work)
    with pytest.raises(ValueError, match="ranks of the initialized"):
        GBDTClassifier(device="cpu", numShards=2).fit(ds)
    with pytest.raises(ValueError, match="collectiveCompression"):
        GBDTClassifier(device="cpu", numIterations=2,
                       collectiveCompression="fp8").fit(ds)


@pytest.mark.parametrize("max_bin,num_leaves,fits", [
    (500, 31, True), (501, 31, False), (1023, 17, False), (1023, 4, True)])
def test_card_width_check(max_bin, num_leaves, fits):
    """One feature's histogram at maxBin + 1 bins and the wave's slots
    (16 from numLeaves 17) must fit a block's shared memory on the card;
    the CPU trains any width.  The check needs no card."""
    import torch
    from synapseml_tpu_torch.models.gbdt.booster import _check_ported_on
    cfg = BoostingConfig(max_bin=max_bin, num_leaves=num_leaves)
    _check_ported_on(cfg, torch.device("cpu"))
    if fits:
        _check_ported_on(cfg, torch.device("cuda"))
    else:
        with pytest.raises(NotImplementedError,
                           match="GBDT breadth: maxBin on the card"):
            _check_ported_on(cfg, torch.device("cuda"))


def test_card_width_check_comes_before_binning(monkeypatch):
    """A card fit at maxBin 1023 raises before the data is binned."""
    import torch
    from synapseml_tpu_torch.models.gbdt import booster

    def no_binning(*a, **kw):
        raise AssertionError("the data was binned")
    monkeypatch.setattr(booster, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(booster, "fit_bin_mapper", no_binning)
    X, y = _binary_data(n=200)
    with pytest.raises(NotImplementedError, match="maxBin on the card"):
        ttrain(X, y, BoostingConfig(max_bin=1023), device="cuda")


def test_feature_fraction_draws_like_jax():
    """feature_fraction draws its per-tree masks from the same numpy
    stream as the JAX package: no tree splits on an unsampled feature."""
    X, y = _binary_data(n=2000, F=8)
    cfg = BoostingConfig(objective="binary", num_iterations=4,
                         feature_fraction=0.5, seed=11, min_data_in_leaf=5)
    b, _ = ttrain(X, y, cfg, device="cpu")
    rng = np.random.default_rng(11)
    for t in b.trees:
        allowed = set(rng.choice(8, 4, replace=False).tolist())
        used = set(t.split_feature[t.split_feature >= 0].tolist())
        assert used <= allowed, (used, allowed)


def test_regression_objective_fits():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1])).astype(np.float64)
    b, _ = ttrain(X, y, BoostingConfig(num_iterations=20, num_leaves=15),
                  device="cpu")
    pred = b.predict_margin(X)
    assert np.mean((pred - y) ** 2) < 0.3 * np.var(y)
    jb = JBooster.from_dict(b.to_dict())
    np.testing.assert_allclose(jb.predict_margin(X), pred, atol=1e-6)


def test_model_save_load_round_trip(tmp_path):
    from synapseml_tpu_torch.core import load_stage
    X, y = _binary_data(n=1500)
    ds = TDataset({"features": list(X), "label": y})
    m = GBDTClassifier(numIterations=3, device="cpu").fit(ds)
    m.save(str(tmp_path / "m"))
    m2 = load_stage(str(tmp_path / "m"))
    np.testing.assert_array_equal(
        np.stack(m2.transform(ds)["probability"]),
        np.stack(m.transform(ds)["probability"]))
    assert isinstance(m2.booster, TBooster)
