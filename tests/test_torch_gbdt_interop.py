"""LightGBM text models and TreeSHAP in the port held against the JAX
package on the CPU.

A model carried across (``convert.booster_from_reference``) is the same
model in both packages, so its LightGBM text must be the same bytes and
its TreeSHAP contributions the same to float64 rounding (atol 1e-9: the
port walks every row of a tree at once and adds the same terms in
another order).  Each package reads the other's text and predicts the
same margins; the edge cases of the JAX package's own import tests
(missing_type Zero, categorical bitsets) behave the same.
"""

import json

import numpy as np
import pytest

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu.models.gbdt.booster import Booster as JBooster
from synapseml_tpu.models.gbdt.estimators import GBDTClassifier as JClf
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.models.gbdt.booster import Booster as TBooster
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
from synapseml_tpu_torch.models.gbdt.convert import booster_from_reference
from synapseml_tpu_torch.models.gbdt.estimators import (
    GBDTClassificationModel, GBDTClassifier, GBDTRankerModel,
    GBDTRegressionModel)

from test_gbdt_categorical import cat_data
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

KINDS = {
    "binary": dict(objective="binary"),
    "multiclass": dict(objective="multiclass", num_class=3),
    "regression": dict(objective="regression"),
    "dart": dict(objective="binary", boosting_type="dart", skip_drop=0.0,
                 drop_rate=0.5),
    "rf": dict(objective="binary", boosting_type="rf", bagging_fraction=0.7,
               bagging_freq=1),
    "categorical": dict(objective="binary", categorical_feature=[0, 1]),
    "monotone": dict(objective="binary",
                     monotone_constraints=[0, 0, 1, -1, 0, 0]),
}


def _data(kind):
    """cat_data's two categorical codes and two dense columns, two more
    dense columns, NaN in one, and each kind's label."""
    X, y = cat_data(n=1200, seed=3)
    rng = np.random.default_rng(5)
    X = np.column_stack([X, rng.normal(size=(len(X), 2)).astype(np.float32)])
    X[::23, 4] = np.nan
    if kind == "multiclass":
        y = np.digitize(X[:, 2] + y, [0.5, 1.2]).astype(np.float64)
    elif kind == "regression":
        y = X[:, 2] * 2 + y
    return X, y


@pytest.fixture(scope="module", params=list(KINDS))
def carried(request):
    """(kind, X, the JAX model, the same model in the port)."""
    kind = request.param
    X, y = _data(kind)
    jb, _ = jtrain(X, y, JConfig(num_iterations=4, num_leaves=7,
                                 min_data_in_leaf=10, **KINDS[kind]))
    tb = booster_from_reference(json.loads(json.dumps(jb.to_dict())),
                                device="cpu")
    return kind, X, jb, tb


def test_export_bytes_equal_jax(carried):
    kind, X, jb, tb = carried
    text = tb.to_string()
    assert text == jb.to_string()
    if kind == "categorical":
        assert "cat_threshold=" in text
    if kind == "rf":
        assert "\naverage_output\n" in text
    if kind == "monotone":
        assert "[monotone_constraints: 0,0,1,-1,0,0]" in text


def test_import_both_ways(carried):
    """The port reads the JAX text and the JAX package reads the port's:
    the margins of the two reads are equal, and within 1e-6 of the
    model's own; the imported model re-exports to a fixed point."""
    kind, X, jb, tb = carried
    text = tb.to_string()
    t_in = TBooster.from_string(jb.to_string(), device="cpu")
    j_in = JBooster.from_string(text)
    mt, mj = t_in.predict_margin(X, device="cpu"), j_in.predict_margin(X)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mt, jb.predict_margin(X), rtol=0, atol=1e-6)
    again = t_in.to_string()
    assert TBooster.from_string(again, device="cpu").to_string() == again
    assert again == j_in.to_string()


@pytest.mark.parametrize("approximate", [False, True])
def test_treeshap_matches_jax(carried, approximate):
    """Exact TreeSHAP and the Saabas path attribution, categorical models
    in bin space; contributions sum to the margin."""
    kind, X, jb, tb = carried
    rows = X[:120]
    got = tb.predict_contrib(rows, approximate=approximate)
    want = jb.predict_contrib(rows, approximate=approximate)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    margin = tb.predict_margin(rows, device="cpu")
    K = tb.num_class
    sums = got.reshape(len(rows), K, -1).sum(-1)
    np.testing.assert_allclose(sums[:, 0] if K == 1 else sums, margin,
                               rtol=0, atol=1e-4)


def test_imported_treeshap_matches_jax(carried):
    """SHAP of the text-imported model (covers from leaf_count /
    internal_count; an imported categorical model's hybrid view) equals
    the JAX package's on its own import."""
    kind, X, jb, tb = carried
    text = jb.to_string()
    got = TBooster.from_string(text, device="cpu").predict_contrib(X[:60])
    want = JBooster.from_string(text).predict_contrib(X[:60])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_cover_counts_survive_text_round_trip():
    """tests/test_gbdt.py's round trip on the port: exact SHAP works on
    the re-imported model, per-feature attributions unchanged."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(800, 5)).astype(np.float32)
    y = (2 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=800) > 0).astype(np.float64)
    b, _ = ttrain(X, y, BoostingConfig(objective="binary", num_iterations=3,
                                       num_leaves=7, min_data_in_leaf=10),
                  device="cpu")
    b2 = TBooster.from_string(b.to_string(), device="cpu")
    assert all(float(t.node_count.max()) > 0 for t in b2.trees)
    c1, c2 = b.predict_contrib(X[:8]), b2.predict_contrib(X[:8])
    np.testing.assert_allclose(c1.sum(1), c2.sum(1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c1[:, :-1], c2[:, :-1], rtol=1e-3, atol=1e-4)
    approx = b.predict_contrib(X[:8], approximate=True)
    assert not np.allclose(approx, c1)


ZERO_MISSING = """tree
version=v3
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=1
objective=regression
feature_names=a b
feature_infos=[-10:10] [-10:10]
tree_sizes=300

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=10 5
threshold=-0.5 1.0
decision_type=6 4
left_child=1 -1
right_child=-3 -2
leaf_value=1 2 4
leaf_weight=0 0 0
leaf_count=0 0 0
internal_value=0 0
internal_weight=0 0
internal_count=0 0
is_linear=0
shrinkage=0.1

end of trees
"""


def test_missing_type_zero_import():
    """tests/test_gbdt.py's missing_type=Zero model: |x| <= 1e-35 and NaN
    route by the stored default direction; the export keeps the bits."""
    X = np.array([[-1.0, 0.5], [0.0, 0.5], [0.0, 0.0], [np.nan, 5.0],
                  [1e-40, 3.0], [0.3, 0.0]], np.float32)
    b = TBooster.from_string(ZERO_MISSING, device="cpu")
    want = [1.0, 1.0, 2.0, 2.0, 2.0, 4.0]
    np.testing.assert_allclose(b.predict_margin(X), want, atol=1e-6)
    np.testing.assert_allclose(JBooster.from_string(ZERO_MISSING)
                               .predict_margin(X), want, atol=1e-6)
    assert "decision_type=6 4" in b.to_string()
    assert b.to_string() == JBooster.from_string(ZERO_MISSING).to_string()
    np.testing.assert_allclose(
        TBooster.from_string(b.to_string(), device="cpu").predict_margin(X),
        want, atol=1e-6)
    # no covers: SHAP takes the Saabas path, as in the JAX package
    np.testing.assert_allclose(
        b.predict_contrib(X),
        JBooster.from_string(ZERO_MISSING).predict_contrib(X), atol=1e-9)


NO_LIST = """tree
num_class=1
num_tree_per_iteration=1
max_feature_idx=0
objective=regression
tree_sizes=100

Tree=0
num_leaves=2
num_cat=1
split_feature=0
threshold=0.5
decision_type=11
left_child=-1
right_child=-2
leaf_value=1 2

end of trees
"""

NOT_SUFFIX = """tree
version=v3
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=1
objective=binary sigmoid:1
feature_names=c0 f1
feature_infos=0:1:2:3 [-1e+308:1e+308]
tree_sizes=200

Tree=0
num_leaves=2
num_cat=1
split_feature=0
split_gain=1
threshold=0
decision_type=1
left_child=-1
right_child=-2
cat_boundaries=0 1
cat_threshold=5
leaf_value=0.1 -0.1
leaf_weight=0 0
leaf_count=10 10
internal_value=0
internal_weight=0
internal_count=20
is_linear=0
shrinkage=0.3

end of trees
"""


@pytest.mark.parametrize("text,match", [
    (NO_LIST, "categorical"), (NOT_SUFFIX, "contiguous suffix")])
def test_categorical_import_rejected_as_in_jax(text, match):
    """tests/test_gbdt.py and tests/test_gbdt_categorical.py: a bitset
    without a category list, and one that is not a suffix of the bin
    order, are refused by both packages."""
    with pytest.raises(ValueError, match=match):
        JBooster.from_string(text)
    with pytest.raises(ValueError, match=match):
        TBooster.from_string(text, device="cpu")


def test_categorical_import_accepted_as_in_jax():
    """A categorical model's own text imports (bitsets from the bin
    order), predicts like the model, unseen categories and NaN
    included."""
    X, y = cat_data()
    b, _ = ttrain(X, y, BoostingConfig(
        objective="binary", num_iterations=10, num_leaves=7,
        learning_rate=0.3, min_data_in_leaf=5, categorical_feature=[0, 1]),
        device="cpu")
    b2 = TBooster.from_string(b.to_string(), device="cpu")
    Xu = X[:64].copy()
    Xu[:, 0] = 99.0
    Xu[10:20, 1] = np.nan
    for Z in (X, Xu):
        np.testing.assert_allclose(b2.predict_margin(Z), b.predict_margin(Z),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b2.predict_contrib(X[:32]),
                               b.predict_contrib(X[:32]), rtol=1e-4,
                               atol=1e-4)
    j2 = JBooster.from_string(b.to_string())
    np.testing.assert_allclose(b2.predict_margin(Xu), j2.predict_margin(Xu),
                               rtol=0, atol=1e-6)


def test_get_model_string_is_the_same_in_both_packages():
    """The repair: ``get_model_string`` is LightGBM text in both packages,
    the same bytes for the same model (a port-trained classifier carried
    into the JAX package); every model class loads it back."""
    X, y = _data("binary")
    cols = {"features": list(X), "label": y}
    tm = GBDTClassifier(device="cpu", numIterations=3,
                        numLeaves=7).fit(TDataset(cols))
    jm = JClf(numIterations=3, numLeaves=7).fit(JDataset(cols))
    jm.set("boosterModel", JBooster.from_dict(json.loads(
        tm.booster.to_json())))
    text = tm.get_model_string()
    assert text.startswith("tree\n") and text == jm.get_model_string()
    for cls in (GBDTClassificationModel, GBDTRegressionModel,
                GBDTRankerModel):
        m = cls.load_native_model_from_string(text, device="cpu")
        np.testing.assert_allclose(m.booster.predict_margin(X[:50]),
                                   tm.booster.predict_margin(X[:50]),
                                   rtol=0, atol=1e-6)
        js = cls.load_native_model_from_string(tm.booster.to_json(),
                                               device="cpu")
        np.testing.assert_array_equal(js.booster.predict_margin(X[:50]),
                                      tm.booster.predict_margin(X[:50]))


def test_load_native_model_from_file(tmp_path):
    p = tmp_path / "model.txt"
    p.write_text(ZERO_MISSING)
    m = GBDTRegressionModel.load_native_model_from_file(str(p), device="cpu")
    X = np.array([[-1.0, 0.5], [0.3, 0.0]], np.float32)
    out = m.transform(TDataset({"features": list(X)}))
    np.testing.assert_allclose(np.asarray(out["prediction"]), [1.0, 4.0],
                               atol=1e-6)
    assert TBooster.from_file(str(p), device="cpu").num_trees == 1


def test_features_shap_col_matches_jax():
    """``featuresShapCol`` through transform: the JAX column within
    1e-9, each row's contributions summing to the raw margin."""
    X, y = _data("binary")
    cols = {"features": list(X), "label": y}
    jm = JClf(numIterations=3, numLeaves=7).fit(JDataset(cols))
    jm.set("featuresShapCol", "shap")
    tb = booster_from_reference(json.loads(json.dumps(
        jm.booster.to_dict())), device="cpu")
    tm = GBDTClassificationModel(boosterModel=tb, device="cpu",
                                 featuresShapCol="shap",
                                 leafPredictionCol="leaves")
    hold = {"features": list(X[:40])}
    got = np.stack(tm.transform(TDataset(hold))["shap"])
    want = np.stack(jm.transform(JDataset(hold))["shap"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.sum(1), tb.predict_margin(X[:40]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows,chunk", [(16, None), (1, None), (0, None),
                                        (5000, None), (5000, 3 * 977)])
def test_batched_walk_equals_per_tree_walk(monkeypatch, rows, chunk):
    """The walk of all trees at once (the served predict path) gives the
    per-tree walk's margins and leaves bit for bit: NaN and ±0 inputs,
    any row count and traversal chunk; and the JAX package's margins
    within 1e-6."""
    import torch
    from synapseml_tpu_torch.models.gbdt import trainer
    rng = np.random.default_rng(rows + 1)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.normal(scale=.3, size=3000)
         > 0).astype(np.float32)
    jb, _ = jtrain(X, y, JConfig(objective="binary", num_iterations=30,
                                 num_leaves=15))
    tb = booster_from_reference(json.loads(json.dumps(jb.to_dict())),
                                device="cpu")
    Z = rng.normal(size=(rows, 6)).astype(np.float32)
    Z[rng.random(Z.shape) < 0.05] = np.nan
    Z[rng.random(Z.shape) < 0.05] = 0.0
    if chunk is not None:
        monkeypatch.setattr(trainer, "PREDICT_CHUNK_ELEMENTS", chunk)
    stacked = tb._stacked_for_class(0, None, torch.device("cpu"))
    zt = torch.as_tensor(Z)
    got = trainer.predict_raw_features(zt, stacked, tb.depth_bound())
    want = trainer.predict_raw_features_per_tree(zt, stacked,
                                                 tb.depth_bound())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].shape == (30, rows)
    if rows:
        np.testing.assert_allclose(tb.predict_margin(Z, device="cpu"),
                                   jb.predict_margin(Z), rtol=0, atol=1e-6)


def test_derived_stacks_follow_the_trees():
    """The booster's derived values (depth bound, stacked trees) are
    built once for a list of trees and rebuilt when the trees, weights
    or classes change; a pickled booster carries none of them."""
    import pickle
    jb, _ = jtrain(*_data("binary"), JConfig(num_iterations=6,
                                             num_leaves=7))
    tb = booster_from_reference(json.loads(json.dumps(jb.to_dict())),
                                device="cpu")
    X = _data("binary")[0][:50]
    first = tb.predict_margin(X, device="cpu")
    st = tb._stacked_for_class(0, None, "cpu")
    assert tb._stacked_for_class(0, None, "cpu") is st
    assert tb._stacked_for_class(0, 3, "cpu") is not st
    back = pickle.loads(pickle.dumps(tb))
    assert "_derived_cache" not in back.__dict__
    np.testing.assert_array_equal(back.predict_margin(X, device="cpu"),
                                  first)
    tb.tree_weights = [0.5] * len(tb.trees)
    assert tb._stacked_for_class(0, None, "cpu") is not st
    np.testing.assert_allclose(tb.predict_margin(X, device="cpu")
                               - tb.init_score[0],
                               (first - tb.init_score[0]) * 0.5,
                               rtol=1e-6, atol=1e-6)
    tb.trees, tb.tree_class = tb.trees[:2], tb.tree_class[:2]
    tb.tree_weights = tb.tree_weights[:2]
    assert tb._stacked_for_class(0, None, "cpu").split_feature.shape[0] == 2
