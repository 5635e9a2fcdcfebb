"""The port's ops stages held against the JAX package's on the same
seeded inputs.

Host stages are exact: featurized matrices and plans, indexed labels,
cleaned columns, text hashes and IDF weights, mini-batch boundaries,
metric tables and per-row losses compare with ``==`` (both packages run
the same numpy on the host).  Anything through the GBDT uses
``tests/test_torch_gbdt_slice.py``'s tolerances: a model the JAX package
fitted, carried across (``convert.trained_model_from_reference``),
predicts margins within atol 1e-6 and the same labels; a fit of each
package on the same rows agrees to the quantization (holdout AUC within
0.005, the first split equal), since the JAX package's CPU fit sums f32
gradients by scatter-add where the port sums the kernels' exact int8
limbs.
"""

import json

import numpy as np
import pytest

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu import ops as jops
from synapseml_tpu.models.gbdt.estimators import GBDTClassifier as JClf
from synapseml_tpu.models.gbdt.estimators import GBDTRegressor as JReg
from synapseml_tpu_torch import ops as tops
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.core.pipeline import load_stage
from synapseml_tpu_torch.models.gbdt.convert import \
    trained_model_from_reference
from synapseml_tpu_torch.models.gbdt.estimators import (GBDTClassifier,
                                                        GBDTRegressor)
from synapseml_tpu_torch.models.gbdt.metrics import auc
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _same(a, b):
    """Equal Datasets: the same columns, every cell equal (arrays by
    value, NaN equal to NaN)."""
    assert a.columns == b.columns, (a.columns, b.columns)
    assert a.num_rows == b.num_rows
    for c in a.columns:
        ca, cb = a[c], b[c]
        assert ca.dtype == cb.dtype, (c, ca.dtype, cb.dtype)
        if ca.dtype != object:
            np.testing.assert_array_equal(ca, cb, err_msg=c)
            continue
        for x, y in zip(ca, cb):
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=c)
            elif isinstance(x, float) and np.isnan(x):
                assert np.isnan(y), c
            else:
                assert x == y, (c, x, y)


def _mixed(seed, n=240):
    """Numeric columns with NaNs, an 8-level and a 150-level string
    column (one-hot and hashed), a vector column and a string label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x[rng.random((n, 3)) < 0.05] = np.nan
    color = rng.choice([f"c{i}" for i in range(8)], size=n)
    ident = np.array([f"id{k}" for k in rng.integers(0, 150, n)])
    vec = np.empty(n, dtype=object)
    for i in range(n):
        vec[i] = rng.normal(size=2)
    logit = (2 * np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 1])
             + (color == "c3") * 1.5)
    label = np.where(logit + rng.normal(scale=0.5, size=n) > 0, "yes", "no")
    # strings as lists: a Dataset keeps them as object columns, which is
    # what Featurize reads as categorical (a numpy '<U' array is not)
    return {"x0": x[:, 0], "x1": x[:, 1], "x2": x[:, 2],
            "color": color.tolist(), "ident": ident.tolist(), "vec": vec,
            "label": label.tolist()}


def _both(cols):
    return Dataset(dict(cols)), JDataset(dict(cols))


# -- featurize --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [dict(), dict(numFeatures=64),
                                dict(oneHotEncodeCategoricals=False,
                                     numFeatures=32),
                                dict(imputeMissing=False)])
def test_featurize_equals_jax(seed, kw):
    t, j = _both(_mixed(seed))
    cols = ["x0", "x1", "x2", "color", "ident", "vec"]
    tm = tops.Featurize(inputCols=cols, **kw).fit(t)
    jm = jops.Featurize(inputCols=cols, **kw).fit(j)
    assert tm.plan == jm.plan
    _same(tm.transform(t), jm.transform(j))


@pytest.mark.parametrize("col", ["color", "ident", "label"])
def test_value_indexer_and_inverse_equal_jax(col):
    t, j = _both(_mixed(2))
    tm = tops.ValueIndexer(inputCol=col, outputCol="idx").fit(t)
    jm = jops.ValueIndexer(inputCol=col, outputCol="idx").fit(j)
    assert tm.levels == jm.levels
    to, jo = tm.transform(t), jm.transform(j)
    _same(to, jo)
    _same(tops.IndexToValue(inputCol="idx", outputCol="back",
                            levels=tm.levels).transform(to),
          jops.IndexToValue(inputCol="idx", outputCol="back",
                            levels=jm.levels).transform(jo))


@pytest.mark.parametrize("mode", ["Mean", "Median", "Custom"])
def test_clean_missing_data_equals_jax(mode):
    t, j = _both(_mixed(3))
    kw = dict(inputCols=["x0", "x1", "x2"], outputCols=["a", "b", "c"],
              cleaningMode=mode)
    if mode == "Custom":
        kw["customValue"] = -7.5
    tm, jm = tops.CleanMissingData(**kw).fit(t), \
        jops.CleanMissingData(**kw).fit(j)
    assert tm.fillValues == jm.fillValues
    _same(tm.transform(t), jm.transform(j))


@pytest.mark.parametrize("to", ["boolean", "integer", "float", "double",
                                "string"])
def test_data_conversion_equals_jax(to):
    cols = _mixed(4)
    cols = {"x0": np.nan_to_num(cols["x0"]) * 10, "label": cols["label"]}
    t, j = _both(cols)
    _same(tops.DataConversion(cols=["x0"], convertTo=to).transform(t),
          jops.DataConversion(cols=["x0"], convertTo=to).transform(j))


def test_count_selector_equals_jax():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(40, 6))
    m[:, [1, 4]] = 0.0
    cols = {"features": list(m)}
    t, j = _both(cols)
    tm, jm = tops.CountSelector().fit(t), jops.CountSelector().fit(j)
    assert tm.indices == jm.indices == [0, 2, 3, 5]
    _same(tm.transform(t), jm.transform(j))


# -- text -------------------------------------------------------------------

_DOCS = ["the quick brown fox", "jumped over the lazy dog",
         "the dog slept", "Héllo Wörld  foxes", "a b c d e f g",
         "quick quick quick"]


@pytest.mark.parametrize("kw", [
    dict(numFeatures=64), dict(numFeatures=128, useIDF=False, binary=True),
    dict(numFeatures=64, useNGram=True, nGramLength=2),
    dict(numFeatures=32, useStopWordsRemover=True, toLowercase=False),
    dict(numFeatures=64, minDocFreq=2)])
def test_text_featurizer_equals_jax(kw):
    t, j = _both({"t": list(_DOCS)})
    tm = tops.TextFeaturizer(inputCol="t", outputCol="f", **kw).fit(t)
    jm = jops.TextFeaturizer(inputCol="t", outputCol="f", **kw).fit(j)
    _same(tm.transform(t), jm.transform(j))


def test_ngrams_pages_and_normalizers_equal_jax():
    toks = np.empty(3, dtype=object)
    for i, d in enumerate(_DOCS[:3]):
        toks[i] = d.split()
    t, j = _both({"toks": toks, "t": list(_DOCS[:3])})
    _same(tops.MultiNGram(inputCol="toks", outputCol="g",
                          lengths=[1, 2, 3]).transform(t),
          jops.MultiNGram(inputCol="toks", outputCol="g",
                          lengths=[1, 2, 3]).transform(j))
    text = " ".join(_DOCS) * 9
    t2, j2 = _both({"t": [text]})
    kw = dict(inputCol="t", outputCol="p", maximumPageLength=70,
              minimumPageLength=50)
    _same(tops.PageSplitter(**kw).transform(t2),
          jops.PageSplitter(**kw).transform(j2))
    t3, j3 = _both({"t": list(_DOCS)})
    kw = dict(inputCol="t", outputCol="o", map={"the": "THE", "dog": "cat",
                                                "do": "x"},
              normFunc="lowerCase")
    _same(tops.TextPreprocessor(**kw).transform(t3),
          jops.TextPreprocessor(**kw).transform(j3))
    _same(tops.UnicodeNormalize(inputCol="t", outputCol="o").transform(t3),
          jops.UnicodeNormalize(inputCol="t", outputCol="o").transform(j3))


# -- stages -----------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 4, 7, 50])
def test_minibatch_boundaries_equal_jax(size):
    cols = _mixed(6, n=23)
    del cols["vec"]
    t, j = _both(cols)
    tb = tops.FixedMiniBatchTransformer(batchSize=size).transform(t)
    jb = jops.FixedMiniBatchTransformer(batchSize=size).transform(j)
    assert [len(b) for b in tb["x0"]] == [len(b) for b in jb["x0"]]
    _same(tops.FlattenBatch().transform(tb), jops.FlattenBatch()
          .transform(jb))
    td = tops.DynamicMiniBatchTransformer(maxBatchSize=size).transform(
        t.repartition(3))
    jd = jops.DynamicMiniBatchTransformer(maxBatchSize=size).transform(
        j.repartition(3))
    assert [len(b) for b in td["x0"]] == [len(b) for b in jd["x0"]]


def test_buffered_batcher_boundaries_equal_jax():
    from synapseml_tpu.ops.batchers import FixedBufferedBatcher as JFixed
    from synapseml_tpu_torch.ops.batchers import FixedBufferedBatcher
    for size in (1, 3, 8):
        assert list(FixedBufferedBatcher(iter(range(29)), batch_size=size)) \
            == list(JFixed(iter(range(29)), batch_size=size))


def test_explode_ensemble_balancer_summary_equal_jax():
    cols = _mixed(7, n=60)
    t, j = _both(cols)
    lists = np.empty(4, dtype=object)
    for i, k in enumerate([3, 0, 2, 1]):
        lists[i] = list(range(k))
    te, je = _both({"k": np.arange(4), "v": lists})
    _same(tops.Explode(inputCol="v").transform(te),
          jops.Explode(inputCol="v").transform(je))
    for collapse in (True, False):
        kw = dict(keys=["color"], cols=["x2"], collapseGroup=collapse)
        clean = {"color": cols["color"], "x2": np.nan_to_num(cols["x2"])}
        tc, jc = _both(clean)
        _same(tops.EnsembleByKey(**kw).transform(tc),
              jops.EnsembleByKey(**kw).transform(jc))
    _same(tops.ClassBalancer(inputCol="label").fit(t).transform(t),
          jops.ClassBalancer(inputCol="label").fit(j).transform(j))
    for mode in ("equal", "original", "mixed"):
        _same(tops.StratifiedRepartition(labelCol="label", mode=mode)
              .transform(t.repartition(3)),
              jops.StratifiedRepartition(labelCol="label", mode=mode)
              .transform(j.repartition(3)))
    num = {k: cols[k] for k in ("x0", "x1", "x2", "color")}
    tn, jn = _both(num)
    _same(tops.SummarizeData().transform(tn),
          jops.SummarizeData().transform(jn))


# -- metric tables ----------------------------------------------------------


def _scored(seed, n=300, k=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    p = rng.dirichlet(np.ones(k), size=n)
    p[np.arange(n), y] += 0.3
    p /= p.sum(1, keepdims=True)
    prob = np.empty(n, dtype=object)
    for i in range(n):
        prob[i] = p[i]
    return {"label": y, "prediction": p.argmax(1).astype(np.float64),
            "probability": prob, "score": np.round(p[:, -1], 2)}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("metric", ["all", "classification", "accuracy",
                                    "precision", "recall"])
def test_classification_statistics_equal_jax(k, metric):
    t, j = _both(_scored(k, k=k))
    kw = dict(labelCol="label", scoredLabelsCol="prediction",
              scoresCol="probability", evaluationMetric=metric)
    ts, js = tops.ComputeModelStatistics(**kw), \
        jops.ComputeModelStatistics(**kw)
    _same(ts.transform(t), js.transform(j))
    np.testing.assert_array_equal(ts.confusion_matrix, js.confusion_matrix)


@pytest.mark.parametrize("metric", ["regression", "mse", "rmse", "r2",
                                    "mae", "all"])
def test_regression_statistics_equal_jax(metric):
    rng = np.random.default_rng(9)
    y = rng.normal(size=200)
    t, j = _both({"label": y, "prediction": y + rng.normal(scale=.3,
                                                           size=200)})
    _same(tops.ComputeModelStatistics(evaluationMetric=metric).transform(t),
          jops.ComputeModelStatistics(evaluationMetric=metric).transform(j))


def test_per_instance_statistics_and_auc_equal_jax():
    t, j = _both(_scored(11, k=3))
    kw = dict(labelCol="label", scoresCol="probability",
              evaluationMetric="classification")
    _same(tops.ComputePerInstanceStatistics(**kw).transform(t),
          jops.ComputePerInstanceStatistics(**kw).transform(j))
    _same(tops.ComputePerInstanceStatistics().transform(t),
          jops.ComputePerInstanceStatistics().transform(j))
    from synapseml_tpu.ops.train import roc_auc as j_roc_auc
    from synapseml_tpu_torch.ops.train import roc_auc
    c = _scored(12)
    assert roc_auc(c["label"], c["score"]) == j_roc_auc(c["label"],
                                                        c["score"])


# -- through the GBDT -------------------------------------------------------

_GBDT = dict(numIterations=12, numLeaves=15, learningRate=0.2,
             minDataInLeaf=5, seed=7)


def _jax_state(jm, regressor=False):
    """The JAX TrainedClassifierModel's plain state (JSON round trip, as
    a file would carry it)."""
    inner = jm.innerModel
    state = {"plan": jm.featurizer.plan,
             "imputeMissing": jm.featurizer.imputeMissing,
             "booster": inner.booster.to_dict(),
             "labelCol": jm.labelCol, "featuresCol": jm.featuresCol,
             "regressor": regressor}
    if not regressor:
        state.update(levels=jm.get("levels"),
                     classLabels=inner.get("classLabels"))
    return json.loads(json.dumps(state))


def _frame(seed, n=600):
    cols = _mixed(seed, n)
    cols.pop("ident")
    return cols


@pytest.fixture(scope="module")
def jax_classifier():
    cols = _frame(20)
    jm = jops.TrainClassifier(model=JClf(numShards=1, **_GBDT),
                              labelCol="label").fit(JDataset(dict(cols)))
    return jm, cols


def test_carried_classifier_transforms_like_jax(jax_classifier, tmp_path):
    jm, _ = jax_classifier
    rows = _frame(21, n=200)
    tm = trained_model_from_reference(_jax_state(jm), device="cpu")
    to = tm.transform(Dataset(dict(rows)))
    jo = jm.transform(JDataset(dict(rows)))
    assert to.columns == jo.columns
    assert list(to["prediction"]) == list(jo["prediction"])
    np.testing.assert_allclose(np.stack(to["rawPrediction"]),
                               np.stack(jo["rawPrediction"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.stack(to["probability"]),
                               np.stack(jo["probability"]), rtol=0,
                               atol=1e-6)
    # the carried model survives the port's save / load_stage
    tm.save(str(tmp_path / "m"))
    back = load_stage(str(tmp_path / "m"))
    assert list(back.transform(Dataset(dict(rows)))["prediction"]) \
        == list(jo["prediction"])


def test_carried_classifier_statistics_equal_jax(jax_classifier):
    jm, _ = jax_classifier
    rows = _frame(22, n=300)
    tm = trained_model_from_reference(_jax_state(jm), device="cpu")
    kw = dict(labelCol="label", scoredLabelsCol="prediction",
              scoresCol="probability", evaluationMetric="classification")
    ts = tops.ComputeModelStatistics(**kw).transform(
        tm.transform(Dataset(dict(rows))))
    js = jops.ComputeModelStatistics(**kw).transform(
        jm.transform(JDataset(dict(rows))))
    _same(ts, js)


def test_carried_regressor_transforms_like_jax():
    cols = _frame(23)
    rng = np.random.default_rng(23)
    cols["label"] = (np.nan_to_num(cols["x0"]) * 2
                     + (np.asarray(cols["color"]) == "c1")
                     + rng.normal(size=600) * .1)
    jm = jops.TrainRegressor(model=JReg(numShards=1, **_GBDT),
                             labelCol="label").fit(JDataset(dict(cols)))
    tm = trained_model_from_reference(_jax_state(jm, regressor=True),
                                      device="cpu")
    rows = _frame(24, n=200)
    rows.pop("label")
    to = tm.transform(Dataset(dict(rows)))
    jo = jm.transform(JDataset(dict(rows)))
    assert to.columns == jo.columns
    np.testing.assert_allclose(to["prediction"], jo["prediction"], rtol=0,
                               atol=1e-6)


def test_train_classifier_slice_matches_jax(jax_classifier):
    """TrainClassifier → ComputeModelStatistics on a mixed numeric,
    categorical and string-label frame, fitted by each package: the
    featurized matrix and the indexed labels are equal, the holdout AUC
    agrees to the fit tolerance, the first split is equal and the
    predictions are the original label values."""
    jm, cols = jax_classifier
    tm = tops.TrainClassifier(model=GBDTClassifier(device="cpu", **_GBDT),
                              labelCol="label").fit(Dataset(dict(cols)))
    assert tm.featurizer.plan == jm.featurizer.plan
    assert tm.levels == jm.levels == ["no", "yes"]
    hold = _frame(25, n=400)
    _same(tm.featurizer.transform(Dataset(dict(hold))),
          jm.featurizer.transform(JDataset(dict(hold))))
    to = tm.transform(Dataset(dict(hold)))
    jo = jm.transform(JDataset(dict(hold)))
    assert to.columns == jo.columns
    assert set(to["prediction"]) <= {"no", "yes"}
    y = (np.asarray(hold["label"]) == "yes").astype(np.float64)
    ta = auc(y, np.stack(to["probability"])[:, 1])
    ja = auc(y, np.stack(jo["probability"])[:, 1])
    assert ta > 0.85 and abs(ta - ja) <= 0.005, (ta, ja)
    tt0, jt0 = tm.innerModel.booster.trees[0], jm.innerModel.booster.trees[0]
    assert tt0.split_feature[0] == jt0.split_feature[0]
    assert tt0.split_bin[0] == jt0.split_bin[0]
    stats = tops.ComputeModelStatistics(
        labelCol="label", scoredLabelsCol="prediction",
        scoresCol="probability", evaluationMetric="classification"
    ).transform(to)
    assert stats["AUC"][0] == pytest.approx(ta, abs=1e-12)
    assert stats["accuracy"][0] > 0.75
