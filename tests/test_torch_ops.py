"""The port's ops layer (stages / featurize / text / train) under the
contracts ``tests/test_ops.py`` holds the JAX package's to: the same
per-stage fuzzing suites (``tests/torch_fuzzing.py``: fit/transform,
save → ``load_stage`` → transform, getters/setters, poisoned rows) and
behavior checks, with every GBDT on ``device="cpu"``.  The parity of the
port's stages with the JAX package's is in ``test_torch_ops_parity.py``.
"""

import numpy as np
import pytest

from synapseml_tpu_torch.core import Dataset, Pipeline
from synapseml_tpu_torch.ops import (Cacher, ClassBalancer, CleanMissingData,
                               ComputeModelStatistics,
                               ComputePerInstanceStatistics, CountSelector,
                               DataConversion, DropColumns,
                               DynamicMiniBatchTransformer, EnsembleByKey,
                               Explode, Featurize, FixedMiniBatchTransformer,
                               FlattenBatch, IndexToValue, Lambda,
                               MultiColumnAdapter, MultiNGram, PageSplitter,
                               PartitionConsolidator, RenameColumn,
                               Repartition, SelectColumns,
                               StratifiedRepartition, SummarizeData,
                               TextFeaturizer, TextPreprocessor, Timer,
                               TrainClassifier, TrainRegressor,
                               UDFTransformer, UnicodeNormalize, ValueIndexer)
from synapseml_tpu_torch.core.hashing import hash_features, murmurhash3_32

from torch_fuzzing import TestObject, TransformerFuzzing, EstimatorFuzzing
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def small_ds():
    return Dataset({
        "a": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
        "b": np.array([0.5, np.nan, 1.5, 2.5, np.nan, 3.5]),
        "cat": ["x", "y", "x", "z", "y", "x"],
        "label": np.array([0, 1, 0, 1, 1, 0]),
    }, num_partitions=2)


# -- plumbing stages -------------------------------------------------------


class TestDropColumns(TransformerFuzzing):
    def fuzzing_objects(self):
        return [TestObject(DropColumns(["b"]), small_ds())]

    def test_behavior(self):
        out = DropColumns(["a", "cat"]).transform(small_ds())
        assert out.columns == ["b", "label"]

    def test_missing_raises(self):
        with pytest.raises(KeyError):
            DropColumns(["nope"]).transform(small_ds())


class TestSelectColumns(TransformerFuzzing):
    def fuzzing_objects(self):
        return [TestObject(SelectColumns(["a", "label"]), small_ds())]

    def test_behavior(self):
        out = SelectColumns(["label", "a"]).transform(small_ds())
        assert out.columns == ["label", "a"]


class TestRenameColumn(TransformerFuzzing):
    def fuzzing_objects(self):
        return [TestObject(RenameColumn(inputCol="a", outputCol="aa"),
                           small_ds())]

    def test_behavior(self):
        out = RenameColumn(inputCol="a", outputCol="z").transform(small_ds())
        assert "z" in out and "a" not in out


class TestRepartitionCacher(TransformerFuzzing):
    def fuzzing_objects(self):
        return [TestObject(Repartition(3), small_ds()),
                TestObject(Cacher(), small_ds()),
                TestObject(PartitionConsolidator(), small_ds())]

    def test_behavior(self):
        assert Repartition(3).transform(small_ds()).num_partitions == 3
        assert PartitionConsolidator().transform(small_ds()).num_partitions == 1


def _double(a):
    return a * 2


def _drop_cat(ds):
    return ds.drop("cat")


class TestUDFAndLambda(TransformerFuzzing):
    def fuzzing_objects(self):
        return [TestObject(
            UDFTransformer(inputCol="a", outputCol="a2", udf=_double),
            small_ds())]

    def test_udf(self):
        out = UDFTransformer(inputCol="a", outputCol="a2",
                             udf=lambda a: a * 2).transform(small_ds())
        np.testing.assert_allclose(out["a2"], small_ds()["a"] * 2)

    def test_udf_multi(self):
        out = UDFTransformer(inputCols=["a", "b"], outputCol="s",
                             udf=lambda a, b: a + b).transform(small_ds())
        assert "s" in out

    def test_lambda(self):
        out = Lambda(lambda ds: ds.drop("cat")).transform(small_ds())
        assert "cat" not in out


class TestExplodeFlatten:
    def test_explode(self):
        ds = Dataset({"k": [1, 2], "v": [[1, 2, 3], [4]]})
        out = Explode(inputCol="v").transform(ds)
        assert out.num_rows == 4
        np.testing.assert_array_equal(out["k"], [1, 1, 1, 2])

    def test_minibatch_roundtrip(self):
        ds = small_ds()
        batched = FixedMiniBatchTransformer(batchSize=4).transform(ds)
        assert batched.num_rows == 2
        assert len(batched["a"][0]) == 4
        flat = FlattenBatch().transform(batched)
        assert flat.num_rows == ds.num_rows
        np.testing.assert_allclose(flat["a"].astype(float), ds["a"])

    def test_dynamic_minibatch(self):
        ds = small_ds().repartition(2)
        batched = DynamicMiniBatchTransformer(maxBatchSize=2).transform(ds)
        assert batched.num_rows == 3 or batched.num_rows == 4  # 6 rows / cap 2


class TestEnsembleByKey(TransformerFuzzing):
    def fuzzing_objects(self):
        return [TestObject(EnsembleByKey(keys=["cat"], cols=["a"]),
                           small_ds())]

    def test_behavior(self):
        out = EnsembleByKey(keys=["cat"], cols=["a"]).transform(small_ds())
        assert out.num_rows == 3
        row = {c: m for c, m in zip(out["cat"], out["mean(a)"])}
        np.testing.assert_allclose(row["x"], (1 + 3 + 6) / 3)


class TestClassBalancer(EstimatorFuzzing):
    def fuzzing_objects(self):
        return [TestObject(ClassBalancer(inputCol="label"), small_ds())]

    def test_weights(self):
        model = ClassBalancer(inputCol="label").fit(small_ds())
        out = model.transform(small_ds())
        w = out["weight"]
        assert np.isclose(w[small_ds()["label"] == 0].sum(),
                          w[small_ds()["label"] == 1].sum())


class TestStratifiedRepartition:
    def test_each_slice_has_both_classes(self):
        n = 40
        ds = Dataset({"x": np.arange(n, dtype=float),
                      "label": np.array([0] * 20 + [1] * 20)},
                     num_partitions=4)
        out = StratifiedRepartition(labelCol="label").transform(ds)
        for a, b in out.partition_bounds():
            part = out["label"][a:b]
            assert len(np.unique(part)) == 2

    def test_equal_mode_truncates(self):
        ds = Dataset({"x": np.arange(10.0),
                      "label": np.array([0] * 8 + [1] * 2)})
        out = StratifiedRepartition(labelCol="label", mode="equal").transform(ds)
        assert (out["label"] == 0).sum() == (out["label"] == 1).sum() == 2


class TestTextStages(TransformerFuzzing):
    def fuzzing_objects(self):
        ds = Dataset({"t": ["Hello World", "FOO bar"]})
        return [
            TestObject(TextPreprocessor(inputCol="t", outputCol="o",
                                        map={"hello": "hi"},
                                        normFunc="lowerCase"), ds),
            TestObject(UnicodeNormalize(inputCol="t", outputCol="o"), ds),
        ]

    def test_preprocessor_longest_match(self):
        ds = Dataset({"t": ["abcd"]})
        out = TextPreprocessor(inputCol="t", outputCol="o",
                               map={"ab": "1", "abc": "2"}).transform(ds)
        assert out["o"][0] == "2d"

    def test_unicode(self):
        ds = Dataset({"t": ["Héllo"]})
        out = UnicodeNormalize(inputCol="t", outputCol="o").transform(ds)
        assert out["o"][0].startswith("he")


class TestSummarizeData:
    def test_summary(self):
        out = SummarizeData().transform(small_ds())
        assert out.num_rows == 4  # one per column
        feats = list(out["Feature"])
        i = feats.index("a")
        assert out["Mean"][i] == pytest.approx(3.5)
        ib = feats.index("b")
        assert out["Missing Value Count"][ib] == 2


class TestTimer:
    def test_timer_wraps(self):
        model = Timer(DropColumns(["b"])).fit(small_ds())
        out = model.transform(small_ds())
        assert "b" not in out
        assert model.last_transform_time_s >= 0


class TestMultiColumnAdapter:
    def test_adapter(self):
        ds = Dataset({"t1": ["A b"], "t2": ["C d"]})
        out = MultiColumnAdapter(
            baseStage=UnicodeNormalize(),
            inputCols=["t1", "t2"], outputCols=["o1", "o2"]).transform(ds)
        assert out["o1"][0] == "a b" and out["o2"][0] == "c d"


# -- featurize -------------------------------------------------------------


class TestValueIndexer(EstimatorFuzzing):
    def fuzzing_objects(self):
        return [TestObject(ValueIndexer(inputCol="cat", outputCol="idx"),
                           small_ds())]

    def test_roundtrip(self):
        model = ValueIndexer(inputCol="cat", outputCol="idx").fit(small_ds())
        out = model.transform(small_ds())
        back = IndexToValue(inputCol="idx", outputCol="cat2",
                            levels=model.levels).transform(out)
        assert list(back["cat2"]) == list(small_ds()["cat"])

    def test_unseen_raises(self):
        model = ValueIndexer(inputCol="cat", outputCol="idx").fit(small_ds())
        bad = Dataset({"cat": ["unseen"]})
        with pytest.raises(ValueError):
            model.transform(bad)


class TestCleanMissingData(EstimatorFuzzing):
    def fuzzing_objects(self):
        return [TestObject(CleanMissingData(inputCols=["b"], outputCols=["b"]),
                           small_ds())]

    def test_mean_fill(self):
        model = CleanMissingData(inputCols=["b"], outputCols=["b"]).fit(small_ds())
        out = model.transform(small_ds())
        assert np.isfinite(out["b"]).all()
        assert out["b"][1] == pytest.approx(np.nanmean(small_ds()["b"]))

    def test_custom_fill(self):
        model = CleanMissingData(inputCols=["b"], outputCols=["b"],
                                 cleaningMode="Custom", customValue=-1.0
                                 ).fit(small_ds())
        assert model.transform(small_ds())["b"][1] == -1.0


class TestDataConversion:
    def test_convert(self):
        out = DataConversion(cols=["a"], convertTo="integer").transform(small_ds())
        assert out["a"].dtype == np.int32
        out2 = DataConversion(cols=["label"], convertTo="string").transform(small_ds())
        assert out2["label"].dtype == object


class TestCountSelector(EstimatorFuzzing):
    def fuzzing_objects(self):
        ds = Dataset({"features": [np.array([1.0, 0.0, 2.0]),
                                   np.array([3.0, 0.0, 0.0])]})
        return [TestObject(CountSelector(), ds)]

    def test_drops_zero_cols(self):
        ds = Dataset({"features": [np.array([1.0, 0.0, 2.0]),
                                   np.array([3.0, 0.0, 0.0])]})
        out = CountSelector().fit(ds).transform(ds)
        assert len(out["features"][0]) == 2


class TestFeaturize(EstimatorFuzzing):
    def fuzzing_objects(self):
        return [TestObject(Featurize(inputCols=["a", "b", "cat"],
                                     outputCol="features"), small_ds())]

    def test_mixed_columns(self):
        model = Featurize(inputCols=["a", "b", "cat"],
                          outputCol="features").fit(small_ds())
        out = model.transform(small_ds())
        vec = np.stack(out["features"])
        # a + b + one-hot(cat: 3 levels) = 5 dims
        assert vec.shape == (6, 5)
        assert np.isfinite(vec).all()


# -- text ------------------------------------------------------------------


class TestHashing:
    def test_murmur_known_values(self):
        # reference vectors for murmur3_x86_32 (public test vectors)
        assert murmurhash3_32(b"", 0) == 0
        assert murmurhash3_32(b"", 1) == 0x514E28B7
        assert murmurhash3_32(b"abc", 0) == 0xB3DD93FA
        assert murmurhash3_32(b"Hello, world!", 1234) == 0xFAF6CDB3

    def test_hash_features_deterministic(self):
        a = hash_features(["x", "y", "x"], 16)
        b = hash_features(["x", "y", "x"], 16)
        np.testing.assert_array_equal(a, b)
        assert np.abs(a).sum() == 3


class TestTextFeaturizer(EstimatorFuzzing):
    def fuzzing_objects(self):
        ds = Dataset({"t": ["the quick brown fox", "jumped over the dog",
                            "the dog slept"]})
        return [TestObject(TextFeaturizer(inputCol="t", outputCol="f",
                                          numFeatures=64), ds)]

    def test_idf_downweights_common(self):
        ds = Dataset({"t": ["cat sat", "cat ran", "cat hid", "dog barked"]})
        model = TextFeaturizer(inputCol="t", outputCol="f",
                               numFeatures=128).fit(ds)
        out = model.transform(ds)
        vec = np.stack(out["f"])
        cat_idx = murmurhash3_32("cat", 0) % 128
        dog_idx = murmurhash3_32("dog", 0) % 128
        assert vec[0, cat_idx] < vec[3, dog_idx]  # common term downweighted

    def test_ngrams(self):
        ds = Dataset({"t": ["a b c"]})
        model = TextFeaturizer(inputCol="t", outputCol="f", numFeatures=64,
                               useNGram=True, nGramLength=2,
                               useIDF=False).fit(ds)
        vec = np.stack(model.transform(ds)["f"])
        assert vec.sum() == 2  # "a b", "b c"


class TestMultiNGramPageSplitter:
    def test_multi_ngram(self):
        ds = Dataset({"toks": [["a", "b", "c"]]})
        out = MultiNGram(inputCol="toks", outputCol="g",
                         lengths=[1, 2]).transform(ds)
        assert out["g"][0] == ["a", "b", "c", "a b", "b c"]

    def test_page_splitter(self):
        text = "word " * 100  # 500 chars
        ds = Dataset({"t": [text]})
        out = PageSplitter(inputCol="t", outputCol="p",
                           maximumPageLength=100,
                           minimumPageLength=80).transform(ds)
        pages = out["p"][0]
        assert all(len(p) <= 100 for p in pages)
        assert "".join(pages) == text


# -- train -----------------------------------------------------------------


class TestTrainClassifier(EstimatorFuzzing):
    """The fuzzing stage hashes at 64 dims where test_ops.py takes the
    default 4096: the poisoned string column of 200 levels is hashed, and
    the port's CPU histograms (the kernels' plain version, int64 limbs for
    every feature, bin and slot) take ~1 GB a wave at 4096 features."""
    rtol = 1e-3

    def _ds(self):
        rng = np.random.default_rng(0)
        n = 200
        x = rng.normal(size=(n, 3))
        y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
        return Dataset({"f1": x[:, 0], "f2": x[:, 1], "f3": x[:, 2],
                        "cat": np.where(y == 1, "hi", "lo").tolist(),
                        "label": y}, num_partitions=2)

    def fuzzing_objects(self):
        from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
        return [TestObject(
            TrainClassifier(model=GBDTClassifier(device="cpu", numIterations=5),
                            labelCol="label", numFeatures=64), self._ds())]

    def test_end_to_end(self):
        from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
        ds = self._ds()
        model = TrainClassifier(model=GBDTClassifier(device="cpu", numIterations=20),
                                labelCol="label").fit(ds)
        scored = model.transform(ds)
        stats = ComputeModelStatistics(
            labelCol="label", scoredLabelsCol="prediction",
            scoresCol="probability").transform(scored)
        assert stats["accuracy"][0] > 0.9
        assert stats["AUC"][0] > 0.95


class TestTrainRegressor(EstimatorFuzzing):
    rtol = 1e-3

    def _ds(self):
        rng = np.random.default_rng(1)
        n = 200
        x = rng.normal(size=(n, 3))
        y = 2 * x[:, 0] - x[:, 1] + 0.1 * rng.normal(size=n)
        return Dataset({"f1": x[:, 0], "f2": x[:, 1], "f3": x[:, 2],
                        "label": y}, num_partitions=2)

    def fuzzing_objects(self):
        from synapseml_tpu_torch.models.gbdt.estimators import GBDTRegressor
        return [TestObject(
            TrainRegressor(model=GBDTRegressor(device="cpu", numIterations=5),
                           labelCol="label", numFeatures=64), self._ds())]

    def test_end_to_end(self):
        from synapseml_tpu_torch.models.gbdt.estimators import GBDTRegressor
        ds = self._ds()
        model = TrainRegressor(model=GBDTRegressor(device="cpu", numIterations=30),
                               labelCol="label").fit(ds)
        scored = model.transform(ds)
        stats = ComputeModelStatistics(
            evaluationMetric="regression", labelCol="label",
            scoredLabelsCol="prediction").transform(scored)
        assert stats["r2"][0] > 0.8
        per_inst = ComputePerInstanceStatistics(
            labelCol="label", scoredLabelsCol="prediction").transform(scored)
        assert "L2_loss" in per_inst


class TestComputeModelStatistics:
    def test_classification_metrics(self):
        ds = Dataset({"label": np.array([0, 0, 1, 1]),
                      "prediction": np.array([0, 1, 1, 1]),
                      "score": np.array([0.1, 0.6, 0.8, 0.9])})
        cms = ComputeModelStatistics(labelCol="label",
                                     scoredLabelsCol="prediction",
                                     scoresCol="score")
        out = cms.transform(ds)
        assert out["accuracy"][0] == pytest.approx(0.75)
        assert out["AUC"][0] == pytest.approx(1.0)
        np.testing.assert_array_equal(cms.confusion_matrix,
                                      [[1, 1], [0, 2]])

    def test_auc_ties(self):
        from synapseml_tpu_torch.ops.train import roc_auc
        assert roc_auc(np.array([0, 1]), np.array([0.5, 0.5])) == pytest.approx(0.5)

    def test_regression_metrics(self):
        ds = Dataset({"label": np.array([1.0, 2.0, 3.0]),
                      "prediction": np.array([1.0, 2.0, 3.0])})
        out = ComputeModelStatistics(evaluationMetric="regression").transform(ds)
        assert out["rmse"][0] == 0.0 and out["r2"][0] == 1.0


class TestReviewRegressions:
    """Regressions for review findings on the ops layer."""

    def test_train_classifier_inverse_maps_labels(self):
        from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
        rng = np.random.default_rng(0)
        n = 100
        x = rng.normal(size=n)
        ds = Dataset({"f1": x, "label": np.where(x > 0, 7, 2)})
        model = TrainClassifier(model=GBDTClassifier(device="cpu", numIterations=10),
                                labelCol="label").fit(ds)
        preds = model.transform(ds)["prediction"]
        assert set(np.unique(preds)) <= {2, 7}

    def test_featurize_honors_num_features(self):
        cats = [f"id{i}" for i in range(300)]
        ds = Dataset({"c": cats, "label": np.zeros(300)})
        model = Featurize(inputCols=["c"], numFeatures=2048).fit(ds)
        dim = len(model.transform(ds)["features"][0])
        assert dim == 2048

    def test_text_preprocessor_normalized_keys(self):
        ds = Dataset({"t": ["Hello world"]})
        out = TextPreprocessor(inputCol="t", outputCol="o",
                               map={"Hello": "hi"},
                               normFunc="lowerCase").transform(ds)
        assert out["o"][0] == "hi world"

    def test_auc_without_scores_raises_cleanly(self):
        ds = Dataset({"label": np.array([0, 1]),
                      "prediction": np.array([0, 1])})
        with pytest.raises(ValueError, match="AUC requires"):
            ComputeModelStatistics(evaluationMetric="AUC").transform(ds)


class TestNewStageFuzzing(TransformerFuzzing):
    """Fuzzing coverage (experiment + serialization + getter/setter) for
    the parity stages added after the original suites."""

    def fuzzing_objects(self):
        import json
        from synapseml_tpu_torch.image import ImageSetAugmenter
        from synapseml_tpu_torch.models.online import (DSJsonTransformer,
                                                 VectorZipper)

        img = np.arange(12, dtype=np.float64).reshape(2, 2, 3)
        return [
            TestObject(ImageSetAugmenter(flipLeftRight=True, device="cpu"),
                       Dataset({"image": [img]})),
            TestObject(VectorZipper(inputCols=["a", "b"], outputCol="z"),
                       Dataset({"a": [1.0], "b": [2.0]})),
            TestObject(DSJsonTransformer(),
                       Dataset({"value": [json.dumps(
                           {"EventId": "e", "_label_cost": -1.0,
                            "_label_probability": 0.5, "_labelIndex": 1})]})),
        ]
