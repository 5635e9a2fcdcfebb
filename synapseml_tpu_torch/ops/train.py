"""High-level train + evaluate stages.

Re-designs the reference's ``train`` package (reference:
core/src/main/scala/com/microsoft/azure/synapse/ml/train/
TrainClassifier.scala:52, TrainRegressor.scala, ComputeModelStatistics.scala:24,
ComputePerInstanceStatistics.scala; metric names from
core/metrics/MetricConstants.scala): wrap any estimator with
auto-featurization + label indexing, and compute metric tables from scored
datasets.  The PyTorch port's copy of the JAX package's ``ops/train.py``:
featurizing, label indexing and the metric tables are numpy on the host,
as there; the wrapped estimator runs where it was built (a port GBDT on
its ``device`` param).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataset import Dataset, find_unused_column_name
from ..core.params import (BoolParam, IntParam, ListParam, Param,
                           PyObjectParam, StringParam)
from ..core.pipeline import Estimator, Model, Transformer
from .featurize import Featurize, ValueIndexer


class MetricConstants:
    """reference: core/metrics/MetricConstants.scala."""

    ACCURACY = "accuracy"
    PRECISION = "precision"
    RECALL = "recall"
    AUC = "AUC"
    MSE = "mse"
    RMSE = "rmse"
    R2 = "r2"
    MAE = "mae"
    ALL = "all"
    CLASSIFICATION_METRICS = (ACCURACY, PRECISION, RECALL, AUC)
    REGRESSION_METRICS = (MSE, RMSE, R2, MAE)


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (equivalent to trapezoidal ROC integration)."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    pos = labels > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks over ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class TrainClassifier(Estimator):
    """Featurize + index labels + fit any classifier in one call
    (reference: train/TrainClassifier.scala:52)."""

    model = PyObjectParam(doc="underlying classifier estimator")
    labelCol = StringParam(doc="label column", default="label")
    featuresCol = StringParam(doc="assembled features column",
                              default="TrainClassifier_features")
    inputCols = ListParam(doc="feature source columns (default: all but label)")
    numFeatures = IntParam(doc="hash dim for text/high-cardinality", default=0)
    reindexLabel = BoolParam(doc="index label values to 0..K-1", default=True)

    def __init__(self, model: Optional[Estimator] = None,
                 labelCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if labelCol is not None:
            self.set("labelCol", labelCol)

    def _fit(self, ds: Dataset) -> "TrainedClassifierModel":
        label = self.labelCol
        feature_cols = (self.inputCols if self.is_set("inputCols")
                        else [c for c in ds.columns if c != label])
        feat = Featurize(inputCols=feature_cols, outputCol=self.featuresCol)
        if self.numFeatures:
            feat.set("numFeatures", self.numFeatures)
        feat_model = feat.fit(ds)
        cur = feat_model.transform(ds)
        levels: Optional[List[Any]] = None
        if self.reindexLabel:
            indexer = ValueIndexer(inputCol=label, outputCol=label).fit(cur)
            levels = indexer.levels
            cur = indexer.transform(cur)
        inner = self.model.copy()
        if inner.has_param("featuresCol"):
            inner.set("featuresCol", self.featuresCol)
        if inner.has_param("labelCol"):
            inner.set("labelCol", label)
        fitted = inner.fit(cur)
        return TrainedClassifierModel(
            featurizer=feat_model, innerModel=fitted, labelCol=label,
            featuresCol=self.featuresCol, levels=levels)


class TrainedClassifierModel(Model):
    """reference: train/TrainClassifier.scala TrainedClassifierModel."""

    featurizer = PyObjectParam(doc="fitted featurize model")
    innerModel = PyObjectParam(doc="fitted classifier")
    labelCol = StringParam(doc="label column", default="label")
    featuresCol = StringParam(doc="features column")
    levels = ListParam(doc="original label values by class index")

    def _transform(self, ds: Dataset) -> Dataset:
        cur = self.featurizer.transform(ds)
        out = self.innerModel.transform(cur)
        if out.num_rows and self.get("levels"):
            # inverse-map class indices back to the original label values
            levels = self.levels
            pred_col = (self.innerModel.predictionCol
                        if self.innerModel.has_param("predictionCol")
                        else "prediction")
            if pred_col in out:
                idx = out[pred_col].astype(np.int64)
                vals = [levels[i] for i in idx]
                out = out.with_column(pred_col, vals)
        return out.drop(self.featuresCol) if self.featuresCol in out else out


class TrainRegressor(Estimator):
    """reference: train/TrainRegressor.scala."""

    model = PyObjectParam(doc="underlying regressor estimator")
    labelCol = StringParam(doc="label column", default="label")
    featuresCol = StringParam(doc="assembled features column",
                              default="TrainRegressor_features")
    inputCols = ListParam(doc="feature source columns (default: all but label)")
    numFeatures = IntParam(doc="hash dim for text/high-cardinality", default=0)

    def __init__(self, model: Optional[Estimator] = None,
                 labelCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set("model", model)
        if labelCol is not None:
            self.set("labelCol", labelCol)

    def _fit(self, ds: Dataset) -> "TrainedRegressorModel":
        label = self.labelCol
        feature_cols = (self.inputCols if self.is_set("inputCols")
                        else [c for c in ds.columns if c != label])
        feat = Featurize(inputCols=feature_cols, outputCol=self.featuresCol)
        if self.numFeatures:
            feat.set("numFeatures", self.numFeatures)
        feat_model = feat.fit(ds)
        cur = feat_model.transform(ds)
        inner = self.model.copy()
        if inner.has_param("featuresCol"):
            inner.set("featuresCol", self.featuresCol)
        if inner.has_param("labelCol"):
            inner.set("labelCol", label)
        fitted = inner.fit(cur)
        return TrainedRegressorModel(
            featurizer=feat_model, innerModel=fitted, labelCol=label,
            featuresCol=self.featuresCol)


class TrainedRegressorModel(Model):
    featurizer = PyObjectParam(doc="fitted featurize model")
    innerModel = PyObjectParam(doc="fitted regressor")
    labelCol = StringParam(doc="label column", default="label")
    featuresCol = StringParam(doc="features column")

    def _transform(self, ds: Dataset) -> Dataset:
        cur = self.featurizer.transform(ds)
        out = self.innerModel.transform(cur)
        return out.drop(self.featuresCol) if self.featuresCol in out else out


class ComputeModelStatistics(Transformer):
    """Metric table from a scored dataset (reference:
    train/ComputeModelStatistics.scala:24 — evaluationMetric selects
    classification vs regression; confusion matrix included)."""

    evaluationMetric = StringParam(doc="classification|regression|all "
                                   "or a single metric name", default="all")
    labelCol = StringParam(doc="label column", default="label")
    scoresCol = StringParam(doc="raw score / probability column")
    scoredLabelsCol = StringParam(doc="predicted label column",
                                  default="prediction")

    #: populated by the last transform (reference exposes confusionMatrix
    #: as a field on the transformer)
    confusion_matrix: Optional[np.ndarray] = None

    def _classification(self, labels, preds, scores) -> Dict[str, float]:
        classes = np.unique(np.concatenate([labels, preds]))
        k = len(classes)
        remap = {v: i for i, v in enumerate(classes)}
        li = np.fromiter((remap[x] for x in labels), dtype=np.int64)
        pi = np.fromiter((remap[x] for x in preds), dtype=np.int64)
        cm = np.zeros((k, k), dtype=np.int64)
        np.add.at(cm, (li, pi), 1)
        self.confusion_matrix = cm
        acc = float((li == pi).mean())
        # macro-averaged precision/recall like the reference's weighted stats
        precisions, recalls = [], []
        for c in range(k):
            tp = cm[c, c]
            fp = cm[:, c].sum() - tp
            fn = cm[c, :].sum() - tp
            precisions.append(tp / (tp + fp) if tp + fp else 0.0)
            recalls.append(tp / (tp + fn) if tp + fn else 0.0)
        out = {
            MetricConstants.ACCURACY: acc,
            MetricConstants.PRECISION: float(np.mean(precisions)),
            MetricConstants.RECALL: float(np.mean(recalls)),
        }
        if scores is not None and k == 2:
            out[MetricConstants.AUC] = roc_auc(li, scores)
        return out

    def _regression(self, labels, preds) -> Dict[str, float]:
        labels = labels.astype(np.float64)
        preds = preds.astype(np.float64)
        err = labels - preds
        mse = float(np.mean(err ** 2))
        ss_tot = float(np.sum((labels - labels.mean()) ** 2))
        return {
            MetricConstants.MSE: mse,
            MetricConstants.RMSE: float(np.sqrt(mse)),
            MetricConstants.R2: (1.0 - float(np.sum(err ** 2)) / ss_tot
                                 if ss_tot > 0 else float("nan")),
            MetricConstants.MAE: float(np.mean(np.abs(err))),
        }

    def _transform(self, ds: Dataset) -> Dataset:
        labels = ds[self.labelCol]
        preds = ds[self.scoredLabelsCol]
        metric = self.evaluationMetric
        scores = None
        if self.is_set("scoresCol") and self.scoresCol in ds:
            raw = ds[self.scoresCol]
            if raw.dtype == object:  # probability vectors: P(class 1)
                scores = np.array([np.asarray(v).ravel()[-1] for v in raw])
            else:
                scores = raw.astype(np.float64)
        if metric in ("regression",) + MetricConstants.REGRESSION_METRICS:
            stats = self._regression(labels, preds)
        elif metric in ("classification", "all") + MetricConstants.CLASSIFICATION_METRICS:
            is_classification = (labels.dtype != object and
                                 np.array_equal(labels.astype(np.float64),
                                                labels.astype(np.int64).astype(np.float64))
                                 and len(np.unique(labels)) <= 100)
            if metric == "all" and not is_classification:
                stats = self._regression(labels, preds)
            else:
                stats = self._classification(labels, preds, scores)
        else:
            raise ValueError(f"unknown evaluationMetric {metric!r}")
        if metric in MetricConstants.CLASSIFICATION_METRICS + MetricConstants.REGRESSION_METRICS:
            if metric not in stats:
                raise ValueError(
                    f"metric {metric!r} unavailable: AUC requires scoresCol "
                    "to be set and binary labels")
            stats = {metric: stats[metric]}
        return Dataset({k: np.asarray([v]) for k, v in stats.items()},
                       num_partitions=1)


class ComputePerInstanceStatistics(Transformer):
    """Per-row loss/error columns (reference:
    train/ComputePerInstanceStatistics.scala — log-loss for classification,
    squared/absolute error for regression)."""

    evaluationMetric = StringParam(doc="classification|regression",
                                   default="regression")
    labelCol = StringParam(doc="label column", default="label")
    scoresCol = StringParam(doc="probability vector column")
    scoredLabelsCol = StringParam(doc="predicted label column",
                                  default="prediction")

    def _transform(self, ds: Dataset) -> Dataset:
        labels = ds[self.labelCol]
        if self.evaluationMetric == "classification":
            probs = ds[self.scoresCol]
            li = labels.astype(np.int64)
            p_true = np.array([
                float(np.asarray(probs[i]).ravel()[li[i]])
                for i in range(len(li))])
            log_loss = -np.log(np.clip(p_true, 1e-15, 1.0))
            return ds.with_column("log_loss", log_loss)
        preds = ds[self.scoredLabelsCol].astype(np.float64)
        err = labels.astype(np.float64) - preds
        return ds.with_columns({"L1_loss": np.abs(err), "L2_loss": err ** 2})
