"""TuneHyperparameters / FindBestModel.

Re-designs the reference's thread-pooled random search (reference:
core/.../automl/TuneHyperparameters.scala:38-150 — ExecutorService with
``parallelism`` threads, each fitting one param map and evaluating
accuracy-style metrics on a random train/test split) and FindBestModel
(automl/FindBestModel.scala).  Trials run in a thread pool of
``parallelism`` workers here too, each fitting its clones on the thread
it runs on.  A port GBDT on the card launches its kernels on the card's
current stream from every thread, so the trials' kernels queue on one
stream and the threads overlap only their host work.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (FloatParam, IntParam, PyObjectParam, StringParam)
from ..core.pipeline import Estimator, Evaluator, Model
from ..ops.train import MetricConstants, roc_auc
from .space import GridSpace, RandomSpace


def _score(metric: str, ds: Dataset, label_col: str, pred_col: str,
           scores_col: Optional[str]) -> float:
    y = np.asarray(ds[label_col], np.float64)
    if metric == MetricConstants.AUC:
        if scores_col and scores_col in ds:
            sc = ds[scores_col]
            s = (np.stack([np.asarray(v, np.float64) for v in sc])[:, -1]
                 if sc.dtype == object else sc.astype(np.float64))
        else:
            s = np.asarray(ds[pred_col], np.float64)
        return roc_auc(y, s)
    p = np.asarray(ds[pred_col], np.float64)
    if metric == MetricConstants.ACCURACY:
        return float((p == y).mean())
    if metric == MetricConstants.PRECISION:
        tp = float(((p > 0) & (y > 0)).sum())
        return tp / max(float((p > 0).sum()), 1.0)
    if metric == MetricConstants.RECALL:
        tp = float(((p > 0) & (y > 0)).sum())
        return tp / max(float((y > 0).sum()), 1.0)
    if metric == MetricConstants.MSE:
        return float(((p - y) ** 2).mean())
    if metric == MetricConstants.RMSE:
        return float(np.sqrt(((p - y) ** 2).mean()))
    if metric == MetricConstants.MAE:
        return float(np.abs(p - y).mean())
    if metric == MetricConstants.R2:
        ss_res = float(((p - y) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum()) or 1.0
        return 1.0 - ss_res / ss_tot
    raise ValueError(f"unknown metric {metric}")


def _larger_better(metric: str) -> bool:
    return metric not in (MetricConstants.MSE, MetricConstants.RMSE,
                          MetricConstants.MAE)


class TuneHyperparameters(Estimator):
    """Parallel random/grid hyperparameter search
    (reference: TuneHyperparameters.scala:38)."""

    models = PyObjectParam(doc="candidate estimators (param-map stages "
                           "reference these instances)")
    evaluationMetric = StringParam(doc="metric name", default="accuracy")
    paramSpace = PyObjectParam(doc="GridSpace or RandomSpace")
    numRuns = IntParam(doc="trials for RandomSpace", default=10)
    parallelism = IntParam(doc="concurrent fits", default=4)
    seed = IntParam(doc="train/test split seed", default=0)
    trainRatio = FloatParam(doc="train fraction", default=0.75)
    labelCol = StringParam(doc="label column", default="label")
    predictionCol = StringParam(doc="prediction column", default="prediction")
    scoresCol = StringParam(doc="probability/raw column for AUC",
                            default="probability")
    evaluator = PyObjectParam(doc="optional Evaluator overriding the metric")

    def _fit(self, ds: Dataset) -> "TuneHyperparametersModel":
        space = self.get("paramSpace")
        if space is None:
            raise ValueError("paramSpace is required")
        if isinstance(space, RandomSpace):
            maps = list(space.param_maps(int(self.numRuns)))
        else:
            maps = list(space.param_maps())
        # candidates in `models` with no paramSpace entry still compete,
        # fitted once with their declared defaults (the reference sweeps
        # every model in `models`)
        referenced = {id(stage) for pm in maps for stage, _, _ in pm}
        for est in (self.get("models") or []):
            if id(est) not in referenced:
                maps.append([(est, None, None)])
        train, test = ds.random_split([self.trainRatio,
                                       1 - self.trainRatio],
                                      seed=int(self.seed))
        metric = self.evaluationMetric
        ev: Optional[Evaluator] = self.get("evaluator")

        def one_trial(pm: List[Tuple[Any, str, Any]]):
            # group assignments by estimator instance, clone, apply
            by_stage: Dict[int, Any] = {}
            assign: Dict[int, List[Tuple[str, Any]]] = {}
            for stage, name, val in pm:
                by_stage.setdefault(id(stage), stage)
                assign.setdefault(id(stage), [])
                if name is not None:  # (est, None, None) = defaults trial
                    assign[id(stage)].append((name, val))
            results = []
            for sid, stage in by_stage.items():
                clone = stage.copy()
                for name, val in assign[sid]:
                    clone.set(name, val)
                model = clone.fit(train)
                scored = model.transform(test)
                if ev is not None:
                    m = ev.evaluate(scored)
                else:
                    m = _score(metric, scored, self.labelCol,
                               self.predictionCol, self.scoresCol)
                results.append((m, model, assign[sid]))
            return results

        all_results = []
        workers = max(1, int(self.parallelism))
        if workers == 1:
            for pm in maps:
                all_results.extend(one_trial(pm))
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for res in pool.map(one_trial, maps):
                    all_results.extend(res)
        if not all_results:
            raise ValueError("empty parameter space")
        larger = (ev.is_larger_better() if ev is not None
                  else _larger_better(metric))
        key = (lambda t: t[0]) if larger else (lambda t: -t[0])
        best_metric, best_model, best_assign = max(all_results, key=key)

        out = TuneHyperparametersModel()
        out.set("bestModel", best_model)
        out.set("bestMetric", float(best_metric))
        out.set("allMetrics", [float(m) for m, _, _ in all_results])
        out.set("bestParams", {name: val for name, val in best_assign})
        return out


class TuneHyperparametersModel(Model):
    bestModel = PyObjectParam(doc="winning fitted model")
    bestMetric = PyObjectParam(doc="winning metric value")
    allMetrics = PyObjectParam(doc="metric per trial")
    bestParams = PyObjectParam(doc="winning param assignment")

    def _transform(self, ds: Dataset) -> Dataset:
        return self.get("bestModel").transform(ds)


class FindBestModel(Estimator):
    """Evaluate already-fitted models on a dataset and keep the best
    (reference: automl/FindBestModel.scala)."""

    models = PyObjectParam(doc="fitted Transformer candidates")
    evaluationMetric = StringParam(doc="metric name", default="accuracy")
    labelCol = StringParam(doc="label column", default="label")
    predictionCol = StringParam(doc="prediction column", default="prediction")
    scoresCol = StringParam(doc="probability column for AUC",
                            default="probability")

    def _fit(self, ds: Dataset) -> "BestModel":
        models = self.get("models")
        if not models:
            raise ValueError("models is required")
        metric = self.evaluationMetric
        scored_metrics = []
        for m in models:
            scored = m.transform(ds)
            scored_metrics.append(_score(metric, scored, self.labelCol,
                                         self.predictionCol, self.scoresCol))
        larger = _larger_better(metric)
        best_i = int(np.argmax(scored_metrics) if larger
                     else np.argmin(scored_metrics))
        out = BestModel()
        out.set("bestModel", models[best_i])
        out.set("bestModelMetrics", float(scored_metrics[best_i]))
        out.set("allModelMetrics", [float(m) for m in scored_metrics])
        return out


class BestModel(Model):
    bestModel = PyObjectParam(doc="winning fitted model")
    bestModelMetrics = PyObjectParam(doc="winning metric value")
    allModelMetrics = PyObjectParam(doc="metric per candidate")

    def _transform(self, ds: Dataset) -> Dataset:
        return self.get("bestModel").transform(ds)
