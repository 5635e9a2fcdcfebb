"""Ranking metrics + recommendation indexing.

Re-designs the reference's ranking tooling (reference: core/.../
recommendation/RankingEvaluator.scala, RecommendationIndexer.scala,
RankingTrainValidationSplit.scala).  Metrics are computed over padded
(U, k) prediction / (U, m) ground-truth id matrices in one vectorized
pass instead of Spark's RankingMetrics RDD job.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (FloatParam, IntParam, PyObjectParam, StringParam)
from ..core.pipeline import Estimator, Evaluator, Model


def _as_id_lists(col: np.ndarray) -> List[List]:
    """Normalize a column to per-user id lists; SAR-style recommendation
    dicts ({'item': ..., 'rating': ...}) are unwrapped to their item id so
    metric set operations stay hashable."""
    def unwrap(e):
        return e.get("item", e.get("value")) if isinstance(e, dict) else e

    out = []
    for v in col:
        if isinstance(v, (list, tuple, np.ndarray)):
            out.append([unwrap(e) for e in v])
        else:
            out.append([unwrap(v)])
    return out


def precision_at_k(pred: List[List], actual: List[List], k: int) -> float:
    vals = []
    for p, a in zip(pred, actual):
        if not a:
            continue
        hits = len(set(p[:k]) & set(a))
        vals.append(hits / k)
    return float(np.mean(vals)) if vals else 0.0


def recall_at_k(pred: List[List], actual: List[List], k: int) -> float:
    vals = []
    for p, a in zip(pred, actual):
        if not a:
            continue
        hits = len(set(p[:k]) & set(a))
        vals.append(hits / len(a))
    return float(np.mean(vals)) if vals else 0.0


def ndcg_at_k(pred: List[List], actual: List[List], k: int) -> float:
    vals = []
    for p, a in zip(pred, actual):
        if not a:
            continue
        aset = set(a)
        dcg = sum(1.0 / np.log2(i + 2) for i, x in enumerate(p[:k])
                  if x in aset)
        idcg = sum(1.0 / np.log2(i + 2) for i in range(min(len(a), k)))
        vals.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(vals)) if vals else 0.0


def mean_average_precision(pred: List[List], actual: List[List],
                           k: Optional[int] = None) -> float:
    vals = []
    for p, a in zip(pred, actual):
        if not a:
            continue
        aset = set(a)
        p_k = p[:k] if k else p
        hits, score = 0, 0.0
        for i, x in enumerate(p_k):
            if x in aset:
                hits += 1
                score += hits / (i + 1)
        vals.append(score / min(len(a), len(p_k)) if p_k else 0.0)
    return float(np.mean(vals)) if vals else 0.0


def diversity_at_k(pred: List[List], all_items: int, k: int) -> float:
    """Fraction of the catalogue covered by the union of top-k lists
    (RankingEvaluator diversityAtK)."""
    rec = set()
    for p in pred:
        rec.update(p[:k])
    return len(rec) / max(all_items, 1)


class RankingEvaluator(Evaluator):
    """Evaluate per-user ranked predictions
    (reference: RankingEvaluator.scala; metric names match)."""

    k = IntParam(doc="cutoff", default=10)
    metricName = StringParam(doc="metric", default="ndcgAt",
                             allowed=("ndcgAt", "map", "precisionAtk",
                                      "recallAtK", "diversityAtK",
                                      "maxDiversity"))
    predictionCol = StringParam(doc="per-user predicted id list",
                                default="prediction")
    labelCol = StringParam(doc="per-user ground-truth id list",
                           default="label")
    nItems = IntParam(doc="catalogue size for diversity metrics", default=-1)

    def evaluate(self, ds: Dataset) -> float:
        pred = _as_id_lists(ds[self.predictionCol])
        actual = _as_id_lists(ds[self.labelCol])
        k = int(self.k)
        name = self.metricName
        if name == "ndcgAt":
            return ndcg_at_k(pred, actual, k)
        if name == "map":
            return mean_average_precision(pred, actual)
        if name == "precisionAtk":
            return precision_at_k(pred, actual, k)
        if name == "recallAtK":
            return recall_at_k(pred, actual, k)
        n_items = int(self.nItems)
        if n_items <= 0:
            n_items = len({x for lst in pred + actual for x in lst})
        if name == "diversityAtK":
            return diversity_at_k(pred, n_items, k)
        if name == "maxDiversity":
            rec = {x for lst in pred for x in lst[:k]}
            act = {x for lst in actual for x in lst}
            return len(rec | act) / max(n_items, 1)
        raise ValueError(name)

    def is_larger_better(self) -> bool:
        return True


class RecommendationIndexer(Estimator):
    """String user/item ids -> contiguous int indices
    (reference: RecommendationIndexer.scala)."""

    userInputCol = StringParam(doc="raw user column", default="user")
    userOutputCol = StringParam(doc="indexed user column", default="userIdx")
    itemInputCol = StringParam(doc="raw item column", default="item")
    itemOutputCol = StringParam(doc="indexed item column", default="itemIdx")

    def _fit(self, ds: Dataset) -> "RecommendationIndexerModel":
        users = np.unique(ds[self.userInputCol])
        items = np.unique(ds[self.itemInputCol])
        model = RecommendationIndexerModel()
        model.set("userVocabulary", users)
        model.set("itemVocabulary", items)
        model._copy_values_from(self)
        return model


class RecommendationIndexerModel(Model):
    userInputCol = StringParam(doc="raw user column", default="user")
    userOutputCol = StringParam(doc="indexed user column", default="userIdx")
    itemInputCol = StringParam(doc="raw item column", default="item")
    itemOutputCol = StringParam(doc="indexed item column", default="itemIdx")
    userVocabulary = PyObjectParam(doc="user vocabulary")
    itemVocabulary = PyObjectParam(doc="item vocabulary")

    def _transform(self, ds: Dataset) -> Dataset:
        u_map = {u: i for i, u in enumerate(
            np.asarray(self.get("userVocabulary")))}
        i_map = {v: i for i, v in enumerate(
            np.asarray(self.get("itemVocabulary")))}
        u_idx = np.array([u_map.get(u, -1) for u in ds[self.userInputCol]],
                         np.int64)
        i_idx = np.array([i_map.get(v, -1) for v in ds[self.itemInputCol]],
                         np.int64)
        return ds.with_columns({self.userOutputCol: u_idx,
                                self.itemOutputCol: i_idx})

    def recover_user(self, idx: np.ndarray) -> np.ndarray:
        return np.asarray(self.get("userVocabulary"))[np.asarray(idx)]

    def recover_item(self, idx: np.ndarray) -> np.ndarray:
        return np.asarray(self.get("itemVocabulary"))[np.asarray(idx)]


def _top_k_actuals(ds: Dataset, user_col: str, item_col: str,
                   rating_col: str, k: int) -> Dict[Any, List]:
    """Per-user ground-truth item lists, windowed by rating desc / item
    asc and truncated to k (reference: RankingAdapter.scala transform's
    Window + rank <= k).  Null ratings sort last (Spark desc default);
    non-comparable item ties fall back to string ordering rather than
    raising."""
    has_rating = rating_col in ds.columns
    rows_by_user: Dict[Any, List] = {}
    for r in ds.iter_rows():
        rating = r[rating_col] if has_rating else 0.0
        # None and NaN both mean "no rating" (NaN is how float columns
        # store nulls here) and must sort last, not poison the sort
        neg = float("inf") if rating is None else -float(rating)
        if neg != neg:                      # NaN rating
            neg = float("inf")
        rows_by_user.setdefault(r[user_col], []).append((neg, r[item_col]))
    out = {}
    for u, rows in rows_by_user.items():
        try:
            ordered = sorted(rows)
        except TypeError:
            ordered = sorted(rows, key=lambda p: (p[0], str(p[1])))
        out[u] = [it for _, it in ordered[:k]]
    return out


class RankingTrainValidationSplit(Estimator):
    """Per-user leave-out split + fit + ranking evaluation
    (reference: RankingTrainValidationSplit.scala).  The estimator must
    produce a model exposing ``recommend_for_all_users``."""

    estimator = PyObjectParam(doc="recommender estimator (e.g. SAR)")
    evaluator = PyObjectParam(doc="RankingEvaluator")
    trainRatio = FloatParam(doc="per-user fraction of events in train",
                            default=0.75)
    userCol = StringParam(doc="user column", default="user")
    itemCol = StringParam(doc="item column", default="item")
    ratingCol = StringParam(doc="rating column for ground-truth ranking",
                            default="rating")
    seed = IntParam(doc="rng seed", default=0)
    minRatingsPerUser = IntParam(doc="drop users with fewer events",
                                 default=1)

    def _fit(self, ds: Dataset) -> "RankingTrainValidationSplitModel":
        rng = np.random.default_rng(int(self.seed))
        users = ds[self.userCol]
        uniq, inv = np.unique(users, return_inverse=True)
        train_mask = np.zeros(ds.num_rows, bool)
        for u in range(len(uniq)):
            rows = np.where(inv == u)[0]
            if len(rows) < int(self.minRatingsPerUser):
                continue
            rng.shuffle(rows)
            n_train = max(1, int(round(len(rows) * float(self.trainRatio))))
            train_mask[rows[:n_train]] = True
        train = ds.filter(train_mask)
        test = ds.filter(~train_mask)

        est: Estimator = self.get("estimator")
        model = est.fit(train)

        ev: RankingEvaluator = self.get("evaluator") or RankingEvaluator()
        k = int(ev.k)
        recs = model.recommend_for_all_users(k)
        rec_map: Dict[Any, List] = {}
        rec_col = recs.columns[1]
        for r in recs.iter_rows():
            rec_map[r[recs.columns[0]]] = [m["item"] for m in r[rec_col]]
        actual_map = _top_k_actuals(test, self.userCol, self.itemCol,
                                    self.ratingCol, k)
        eval_users = [u for u in actual_map if u in rec_map]
        eval_ds = Dataset({
            "user": np.asarray(eval_users, dtype=object),
            ev.predictionCol: [rec_map[u] for u in eval_users],
            ev.labelCol: [actual_map[u] for u in eval_users],
        }) if eval_users else None
        metric = ev.evaluate(eval_ds) if eval_ds is not None else 0.0

        out = RankingTrainValidationSplitModel()
        out.set("bestModel", model)
        out.set("validationMetric", float(metric))
        out._copy_values_from(self)
        return out


class RankingTrainValidationSplitModel(Model):
    userCol = StringParam(doc="user column", default="user")
    itemCol = StringParam(doc="item column", default="item")
    bestModel = PyObjectParam(doc="fitted recommender")
    validationMetric = PyObjectParam(doc="held-out ranking metric")

    def _transform(self, ds: Dataset) -> Dataset:
        return self.get("bestModel").transform(ds)


class RankingAdapter(Estimator):
    """Adapt any recommender estimator for ranking evaluation
    (reference: RankingAdapter.scala — fit the wrapped estimator, then
    ``transform`` emits one row per user with the top-k predicted item
    list and the ground-truth item list, the schema RankingEvaluator
    consumes)."""

    recommender = PyObjectParam(doc="wrapped recommender estimator")
    k = IntParam(doc="recommendations per user", default=10)
    userCol = StringParam(doc="user column", default="user")
    itemCol = StringParam(doc="item column", default="item")
    ratingCol = StringParam(doc="rating column for ground-truth ranking",
                            default="rating")

    def _fit(self, ds: Dataset) -> "RankingAdapterModel":
        model = self.get("recommender").fit(ds)
        out = RankingAdapterModel()
        out.set("recommenderModel", model)
        out._copy_values_from(self)
        return out


class RankingAdapterModel(Model):
    recommenderModel = PyObjectParam(doc="fitted recommender")
    k = IntParam(doc="recommendations per user", default=10)
    userCol = StringParam(doc="user column", default="user")
    itemCol = StringParam(doc="item column", default="item")
    ratingCol = StringParam(doc="rating column for ground-truth ranking",
                            default="rating")

    def _transform(self, ds: Dataset) -> Dataset:
        model = self.get("recommenderModel")
        k = int(self.k)
        recs = model.recommend_for_all_users(k)
        rec_map: Dict[Any, List] = {}
        rec_col = recs.columns[1]
        for r in recs.iter_rows():
            rec_map[r[recs.columns[0]]] = [m["item"] for m in r[rec_col]]
        # ground truth mirrors the reference's Window(rating desc, item asc)
        # + rank <= k truncation (RankingAdapter.scala transform): only each
        # user's top-k actual items count as relevant for recall/MAP/NDCG.
        actual_map = _top_k_actuals(ds, self.userCol, self.itemCol,
                                    self.ratingCol, k)
        users = [u for u in actual_map if u in rec_map]
        return Dataset({
            self.userCol: np.asarray(users, dtype=object),
            "prediction": [rec_map[u] for u in users],
            "label": [actual_map[u] for u in users],
        })
