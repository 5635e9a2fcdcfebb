"""Recommendation (reference: core/.../recommendation/)."""

from .evaluator import (RankingEvaluator, RankingTrainValidationSplit,
                        RankingTrainValidationSplitModel,
                        RecommendationIndexer, RecommendationIndexerModel,
                        diversity_at_k, mean_average_precision, ndcg_at_k,
                        precision_at_k, recall_at_k)
from .evaluator import RankingAdapter, RankingAdapterModel
from .sar import SAR, SARModel

__all__ = [
    "RankingAdapter", "RankingAdapterModel",
    "RankingEvaluator", "RankingTrainValidationSplit",
    "RankingTrainValidationSplitModel", "RecommendationIndexer",
    "RecommendationIndexerModel", "SAR", "SARModel", "diversity_at_k",
    "mean_average_precision", "ndcg_at_k", "precision_at_k", "recall_at_k",
]
