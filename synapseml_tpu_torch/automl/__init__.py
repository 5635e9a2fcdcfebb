"""Hyperparameter search (reference: core/.../automl/)."""

from .space import (DefaultHyperparams, DiscreteHyperParam, GridSpace,
                    HyperparamBuilder, RandomSpace, RangeHyperParam)
from .tune import (BestModel, FindBestModel, TuneHyperparameters,
                   TuneHyperparametersModel)

__all__ = [
    "DefaultHyperparams", "DiscreteHyperParam", "GridSpace",
    "HyperparamBuilder", "RandomSpace", "RangeHyperParam", "BestModel",
    "FindBestModel", "TuneHyperparameters", "TuneHyperparametersModel",
]
