"""GBDT engine of the PyTorch port: binning, the booster, the tree
grower with the histogram kernels K1/K2, and the estimators, with the
LightGBM names of the reference as aliases."""

from .binning import BinMapper, fit_bin_mapper
from .booster import Booster, BoostingConfig, EvalRecord, train
from .estimators import (GBDTClassificationModel, GBDTClassifier, GBDTParams,
                         GBDTRanker, GBDTRankerModel, GBDTRegressionModel,
                         GBDTRegressor)
from .trainer import GrowthParams, Tree, grow_tree, predict_raw_features

# reference-compatible aliases (the LightGBM names users know)
LightGBMClassifier = GBDTClassifier
LightGBMClassificationModel = GBDTClassificationModel
LightGBMRegressor = GBDTRegressor
LightGBMRegressionModel = GBDTRegressionModel
LightGBMRanker = GBDTRanker
LightGBMRankerModel = GBDTRankerModel
