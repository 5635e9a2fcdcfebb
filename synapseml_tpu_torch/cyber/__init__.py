"""Cyber-ML: access-anomaly detection via collaborative filtering
(reference: core/src/main/python/synapse/ml/cyber/ — indexers, per-group
scalers, complement-set sampling, and the AccessAnomaly estimator built
on ALS, anomaly/collaborative_filtering.py:1-1229).

Device re-design: the ALS solves are dense normal-equation updates (one
batched ridge solve per side and iteration on the estimator's device)
instead of Spark's blocked ALS."""

from .indexers import IdIndexer, IdIndexerModel, MultiIndexer, MultiIndexerModel
from .scalers import (LinearScalarScaler, LinearScalarScalerModel,
                      StandardScalarScaler, StandardScalarScalerModel)
from .complement_access import ComplementAccessTransformer
from .access_anomaly import (AccessAnomaly, AccessAnomalyConfig,
                             AccessAnomalyModel)

__all__ = [
    "IdIndexer", "IdIndexerModel", "MultiIndexer", "MultiIndexerModel",
    "StandardScalarScaler", "StandardScalarScalerModel",
    "LinearScalarScaler", "LinearScalarScalerModel",
    "ComplementAccessTransformer",
    "AccessAnomaly", "AccessAnomalyConfig", "AccessAnomalyModel",
]
