"""Pipeline stage library — the reference's L4 layer.

Generic dataset ops (``stages``), auto-featurization (``featurize``), text
featurizers (``text``), and high-level train+eval (``train``) — reference:
core/src/main/scala/com/microsoft/azure/synapse/ml/{stages,featurize,train}/.
"""

from .stages import (Cacher, ClassBalancer, ClassBalancerModel, DropColumns,
                     DynamicMiniBatchTransformer, EnsembleByKey, Explode,
                     FixedMiniBatchTransformer, FlattenBatch, Lambda,
                     MultiColumnAdapter, PartitionConsolidator, RenameColumn,
                     Repartition, SelectColumns, StratifiedRepartition,
                     SummarizeData, TextPreprocessor, Timer, TimerModel,
                     TimeIntervalMiniBatchTransformer, UDFTransformer,
                     UnicodeNormalize)
from .batchers import (DynamicBufferedBatcher, FixedBufferedBatcher,
                       TimeIntervalBatcher)
from .featurize import (CleanMissingData, CleanMissingDataModel, CountSelector,
                        CountSelectorModel, DataConversion, Featurize,
                        IndexToValue, ValueIndexer, ValueIndexerModel)
from .text import MultiNGram, PageSplitter, TextFeaturizer, TextFeaturizerModel
from .train import (ComputeModelStatistics, ComputePerInstanceStatistics,
                    MetricConstants, TrainedClassifierModel,
                    TrainedRegressorModel, TrainClassifier, TrainRegressor)

__all__ = [
    "Cacher", "ClassBalancer", "ClassBalancerModel", "DropColumns",
    "DynamicMiniBatchTransformer", "EnsembleByKey", "Explode",
    "FixedMiniBatchTransformer", "FlattenBatch", "Lambda",
    "MultiColumnAdapter", "PartitionConsolidator", "RenameColumn",
    "Repartition", "SelectColumns", "StratifiedRepartition", "SummarizeData",
    "TextPreprocessor", "Timer", "TimerModel",
    "TimeIntervalMiniBatchTransformer", "UDFTransformer", "UnicodeNormalize",
    "DynamicBufferedBatcher", "FixedBufferedBatcher", "TimeIntervalBatcher",
    "CleanMissingData", "CleanMissingDataModel", "CountSelector",
    "CountSelectorModel", "DataConversion", "Featurize", "IndexToValue",
    "ValueIndexer", "ValueIndexerModel",
    "MultiNGram", "PageSplitter", "TextFeaturizer", "TextFeaturizerModel",
    "ComputeModelStatistics", "ComputePerInstanceStatistics",
    "MetricConstants", "TrainClassifier", "TrainRegressor",
    "TrainedClassifierModel", "TrainedRegressorModel",
]
