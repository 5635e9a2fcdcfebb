"""Dataset / Params / Pipeline algebra of the PyTorch port."""

from .dataset import Dataset, find_unused_column_name
from .params import Params
from .pipeline import (Estimator, Model, Pipeline, PipelineModel,
                       PipelineStage, Transformer, load_stage)

__all__ = ["Dataset", "find_unused_column_name", "Params", "Estimator",
           "Model", "Pipeline", "PipelineModel", "PipelineStage",
           "Transformer", "load_stage"]
