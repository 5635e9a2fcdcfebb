"""Dataset / Params / Pipeline algebra of the PyTorch port, with the
per-verb telemetry (:func:`log_verb`) that every ``fit``/``transform``
runs under, and the profiling helpers (:class:`PhaseTimer`,
:func:`trace`)."""

from .dataset import Dataset, find_unused_column_name
from .logging import log_verb, logger, scrub
from .params import Params
from .profiling import PhaseTimer, trace
from .pipeline import (Estimator, Evaluator, Model, Pipeline, PipelineModel,
                       PipelineStage, Transformer, load_dataset, load_stage,
                       save_dataset)

__all__ = ["Dataset", "find_unused_column_name", "Params", "Estimator",
           "Evaluator", "Model", "Pipeline", "PipelineModel",
           "PipelineStage", "Transformer", "load_dataset", "load_stage",
           "save_dataset", "log_verb", "logger", "scrub", "PhaseTimer",
           "trace"]
