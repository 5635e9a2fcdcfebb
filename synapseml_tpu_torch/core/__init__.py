"""Dataset / Params / Pipeline algebra of the PyTorch port, with the
per-verb telemetry (:func:`log_verb`) that every ``fit``/``transform``
runs under, the profiling helpers (:class:`PhaseTimer`, :func:`trace`)
and the runtime utilities of :mod:`.utils`."""

from .dataset import Dataset, find_unused_column_name
from .logging import log_verb, logger, scrub
from .params import (ArrayParam, BoolParam, ComplexParam, DatasetParam,
                     DictParam, EstimatorParam, FloatParam, IntParam,
                     ListParam, Param, Params, PyObjectParam, StringParam,
                     TransformerParam, UDFParam)
from .profiling import PhaseTimer, trace
from .pipeline import (Estimator, Evaluator, Model, Pipeline, PipelineModel,
                       PipelineStage, Transformer, load_dataset, load_stage,
                       save_dataset)
from .utils import (KahanSum, SharedVariable, StopWatch,
                    assert_models_equal, retry, retry_with_timeout, using)

__all__ = ["Dataset", "find_unused_column_name", "Params", "Estimator",
           "Evaluator", "Model", "Pipeline", "PipelineModel",
           "PipelineStage", "Transformer", "load_dataset", "load_stage",
           "save_dataset", "log_verb", "logger", "scrub", "PhaseTimer",
           "trace", "ArrayParam", "BoolParam", "ComplexParam",
           "DatasetParam", "DictParam", "EstimatorParam", "FloatParam",
           "IntParam", "ListParam", "Param", "PyObjectParam", "StringParam",
           "TransformerParam", "UDFParam", "KahanSum", "SharedVariable",
           "StopWatch", "assert_models_equal", "retry", "retry_with_timeout",
           "using"]
