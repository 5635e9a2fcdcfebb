"""PyTorch port of synapseml_tpu: the same ``.fit()/.transform()``
pipelines, with PyTorch and hand-written CUDA kernels for an NVIDIA
Hopper card as the execution backend.  ``from synapseml_tpu_torch import
Dataset, Pipeline`` binds what the JAX package's top level binds;
importing the package initialises no CUDA context and builds no kernel.
"""

__version__ = "0.1.0"

# the Dataset/Pipeline algebra first: core.pipeline and the row guard
# import each other, and this order settles it for every entry module
from . import core  # noqa: E402,F401
from . import resilience, telemetry  # noqa: E402
from .core.dataset import Dataset  # noqa: E402
from .core.params import Params  # noqa: E402
from .core.pipeline import (Estimator, Evaluator, Model,  # noqa: E402
                            Pipeline, PipelineModel, PipelineStage,
                            Transformer)
from .resilience import (CircuitBreaker, Deadline,  # noqa: E402
                         RetryPolicy, get_faults)
from .telemetry import get_registry, span  # noqa: E402

__all__ = [
    "Dataset", "Params", "Estimator", "Evaluator", "Model", "Pipeline",
    "PipelineModel", "PipelineStage", "Transformer", "__version__",
    "telemetry", "get_registry", "span",
    "resilience", "RetryPolicy", "Deadline", "CircuitBreaker", "get_faults",
]
