"""ONNX batch inference in PyTorch.

The port of the JAX package's ONNX path (reference: deep-learning/src/
main/scala/.../onnx/): a self-contained protobuf codec, a graph IR with
model surgery, op lowerings into PyTorch on the graph's device, and the
``ONNXModel`` / ``ImageFeaturizer`` pipeline stages.
"""

from .graph import Graph, GraphBuilder, load_graph, slice_at_outputs, to_model
from .hub import ONNXHub, ONNXHubModelInfo
from .model import ImageFeaturizer, ONNXModel
from .ops import supported_ops
from .protoparse import ModelProto, load_model
from .runner import OnnxFunction, compile_onnx, evaluate

__all__ = [
    "Graph", "GraphBuilder", "load_graph", "slice_at_outputs", "to_model",
    "ONNXHub", "ONNXHubModelInfo", "ImageFeaturizer", "ONNXModel",
    "supported_ops", "ModelProto", "load_model", "OnnxFunction",
    "compile_onnx", "evaluate",
]
