"""ONNX graph IR: topological order, output slicing, and a builder.

``slice_at_outputs`` re-implements the reference's backward-reachability
model-surgery pass (reference: deep-learning/.../onnx/ONNXUtils.scala:259-345
``sliceModelAtOutputs``): keep exactly the nodes an intermediate output
depends on, re-point graph outputs, drop unreferenced initializers.
``GraphBuilder`` constructs valid ONNX protobuf bytes directly — the test
and export path in an environment without the onnx wheel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .protoparse import (FLOAT, AttributeProto, GraphProto, ModelProto,
                         NodeProto, TensorProto, ValueInfoProto,
                         numpy_to_elem_type)


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = field(default_factory=dict)
    name: str = ""
    domain: str = ""


@dataclass
class ValueInfo:
    name: str
    elem_type: int = FLOAT
    shape: Optional[List[Union[int, str, None]]] = None


@dataclass
class Graph:
    name: str
    nodes: List[Node]
    inputs: List[ValueInfo]
    outputs: List[ValueInfo]
    initializers: Dict[str, np.ndarray]
    opset: int = 17

    @property
    def input_names(self) -> List[str]:
        return [v.name for v in self.inputs if v.name not in self.initializers]

    @property
    def output_names(self) -> List[str]:
        return [v.name for v in self.outputs]

    def producers(self) -> Dict[str, Node]:
        out: Dict[str, Node] = {}
        for n in self.nodes:
            for o in n.outputs:
                if o:
                    out[o] = n
        return out

    def toposort(self) -> List[Node]:
        """Topological order of nodes (graph may be stored unordered)."""
        produced = self.producers()
        order: List[Node] = []
        state: Dict[int, int] = {}  # id(node) -> 0 visiting / 1 done

        def visit(n: Node) -> None:
            s = state.get(id(n))
            if s == 1:
                return
            if s == 0:
                raise ValueError(f"cycle through node {n.op_type} {n.name!r}")
            state[id(n)] = 0
            for i in n.inputs:
                if i in produced:
                    visit(produced[i])
            state[id(n)] = 1
            order.append(n)

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * len(self.nodes) + 100))
        try:
            for n in self.nodes:
                visit(n)
        finally:
            sys.setrecursionlimit(old)
        return order


def from_model(model: ModelProto) -> Graph:
    g = model.graph
    inits = {t.name: t.to_numpy() for t in g.initializer}
    nodes = [Node(n.op_type, list(n.input), list(n.output), n.attrs(),
                  n.name, n.domain) for n in g.node]
    inputs = [ValueInfo(v.name, v.elem_type, v.shape) for v in g.input]
    outputs = [ValueInfo(v.name, v.elem_type, v.shape) for v in g.output]
    return Graph(g.name or "graph", nodes, inputs, outputs, inits,
                 opset=model.opset_version)


def load_graph(source: Union[str, bytes]) -> Graph:
    from .protoparse import load_model
    return from_model(load_model(source))


def slice_at_outputs(graph: Graph, output_names: Sequence[str]) -> Graph:
    """Backward-reachability slice (reference: ONNXUtils.scala:259-345).

    Returns a new graph whose outputs are ``output_names`` and that contains
    only the nodes/initializers those outputs transitively require.
    """
    produced = graph.producers()
    known = (set(produced) | set(graph.initializers)
             | {v.name for v in graph.inputs})
    missing = [o for o in output_names if o not in known]
    if missing:
        raise KeyError(f"outputs not found in graph: {missing}")

    needed_nodes: List[Node] = []
    seen_nodes = set()
    frontier = list(output_names)
    needed_values = set(output_names)
    while frontier:
        name = frontier.pop()
        node = produced.get(name)
        if node is None or id(node) in seen_nodes:
            continue
        seen_nodes.add(id(node))
        needed_nodes.append(node)
        for i in node.inputs:
            if i and i not in needed_values:
                needed_values.add(i)
                frontier.append(i)

    nodes = [n for n in graph.nodes if id(n) in seen_nodes]
    inits = {k: v for k, v in graph.initializers.items() if k in needed_values}
    inputs = [v for v in graph.inputs
              if v.name in needed_values and v.name not in inits]
    outputs = [ValueInfo(o) for o in output_names]
    return Graph(graph.name + "_sliced", nodes, inputs, outputs, inits,
                 opset=graph.opset)


def to_model(graph: Graph) -> ModelProto:
    gp = GraphProto(name=graph.name)
    for n in graph.nodes:
        gp.node.append(NodeProto(
            op_type=n.op_type, name=n.name, domain=n.domain,
            input=list(n.inputs), output=list(n.outputs),
            attribute=[AttributeProto.make(k, v) for k, v in n.attrs.items()]))
    for name, arr in graph.initializers.items():
        gp.initializer.append(TensorProto.from_numpy(np.asarray(arr), name))
    for v in graph.inputs:
        gp.input.append(ValueInfoProto(v.name, v.elem_type, v.shape))
    for v in graph.outputs:
        gp.output.append(ValueInfoProto(v.name, v.elem_type, v.shape))
    return ModelProto(graph=gp, opset_version=graph.opset)


class GraphBuilder:
    """Fluent ONNX graph construction; ``.build()`` → protobuf bytes.

    >>> b = GraphBuilder("mlp")
    >>> x = b.input("x", (None, 4))
    >>> w = b.initializer("w", np.zeros((4, 8), np.float32))
    >>> h = b.node("MatMul", [x, w])
    >>> b.output(b.node("Relu", [h]))
    >>> model_bytes = b.build()
    """

    def __init__(self, name: str = "graph", opset: int = 17):
        self._g = Graph(name, [], [], [], {}, opset=opset)
        self._ctr = 0

    def _fresh(self, base: str) -> str:
        self._ctr += 1
        return f"{base}_{self._ctr}"

    def input(self, name: str, shape: Sequence[Optional[int]],
              dtype=np.float32) -> str:
        self._g.inputs.append(ValueInfo(name, numpy_to_elem_type(dtype),
                                        [d if d else f"d{i}"
                                         for i, d in enumerate(shape)]))
        return name

    def initializer(self, name: str, value: np.ndarray) -> str:
        self._g.initializers[name] = np.asarray(value)
        return name

    def node(self, op_type: str, inputs: Sequence[str],
             outputs: Optional[Sequence[str]] = None,
             n_outputs: int = 1, **attrs) -> Union[str, List[str]]:
        if outputs is None:
            outputs = [self._fresh(op_type.lower()) for _ in range(n_outputs)]
        self._g.nodes.append(Node(op_type, list(inputs), list(outputs),
                                  dict(attrs)))
        return outputs[0] if len(outputs) == 1 else list(outputs)

    def output(self, name: str, dtype=np.float32) -> str:
        self._g.outputs.append(ValueInfo(name, numpy_to_elem_type(dtype)))
        return name

    @property
    def graph(self) -> Graph:
        return self._g

    def build(self) -> bytes:
        return to_model(self._g).serialize()
