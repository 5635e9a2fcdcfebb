"""Graph evaluator: an ONNX graph → one PyTorch call sequence on a device.

Where the reference creates an OrtSession per Spark partition and runs it
batch-by-batch over JNI (reference: deep-learning/.../onnx/ONNXRuntime.scala:
25-44 session creation, :58-108 ``applyModel`` hot loop), the port
prepares each graph once per (outputs, dtype, device, input names): every
float initializer is uploaded (cast once), and every node whose inputs
are all constants is evaluated then (the counterpart of the constant
folding the JAX package gets from ``jit``).  A call then runs only the
nodes that depend on the inputs and moves no weight across the host link.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...device import DeviceLike, full_f32, resolve_device
from .graph import Graph, load_graph
from .ops import OpCall, is_static, lower, to_tensor


#: ops that MIX rows when applied over axis 0 (or over all axes, the
#: Reduce* default) — chunking the batch through them would silently
#: change results, so such graphs keep the raise-on-OOM behavior
_ROW_MIXING_OPS = frozenset((
    "ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd",
    "ReduceL1", "ReduceL2", "ReduceLogSum", "ReduceLogSumExp",
    "ReduceSumSquare", "Softmax", "LogSoftmax", "Hardmax", "Mean",
    "CumSum", "LpNormalization", "TopK", "ArgMax", "ArgMin",
))


def _mixes_batch_rows(graph) -> bool:
    """True when any node plausibly combines values ACROSS axis 0 —
    chunked execution would compute per-chunk statistics instead of
    whole-batch ones.  Conservative: a hit only disables OOM chunking
    (the call then fails like the unchunked path would)."""
    for n in getattr(graph, "nodes", ()):
        if n.op_type not in _ROW_MIXING_OPS:
            continue
        axis = n.attrs.get("axis")
        axes = n.attrs.get("axes")
        if axis == 0:
            return True
        if axes is not None and 0 in np.atleast_1d(axes):
            return True
        if (axis is None and axes is None
                and n.op_type.startswith("Reduce")):
            return True                  # Reduce* default: ALL axes
    return False


def _graph_oom_key(graph) -> str:
    """Stable structural key for the OOM-safe-batch memory: the same
    model reloaded into a fresh ``OnnxFunction`` keeps its discovered
    safe batch size, and the process-wide memory/gauge stays bounded by
    the number of DISTINCT graphs."""
    sig = "|".join((
        getattr(graph, "name", "") or "graph",
        str(len(getattr(graph, "nodes", ()))),
        ",".join(n.op_type for n in getattr(graph, "nodes", ())[:64]),
        ",".join(graph.input_names), ",".join(graph.output_names),
    ))
    return "onnx:" + hashlib.sha1(sig.encode()).hexdigest()[:12]


_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype if not hasattr(v, "dtype")
                         else v.dtype, np.floating)


class Plan:
    """One graph prepared for (outputs, dtype, device, input names).

    ``dtype`` (e.g. ``torch.bfloat16``): float weights, float inputs AND
    every float node output are cast to it, static numpy results
    included (the JAX package's rule, which decides which ops see numpy),
    so matmuls and convolutions run at the reduced precision with float32
    accumulation — the role the GPU execution provider's fp16 mode plays
    in the reference's ORT stack (ONNXRuntime.scala:46-56).

    ``n_folded`` nodes ran when the plan was made; ``n_per_call`` run on
    every call.  ``uploads`` counts the static values the last call had
    to send to the device (0 once every constant is cached)."""

    def __init__(self, graph: Graph, outputs: Sequence[str],
                 dtype: Optional[torch.dtype], device: torch.device,
                 input_names: FrozenSet[str]):
        self.graph = graph
        self.outputs = list(outputs)
        self.dtype = dtype
        self.device = device
        self._uploaded: Dict[int, Tuple[Any, torch.Tensor]] = {}
        self._folds: Dict[Any, Any] = {}
        self._const_ids: set = set()
        self.uploads = 0
        missing = [n for n in graph.input_names
                   if n not in input_names and n not in graph.initializers]
        if missing:
            raise KeyError(f"missing graph inputs: {missing}")
        env: Dict[str, Any] = {}
        for k, v in graph.initializers.items():
            if k in input_names:
                continue
            env[k] = self._c(v)
            if is_static(env[k]) and _is_float(v):
                self._remember(env[k])
        self._hold(env.values())
        self.dynamic: List[Any] = []
        for node in graph.toposort():
            if any(i and i not in env for i in node.inputs):
                self.dynamic.append(node)
                continue
            for name, val in zip(node.outputs, self._run_node(node, env)):
                if name:
                    env[name] = val
            self._hold(env[o] for o in node.outputs if o)
        self.const = env
        self.n_folded = len(graph.nodes) - len(self.dynamic)
        self.n_per_call = len(self.dynamic)
        self.uploads = 0

    # -- the upload cache and folds (the OpCall context) --------------------
    def _hold(self, vals) -> None:
        self._const_ids.update(id(v) for v in vals)

    def _remember(self, v) -> torch.Tensor:
        t = to_tensor(v, self.device)
        self._uploaded[id(v)] = (v, t)
        return t

    def dev(self, v) -> torch.Tensor:
        hit = self._uploaded.get(id(v))
        if hit is not None and hit[0] is v:
            return hit[1]
        if id(v) in self._const_ids:
            return self._remember(v)
        self.uploads += 1
        return to_tensor(v, self.device)

    def fold(self, key, fn, vals):
        if not all(id(v) in self._const_ids for v in vals if v is not None):
            return fn()
        if key not in self._folds:
            self._folds[key] = fn()
        return self._folds[key]

    # -- evaluation ---------------------------------------------------------
    def _c(self, v):
        if self.dtype is not None and _is_float(v):
            if isinstance(v, torch.Tensor):
                return v.to(self.dtype)
            return to_tensor(v, self.device).to(self.dtype)
        return v

    def _run_node(self, node, env) -> List[Any]:
        vals = [env[i] if i else None for i in node.inputs]
        call = OpCall(node.op_type, vals, node.attrs, self.graph.opset,
                      len(node.outputs), ctx=self, key=id(node),
                      out_dtype=self.dtype)
        # keep every float tensor at the reduced precision: ops that
        # internally upcast (epsilon math, reductions) would otherwise
        # leak float32 into downstream convs/matmuls
        return [self._c(r) for r in lower(call)]

    def run(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Evaluate on device ``inputs`` → {output name: value} (a static
        output stays numpy)."""
        self.uploads = 0
        env = dict(self.const)
        for k, v in inputs.items():
            env[k] = self._c(v)
        for node in self.dynamic:
            for name, val in zip(node.outputs, self._run_node(node, env)):
                if name:
                    env[name] = val
        missing_out = [o for o in self.outputs if o not in env]
        if missing_out:
            raise KeyError(f"graph values not produced: {missing_out}")
        return {o: env[o] for o in self.outputs}


def _upload_inputs(inputs: Dict[str, Any],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Device tensors pass through untouched; everything else goes up
    once (float64 as float32)."""
    out = {}
    for k, v in inputs.items():
        if isinstance(v, torch.Tensor):
            out[k] = v if v.device == device else v.to(device)
        else:
            out[k] = to_tensor(v, device)
    return out


def evaluate(graph: Graph, inputs: Dict[str, Any],
             outputs: Optional[Sequence[str]] = None,
             dtype: Optional[Any] = None,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Evaluate ``graph`` on ``inputs`` on ``device`` (one call; keeps no
    plan).  ``dtype`` as :class:`Plan` takes it."""
    dev = resolve_device(device)
    dt = _torch_dtype(dtype)
    wanted = list(outputs) if outputs is not None else graph.output_names
    ins = _upload_inputs(inputs, dev)
    with full_f32():
        plan = Plan(graph, wanted, dt, dev, frozenset(ins))
        return plan.run(ins)


class OnnxFunction:
    """A prepared ONNX graph: ``fn(**inputs) -> {name: device tensor}``.

    Calls are OOM-adaptive: when the single-dispatch path dies with a
    device out-of-memory error and every input shares a leading batch
    dimension, the batch is bisected into chunks that fit (safe size
    remembered per graph in the ``rowguard_safe_batch_size`` gauge)
    and per-output results concatenate along axis 0 — the standard
    batch-major, row-independent inference layout.  Graphs that visibly
    combine values across axis 0 (axis-0 softmax/reductions, all-axes
    Reduce*) are never chunked — their OOM re-raises — and non-batch
    outputs fail loudly on the concatenate rather than silently mixing
    axes.  Every call runs under ``device.full_f32`` (no TF32 products,
    no reduced-precision sums), so float32 is full float32 and bf16
    products sum in float32."""

    def __init__(self, graph: Graph, outputs: Optional[Sequence[str]] = None,
                 dtype: Optional[Any] = None, device: DeviceLike = "cuda"):
        self.graph = graph
        self.device = resolve_device(device)
        self.input_names = graph.input_names
        self.output_names = list(outputs) if outputs else graph.output_names
        self.dtype = _torch_dtype(dtype)
        self._oom_key = _graph_oom_key(graph)
        self._chunkable = not _mixes_batch_rows(graph)
        self._plans: Dict[FrozenSet[str], Plan] = {}

    def plan(self, input_names) -> Plan:
        key = frozenset(input_names)
        if key not in self._plans:
            with full_f32():
                self._plans[key] = Plan(self.graph, self.output_names,
                                        self.dtype, self.device, key)
        return self._plans[key]

    def _run(self, arrays: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        ins = _upload_inputs(arrays, self.device)
        plan = self.plan(ins)
        with full_f32():
            out = plan.run(ins)
        return {k: v if isinstance(v, torch.Tensor)
                else to_tensor(v, self.device) for k, v in out.items()}

    def __call__(self, **inputs) -> Dict[str, torch.Tensor]:
        from ...resilience.rowguard import oom_fault_point, run_adaptive

        # device tensors pass through untouched — no download and re-upload
        arrays = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                  for k, v in inputs.items()}
        dims = {v.shape[0] for v in arrays.values()
                if getattr(v, "ndim", 0) >= 1}
        if len(dims) != 1 or next(iter(dims)) <= 1 or not self._chunkable:
            # no shared batch axis to bisect (or the graph combines
            # values across rows, so chunking would change results) —
            # dispatch as-is and let an OOM surface
            oom_fault_point(self._oom_key, 1)
            return self._run(arrays)
        n = next(iter(dims))

        def run(bs: int) -> Dict[str, torch.Tensor]:
            if bs >= n:
                oom_fault_point(self._oom_key, n)
                return self._run(arrays)
            outs = []
            for s in range(0, n, bs):
                chunk = {k: (v[s:s + bs] if getattr(v, "ndim", 0) >= 1
                             else v) for k, v in arrays.items()}
                oom_fault_point(self._oom_key, min(bs, n - s))
                outs.append(self._run(chunk))
            return {k: torch.cat([o[k] for o in outs], dim=0)
                    for k in outs[0]}

        return run_adaptive(self._oom_key, n, run)

    def trace(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """One evaluation without OOM handling (for embedding in a larger
        call sequence)."""
        return self._run(inputs)


def compile_onnx(source: Union[str, bytes, Graph],
                 outputs: Optional[Sequence[str]] = None,
                 dtype: Optional[Any] = None,
                 device: DeviceLike = "cuda") -> OnnxFunction:
    graph = source if isinstance(source, Graph) else load_graph(source)
    return OnnxFunction(graph, outputs, dtype=dtype, device=device)
