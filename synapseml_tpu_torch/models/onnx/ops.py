"""ONNX op → PyTorch lowerings.

Replaces the reference's ONNX Runtime execution (reference:
deep-learning/.../onnx/ONNXRuntime.scala:24-108 — a CUDA OrtSession per
Spark partition) with one PyTorch call sequence per graph, on the
graph's device.  The JAX package lowers the same ops to one XLA program;
every op here computes what that lowering computes.

Static-vs-device dispatch: shape-producing subgraphs (``Shape`` →
``Gather`` → ``Concat`` → ``Reshape`` is the classic exporter pattern)
stay numpy so reshapes get Python ints.  Every value in the evaluator is
either a ``np.ndarray`` (static) or a ``torch.Tensor`` on the graph's
device; an op computes with numpy exactly as the JAX package does
whenever all its inputs are static, and with torch otherwise.  A static
value that meets a device value goes up through :meth:`OpCall.dev`,
which the runner backs with a cache, so a weight crosses the host link
once per compiled graph.  Device values never hold float64 (the JAX
package runs with 64-bit mode off, so its device floats are float32);
unlike the JAX package, device integers keep ONNX's int64.

Matmuls and convolutions return float32 whatever their input type (the
reference's ``preferred_element_type=float32``): bf16 operands on the
card go through cuBLAS with a float32 output, and the CPU computes bf16
products in float32.  cuDNN has no bf16-in, float32-out convolution, so
a bf16 convolution whose float32 result is needed (a bias follows) runs
on operands widened to float32, which holds them and their products
exactly.  Where the runner would round the float32 result straight back
to the operands' bf16 (no bias or scale follows), the product stays in
bf16: cuBLAS and cuDNN round their float32 sum once, the same value
without the round trip.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...image import ops as image_ops

OP_REGISTRY: Dict[str, Callable] = {}

_LOW = (torch.bfloat16, torch.float16)

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float32, np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}
_TORCH_TO_NP = {torch.float32: np.float32, torch.float16: np.float16,
                torch.int64: np.int64, torch.int32: np.int32,
                torch.int16: np.int16, torch.int8: np.int8,
                torch.uint8: np.uint8, torch.bool: np.bool_}


def register(*names: str):
    def deco(fn):
        for n in names:
            OP_REGISTRY[n] = fn
        return fn
    return deco


def to_tensor(v, device: torch.device) -> torch.Tensor:
    """Upload a static value: float64 becomes float32 (the reference's
    device rule), every other type keeps its width."""
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.ascontiguousarray(a).copy()
    return torch.from_numpy(a).to(device)


def torch_dtype(np_dtype) -> torch.dtype:
    d = np.dtype(np_dtype)
    if d not in _NP_TO_TORCH:
        raise TypeError(f"no device dtype for {d}")
    return _NP_TO_TORCH[d]


class OpCall:
    """One node application: resolved inputs + attributes, on the device
    of ``ctx`` (the runner's :class:`~.runner.Plan`, which uploads static
    values, caches them and holds per-graph folds)."""

    def __init__(self, op_type: str, inputs: List[Any], attrs: Dict[str, Any],
                 opset: int, n_outputs: int, ctx, key: Any = None,
                 out_dtype: Optional[torch.dtype] = None):
        self.op_type = op_type
        self.inputs = inputs          # None for omitted optional inputs
        self.attrs = attrs
        self.opset = opset
        self.n_outputs = n_outputs
        self.ctx = ctx
        self.key = key
        #: the type the runner rounds every float result to (the bf16
        #: rule), None when it keeps them
        self.out_dtype = out_dtype

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def inp(self, i: int, default=None):
        if i < len(self.inputs) and self.inputs[i] is not None:
            return self.inputs[i]
        return default

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def static(self, i: int, default=None) -> Optional[np.ndarray]:
        v = self.inp(i)
        if v is None:
            return default
        if not is_static(v):
            raise ValueError(
                f"{self.op_type}: input #{i} must be static (shape-like) "
                f"under jit, got traced value")
        return v

    def dev(self, v):
        """``v`` as a device tensor (None stays None)."""
        if v is None or isinstance(v, torch.Tensor):
            return v
        return self.ctx.dev(v)

    def t(self, i: int, default=None):
        return self.dev(self.inp(i, default))

    def fold(self, tag: str, fn: Callable, *vals):
        """``fn()`` once per compiled graph when every value in ``vals``
        is a graph constant; recomputed otherwise."""
        return self.ctx.fold((self.key, tag), fn, vals)


def is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _all_static(*vals) -> bool:
    return all(is_static(v) for v in vals if v is not None)


# ============================================================================
# elementwise / arithmetic
# ============================================================================

def _binop(np_fn, torch_fn):
    def f(c: OpCall):
        a, b = c.inp(0), c.inp(1)
        if _all_static(a, b):
            return [np_fn(a, b)]
        return [torch_fn(c.dev(a), c.dev(b))]
    return f


for _name, _np_fn, _t_fn in [
        ("Add", np.add, torch.add), ("Sub", np.subtract, torch.sub),
        ("Mul", np.multiply, torch.mul), ("Pow", np.power, torch.pow),
        ("Greater", np.greater, torch.gt),
        ("GreaterOrEqual", np.greater_equal, torch.ge),
        ("Less", np.less, torch.lt), ("LessOrEqual", np.less_equal, torch.le),
        ("Equal", np.equal, torch.eq),
        ("And", np.logical_and, torch.logical_and),
        ("Or", np.logical_or, torch.logical_or),
        ("Xor", np.logical_xor, torch.logical_xor),
        ("BitwiseAnd", np.bitwise_and, torch.bitwise_and),
        ("BitwiseOr", np.bitwise_or, torch.bitwise_or),
        # numpy's mod is the floor mod: torch.remainder, not fmod
        ("Mod", np.mod, torch.remainder)]:
    register(_name)(_binop(_np_fn, _t_fn))


@register("Div")
def _div(c: OpCall):
    a, b = c.inp(0), c.inp(1)
    if _all_static(a, b):
        dtype = a.dtype
        if np.issubdtype(dtype, np.integer):
            # ONNX integer Div truncates toward zero; numpy floor-divides.
            return [np.trunc(np.divide(a, b)).astype(dtype)]
        return [np.divide(a, b)]
    a, b = c.dev(a), c.dev(b)
    if not a.is_floating_point() and a.dtype != torch.bool:
        return [torch.div(a, b, rounding_mode="trunc").to(a.dtype)]
    return [torch.div(a, b)]


def _unary(np_fn, torch_fn):
    def f(c: OpCall):
        a = c.inp(0)
        if is_static(a):
            return [np_fn(a)]
        return [torch_fn(a)]
    return f


for _name, _np_fn, _t_fn in [
        ("Neg", np.negative, torch.neg), ("Abs", np.abs, torch.abs),
        ("Exp", np.exp, torch.exp), ("Log", np.log, torch.log),
        ("Sqrt", np.sqrt, torch.sqrt), ("Floor", np.floor, torch.floor),
        ("Ceil", np.ceil, torch.ceil), ("Round", np.round, torch.round),
        ("Sin", np.sin, torch.sin), ("Cos", np.cos, torch.cos),
        ("Tan", np.tan, torch.tan), ("Asin", np.arcsin, torch.asin),
        ("Acos", np.arccos, torch.acos), ("Atan", np.arctan, torch.atan),
        ("Sinh", np.sinh, torch.sinh), ("Cosh", np.cosh, torch.cosh),
        ("Tanh", np.tanh, torch.tanh),
        ("Not", np.logical_not, torch.logical_not),
        ("IsNaN", np.isnan, torch.isnan), ("IsInf", np.isinf, torch.isinf)]:
    register(_name)(_unary(_np_fn, _t_fn))


@register("Sign")
def _sign(c: OpCall):
    a = c.inp(0)
    if is_static(a):
        return [np.sign(a)]
    if a.is_floating_point():               # numpy's sign(nan) is nan
        return [torch.where(torch.isnan(a), a, torch.sign(a))]
    return [torch.sign(a)]


@register("Reciprocal")
def _reciprocal(c: OpCall):
    return [1.0 / c.inp(0)]


@register("Erf")
def _erf(c: OpCall):
    a = c.inp(0)
    if is_static(a):
        return [np.vectorize(math.erf, otypes=[np.asarray(a).dtype])(a)]
    return [torch.erf(a)]


@register("Relu")
def _relu(c: OpCall):
    a = c.inp(0)
    if is_static(a):
        return [np.maximum(a, 0)]
    return [torch.relu(a)]


@register("LeakyRelu")
def _leaky_relu(c: OpCall):
    a, alpha = c.inp(0), c.attr("alpha", 0.01)
    if is_static(a):
        return [np.where(a >= 0, a, alpha * a)]
    return [torch.where(a >= 0, a, alpha * a)]


@register("PRelu")
def _prelu(c: OpCall):
    a, slope = c.inp(0), c.inp(1)
    if _all_static(a, slope):
        return [np.where(a >= 0, a, slope * a)]
    a, slope = c.dev(a), c.dev(slope)
    return [torch.where(a >= 0, a, slope * a)]


def _elu_core(c: OpCall, a, alpha):
    if is_static(a):
        return np.where(a >= 0, a, alpha * (np.exp(np.minimum(a, 0)) - 1))
    return torch.where(a >= 0, a,
                       alpha * (torch.exp(torch.clamp(a, max=0)) - 1))


@register("Elu")
def _elu(c: OpCall):
    return [_elu_core(c, c.inp(0), c.attr("alpha", 1.0))]


@register("Selu")
def _selu(c: OpCall):
    alpha = c.attr("alpha", 1.6732632423543772)
    gamma = c.attr("gamma", 1.0507009873554805)
    return [gamma * _elu_core(c, c.inp(0), alpha)]


@register("Sigmoid")
def _sigmoid(c: OpCall):
    a = c.inp(0)
    if is_static(a):
        return [1.0 / (1.0 + np.exp(-a))]
    return [torch.sigmoid(a)]


@register("HardSigmoid")
def _hard_sigmoid(c: OpCall):
    a = c.inp(0)
    alpha, beta = c.attr("alpha", 0.2), c.attr("beta", 0.5)
    if is_static(a):
        return [np.clip(alpha * a + beta, 0, 1)]
    return [torch.clamp(alpha * a + beta, 0, 1)]


@register("HardSwish")
def _hard_swish(c: OpCall):
    a = c.inp(0)
    if is_static(a):
        return [a * np.clip(a / 6.0 + 0.5, 0, 1)]
    return [a * torch.clamp(a / 6.0 + 0.5, 0, 1)]


def _softplus_t(a: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype, device=a.device))


@register("Softplus")
def _softplus(c: OpCall):
    a = c.inp(0)
    if is_static(a):
        return [np.log1p(np.exp(-np.abs(a))) + np.maximum(a, 0)]
    return [_softplus_t(a)]


@register("Softsign")
def _softsign(c: OpCall):
    a = c.inp(0)
    if is_static(a):
        return [a / (1 + np.abs(a))]
    return [a / (1 + torch.abs(a))]


@register("Gelu")
def _gelu(c: OpCall):
    a = c.t(0)
    if c.attr("approximate", "none") == "tanh":
        k = float(np.sqrt(2 / np.pi).astype(np.float32))
        return [a * (0.5 * (1.0 + torch.tanh(k * (a + 0.044715 * a ** 3))))]
    # jax.nn.gelu's exact form: 0.5 * x * erfc(-x * sqrt(1/2))
    half = float(np.sqrt(0.5).astype(np.float32))
    return [0.5 * a * torch.erfc(-a * half)]


@register("Mish")
def _mish(c: OpCall):
    a = c.t(0)
    return [a * torch.tanh(_softplus_t(a))]


def _tmax(c: OpCall, a, b):
    if isinstance(b, (int, float)):
        return torch.clamp(a, min=b)
    return torch.maximum(a, c.dev(b))


def _tmin(c: OpCall, a, b):
    if isinstance(b, (int, float)):
        return torch.clamp(a, max=b)
    return torch.minimum(a, c.dev(b))


@register("Clip")
def _clip(c: OpCall):
    a = c.inp(0)
    if c.opset >= 11:
        lo, hi = c.inp(1), c.inp(2)
    else:
        lo, hi = c.attr("min"), c.attr("max")
    if is_static(a):
        if lo is not None:
            a = np.maximum(a, lo)
        if hi is not None:
            a = np.minimum(a, hi)
        return [a]
    if lo is not None:
        a = _tmax(c, a, lo)
    if hi is not None:
        a = _tmin(c, a, hi)
    return [a]


@register("Softmax")
def _softmax(c: OpCall):
    a = c.t(0)
    axis = c.attr("axis", -1 if c.opset >= 13 else 1)
    if c.opset < 13:
        # legacy: flatten to 2D at `axis`, softmax rows, reshape back
        shp = a.shape
        lead = int(np.prod(shp[:axis])) if axis > 0 else 1
        flat = a.reshape(lead, -1)
        return [torch.softmax(flat, dim=-1).reshape(shp)]
    return [torch.softmax(a, dim=axis)]


@register("LogSoftmax")
def _log_softmax(c: OpCall):
    a = c.t(0)
    axis = c.attr("axis", -1 if c.opset >= 13 else 1)
    return [torch.log_softmax(a, dim=axis)]


@register("Min", "Max", "Sum", "Mean")
def _variadic(c: OpCall):
    vals = [v for v in c.inputs if v is not None]
    if _all_static(*vals):
        fmin, fmax, fadd = np.minimum, np.maximum, np.add
    else:
        vals = [c.dev(v) for v in vals]
        fmin, fmax, fadd = torch.minimum, torch.maximum, torch.add
    fn = {"Min": fmin, "Max": fmax}.get(c.op_type, fadd)
    out = vals[0]
    for v in vals[1:]:
        out = fn(out, v)
    if c.op_type == "Mean":
        out = out / len(vals)
    return [out]


@register("Where")
def _where(c: OpCall):
    cond, a, b = c.inp(0), c.inp(1), c.inp(2)
    if _all_static(cond, a, b):
        return [np.where(cond, a, b)]
    return [torch.where(c.dev(cond), c.dev(a), c.dev(b))]


# ============================================================================
# shape / indexing
# ============================================================================

@register("Shape")
def _shape(c: OpCall):
    a = c.inp(0)
    shp = np.asarray(tuple(a.shape) if hasattr(a, "shape") else np.shape(a),
                     dtype=np.int64)
    start = c.attr("start", 0)
    end = c.attr("end")
    return [shp[start:end]]


@register("Size")
def _size(c: OpCall):
    a = c.inp(0)
    return [np.asarray(int(np.prod(tuple(a.shape))), dtype=np.int64)]


@register("Reshape")
def _reshape(c: OpCall):
    a = c.inp(0)
    if c.opset >= 5:
        shape = c.static(1).astype(np.int64).tolist()
    else:
        shape = list(c.attr("shape"))
    allowzero = c.attr("allowzero", 0)
    out_shape = []
    for i, d in enumerate(shape):
        if d == 0 and not allowzero:
            out_shape.append(int(a.shape[i]))
        else:
            out_shape.append(int(d))
    return [a.reshape(out_shape)]


@register("Flatten")
def _flatten(c: OpCall):
    a = c.inp(0)
    axis = c.attr("axis", 1)
    lead = int(np.prod(tuple(a.shape)[:axis])) if axis > 0 else 1
    return [a.reshape(lead, -1)]


@register("Transpose")
def _transpose(c: OpCall):
    a = c.inp(0)
    perm = c.attr("perm")
    if is_static(a):
        return [np.transpose(a, perm)]
    if perm is None:
        perm = list(range(a.dim()))[::-1]
    return [a.permute(*perm)]


@register("Squeeze")
def _squeeze(c: OpCall):
    a = c.inp(0)
    if c.opset >= 13:
        axes = c.static(1)
        axes = None if axes is None else tuple(int(x) for x in axes)
    else:
        axes = c.attr("axes")
        axes = None if axes is None else tuple(axes)
    if axes is None:
        axes = tuple(i for i, d in enumerate(a.shape) if d == 1)
    if is_static(a):
        return [np.squeeze(a, axis=axes)]
    rank = a.dim()
    for ax in sorted({ax % rank for ax in axes}, reverse=True):
        if a.shape[ax] != 1:
            raise ValueError(f"Squeeze: axis {ax} of shape {tuple(a.shape)} "
                             "is not 1")
        a = a.squeeze(ax)
    return [a]


@register("Unsqueeze")
def _unsqueeze(c: OpCall):
    a = c.inp(0)
    if c.opset >= 13:
        axes = [int(x) for x in c.static(1)]
    else:
        axes = list(c.attr("axes"))
    out_rank = len(a.shape) + len(axes)
    axes = sorted(ax % out_rank for ax in axes)
    for ax in axes:
        a = np.expand_dims(a, ax) if is_static(a) else a.unsqueeze(ax)
    return [a]


@register("Concat")
def _concat(c: OpCall):
    vals = [v for v in c.inputs if v is not None]
    axis = c.attr("axis", 0)
    if _all_static(*vals):
        return [np.concatenate(vals, axis=axis)]
    return [torch.cat([c.dev(v) for v in vals], dim=axis)]


@register("Split")
def _split(c: OpCall):
    a = c.inp(0)
    axis = c.attr("axis", 0)
    if c.opset >= 13:
        split = c.static(1)
        split = None if split is None else np.asarray(split).tolist()
    else:
        split = c.attr("split")
    n = c.n_outputs
    if split is None:
        size = a.shape[axis]
        base = -(-size // n)  # ONNX: last chunk may be smaller
        split = [base] * (n - 1) + [size - base * (n - 1)]
    idx = np.cumsum(split)[:-1].tolist()
    if is_static(a):
        return list(np.split(a, idx, axis=axis))
    return list(torch.tensor_split(a, idx, dim=axis))


def _slice_axis(a: torch.Tensor, ax: int, sl: slice) -> torch.Tensor:
    """numpy's ``a[..., sl, ...]`` on axis ``ax``, negative steps included
    (torch slicing takes positive steps only)."""
    start, stop, step = sl.indices(a.shape[ax])
    if step > 0:
        index = [slice(None)] * a.dim()
        index[ax] = slice(start, max(start, stop), step)
        return a[tuple(index)]
    idx = torch.arange(start, stop, step, device=a.device)
    return torch.index_select(a, ax, idx)


@register("Slice")
def _slice(c: OpCall):
    a = c.inp(0)
    if c.opset >= 10:
        starts = c.static(1).tolist()
        ends = c.static(2).tolist()
        axes = c.static(3)
        steps = c.static(4)
        axes = list(range(len(starts))) if axes is None else axes.tolist()
        steps = [1] * len(starts) if steps is None else steps.tolist()
    else:
        starts = list(c.attr("starts"))
        ends = list(c.attr("ends"))
        axes = list(c.attr("axes", range(len(starts))))
        steps = [1] * len(starts)
    slices = [slice(None)] * len(a.shape)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % len(a.shape)
        INT_MAX = np.iinfo(np.int64).max
        en = None if en >= INT_MAX else int(en)
        en2 = None if (sp < 0 and en is not None and en < -a.shape[ax]) else en
        slices[ax] = slice(int(st), en2, int(sp))
    if is_static(a):
        return [a[tuple(slices)]]
    for ax, sl in enumerate(slices):
        if sl != slice(None):
            a = _slice_axis(a, ax, sl)
    return [a]


def _wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


@register("Gather")
def _gather(c: OpCall):
    a, idx = c.inp(0), c.inp(1)
    axis = c.attr("axis", 0)
    if _all_static(a, idx):
        return [np.take(a, idx, axis=axis)]
    a, idx = c.dev(a), c.dev(idx)
    axis %= a.dim()
    flat = _wrap_index(idx.reshape(-1), a.shape[axis])
    out = torch.index_select(a, axis, flat)
    return [out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                        + tuple(a.shape[axis + 1:]))]


@register("GatherElements")
def _gather_elements(c: OpCall):
    a, idx = c.t(0), c.t(1)
    axis = c.attr("axis", 0) % a.dim()
    return [torch.gather(a, axis, _wrap_index(idx, a.shape[axis]))]


def _nd_index(indices: np.ndarray, device) -> tuple:
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


@register("GatherND")
def _gather_nd(c: OpCall):
    data, indices = c.t(0), np.asarray(c.static(1))
    if c.attr("batch_dims", 0):
        raise NotImplementedError("GatherND batch_dims > 0")
    return [data[_nd_index(indices, data.device)]]


@register("ScatterND")
def _scatter_nd(c: OpCall):
    data, indices, updates = c.t(0), c.static(1), c.t(2)
    out = data.clone()
    out[_nd_index(indices, data.device)] = updates.to(out.dtype)
    return [out]


@register("Expand")
def _expand(c: OpCall):
    a = c.inp(0)
    shape = [int(s) for s in c.static(1)]
    # ONNX Expand uses multidirectional broadcasting
    target = np.broadcast_shapes(tuple(a.shape), tuple(shape))
    if is_static(a):
        return [np.broadcast_to(a, target)]
    return [torch.broadcast_to(a, target)]


@register("Tile")
def _tile(c: OpCall):
    a = c.inp(0)
    reps = [int(r) for r in c.static(1)]
    if is_static(a):
        return [np.tile(a, reps)]
    return [torch.tile(a, reps)]


_PAD_MODES = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}


@register("Pad")
def _pad(c: OpCall):
    a = c.inp(0)
    if c.opset >= 11:
        pads = c.static(1).astype(np.int64)
        cval = c.static(2)
        cval = 0.0 if cval is None else float(np.asarray(cval))
        axes = c.static(3)
    else:
        pads = np.asarray(c.attr("pads"), dtype=np.int64)
        cval = c.attr("value", 0.0)
        axes = None
    mode = c.attr("mode", "constant")
    rank = len(a.shape)
    pad_width = [(0, 0)] * rank
    if axes is None:
        axes = list(range(rank))
    half = len(pads) // 2
    for j, ax in enumerate(axes):
        pad_width[int(ax) % rank] = (int(pads[j]), int(pads[j + half]))
    if is_static(a):
        if mode == "constant":
            return [np.pad(a, pad_width, mode="constant",
                           constant_values=cval)]
        return [np.pad(a, pad_width, mode=_PAD_MODES[mode])]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pad_width) for p in lo_hi]
        return [F.pad(a, flat, mode="constant", value=cval)]
    np_mode = _PAD_MODES[mode]
    for ax, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            # numpy's own index map for the mode, applied as one gather
            idx = np.pad(np.arange(a.shape[ax]), (lo, hi), mode=np_mode)
            a = torch.index_select(a, ax, torch.as_tensor(idx,
                                                          device=a.device))
    return [a]


@register("Cast")
def _cast(c: OpCall):
    from .protoparse import DTYPE_TO_NUMPY
    a = c.inp(0)
    to = DTYPE_TO_NUMPY[c.attr("to")]
    if is_static(a):
        return [a.astype(to)]
    return [a.to(torch_dtype(to))]


@register("CastLike")
def _cast_like(c: OpCall):
    a, b = c.inp(0), c.inp(1)
    if is_static(a):
        to = b.dtype if is_static(b) else _TORCH_TO_NP.get(b.dtype)
        if to is None:
            return [c.dev(a).to(b.dtype)]
        return [a.astype(to)]
    return [a.to(b.dtype if isinstance(b, torch.Tensor)
                 else torch_dtype(b.dtype))]


@register("Identity")
def _identity(c: OpCall):
    return [c.inp(0)]


@register("Dropout")
def _dropout(c: OpCall):
    a = c.inp(0)
    outs = [a]
    if c.n_outputs > 1:
        outs.append(np.ones(a.shape, dtype=bool) if is_static(a)
                    else torch.ones(a.shape, dtype=torch.bool,
                                    device=a.device))
    return outs


@register("Constant")
def _constant(c: OpCall):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints", "value_string"):
        v = c.attr(key)
        if v is not None:
            if key == "value_int":
                return [np.asarray(v, dtype=np.int64)]
            if key == "value_ints":
                return [np.asarray(v, dtype=np.int64)]
            if key == "value_float":
                return [np.asarray(v, dtype=np.float32)]
            if key == "value_floats":
                return [np.asarray(v, dtype=np.float32)]
            return [np.asarray(v)]
    raise ValueError("Constant node with no value attribute")


@register("ConstantOfShape")
def _constant_of_shape(c: OpCall):
    shape = [int(s) for s in c.static(0)]
    value = c.attr("value")
    if value is None:
        value = np.zeros(1, dtype=np.float32)
    value = np.asarray(value)
    return [np.full(shape, value.reshape(-1)[0], dtype=value.dtype)]


@register("Range")
def _range(c: OpCall):
    start, limit, delta = (np.asarray(c.static(0)), np.asarray(c.static(1)),
                           np.asarray(c.static(2)))
    return [np.arange(start.item(), limit.item(), delta.item(),
                      dtype=start.dtype)]


@register("OneHot")
def _onehot(c: OpCall):
    indices, depth, values = (c.t(0), int(np.asarray(c.static(1)).item()),
                              c.t(2))
    axis = c.attr("axis", -1)
    off, on = values[0], values[1]
    oh = F.one_hot(torch.remainder(indices.long(), depth), depth).float()
    if axis != -1:
        oh = torch.movedim(oh, -1, axis)
    return [oh * (on - off) + off]


@register("TopK")
def _topk(c: OpCall):
    a = c.t(0)
    k = int(np.asarray(c.static(1)).item())
    axis = c.attr("axis", -1)
    largest = c.attr("largest", 1)
    a_m = torch.movedim(a, axis, -1)
    # lax.top_k's order: ties go to the lower index first.  A stable sort
    # keeps it on every device (torch.topk promises no order among ties)
    vals, idx = torch.sort(a_m if largest else -a_m, dim=-1,
                           descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if not largest:
        vals = -vals
    return [torch.movedim(vals, -1, axis),
            torch.movedim(idx.to(torch.int64), -1, axis)]


@register("ArgMax", "ArgMin")
def _argmax(c: OpCall):
    a = c.inp(0)
    axis = c.attr("axis", 0)
    keepdims = c.attr("keepdims", 1)
    if is_static(a):
        fn = np.argmax if c.op_type == "ArgMax" else np.argmin
        out = fn(a, axis=axis).astype(np.int64)
        return [np.expand_dims(out, axis) if keepdims else out]
    # torch returns the first extreme, as numpy does
    fn = torch.argmax if c.op_type == "ArgMax" else torch.argmin
    return [fn(a, dim=axis, keepdim=bool(keepdims)).to(torch.int64)]


@register("CumSum")
def _cumsum(c: OpCall):
    a = c.inp(0)
    axis = int(np.asarray(c.static(1)).item())
    if c.attr("exclusive", 0) or c.attr("reverse", 0):
        raise NotImplementedError("CumSum exclusive/reverse")
    if is_static(a):
        return [np.cumsum(a, axis=axis)]
    return [torch.cumsum(a, dim=axis)]


@register("Trilu")
def _trilu(c: OpCall):
    a = c.inp(0)
    k = c.static(1)
    k = 0 if k is None else int(np.asarray(k).item())
    upper = c.attr("upper", 1)
    if is_static(a):
        return [np.triu(a, k) if upper else np.tril(a, k)]
    return [torch.triu(a, k) if upper else torch.tril(a, k)]


@register("NonZero")
def _nonzero(c: OpCall):
    a = c.static(0)  # data-dependent shape: only legal on static values
    return [np.stack(np.nonzero(a)).astype(np.int64)]


@register("Einsum")
def _einsum(c: OpCall):
    eq = c.attr("equation")
    vals = [c.dev(v) for v in c.inputs if v is not None]
    return [torch.einsum(eq, *vals)]


# ============================================================================
# reductions
# ============================================================================

def _reduce_axes(c: OpCall, use_input: bool):
    if use_input:
        axes = c.static(1)
        return None if axes is None else tuple(int(x) for x in
                                               np.asarray(axes))
    axes = c.attr("axes")
    return None if axes is None else tuple(axes)


def _t_reduce(name: str, a: torch.Tensor, axes, keepdims: bool):
    if axes == ():
        # numpy reduces over no axis: the value itself
        return a.float() if name == "mean" and not a.is_floating_point() \
            else a
    dims = tuple(range(a.dim())) if axes is None else axes
    if name == "sum":
        return torch.sum(a, dim=dims, keepdim=keepdims)
    if name == "mean":
        if not a.is_floating_point():
            a = a.float()
        return torch.mean(a, dim=dims, keepdim=keepdims)
    if name == "max":
        return torch.amax(a, dim=dims, keepdim=keepdims)
    if name == "min":
        return torch.amin(a, dim=dims, keepdim=keepdims)
    out = a                                  # prod: one axis at a time
    for d in sorted((d % a.dim() for d in dims), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


def _reduce(name: str):
    np_fn = getattr(np, name)

    def f(c: OpCall):
        a = c.inp(0)
        axes = _reduce_axes(c, c.opset >= 18 or (c.op_type == "ReduceSum"
                                                 and c.opset >= 13))
        keepdims = bool(c.attr("keepdims", 1))
        if axes is None and c.attr("noop_with_empty_axes", 0):
            return [a]
        if is_static(a):
            return [np_fn(a, axis=axes, keepdims=keepdims)]
        return [_t_reduce(name, a, axes, keepdims)]
    return f


register("ReduceSum")(_reduce("sum"))
register("ReduceMean")(_reduce("mean"))
register("ReduceMax")(_reduce("max"))
register("ReduceMin")(_reduce("min"))
register("ReduceProd")(_reduce("prod"))


@register("ReduceL2")
def _reduce_l2(c: OpCall):
    a = c.inp(0)
    axes = _reduce_axes(c, c.opset >= 18)
    keepdims = bool(c.attr("keepdims", 1))
    if is_static(a):
        return [np.sqrt(np.sum(np.square(a), axis=axes, keepdims=keepdims))]
    return [torch.sqrt(_t_reduce("sum", a * a, axes, keepdims))]


@register("ReduceLogSumExp")
def _reduce_lse(c: OpCall):
    a = c.t(0)
    axes = c.attr("axes")
    dims = tuple(range(a.dim())) if axes is None else tuple(axes)
    keepdims = bool(c.attr("keepdims", 1))
    return [torch.logsumexp(a, dim=dims, keepdim=keepdims)]


# ============================================================================
# linear algebra
# ============================================================================

def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               keep: Optional[torch.dtype] = None) -> torch.Tensor:
    """``jnp.matmul(a, b, preferred_element_type=float32)``: numpy's
    matmul broadcasting, a float32 result whatever the operand types.
    bf16/f16 operands on the card go to cuBLAS at their own type with a
    float32 output (``out_dtype``: the float32 sum, not rounded).  With
    ``keep`` equal to that type the product stays in it instead: cuBLAS
    rounds its float32 sum once, the value the runner's cast of the
    float32 result would give."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if not (dt in _LOW and a.is_cuda):
        return torch.matmul(a.to(dt).float(), b.to(dt).float())
    a, b = a.to(dt), b.to(dt)
    if keep == dt:
        return torch.matmul(a, b)
    va, vb = a.dim() == 1, b.dim() == 1
    if va:
        a = a.unsqueeze(0)
    if vb:
        b = b.unsqueeze(-1)
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, k), b, out_dtype=torch.float32)
        out = out.reshape(*a.shape[:-1], n)
    else:
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        out = torch.bmm(a.expand(*batch, m, k).reshape(-1, m, k),
                        b.expand(*batch, k, n).reshape(-1, k, n),
                        out_dtype=torch.float32)
        out = out.reshape(*batch, m, n)
    if va:
        out = out.squeeze(-2)
    if vb:
        out = out.squeeze(-1)
    return out


@register("MatMul")
def _matmul(c: OpCall):
    a, b = c.inp(0), c.inp(1)
    if _all_static(a, b):
        return [np.matmul(a, b)]
    return [matmul_f32(c.dev(a), c.dev(b), keep=c.out_dtype)]


@register("Gemm")
def _gemm(c: OpCall):
    a, b, bias = c.t(0), c.t(1), c.t(2)
    alpha, beta = c.attr("alpha", 1.0), c.attr("beta", 1.0)
    if c.attr("transA", 0):
        a = a.T
    if c.attr("transB", 0):
        b = b.T
    if bias is None and alpha == 1.0:
        return [matmul_f32(a, b, keep=c.out_dtype)]
    out = alpha * matmul_f32(a, b)
    if bias is not None:
        out = out + beta * bias
    return [out]


# ============================================================================
# convolutions / pooling / normalization
# ============================================================================

def _conv_pads(call: OpCall, a_shape, k_shape, strides, dilations):
    """Resolve ONNX pads/auto_pad to a padding list [(lo,hi), ...]."""
    spatial = len(k_shape)
    auto = call.attr("auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        pads = call.attr("pads", [0] * 2 * spatial)
        return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    if auto == "VALID":
        return [(0, 0)] * spatial
    out = []
    for i in range(spatial):
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-a_shape[i] // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + eff_k - a_shape[i])
        lo = total // 2 if auto == "SAME_UPPER" else total - total // 2
        out.append((lo, total - lo))
    return out


def _pad_spatial(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Explicit (lo, hi) padding of the trailing spatial axes (negative
    values crop, as lax's padding does)."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if not any(flat):
        return x
    return F.pad(x, flat, mode="constant", value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _conv_f32(fn, x: torch.Tensor, w: torch.Tensor,
              keep: Optional[torch.dtype] = None, **kw) -> torch.Tensor:
    """A convolution with a float32 result.  With ``keep`` equal to the
    bf16/f16 operand type on the card, cuDNN runs at that type (float32
    accumulation) and rounds once, the value the runner's cast of the
    float32 result would give.  Otherwise the operands widen to float32,
    which holds every bf16/f16 value and every product of two exactly,
    so the float32 result is the sum of the exact products, as
    ``preferred_element_type=float32`` gives it (cuDNN has no bf16-in,
    float32-out convolution)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if keep == dt and dt in _LOW and x.is_cuda:
        return fn(x.to(dt), w.to(dt), **kw)
    return fn(x.float(), w.float(), **kw)


@register("Conv")
def _conv(c: OpCall):
    x, w, b = c.t(0), c.t(1), c.inp(2)
    spatial = x.dim() - 2
    if spatial not in _CONV:
        raise NotImplementedError(f"Conv with {spatial} spatial dims")
    strides = list(c.attr("strides", [1] * spatial))
    dilations = list(c.attr("dilations", [1] * spatial))
    group = c.attr("group", 1)
    pads = _conv_pads(c, x.shape[2:], w.shape[2:], strides, dilations)
    out = _conv_f32(_CONV[spatial], _pad_spatial(x, pads), w,
                    keep=c.out_dtype if b is None else None,
                    stride=strides, dilation=dilations, groups=group)
    if b is not None:
        out = out + c.dev(b).reshape((1, -1) + (1,) * spatial)
    return [out]


@register("ConvTranspose")
def _conv_transpose(c: OpCall):
    x, w, b = c.t(0), c.t(1), c.inp(2)
    spatial = x.dim() - 2
    strides = list(c.attr("strides", [1] * spatial))
    dilations = list(c.attr("dilations", [1] * spatial))
    group = c.attr("group", 1)
    if group != 1:
        raise NotImplementedError("ConvTranspose group > 1")
    pads = c.attr("pads", [0] * 2 * spatial)
    out_pads = c.attr("output_padding", [0] * spatial)
    # ONNX's kernel layout (C_in, C_out, *k) is torch's: the full
    # transposed output, then the ONNX pads cropped off (and output_padding
    # added back at the end of each axis)
    out = _conv_f32(_CONV_T[spatial], x, w,
                    keep=c.out_dtype if b is None else None,
                    stride=strides, dilation=dilations)
    crop = [(-int(pads[i]), int(out_pads[i]) - int(pads[i + spatial]))
            for i in range(spatial)]
    out = _pad_spatial(out, crop)
    if b is not None:
        out = out + c.dev(b).reshape((1, -1) + (1,) * spatial)
    return [out]


def _window_sums(x: torch.Tensor, kernel, strides, dilations) -> torch.Tensor:
    """lax.reduce_window(add) over an already padded (N, C, *S) tensor: a
    depthwise convolution with a kernel of ones (exact sums)."""
    spatial = x.dim() - 2
    ch = x.shape[1]
    ones = torch.ones((ch, 1) + tuple(kernel), dtype=x.dtype,
                      device=x.device)
    return _CONV[spatial](x, ones, stride=strides, dilation=dilations,
                          groups=ch)


def _pool(c: OpCall, is_avg: bool):
    x = c.t(0)
    spatial = x.dim() - 2
    kernel = list(c.attr("kernel_shape"))
    strides = list(c.attr("strides", [1] * spatial))
    dilations = list(c.attr("dilations", [1] * spatial))
    pads = _conv_pads(c, x.shape[2:], kernel, strides, dilations)
    if not is_avg:
        xp = _pad_spatial(x, pads, value=-math.inf)
        return [_MAXPOOL[spatial](xp, kernel, stride=strides,
                                  dilation=dilations)]
    out = _window_sums(_pad_spatial(x, pads), kernel, strides, dilations)
    if c.attr("count_include_pad", 0):
        out = out / float(np.prod(kernel))
    else:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = _window_sums(_pad_spatial(ones, pads), kernel, strides,
                              dilations)
        out = out / counts
    return [out]


@register("MaxPool")
def _maxpool(c: OpCall):
    return _pool(c, is_avg=False)


@register("AveragePool")
def _avgpool(c: OpCall):
    return _pool(c, is_avg=True)


@register("GlobalAveragePool")
def _global_avgpool(c: OpCall):
    x = c.inp(0)
    axes = tuple(range(2, len(x.shape)))
    if is_static(x):
        return [np.mean(x, axis=axes, keepdims=True)]
    return [torch.mean(x, dim=axes, keepdim=True)]


@register("GlobalMaxPool")
def _global_maxpool(c: OpCall):
    x = c.inp(0)
    axes = tuple(range(2, len(x.shape)))
    if is_static(x):
        return [np.max(x, axis=axes, keepdims=True)]
    return [torch.amax(x, dim=axes, keepdim=True)]


@register("BatchNormalization")
def _batchnorm(c: OpCall):
    x, scale, bias, mean, var = (c.inp(0), c.inp(1), c.inp(2), c.inp(3),
                                 c.inp(4))
    eps = c.attr("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (len(x.shape) - 2)
    params = (scale, bias, mean, var)
    if _all_static(x, *params):
        inv = scale / np.sqrt(var + eps)
        return [x * inv.reshape(shape) + (bias - mean * inv).reshape(shape)]

    def fold():
        # the reference's x * inv + (bias - mean * inv); over static
        # parameters numpy's IEEE float32 ops give the device's values
        if _all_static(*params):
            inv = scale / np.sqrt(var + eps)
            return c.dev(inv.reshape(shape)), c.dev(
                (bias - mean * inv).reshape(shape))
        s, b, m, v = (c.dev(p) for p in params)
        inv = s / torch.sqrt(v + eps)
        return inv.reshape(shape), (b - m * inv).reshape(shape)

    inv, shift = c.fold("bn", fold, *params)
    return [c.dev(x) * inv + shift]


def _mean_var(x: torch.Tensor, axes):
    """jnp.mean / jnp.var (ddof 0) in the reference's order: the mean,
    then the mean of the squared deviations."""
    mean = x.mean(dim=axes, keepdim=True)
    d = x - mean
    return mean, (d * d).mean(dim=axes, keepdim=True)


@register("InstanceNormalization")
def _instancenorm(c: OpCall):
    x, scale, bias = c.t(0), c.t(1), c.t(2)
    eps = c.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean, var = _mean_var(x, axes)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return [(x - mean) / torch.sqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape)]


@register("LayerNormalization")
def _layernorm(c: OpCall):
    x, scale, bias = c.t(0), c.t(1), c.t(2)
    axis = c.attr("axis", -1)
    eps = c.attr("epsilon", 1e-5)
    axes = tuple(range(axis % x.dim(), x.dim()))
    mean, var = _mean_var(x, axes)
    inv = 1.0 / torch.sqrt(var + eps)
    out = (x - mean) * inv * scale
    if bias is not None:
        out = out + bias
    outs = [out]
    if c.n_outputs > 1:
        outs.append(mean)
    if c.n_outputs > 2:
        outs.append(inv)
    return outs


@register("GroupNormalization")
def _groupnorm(c: OpCall):
    x, scale, bias = c.t(0), c.t(1), c.t(2)
    ngroups = c.attr("num_groups")
    eps = c.attr("epsilon", 1e-5)
    n, ch = x.shape[0], x.shape[1]
    grouped = x.reshape((n, ngroups, ch // ngroups) + tuple(x.shape[2:]))
    axes = tuple(range(2, grouped.dim()))
    mean, var = _mean_var(grouped, axes)
    normed = ((grouped - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return [normed * scale.reshape(shape) + bias.reshape(shape)]


@register("LRN")
def _lrn(c: OpCall):
    x = c.t(0)
    size = c.attr("size")
    alpha, beta, bias = (c.attr("alpha", 1e-4), c.attr("beta", 0.75),
                         c.attr("bias", 1.0))
    sq = x * x
    half_lo = (size - 1) // 2
    half_hi = size - 1 - half_lo
    pad = [0, 0] * (x.dim() - 2) + [half_lo, half_hi]
    sums = F.pad(sq, pad).unfold(1, size, 1).sum(-1)
    return [x / torch.pow(bias + alpha / size * sums, beta)]


@register("Resize")
def _resize(c: OpCall):
    x = c.t(0)
    scales = c.static(2)
    sizes = c.static(3)
    mode = c.attr("mode", "nearest")
    if sizes is not None:
        out_shape = [int(s) for s in np.asarray(sizes)]
    elif scales is not None and len(np.asarray(scales)):
        sc = np.asarray(scales, dtype=np.float64)
        out_shape = [int(math.floor(d * s)) for d, s in zip(x.shape, sc)]
    else:
        raise ValueError("Resize needs scales or sizes")
    method = {"nearest": "nearest", "linear": "linear",
              "cubic": "cubic"}[mode]
    return [image_ops.resize(x, out_shape, method)]


@register("Upsample")
def _upsample(c: OpCall):
    x = c.t(0)
    scales = c.static(1)
    sc = np.asarray(scales if scales is not None else c.attr("scales"),
                    dtype=np.float64)
    out_shape = [int(math.floor(d * s)) for d, s in zip(x.shape, sc)]
    mode = c.attr("mode", "nearest")
    return [image_ops.resize(x, out_shape,
                             "nearest" if mode == "nearest" else "linear")]


@register("DepthToSpace")
def _depth_to_space(c: OpCall):
    x = c.t(0)
    bs = c.attr("blocksize")
    n, ch, h, w = x.shape
    if c.attr("mode", "DCR") == "DCR":
        t = x.reshape(n, bs, bs, ch // (bs * bs), h, w)
        t = t.permute(0, 3, 4, 1, 5, 2)
    else:
        t = x.reshape(n, ch // (bs * bs), bs, bs, h, w)
        t = t.permute(0, 1, 4, 2, 5, 3)
    return [t.reshape(n, ch // (bs * bs), h * bs, w * bs)]


@register("SpaceToDepth")
def _space_to_depth(c: OpCall):
    x = c.t(0)
    bs = c.attr("blocksize")
    n, ch, h, w = x.shape
    t = x.reshape(n, ch, h // bs, bs, w // bs, bs)
    t = t.permute(0, 3, 5, 1, 2, 4)
    return [t.reshape(n, ch * bs * bs, h // bs, w // bs)]


def lower(call: OpCall) -> List[Any]:
    fn = OP_REGISTRY.get(call.op_type)
    if fn is None:
        raise NotImplementedError(
            f"ONNX op {call.op_type!r} has no PyTorch lowering "
            f"({len(OP_REGISTRY)} ops supported)")
    return fn(call)


def supported_ops() -> List[str]:
    return sorted(OP_REGISTRY)
