"""Small ONNX graphs, one per op family of the ONNX lowerings, with seeded
inputs and each output's tolerance class.  Imports no JAX: the port's
CPU parity tests and its card tests both use them.

Tolerance classes, against the output's scale (its largest magnitude, at
least 1): ``exact``; ``tr`` 1e-6 (elementwise transcendentals);
``red`` 1e-5 (reductions, softmax, pooling averages, normalizations);
``mm`` 1e-4 (matmul and convolution).
"""

import numpy as np

from synapseml_tpu_torch.models.onnx import GraphBuilder
from synapseml_tpu_torch.models.onnx import protoparse as TP

INT_MAX = np.iinfo(np.int64).max
TOL = {"exact": 0.0, "tr": 1e-6, "red": 1e-5, "mm": 1e-4}


def check(name, got, want, tol):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if tol == 0.0:
        if want.dtype.kind == "f":
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64), err_msg=name)
        return
    # non-finite values (inf, nan) must sit at the same places, equal
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin].astype(got.dtype),
                                  err_msg=name)
    if not fin.any():
        return
    g, w = got[fin].astype(np.float64), want[fin].astype(np.float64)
    scale = max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, (name, err, scale)


# -- one graph per op family ---------------------------------------------------

def _arith(rng):
    b = GraphBuilder("arith")
    x, y = b.input("x", (3, 4)), b.input("y", (3, 4))
    c = b.initializer("c", rng.normal(size=(4,)).astype(np.float32))
    outs = {}
    for op in ("Add", "Sub", "Mul"):
        outs[b.node(op, [x, c])] = "exact"
        outs[b.node(op, [x, y])] = "exact"
    # XLA divides by a constant through its reciprocal (1 ulp)
    outs[b.node("Div", [x, c])] = "tr"
    outs[b.node("Div", [x, y])] = "exact"
    outs[b.node("Pow", [b.node("Abs", [x]), y])] = "tr"
    for op in ("Min", "Max", "Sum"):
        outs[b.node(op, [x, y, c])] = "exact"
    outs[b.node("Mean", [x, y, c])] = "tr"         # XLA: x * (1/3)
    gt = b.node("Greater", [x, y])
    le = b.node("LessOrEqual", [x, c])
    outs[gt] = outs[le] = "exact"
    for op in ("Less", "GreaterOrEqual", "Equal"):
        outs[b.node(op, [x, y])] = "exact"
    for op in ("And", "Or", "Xor"):
        outs[b.node(op, [gt, le])] = "exact"
    outs[b.node("Not", [gt])] = "exact"
    outs[b.node("Where", [gt, x, c])] = "exact"
    for o in outs:
        b.output(o)
    y_np = rng.normal(size=(3, 4)).astype(np.float32)
    y_np[0, 0] = 0.0
    return b.build(), {"x": rng.normal(size=(3, 4)).astype(np.float32),
                       "y": y_np}, outs


def _integer(rng):
    b = GraphBuilder("ints")
    a, d = b.input("a", (4, 5), np.int64), b.input("d", (4, 5), np.int64)
    outs = {b.node("Div", [a, d]): "exact", b.node("Mod", [a, d]): "exact",
            b.node("BitwiseAnd", [a, d]): "exact",
            b.node("BitwiseOr", [a, d]): "exact",
            b.node("Neg", [a]): "exact", b.node("Abs", [a]): "exact",
            b.node("Sign", [a]): "exact",
            b.node("Cast", [a], to=TP.FLOAT): "exact"}
    f = b.input("f", (4, 5))
    outs[b.node("Cast", [f], to=TP.INT64)] = "exact"
    outs[b.node("CastLike", [f, a])] = "exact"
    outs[b.node("Div", [f, b.node("Cast", [d], to=TP.FLOAT)])] = "exact"
    outs[b.node("Mod", [f, b.initializer("m", np.float32(1.5))])] = "exact"
    for o in outs:
        b.output(o)
    dv = rng.integers(-9, 10, (4, 5))
    dv[dv == 0] = 3
    return b.build(), {"a": rng.integers(-50, 50, (4, 5)),
                       "d": dv,
                       "f": rng.normal(size=(4, 5)).astype(np.float32) * 9}, \
        outs


_UNARY = ["Exp", "Sin", "Cos", "Tan", "Atan", "Sinh", "Cosh", "Tanh", "Erf",
          "Sigmoid", "Softplus", "Softsign", "Mish", "Elu", "Selu",
          "HardSigmoid", "HardSwish", "LeakyRelu", "Relu", "Reciprocal",
          "Floor", "Ceil", "Round", "Neg", "Abs", "Sign", "IsNaN", "IsInf"]


def _unary(rng):
    b = GraphBuilder("unary")
    x = b.input("x", (6, 7))
    outs = {b.node(op, [x]): "tr" for op in _UNARY}
    pos = b.node("Abs", [x])
    outs[b.node("Log", [pos])] = "tr"
    outs[b.node("Sqrt", [pos])] = "tr"
    unit = b.input("u", (6, 7))
    outs[b.node("Asin", [unit])] = "tr"
    outs[b.node("Acos", [unit])] = "tr"
    outs[b.node("Gelu", [x])] = "tr"
    outs[b.node("Gelu", [x], approximate="tanh")] = "tr"
    outs[b.node("PRelu", [x, b.initializer(
        "slope", rng.uniform(0.1, 0.3, (7,)).astype(np.float32))])] = "tr"
    for o in outs:
        b.output(o)
    xv = (rng.normal(size=(6, 7)) * 2).astype(np.float32)
    xv[0, :3] = [np.inf, -np.inf, np.nan]
    xv[1, :4] = [0.5, -0.5, 1.5, 2.5]          # Round's ties go to even
    return b.build(), {"x": xv, "u": rng.uniform(-0.95, 0.95, (6, 7)).astype(
        np.float32)}, outs


def _clip(rng):
    outs = {}
    b = GraphBuilder("clip", opset=13)
    x = b.input("x", (5, 5))
    lo = b.initializer("lo", np.float32(-0.5))
    hi = b.initializer("hi", np.float32(0.7))
    outs[b.node("Clip", [x, lo, hi])] = "exact"
    outs[b.node("Clip", [x, lo])] = "exact"
    outs[b.node("Clip", [x, "", hi])] = "exact"
    outs[b.node("Clip", [x])] = "exact"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(5, 5)).astype(np.float32)}, outs


def _clip6(rng):
    b = GraphBuilder("clip6", opset=6)
    x = b.input("x", (5, 5))
    outs = {b.node("Clip", [x], min=-0.25, max=0.5): "exact",
            b.node("Clip", [x], min=0.1): "exact"}
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(5, 5)).astype(np.float32)}, outs


def _softmax(opset):
    def build(rng):
        b = GraphBuilder(f"softmax{opset}", opset=opset)
        x = b.input("x", (2, 3, 4))
        outs = {b.node("Softmax", [x]): "red",
                b.node("Softmax", [x], axis=2): "red",
                b.node("LogSoftmax", [x]): "red",
                b.node("LogSoftmax", [x], axis=1): "red"}
        for o in outs:
            b.output(o)
        return b.build(), {"x": rng.normal(size=(2, 3, 4)).astype(
            np.float32) * 3}, outs
    return build


def _reduce(rng):
    b = GraphBuilder("reduce", opset=13)
    x = b.input("x", (3, 4, 5))
    ax = b.initializer("ax", np.asarray([1, 2], np.int64))
    outs = {b.node("ReduceSum", [x, ax], keepdims=0): "red",
            b.node("ReduceSum", [x]): "red",
            b.node("ReduceSum", [x], noop_with_empty_axes=1): "exact",
            b.node("ReduceMean", [x], axes=[0, 2]): "red",
            b.node("ReduceMax", [x], axes=[-1]): "exact",
            b.node("ReduceMin", [x], axes=[1], keepdims=0): "exact",
            b.node("ReduceProd", [x], axes=[1, 2]): "red",
            b.node("ReduceL2", [x], axes=[2]): "red",
            b.node("ReduceLogSumExp", [x], axes=[1]): "red",
            b.node("CumSum", [x, b.initializer(
                "one", np.asarray(1, np.int64))]): "red"}
    q = b.input("q", (4, 6))
    outs[b.node("ArgMax", [q], axis=1)] = "exact"
    outs[b.node("ArgMin", [q], axis=0, keepdims=0)] = "exact"
    k = b.initializer("k", np.asarray([3], np.int64))
    for largest in (1, 0):
        vals, idx = b.node("TopK", [q, k], n_outputs=2, axis=1,
                           largest=largest)
        outs[vals] = outs[idx] = "exact"
    for o in outs:
        b.output(o)
    # ties: TopK's lower index first, ArgMax/ArgMin's first extreme
    qv = rng.integers(0, 3, (4, 6)).astype(np.float32)
    return b.build(), {"x": rng.uniform(0.5, 1.5, (3, 4, 5)).astype(
        np.float32), "q": qv}, outs


def _shape(rng):
    b = GraphBuilder("shape", opset=13)
    x = b.input("x", (2, 3, 4))
    shp = b.node("Shape", [x])
    bdim = b.node("Gather", [shp, b.initializer(
        "zero", np.asarray(0, np.int64))], axis=0)
    bdim = b.node("Unsqueeze", [bdim, b.initializer(
        "ax0", np.asarray([0], np.int64))])
    tgt = b.node("Concat", [bdim, b.initializer(
        "rest", np.asarray([-1], np.int64))], axis=0)
    outs = {b.node("Reshape", [x, tgt]): "exact",
            b.node("Reshape", [x, b.initializer(
                "keep", np.asarray([0, 12], np.int64))]): "exact",
            b.node("Flatten", [x], axis=2): "exact",
            b.node("Transpose", [x], perm=[2, 0, 1]): "exact",
            b.node("Transpose", [x]): "exact",
            b.node("Shape", [x], start=1): "exact",
            b.node("Size", [x]): "exact",
            b.node("Identity", [x]): "exact",
            b.node("Expand", [b.node("Unsqueeze", [x, b.initializer(
                "ax1", np.asarray([1], np.int64))]), b.initializer(
                "eshape", np.asarray([2, 2, 1, 1], np.int64))]): "exact",
            b.node("Tile", [x, b.initializer(
                "reps", np.asarray([1, 2, 1], np.int64))]): "exact",
            b.node("Concat", [x, x], axis=-1): "exact"}
    sq = b.node("Unsqueeze", [x, b.initializer(
        "ax13", np.asarray([1, -1], np.int64))])
    outs[sq] = "exact"
    outs[b.node("Squeeze", [sq, b.initializer(
        "sqax", np.asarray([1], np.int64))])] = "exact"
    outs[b.node("Squeeze", [sq])] = "exact"
    for o in b.node("Split", [x], n_outputs=2, axis=2):
        outs[o] = "exact"
    for o in b.node("Split", [x, b.initializer(
            "parts", np.asarray([1, 2], np.int64))], n_outputs=2, axis=1):
        outs[o] = "exact"
    for o in b.node("Split", [x], n_outputs=3, axis=2):   # 2 + 2 + 0
        outs[o] = "exact"
    sl = lambda name, v: b.initializer(name, np.asarray(v, np.int64))  # noqa
    outs[b.node("Slice", [x, sl("s0", [-1, 1]), sl("e0", [-INT_MAX, 3]),
                          sl("a0", [2, 1]), sl("p0", [-1, 1])])] = "exact"
    outs[b.node("Slice", [x, sl("s1", [0]), sl("e1", [INT_MAX]),
                          sl("a1", [-1]), sl("p1", [2])])] = "exact"
    outs[b.node("Slice", [x, sl("s2", [2, 5]), sl("e2", [0, -7]),
                          sl("a2", [1, 2]), sl("p2", [-1, -2])])] = "exact"
    outs[b.node("Slice", [x, sl("s3", [1]), sl("e3", [2])])] = "exact"
    drop, mask = b.node("Dropout", [x], n_outputs=2)
    outs[drop] = outs[mask] = "exact"
    # static producers: Constant's kinds, ConstantOfShape, Range, NonZero
    cval = b.node("Constant", [], value=np.asarray([[1, 0], [3, 0]], np.int64))
    outs[b.node("NonZero", [cval])] = "exact"
    outs[b.node("Constant", [], value_float=2.5)] = "exact"
    outs[b.node("Constant", [], value_ints=[4, 5])] = "exact"
    outs[b.node("Constant", [], value_floats=[0.5, 1.5])] = "exact"
    outs[b.node("Constant", [], value_int=7)] = "exact"
    outs[b.node("ConstantOfShape", [shp], value=np.asarray(
        [2.0], np.float32))] = "exact"
    outs[b.node("ConstantOfShape", [sl("cs", [2, 2])])] = "exact"
    outs[b.node("Range", [sl("r0", 1), sl("r1", 9), sl("r2", 3)])] = "exact"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 3, 4)).astype(np.float32)}, \
        outs


def _legacy_shape(rng):
    b = GraphBuilder("legacy", opset=9)
    x = b.input("x", (2, 1, 6))
    outs = {b.node("Squeeze", [x], axes=[1]): "exact",
            b.node("Unsqueeze", [x], axes=[0, 4]): "exact",
            b.node("Slice", [x], starts=[1, -4], ends=[2, 100],
                   axes=[0, 2]): "exact",
            b.node("Reshape", [x, b.initializer(
                "shape", np.asarray([3, -1], np.int64))]): "exact"}
    for o in b.node("Split", [x], n_outputs=2, axis=2, split=[2, 4]):
        outs[o] = "exact"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 1, 6)).astype(np.float32)}, \
        outs


def _gather(rng):
    b = GraphBuilder("gather", opset=17)
    x = b.input("x", (4, 5))
    i = b.input("i", (2, 3), np.int64)
    emb = b.initializer("emb", rng.normal(size=(7, 3)).astype(np.float32))
    outs = {b.node("Gather", [x, i], axis=1): "exact",
            b.node("Gather", [emb, i], axis=0): "exact",
            b.node("Gather", [x, b.initializer(
                "neg", np.asarray([-1, 0], np.int64))], axis=0): "exact",
            b.node("GatherElements", [x, b.initializer(
                "ge", np.asarray([[0, 4], [-1, 2], [1, 0], [3, -5]], np.int64))],
                axis=1): "exact",
            b.node("GatherND", [x, b.initializer(
                "gnd", np.asarray([[0, 1], [3, 4]], np.int64))]): "exact",
            b.node("ScatterND", [x, b.initializer(
                "snd", np.asarray([[1], [3]], np.int64)), b.initializer(
                "upd", rng.normal(size=(2, 5)).astype(np.float32))]): "exact",
            b.node("OneHot", [i, b.initializer(
                "depth", np.asarray(4, np.int64)), b.initializer(
                "onoff", np.asarray([-1.0, 2.0], np.float32))]): "exact",
            b.node("OneHot", [i, b.initializer(
                "depth1", np.asarray(3, np.int64)), b.initializer(
                "onoff1", np.asarray([0, 5], np.int64))], axis=1): "exact",
            b.node("Trilu", [x]): "exact",
            b.node("Trilu", [x, b.initializer(
                "kk", np.asarray(1, np.int64))], upper=0): "exact",
            b.node("Einsum", [x, b.node("Transpose", [x])],
                   equation="ij,jk->ik"): "mm"}
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(4, 5)).astype(np.float32),
                       "i": np.asarray([[0, -1, 2], [4, 1, -2]])}, outs


def _pad(rng):
    b = GraphBuilder("pad", opset=13)
    x = b.input("x", (2, 3, 5))
    pads = b.initializer("pads", np.asarray([0, 1, 2, 0, 2, 3], np.int64))
    outs = {b.node("Pad", [x, pads, b.initializer(
        "cv", np.float32(1.5))]): "exact",
        b.node("Pad", [x, pads]): "exact"}
    for mode in ("reflect", "edge", "wrap"):
        outs[b.node("Pad", [x, pads], mode=mode)] = "exact"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 3, 5)).astype(np.float32)}, \
        outs


def _pad2(rng):
    b = GraphBuilder("pad2", opset=2)
    x = b.input("x", (2, 4))
    outs = {b.node("Pad", [x], pads=[1, 0, 0, 2], value=-3.0): "exact",
            b.node("Pad", [x], pads=[0, 3, 0, 3], mode="reflect"): "exact"}
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 4)).astype(np.float32)}, outs


def _matmul(rng):
    b = GraphBuilder("matmul")
    x = b.input("x", (2, 3, 8))
    w = b.initializer("w", rng.normal(size=(8, 5)).astype(np.float32))
    bw = b.initializer("bw", rng.normal(size=(2, 1, 8, 4)).astype(np.float32))
    v = b.initializer("v", rng.normal(size=(8,)).astype(np.float32))
    outs = {b.node("MatMul", [x, w]): "mm", b.node("MatMul", [x, bw]): "mm",
            b.node("MatMul", [x, v]): "mm",
            b.node("MatMul", [v, w]): "mm"}
    a2 = b.input("a", (6, 8))
    g = b.initializer("g", rng.normal(size=(5, 8)).astype(np.float32))
    gb = b.initializer("gb", rng.normal(size=(5,)).astype(np.float32))
    outs[b.node("Gemm", [a2, g, gb], transB=1, alpha=0.5, beta=2.0)] = "mm"
    outs[b.node("Gemm", [b.node("Transpose", [a2]), w], transA=1)] = "mm"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 3, 8)).astype(np.float32),
                       "a": rng.normal(size=(6, 8)).astype(np.float32)}, outs


def _conv(rng):
    b = GraphBuilder("conv")
    x = b.input("x", (2, 4, 9, 11))
    w = b.initializer("w", rng.normal(size=(6, 4, 3, 3)).astype(np.float32))
    wg = b.initializer("wg", rng.normal(size=(6, 2, 3, 2)).astype(np.float32))
    bias = b.initializer("b", rng.normal(size=(6,)).astype(np.float32))
    outs = {b.node("Conv", [x, w, bias], pads=[0, 1, 2, 1],
                   strides=[2, 1]): "mm",
            b.node("Conv", [x, w], dilations=[2, 1], pads=[1, 1, 1, 1]): "mm",
            b.node("Conv", [x, wg], group=2, strides=[1, 2]): "mm"}
    for auto in ("SAME_UPPER", "SAME_LOWER", "VALID"):
        outs[b.node("Conv", [x, w], auto_pad=auto, strides=[2, 3])] = "mm"
    wt = b.initializer("wt", rng.normal(size=(4, 3, 3, 2)).astype(np.float32))
    outs[b.node("ConvTranspose", [x, wt, b.initializer(
        "bt", rng.normal(size=(3,)).astype(np.float32))],
        strides=[2, 2], pads=[1, 0, 0, 1], output_padding=[1, 0])] = "mm"
    outs[b.node("ConvTranspose", [x, wt], dilations=[2, 1])] = "mm"
    x1 = b.input("x1", (2, 3, 10))
    outs[b.node("Conv", [x1, b.initializer(
        "w1", rng.normal(size=(4, 3, 3)).astype(np.float32))],
        pads=[2, 0])] = "mm"
    x3 = b.input("x3", (1, 2, 4, 5, 6))
    outs[b.node("Conv", [x3, b.initializer(
        "w3", rng.normal(size=(3, 2, 2, 3, 2)).astype(np.float32))],
        pads=[1, 0, 1, 0, 1, 1])] = "mm"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 4, 9, 11)).astype(np.float32),
                       "x1": rng.normal(size=(2, 3, 10)).astype(np.float32),
                       "x3": rng.normal(size=(1, 2, 4, 5, 6)).astype(
                           np.float32)}, outs


def _pool(rng):
    b = GraphBuilder("pool")
    x = b.input("x", (2, 3, 9, 10))
    outs = {b.node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2],
                   pads=[1, 1, 1, 1], dilations=[2, 2]): "exact",
            b.node("MaxPool", [x], kernel_shape=[2, 3],
                   auto_pad="SAME_UPPER", strides=[2, 2]): "exact",
            b.node("AveragePool", [x], kernel_shape=[3, 3], strides=[2, 2],
                   pads=[1, 0, 2, 1]): "red",
            b.node("AveragePool", [x], kernel_shape=[3, 2], pads=[1, 1, 1, 1],
                   count_include_pad=1): "red",
            b.node("AveragePool", [x], kernel_shape=[2, 2],
                   auto_pad="SAME_LOWER", dilations=[1, 2]): "red",
            b.node("GlobalAveragePool", [x]): "red",
            b.node("GlobalMaxPool", [x]): "exact",
            b.node("LRN", [x], size=3, alpha=1e-3, beta=0.75,
                   bias=2.0): "red"}
    x1 = b.input("x1", (2, 3, 11))
    outs[b.node("MaxPool", [x1], kernel_shape=[3], strides=[2],
                pads=[1, 1])] = "exact"
    outs[b.node("AveragePool", [x1], kernel_shape=[4], pads=[2, 1])] = "red"
    x3 = b.input("x3", (1, 2, 5, 6, 4))
    outs[b.node("MaxPool", [x3], kernel_shape=[2, 2, 2], strides=[2, 2, 1],
                pads=[0, 1, 1, 1, 0, 0])] = "exact"
    outs[b.node("AveragePool", [x3], kernel_shape=[3, 2, 2],
                pads=[1, 1, 0, 1, 0, 1])] = "red"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 3, 9, 10)).astype(np.float32),
                       "x1": rng.normal(size=(2, 3, 11)).astype(np.float32),
                       "x3": rng.normal(size=(1, 2, 5, 6, 4)).astype(
                           np.float32)}, outs


def _norm(rng):
    b = GraphBuilder("norm", opset=18)
    x = b.input("x", (2, 4, 5, 3))
    c = 4
    p = {k: b.initializer(k, v) for k, v in {
        "s": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bb": rng.normal(size=c).astype(np.float32),
        "m": rng.normal(size=c).astype(np.float32),
        "v": rng.uniform(0.5, 2.0, c).astype(np.float32),
        "ls": rng.uniform(0.5, 1.5, (5, 3)).astype(np.float32),
        "lb": rng.normal(size=(5, 3)).astype(np.float32),
        "gs": rng.uniform(0.5, 1.5, c).astype(np.float32)}.items()}
    outs = {b.node("BatchNormalization", [x, p["s"], p["bb"], p["m"], p["v"]],
                   epsilon=1e-3): "red",
            b.node("InstanceNormalization", [x, p["s"], p["bb"]]): "red",
            b.node("GroupNormalization", [x, p["gs"], p["bb"]],
                   num_groups=2): "red"}
    ln = b.node("LayerNormalization", [x, p["ls"], p["lb"]], n_outputs=3,
                axis=2, epsilon=1e-4)
    for o in ln:
        outs[o] = "red"
    outs[b.node("LayerNormalization", [x, b.initializer(
        "l1", rng.uniform(0.5, 1.5, 3).astype(np.float32))])] = "red"
    for o in outs:
        b.output(o)
    return b.build(), {"x": (rng.normal(size=(2, 4, 5, 3)) * 2 + 1).astype(
        np.float32)}, outs


def _resize(rng):
    b = GraphBuilder("resize", opset=13)
    x = b.input("x", (1, 2, 6, 9))
    outs = {}
    for mode in ("nearest", "linear", "cubic"):
        for k, size in enumerate(([1, 2, 11, 4], [1, 2, 3, 17])):
            outs[b.node("Resize", [x, "", "", b.initializer(
                f"sz_{mode}{k}", np.asarray(size, np.int64))],
                mode=mode)] = "red"
        outs[b.node("Resize", [x, "", b.initializer(
            f"sc_{mode}", np.asarray([1, 1, 0.5, 2.0], np.float32))],
            mode=mode)] = "red"
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(1, 2, 6, 9)).astype(np.float32)}, \
        outs


def _upsample(rng):
    b = GraphBuilder("upsample", opset=9)
    x = b.input("x", (1, 2, 4, 5))
    sc = b.initializer("sc", np.asarray([1, 1, 2, 1.5], np.float32))
    outs = {b.node("Upsample", [x, sc]): "red",
            b.node("Upsample", [x, sc], mode="linear"): "red",
            b.node("Upsample", [x, b.initializer(
                "down", np.asarray([1, 1, 0.5, 0.6], np.float32))],
                mode="linear"): "red"}
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(1, 2, 4, 5)).astype(np.float32)}, \
        outs


def _space(rng):
    b = GraphBuilder("space")
    x = b.input("x", (2, 8, 3, 4))
    outs = {b.node("DepthToSpace", [x], blocksize=2): "exact",
            b.node("DepthToSpace", [x], blocksize=2, mode="CRD"): "exact",
            b.node("SpaceToDepth", [b.node("DepthToSpace", [x],
                                           blocksize=2)],
                   blocksize=2): "exact"}
    for o in outs:
        b.output(o)
    return b.build(), {"x": rng.normal(size=(2, 8, 3, 4)).astype(np.float32)}, \
        outs


FAMILIES = {
    "arith": _arith, "integer": _integer, "unary": _unary, "clip": _clip,
    "clip_opset6": _clip6, "softmax_opset11": _softmax(11),
    "softmax_opset13": _softmax(13), "reduce_argmax_topk": _reduce,
    "shape_static": _shape, "shape_legacy": _legacy_shape,
    "gather_scatter": _gather, "pad": _pad, "pad_opset2": _pad2,
    "matmul_gemm": _matmul, "conv": _conv, "pool_lrn": _pool,
    "norm": _norm, "resize": _resize, "upsample": _upsample,
    "depth_space": _space,
}
