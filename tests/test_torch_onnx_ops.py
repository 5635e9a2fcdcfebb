"""The port's ONNX op lowerings against the JAX package's, on the CPU.

Each case builds one small ONNX graph per op family (the protobuf bytes
are the same from either package's ``GraphBuilder``), feeds seeded numpy
inputs through ``synapseml_tpu.models.onnx.compile_onnx`` (jit on the
CPU) and through the port's ``compile_onnx(..., device="cpu")``, and
compares every output.  Tolerances, against the output's scale (its
largest magnitude, at least 1):

- data movement, integer ops and comparisons: exact;
- elementwise transcendentals: 1e-6 (XLA's and PyTorch's CPU math
  libraries differ by a few ulp);
- reductions, softmax, pooling averages and normalizations: 1e-5
  (summation order);
- matmul and convolution: 1e-4 (another summation order over longer
  sums).

The JAX package runs with 64-bit mode off, so its int64 values come back
as int32 while the port keeps ONNX's int64: the tests compare values, not
integer widths.
"""

import numpy as np
import pytest
import torch

import synapseml_tpu.models.onnx as J
import synapseml_tpu_torch.models.onnx as T
from onnx_families import FAMILIES, TOL, _conv, check
from synapseml_tpu_torch.models.onnx import GraphBuilder
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _run_both(payload, feeds):
    j = J.compile_onnx(payload)(**feeds)
    t = T.compile_onnx(payload, device="cpu")(**feeds)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.cpu().numpy() for k, v in t.items()})


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_op_family_matches_reference(family):
    payload, feeds, outs = FAMILIES[family](np.random.default_rng(7))
    want, got = _run_both(payload, feeds)
    assert set(got) == set(want) == set(outs)
    for name, tol in outs.items():
        check(f"{family}:{name}", got[name], want[name], TOL[tol])


def test_every_registered_op_has_a_family():
    seen = set()
    for fn in FAMILIES.values():
        payload, _, _ = fn(np.random.default_rng(0))
        seen |= {n.op_type for n in T.load_graph(payload).nodes}
    assert seen == set(T.supported_ops())


def test_supported_ops_equal_the_reference():
    assert T.supported_ops() == J.supported_ops()


# -- the protobuf codec ---------------------------------------------------------

def test_protobuf_round_trip_bytes_equal_across_packages():
    payload, _, _ = _conv(np.random.default_rng(1))
    jm, tm = J.load_model(payload), T.load_model(payload)
    assert tm.serialize() == jm.serialize() == payload
    jg, tg = J.load_graph(payload), T.load_graph(payload)
    assert T.to_model(tg).serialize() == J.to_model(jg).serialize()
    sliced = T.slice_at_outputs(tg, [tg.nodes[0].outputs[0]])
    jsliced = J.slice_at_outputs(jg, [jg.nodes[0].outputs[0]])
    assert T.to_model(sliced).serialize() == J.to_model(jsliced).serialize()


def test_attributes_of_every_type_round_trip():
    from synapseml_tpu.models.onnx import GraphBuilder as JGraphBuilder
    attrs = dict(i=-3, f=1.5, s="edge", t=np.arange(6, dtype=np.int64)
                 .reshape(2, 3), ints=[1, -2, 3], floats=[0.5, -1.25],
                 strings=["a", "bc"])
    built = []
    for B in (GraphBuilder, JGraphBuilder):
        b = B("attrs")
        x = b.input("x", (2, 3))
        b.output(b.node("Identity", [x], **attrs))
        b.initializer("f16", np.arange(4, dtype=np.float16))
        b.initializer("b", np.asarray([True, False]))
        built.append(b.build())
    assert built[0] == built[1]
    g = T.load_graph(built[0])
    got = g.nodes[0].attrs
    assert got["i"] == -3 and got["f"] == 1.5 and got["s"] == "edge"
    np.testing.assert_array_equal(got["t"], attrs["t"])
    assert got["ints"] == [1, -2, 3] and got["floats"] == [0.5, -1.25]
    assert got["strings"] == ["a", "bc"]
    assert g.initializers["f16"].dtype == np.float16
    assert T.load_model(built[0]).serialize() == built[0]


# -- refusals and the static contract -------------------------------------------

def _single(op, inputs, feeds, opset=17, **attrs):
    b = GraphBuilder("one", opset=opset)
    names = [b.input(k, v.shape, v.dtype) for k, v in feeds.items()]
    names += [b.initializer(k, v) for k, v in inputs.items()]
    b.output(b.node(op, names, **attrs))
    return b.build()


@pytest.mark.parametrize("case", ["cumsum_exclusive", "cumsum_reverse",
                                  "unknown_op", "convtranspose_group",
                                  "gathernd_batch_dims"])
def test_refusals_match_the_reference(case):
    x = np.ones((2, 4, 3, 3), np.float32)
    payload = {
        "cumsum_exclusive": lambda: _single(
            "CumSum", {"a": np.asarray(1, np.int64)}, {"x": x}, exclusive=1),
        "cumsum_reverse": lambda: _single(
            "CumSum", {"a": np.asarray(1, np.int64)}, {"x": x}, reverse=1),
        "unknown_op": lambda: _single("NotAnOnnxOp", {}, {"x": x}),
        "convtranspose_group": lambda: _single(
            "ConvTranspose", {"w": np.ones((4, 1, 2, 2), np.float32)},
            {"x": x}, group=2),
        "gathernd_batch_dims": lambda: _single(
            "GatherND", {"i": np.zeros((2, 1), np.int64)}, {"x": x},
            batch_dims=1),
    }[case]()
    with pytest.raises(NotImplementedError):
        J.compile_onnx(payload)(x=x)
    with pytest.raises(NotImplementedError):
        T.compile_onnx(payload, device="cpu")(x=x)


def test_static_inputs_are_required_where_the_reference_requires_them():
    """A shape that arrives as a graph input is a device value: Reshape
    refuses it in both packages, with the reference's message."""
    x = np.ones((2, 6), np.float32)
    s = np.asarray([3, 4], np.int64)
    payload = _single("Reshape", {}, {"x": x, "s": s})
    with pytest.raises(Exception):
        J.compile_onnx(payload)(x=x, s=s)
    with pytest.raises(ValueError, match="must be static"):
        T.compile_onnx(payload, device="cpu")(x=x, s=s)
