"""The ONNX path and the image stages on the card against the same code on
the CPU.  Marked ``gpu``: every test that needs the card skips where none
is present (the check runs inside the fixture, so every worker collects
the same tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_onnx_cuda.py

Tolerances, against each output's scale (its largest magnitude, at least
1): float32 within 1e-5 per op and within 1e-4 for the whole ResNet-50
(cuBLAS/cuDNN and the CPU sum in other orders; the float32 path runs
with TF32 off, and TF32 products, ~1e-3 relative, would miss this);
bf16 within 2e-2; integer, boolean and index outputs (TopK's tie order
included) equal.  A bf16 product whose float32 result is kept (a bias or
scale follows) holds within 1e-5 of the float32 product of the same bf16
values, and the bf16 convolutions and matmuls round once: card and CPU
differ by at most one bf16 step, on at most 1% of the elements.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import synapseml_tpu_torch.models.onnx as T
from onnx_families import FAMILIES, check
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.device import full_f32
from synapseml_tpu_torch.image import ImageTransformer, slic_segments
from synapseml_tpu_torch.models.onnx import GraphBuilder
from synapseml_tpu_torch.models.onnx import ops as TO
from synapseml_tpu_torch.models.onnx import zoo as TZ
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

#: op families whose graphs also run at bf16 (the others hold shape or
#: integer work, or a float value the bf16 rule moves to the device where
#: the op needs it static, as the reference does)
BF16_FAMILIES = ("conv", "matmul_gemm", "norm", "pool_lrn", "softmax_opset13",
                 "unary")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _both(payload, feeds, dev, dtype=None):
    outs = []
    for d in (dev, "cpu"):
        got = T.compile_onnx(payload, dtype=dtype, device=d)(**feeds)
        outs.append({k: v.float().cpu().numpy()
                     if v.dtype == torch.bfloat16 else v.cpu().numpy()
                     for k, v in got.items()})
    return outs


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_op_family_on_card_equals_cpu(family, dev):
    payload, feeds, outs = FAMILIES[family](np.random.default_rng(7))
    card, cpu = _both(payload, feeds, dev)
    for name, tol in outs.items():
        check(f"{family}:{name}", card[name], cpu[name],
              0.0 if tol == "exact" else 1e-5)


@pytest.mark.parametrize("family", BF16_FAMILIES)
def test_op_family_bf16_on_card_near_cpu(family, dev):
    payload, feeds, outs = FAMILIES[family](np.random.default_rng(7))
    card, cpu = _both(payload, feeds, dev, dtype="bfloat16")
    for name in outs:
        if card[name].dtype.kind == "f":
            check(f"{family}:{name}", card[name], cpu[name], 2e-2)
        else:
            assert card[name].shape == cpu[name].shape


def test_bf16_products_keep_the_float32_sum(dev):
    """MatMul/Gemm (2-D and batched) and a convolution on bf16 operands
    with a float32 result: the float32 sum of the exact products, as on
    the CPU, not a sum rounded to bf16 (~1e-3 of scale off)."""
    rng = np.random.default_rng(5)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).bfloat16()

    a, b, a3 = bf16(64, 96), bf16(96, 48), bf16(4, 64, 96)
    x, w = bf16(2, 8, 12, 12), bf16(16, 8, 3, 3)
    with full_f32():
        cases = {
            "mm": (TO.matmul_f32(a.to(dev), b.to(dev)),
                   a.float() @ b.float()),
            "bmm": (TO.matmul_f32(a3.to(dev), b.to(dev)),
                    a3.float() @ b.float()),
            "conv": (TO._conv_f32(F.conv2d, x.to(dev), w.to(dev),
                                  padding=1),
                     F.conv2d(x.float(), w.float(), padding=1))}
    for name, (got, want) in cases.items():
        assert got.dtype == torch.float32, name
        check(name, got.cpu().numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("family", ("conv", "matmul_gemm"))
def test_bf16_products_round_once_on_card(family, dev):
    payload, feeds, outs = FAMILIES[family](np.random.default_rng(7))
    card, cpu = _both(payload, feeds, dev, dtype="bfloat16")
    for name in outs:
        got, want = card[name], cpu[name]
        if want.dtype.kind != "f":
            continue
        diff = np.abs(got - want)
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                   1e-30))) - 7)
        share = float((diff > 0).mean())
        print(f"{family}:{name} bf16 card vs CPU: {share:.4f} of "
              f"{want.size} elements differ, at most "
              f"{float((diff / step).max()):.2f} steps")
        assert np.all(diff <= step), (name, float((diff / step).max()))
        assert share <= 0.01, (name, share)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_resnet50_on_card_equals_cpu(dtype, dev):
    payload = TZ.build_resnet50(num_classes=1000, seed=0)[0]
    x = np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(
        np.float32)
    card, cpu = _both(payload, {"data": x}, dev, dtype=dtype)
    err = np.abs(card["logits"] - cpu["logits"]).max() / np.abs(
        cpu["logits"]).max()
    assert err <= (1e-4 if dtype is None else 2e-2), err
    if dtype is None:
        np.testing.assert_array_equal(card["logits"].argmax(1),
                                      cpu["logits"].argmax(1))


def test_float32_path_turns_tf32_off_and_restores_it(dev):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        payload, feeds, _ = FAMILIES["conv"](np.random.default_rng(7))
        card, cpu = _both(payload, feeds, dev)
        for k in card:
            check(k, card[k], cpu[k], 1e-5)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_device_input_passes_through_without_a_host_copy(dev):
    b = GraphBuilder("ident")
    b.output(b.node("Identity", [b.input("x", (None, 3))]))
    fn = T.compile_onnx(b.build(), device=dev)
    x = torch.randn(4, 3, device=dev)
    out = fn(x=x)[fn.output_names[0]]
    assert out.data_ptr() == x.data_ptr()
    payload = TZ.build_resnet50(num_classes=10, seed=0)[0]
    fn = T.compile_onnx(payload, device=dev)
    x = torch.randn(2, 3, 64, 64, device=dev)
    fn(data=x)
    fn(data=x)
    assert fn.plan(["data"]).uploads == 0


def test_onnx_model_and_featurizer_on_card_equal_cpu(dev):
    payload = TZ.build_resnet50(num_classes=10, seed=0)[0]
    g = T.load_graph(payload)
    feat = [n for n in g.nodes if n.op_type == "Gemm"][-1].inputs[0]
    rng = np.random.default_rng(2)
    imgs = [rng.uniform(0, 255, (40, 48, 3)).astype(np.float32)
            for _ in range(5)]
    cols = []
    for d in ("cuda", "cpu"):
        prep = (ImageTransformer(inputCol="img", outputCol="t", device=d)
                .resize(36, 36).center_crop(32, 32)
                .normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]))
        ds = prep.transform(Dataset({"img": imgs}))
        m = T.ONNXModel(payload, feedDict={"data": "t"},
                        fetchDict={"out": "logits"}, miniBatchSize=2,
                        argMaxDict={"out": "label"}, device=d)
        out = m.transform(ds)
        f = T.ImageFeaturizer(T.ONNXModel(payload), inputCol="t",
                              featureTensorName=feat, miniBatchSize=4,
                              device=d).transform(ds)
        cols.append((np.stack(list(ds["t"])), np.stack(list(out["out"])),
                     np.asarray(out["label"]),
                     np.stack(list(f["features"]))))
    (t1, o1, l1, f1), (t2, o2, l2, f2) = cols
    check("tensor", t1, t2, 1e-5)
    check("logits", o1, o2, 1e-4)
    check("features", f1, f2, 1e-4)
    np.testing.assert_array_equal(l1, l2)


def test_slic_on_card_equals_cpu(dev):
    img = np.random.default_rng(3).uniform(0, 255, (40, 48, 3)).astype(
        np.float32)
    card = slic_segments(img, 8.0, 40.0, device=dev)
    cpu = slic_segments(img, 8.0, 40.0, device="cpu")
    assert float((card == cpu).mean()) >= 0.999


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid")
    payload = TZ.build_resnet50(num_classes=10, seed=0)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.compile_onnx(payload, device="cuda")
