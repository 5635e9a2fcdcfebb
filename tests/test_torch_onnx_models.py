"""Whole ONNX graphs and the ONNX stages: the port against the JAX
package on the CPU.

The same model bytes (built from a seed by either package's zoo, which
write equal bytes) go through ``synapseml_tpu.models.onnx`` and
``synapseml_tpu_torch.models.onnx`` with ``device="cpu"``.  Tolerances:

- ResNet-50 (1,000 classes) on one 3x64x64 image: f32 within 1e-4 of the
  largest |logit|; bf16 within 2e-2 of it with the argmax equal (the
  reference's own bf16 bound, ``tests/test_onnx_resnet50.py``);
- a 2-layer, 32-wide BERT classifier with a padded mask: f32 within 1e-5,
  bf16 within 5e-2 (``test_onnx_resnet50.py``'s bound);
- the stages (``ONNXModel``, ``ImageFeaturizer`` behind an
  ``ImageTransformer``): 1e-5 of scale, argmax columns equal.

The JAX package's int64 values are int32 (64-bit mode off); the port
keeps int64, so integer columns are compared by value.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import synapseml_tpu.models.onnx as J
import synapseml_tpu_torch.models.onnx as T
from chip_smoke import random_bert_state_dict
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu.image import ImageTransformer as JImageTransformer
from synapseml_tpu.models.onnx import zoo as JZ
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.device import full_f32
from synapseml_tpu_torch.image import ImageTransformer
from synapseml_tpu_torch.models.onnx import GraphBuilder
from synapseml_tpu_torch.models.onnx import runner as TR
from synapseml_tpu_torch.models.onnx import zoo as TZ
from synapseml_tpu_torch.resilience import get_faults, rowguard
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

BERT = dict(vocab_size=120, d_model=32, num_layers=2, intermediate=64,
            num_labels=3, max_positions=64)


@pytest.fixture(scope="module")
def resnet():
    return TZ.build_resnet50(num_classes=1000, seed=0)[0]


@pytest.fixture(scope="module")
def bert():
    sd = random_bert_state_dict(0, **BERT)
    return sd, TZ.build_bert_classifier(sd, num_layers=2, num_heads=4,
                                        seq_len=10)


def _scale_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_zoo_bytes_equal_across_packages(resnet, bert):
    assert resnet == JZ.build_resnet50(num_classes=1000, seed=0)[0]
    sd, payload = bert
    assert payload == JZ.build_bert_classifier(sd, num_layers=2, num_heads=4,
                                               seq_len=10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_matches_reference(resnet, dtype):
    x = np.random.default_rng(1).normal(size=(1, 3, 64, 64)).astype(
        np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    want = np.asarray(J.compile_onnx(resnet, dtype=jd)(data=x)["logits"],
                      np.float32)
    fn = T.compile_onnx(resnet, dtype=None if jd is None else dtype,
                        device="cpu")
    got = fn(data=x)["logits"].float().numpy()
    assert got.shape == (1, 1000)
    if dtype == "float32":
        assert _scale_err(got, want) <= 1e-4
    else:
        assert _scale_err(got, want) <= 2e-2
        assert got.argmax() == want.argmax()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_classifier_matches_reference(bert, dtype):
    _, payload = bert
    rng = np.random.default_rng(2)
    ids = rng.integers(0, BERT["vocab_size"], (4, 10)).astype(np.int64)
    mask = np.ones((4, 10), np.float32)
    mask[1, 6:] = 0
    mask[3, 3:] = 0
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    want = np.asarray(J.compile_onnx(payload, dtype=jd)(
        input_ids=ids, attention_mask=mask)["logits"], np.float32)
    got = T.compile_onnx(payload, dtype=None if jd is None else dtype,
                         device="cpu")(input_ids=ids, attention_mask=mask)
    got = got["logits"].float().numpy()
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- the plan: constants folded once, no weight uploaded per call ------------

def _folding_graph():
    b = GraphBuilder("fold")
    x = b.input("x", (None, 4))
    w = b.initializer("w", np.arange(12, dtype=np.float32).reshape(4, 3))
    w2 = b.node("Mul", [w, b.initializer("two", np.float32(2.0))])
    shp = b.node("Shape", [x])
    y = b.node("MatMul", [x, w2])
    b.output(b.node("Reshape", [y, b.node("Concat", [
        b.node("Slice", [shp, b.initializer("s0", np.asarray([0])),
                         b.initializer("s1", np.asarray([1]))]),
        b.initializer("m1", np.asarray([-1]))], axis=0)]))
    return b.build(), w2


def test_plan_folds_constants_and_moves_no_weight():
    payload, w2 = _folding_graph()
    x = np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32)
    want = np.asarray(J.compile_onnx(payload)(x=x)[
        J.load_graph(payload).output_names[0]])
    for dtype in (None, "bfloat16"):
        fn = T.compile_onnx(payload, dtype=dtype, device="cpu")
        out = fn.output_names[0]
        first = fn(x=x)[out].float().numpy()
        plan = fn.plan(["x"])
        # Mul(w, 2) folds; Shape, Slice, Concat, MatMul, Reshape run
        assert (plan.n_folded, plan.n_per_call) == (1, 5)
        second = fn(x=x)[out].float().numpy()
        assert plan.uploads == 0
        np.testing.assert_array_equal(first, second)
        tol = 1e-6 if dtype is None else 2e-2
        assert _scale_err(second, want) <= tol
        # the reference's dtype rule: under bf16 the folded float value is
        # a device tensor, under f32 it stays numpy (static)
        folded = plan.const[w2]
        if dtype is None:
            assert isinstance(folded, np.ndarray)
        else:
            assert isinstance(folded, torch.Tensor)
            assert folded.dtype == torch.bfloat16


def test_device_input_passes_through():
    b = GraphBuilder("ident")
    b.output(b.node("Identity", [b.input("x", (None, 3))]))
    fn = T.compile_onnx(b.build(), device="cpu")
    x = torch.randn(4, 3)
    out = fn(x=x)[fn.output_names[0]]
    assert out.data_ptr() == x.data_ptr()


# -- OOM-adaptive calls ---------------------------------------------------------

@pytest.fixture
def faults():
    reg = get_faults()
    reg.clear()
    yield reg
    reg.clear()


def _mlp(rows_mixing: bool):
    rng = np.random.default_rng(4)
    b = GraphBuilder("mlp_mix" if rows_mixing else "mlp")
    x = b.input("x", (None, 6))
    h = b.node("Gemm", [x, b.initializer(
        "w", rng.normal(size=(6, 5)).astype(np.float32)), b.initializer(
        "b", rng.normal(size=5).astype(np.float32))])
    h = b.node("Softmax", [h], axis=0 if rows_mixing else 1)
    b.output(h)
    return b.build()


def test_oom_at_batch_8_halves_and_remembers(faults):
    fn = T.compile_onnx(_mlp(False), device="cpu")
    key = fn._oom_key
    rowguard.reset_safe_batch(key)
    x = np.random.default_rng(5).normal(size=(8, 6)).astype(np.float32)
    out = fn.output_names[0]
    whole = fn(x=x)[out]
    faults.inject("oom", "oom", when=lambda c: c["batch"] >= 8)
    try:
        chunked = fn(x=x)[out]
        assert rowguard.safe_batch_size(key, 8) == 4
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                                   rtol=1e-6, atol=1e-7)
        # the remembered size holds: the next call starts at 4, no OOM
        rule = faults.rules()[0]
        before = rule.fired
        np.testing.assert_allclose(fn(x=x)[out].numpy(), whole.numpy(),
                                   rtol=1e-6, atol=1e-7)
        assert rule.fired == before
    finally:
        rowguard.reset_safe_batch(key)


def test_row_mixing_graph_reraises(faults):
    """Softmax over axis 0 mixes rows: the call dispatches whole, and its
    OOM surfaces at once (one firing, no halving)."""
    fn = T.compile_onnx(_mlp(True), device="cpu")
    rule = faults.inject("oom", "oom")
    x = np.ones((8, 6), np.float32)
    with pytest.raises(Exception) as e:
        fn(x=x)
    assert rowguard.is_oom_error(e.value)
    assert rule.fired == 1
    assert rowguard.safe_batch_size(fn._oom_key, 8) == 8


def test_cuda_oom_text_is_an_oom_marker():
    """PyTorch's card allocator fails with torch.cuda.OutOfMemoryError,
    whose text carries the existing "out of memory" marker."""
    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")
    assert rowguard.is_oom_error(err)
    assert not rowguard.is_oom_error(RuntimeError("shape mismatch"))


# -- the stages -----------------------------------------------------------------

def _cnn():
    rng = np.random.default_rng(6)
    b = GraphBuilder("cnn")
    x = b.input("image", (None, 3, 16, 16))
    h = b.node("Conv", [x, b.initializer(
        "w1", (rng.normal(size=(8, 3, 3, 3)) * 0.3).astype(np.float32)),
        b.initializer("b1", rng.normal(size=8).astype(np.float32))],
        kernel_shape=[3, 3], pads=[1, 1, 1, 1])
    h = b.node("Relu", [h])
    h = b.node("MaxPool", [h], kernel_shape=[2, 2], strides=[2, 2])
    h = b.node("GlobalAveragePool", [h], outputs=["gap"])
    h = b.node("Flatten", [h], axis=1, outputs=["feat"])
    b.node("Gemm", [h, b.initializer(
        "wf", rng.normal(size=(5, 8)).astype(np.float32)), b.initializer(
        "bf", rng.normal(size=5).astype(np.float32))], transB=1,
        outputs=["logits"])
    b.output("logits")
    return b.build()


def _stack(col):
    return np.stack([np.asarray(v, np.float64) for v in col])


def test_onnx_model_with_padding_and_post_ops():
    payload = _cnn()
    imgs = np.random.default_rng(7).normal(size=(5, 3, 16, 16)).astype(
        np.float32)
    kw = dict(feedDict={"image": "img"}, fetchDict={"out": "logits"},
              miniBatchSize=2, softMaxDict={"out": "prob"},
              argMaxDict={"out": "label"})
    want = J.ONNXModel(payload, **kw).transform(JDataset({"img": list(imgs)}))
    got = T.ONNXModel(payload, device="cpu", **kw).transform(
        Dataset({"img": list(imgs)}))
    for col in ("out", "prob"):
        assert got[col].dtype == object
        w = _stack(want[col])
        assert _scale_err(_stack(got[col]), w) <= 1e-5
    np.testing.assert_array_equal(np.asarray(got["label"], np.int64),
                                  np.asarray(want["label"], np.int64))
    assert T.ONNXModel(payload).model_inputs() == ["image"]


def test_image_featurizer_headless_behind_image_transformer():
    """ImageTransformer (resize, center crop, normalize) then the headless
    ImageFeaturizer, and slice_at_output on its own, against the JAX
    package's stages on the same images."""
    payload = _cnn()
    rng = np.random.default_rng(8)
    imgs = [rng.uniform(0, 255, (20, 23, 3)).astype(np.float32)
            for _ in range(3)]
    stats = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    outs = []
    for pkg, IT, DS, M in ((J, JImageTransformer, JDataset, J.ONNXModel),
                           (T, ImageTransformer, Dataset, T.ONNXModel)):
        extra = {} if pkg is J else {"device": "cpu"}
        prep = (IT(inputCol="img", outputCol="t", **extra).resize(18, 18)
                .center_crop(16, 16).normalize(*stats))
        ds = prep.transform(DS({"img": imgs}))
        feat = pkg.ImageFeaturizer(M(payload, **extra), inputCol="t",
                                   featureTensorName="feat", miniBatchSize=2,
                                   **extra).transform(ds)
        sliced = M(payload, **extra).slice_at_output("gap")
        assert sliced.model_outputs() == ["gap"]
        gap = sliced.set_feed_dict({"image": "t"}).transform(ds)
        outs.append((_stack(ds["t"]), _stack(feat["features"]),
                     _stack(gap["gap"])))
    (jt, jf, jg), (tt, tf, tg) = outs
    assert tt.shape == (3, 3, 16, 16) and tf.shape == (3, 8)
    assert _scale_err(tt, jt) <= 1e-5
    assert _scale_err(tf, jf) <= 1e-5
    assert _scale_err(tg, jg) <= 1e-5
    np.testing.assert_allclose(tg.reshape(3, 8), tf, rtol=0, atol=0)


def test_full_f32_blocks_on_two_threads_share_one_setting():
    """Blocks that overlap on two threads: the first to leave keeps TF32
    off for the other, the last restores the caller's flags."""
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, cudnn.allow_tf32)
    m.allow_tf32 = cudnn.allow_tf32 = True
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def a():
        with full_f32():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with full_f32():
            b_in.set()
            a_out.wait(10)
            seen["after_a_left"] = (m.allow_tf32, cudnn.allow_tf32)

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(20)
        assert a_out.is_set() and seen["after_a_left"] == (False, False)
        assert (m.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        m.allow_tf32, cudnn.allow_tf32 = saved


def test_entry_points_need_a_card_by_default(resnet):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.compile_onnx(resnet)
    ds = Dataset({"image": [np.zeros((3, 8, 8), np.float32)]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ONNXModel(resnet, feedDict={"data": "image"}).transform(ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ImageFeaturizer(T.ONNXModel(resnet), inputCol="image",
                          featureTensorName="logits").transform(ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageTransformer(inputCol="image").flip().transform(ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.evaluate(T.load_graph(resnet), {"data": np.zeros((1, 3, 8, 8))})
