"""Local ONNX model zoo: construct standard architectures as ONNX graphs.

The reference downloads zoo models through ONNXHub (reference:
deep-learning/.../onnx/ONNXHub.scala:181-255 — manifest, SHA check, cached
bytes) and benchmarks ResNet-50 batch inference through ONNXModel
(ONNXModel.scala:242-251, ImageFeaturizer.scala:34-270).  In a zero-egress
environment the zoo is CONSTRUCTED instead of fetched: this module emits
real, full-size ONNX graphs for well-known architectures via
:class:`~synapseml_tpu_torch.models.onnx.graph.GraphBuilder`, with weights
supplied or randomly initialized.  Weight names follow torchvision's
state-dict convention, so the same dict can drive a torch reference
implementation (how the tests verify numerical correctness) or be filled
from a real torchvision checkpoint via
``models.dl.checkpoints.read_checkpoint``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .graph import GraphBuilder

#: bottleneck block counts per stage
RESNET50_STAGES = (3, 4, 6, 3)


def build_bert_classifier(state_dict: Dict[str, np.ndarray],
                          num_layers: int, num_heads: int,
                          seq_len: int = 16,
                          input_ids_name: str = "input_ids",
                          mask_name: str = "attention_mask",
                          output_name: str = "logits") -> bytes:
    """A BertForSequenceClassification forward pass as an ONNX graph, built
    from an HF-format state dict (the same tensor names
    ``models.dl.checkpoints.import_bert`` consumes) — the transformer
    counterpart of :func:`build_resnet50` for proving the ONNX path on
    attention/LayerNorm/Gelu graphs.  Fixed ``seq_len``; single-segment
    inputs (token-type row 0 folds into the additive embedding)."""
    def g(key):
        for prefix in ("bert.", ""):
            if prefix + key in state_dict:
                return np.asarray(state_dict[prefix + key], np.float32)
        raise KeyError(key)

    d_model = g("embeddings.word_embeddings.weight").shape[1]
    d_head = d_model // num_heads
    b = GraphBuilder("bert_classifier", opset=17)
    ids = b.input(input_ids_name, (None, seq_len), dtype=np.int64)
    mask = b.input(mask_name, (None, seq_len), dtype=np.float32)

    def init(name, value):
        return b.initializer(name.replace(".", "_"), value)

    def linear(x, key, out_name_hint):
        w = init(key + ".w", g(key + ".weight").T)
        bias = init(key + ".b", g(key + ".bias"))
        return b.node("Add", [b.node("MatMul", [x, w]), bias])

    def layer_norm(x, key):
        return b.node("LayerNormalization",
                      [x, init(key + ".g", g(key + ".weight")),
                       init(key + ".beta", g(key + ".bias"))],
                      axis=-1, epsilon=1e-12)

    # embeddings: gather words; positions + segment-0 are additive constants
    tok = b.node("Gather", [init("tok", g("embeddings.word_embeddings.weight")),
                            ids], axis=0)
    pos_const = (g("embeddings.position_embeddings.weight")[:seq_len]
                 + g("embeddings.token_type_embeddings.weight")[0:1])
    x = b.node("Add", [tok, init("pos", pos_const[None, :, :])])
    x = layer_norm(x, "embeddings.LayerNorm")

    # additive attention mask (B, 1, 1, S): (1 - mask) * -1e9
    one = init("one", np.float32(1.0))
    m4 = b.node("Unsqueeze", [mask, init("axes11", np.array([1, 2], np.int64))])
    neg = b.node("Mul", [b.node("Sub", [one, m4]),
                         init("negbig", np.float32(-1e9))])

    perm_heads = [0, 2, 1, 3]
    shape_split = init("shape_split",
                       np.array([0, seq_len, num_heads, d_head], np.int64))
    shape_merge = init("shape_merge", np.array([0, seq_len, d_model], np.int64))
    # erf-expanded gelu constants: standard ONNX only defines the Gelu op
    # from opset 20, so this opset-17 graph spells 0.5*x*(1+erf(x/sqrt(2)))
    # in primitives and stays valid for external runtimes
    half = init("gelu_half", np.float32(0.5))
    sqrt2 = init("gelu_sqrt2", np.float32(np.sqrt(2.0)))
    for i in range(num_layers):
        p = f"encoder.layer.{i}."

        def heads(name):
            h = linear(x, p + "attention.self." + name, name)
            h = b.node("Reshape", [h, shape_split])
            return b.node("Transpose", [h], perm=perm_heads)  # (B,H,S,dh)

        q, k, v = heads("query"), heads("key"), heads("value")
        kt = b.node("Transpose", [k], perm=[0, 1, 3, 2])
        scores = b.node("Div", [b.node("MatMul", [q, kt]),
                                init(f"scale{i}", np.float32(np.sqrt(d_head)))])
        scores = b.node("Add", [scores, neg])
        probs = b.node("Softmax", [scores], axis=-1)
        ctx = b.node("MatMul", [probs, v])
        ctx = b.node("Transpose", [ctx], perm=perm_heads)
        ctx = b.node("Reshape", [ctx, shape_merge])
        att = linear(ctx, p + "attention.output.dense", "attout")
        x = layer_norm(b.node("Add", [att, x]),
                       p + "attention.output.LayerNorm")
        ff = linear(x, p + "intermediate.dense", "ffup")
        h = b.node("Mul", [
            b.node("Mul", [ff, half]),
            b.node("Add", [one,
                           b.node("Erf", [b.node("Div", [ff, sqrt2])])])])
        h = linear(h, p + "output.dense", "ffdown")
        x = layer_norm(b.node("Add", [h, x]), p + "output.LayerNorm")

    cls = b.node("Gather", [x, init("zero", np.array(0, np.int64))], axis=1)
    pooled = b.node("Tanh", [linear(cls, "pooler.dense", "pool")])
    wcls = init("cls.w", np.asarray(state_dict["classifier.weight"],
                                    np.float32).T)
    bcls = init("cls.b", np.asarray(state_dict["classifier.bias"], np.float32))
    b.node("Add", [b.node("MatMul", [pooled, wcls]), bcls],
           outputs=[output_name])
    b.output(output_name)
    return b.build()


def _rand_weights_resnet50(num_classes: int, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    w: Dict[str, np.ndarray] = {}

    def conv(name, cout, cin, k):
        fan_in = cin * k * k
        w[name + ".weight"] = (rng.normal(size=(cout, cin, k, k))
                               * np.sqrt(2.0 / fan_in)).astype(np.float32)

    def bn(name, c):
        w[name + ".weight"] = np.ones(c, np.float32)
        w[name + ".bias"] = np.zeros(c, np.float32)
        w[name + ".running_mean"] = (rng.normal(size=c) * 0.01).astype(np.float32)
        w[name + ".running_var"] = np.ones(c, np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, blocks in enumerate(RESNET50_STAGES):
        width = 64 * 2 ** s
        for j in range(blocks):
            p = f"layer{s + 1}.{j}"
            conv(f"{p}.conv1", width, cin, 1)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3)
            bn(f"{p}.bn2", width)
            conv(f"{p}.conv3", width * 4, width, 1)
            bn(f"{p}.bn3", width * 4)
            if j == 0:
                conv(f"{p}.downsample.0", width * 4, cin, 1)
                bn(f"{p}.downsample.1", width * 4)
            cin = width * 4
    w["fc.weight"] = (rng.normal(size=(num_classes, cin)) * 0.01).astype(np.float32)
    w["fc.bias"] = np.zeros(num_classes, np.float32)
    return w


def build_resnet50(num_classes: int = 1000, seed: int = 0,
                   weights: Optional[Dict[str, np.ndarray]] = None,
                   input_name: str = "data", output_name: str = "logits",
                   ) -> Tuple[bytes, Dict[str, np.ndarray]]:
    """ResNet-50 v1 (bottleneck [3,4,6,3]) as ONNX model bytes.

    Input ``data``: (N, 3, H, W) float32 NCHW; output ``logits``:
    (N, num_classes).  Returns ``(model_bytes, weights)`` — feed the weights
    to a torch reference with ``load_state_dict`` for parity checks.
    """
    w = weights if weights is not None else _rand_weights_resnet50(num_classes, seed)
    b = GraphBuilder("resnet50", opset=17)
    x = b.input(input_name, (None, 3, None, None))

    def init(name):
        return b.initializer(name.replace(".", "_"), w[name])

    def conv(x, name, k, stride=1):
        pad = (k - 1) // 2
        return b.node("Conv", [x, init(name + ".weight")],
                      kernel_shape=[k, k], strides=[stride, stride],
                      pads=[pad, pad, pad, pad])

    def bn(x, name):
        return b.node("BatchNormalization",
                      [x, init(name + ".weight"), init(name + ".bias"),
                       init(name + ".running_mean"),
                       init(name + ".running_var")], epsilon=1e-5)

    y = conv(x, "conv1", 7, 2)
    y = bn(y, "bn1")
    y = b.node("Relu", [y])
    y = b.node("MaxPool", [y], kernel_shape=[3, 3], strides=[2, 2],
               pads=[1, 1, 1, 1])

    for s, blocks in enumerate(RESNET50_STAGES):
        for j in range(blocks):
            p = f"layer{s + 1}.{j}"
            stride = 2 if (s > 0 and j == 0) else 1
            h = conv(y, f"{p}.conv1", 1)
            h = b.node("Relu", [bn(h, f"{p}.bn1")])
            h = conv(h, f"{p}.conv2", 3, stride)
            h = b.node("Relu", [bn(h, f"{p}.bn2")])
            h = bn(conv(h, f"{p}.conv3", 1), f"{p}.bn3")
            if j == 0:
                shortcut = bn(conv(y, f"{p}.downsample.0", 1, stride),
                              f"{p}.downsample.1")
            else:
                shortcut = y
            y = b.node("Relu", [b.node("Add", [h, shortcut])])

    y = b.node("GlobalAveragePool", [y])
    y = b.node("Flatten", [y], axis=1)
    y = b.node("Gemm", [y, init("fc.weight"), init("fc.bias")],
               transB=1, outputs=[output_name])
    b.output(output_name)
    return b.build(), w
