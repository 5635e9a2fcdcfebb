"""Pretrained-weight import: HF/torchvision checkpoints → the port's state
dicts.

The PyTorch port of the JAX package's ``models/dl/checkpoints.py``: read a
checkpoint (safetensors, a torch pickle, a sharded ``*.index.json`` or an
HF model directory), translate tensor names and layouts through a
per-family mapping table, and splice the arrays into a model's state dict.

- ``import_bert`` → :class:`~.transformer.TextEncoder` (HF
  BertForSequenceClassification naming; the segment-0 token-type
  embedding is folded into every position, exact for single-segment
  inputs);
- ``import_llama`` → :class:`~synapseml_tpu_torch.models.llm.model
  .LlamaModel` (HF LlamaForCausalLM naming; HF stores q/k arranged for
  the rotate-half RoPE that ``apply_rope`` implements, so the weights
  copy as they are);
- ``import_resnet`` → :class:`~.resnet.ResNet` (torchvision naming; conv
  OIHW → HWIO, BatchNorm running statistics into the batch-statistic
  buffers).

Torch ``Linear.weight`` is (out, in) and the port's ``Dense.kernel`` is
(in, out), so every dense mapping transposes.  The safetensors reader
parses the format itself (an 8-byte little-endian header length, a JSON
header, then raw little-endian bytes; BF16 widens to f32), so no
``safetensors`` package is needed, and ``flax_model.msgpack`` files go
through the port's own decoder (:mod:`synapseml_tpu_torch.io.msgpack`),
so neither ``flax`` nor ``msgpack`` is.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ...io.msgpack import BF16Bits, restore, widen_bf16

__all__ = ["read_checkpoint", "read_msgpack", "import_bert",
           "import_llama", "import_resnet", "load_into_params"]

#: safetensors dtype codes → numpy dtypes (BF16 is widened separately)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


# --------------------------------------------------------------------------
# readers
# --------------------------------------------------------------------------

def _to_numpy(t) -> np.ndarray:
    """torch tensor / numpy → numpy, bf16 widened to f32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as numpy (BF16 → f32)."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(n)))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        shape = tuple(info["shape"])
        dt = info["dtype"]
        if dt == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif dt in _ST_DTYPES:
            arr = np.frombuffer(raw, dtype=np.dtype(_ST_DTYPES[dt])
                                .newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"safetensors dtype {dt!r}")
        out[name] = arr.reshape(shape).copy()
    return out


def _leaf_to_numpy(x) -> np.ndarray:
    """A decoded msgpack leaf → numpy as the reference's ``_to_numpy``
    gives it (bf16 widened to f32; lists and scalars through
    ``np.asarray``)."""
    if isinstance(x, BF16Bits):
        return widen_bf16(x)
    if isinstance(x, list):
        return np.asarray([_leaf_to_numpy(v) if isinstance(v, (BF16Bits,
                                                               list))
                           else v for v in x])
    return np.asarray(x)


def read_msgpack(path: str) -> Dict[str, np.ndarray]:
    """Every leaf of a flax ``msgpack`` checkpoint (``flax.serialization``'s
    format, chunked leaves rejoined) under its ``"."``-joined tree path."""
    with open(path, "rb") as f:
        tree = restore(f.read())
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            flat[prefix] = _leaf_to_numpy(node)

    walk("", tree)
    return flat


def _read_torch(path: str) -> Dict[str, np.ndarray]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: _to_numpy(v) for k, v in state.items()}


def read_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Flat {name: array} from a checkpoint file or HF-style model dir
    (handles sharded ``*.index.json`` checkpoints)."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin",
                     "flax_model.msgpack"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                return read_checkpoint(p)
        for idx_name in ("model.safetensors.index.json",
                         "pytorch_model.bin.index.json"):
            idx = os.path.join(path, idx_name)
            if os.path.exists(idx):
                with open(idx) as f:
                    weight_map = json.load(f)["weight_map"]
                out: Dict[str, np.ndarray] = {}
                for shard in sorted(set(weight_map.values())):
                    out.update(read_checkpoint(os.path.join(path, shard)))
                return out
        raise FileNotFoundError(
            f"{path}: no model.safetensors / pytorch_model.bin / "
            "flax_model.msgpack (or sharded index) found")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith(".msgpack"):
        return read_msgpack(path)
    return _read_torch(path)


# --------------------------------------------------------------------------
# splicing into state dicts
# --------------------------------------------------------------------------

def load_into_params(target: Mapping[str, torch.Tensor],
                     imported: Dict[Tuple[str, ...], np.ndarray],
                     strict: bool = True) -> Dict[str, torch.Tensor]:
    """A copy of the state dict ``target`` with the leaves addressed by
    ``imported``'s path tuples replaced (each cast to the leaf's dtype and
    put on its device)."""
    unused = {".".join(k): v for k, v in imported.items()}
    out: Dict[str, torch.Tensor] = {}
    for key, ref in target.items():
        if key in unused:
            val = unused.pop(key)
            if tuple(ref.shape) != tuple(val.shape):
                raise ValueError(
                    f"shape mismatch at {key}: checkpoint {val.shape} vs "
                    f"model {tuple(ref.shape)}")
            if not val.flags.c_contiguous and val.T.flags.c_contiguous:
                # a transposed view (the (out, in) → (in, out) kernels):
                # moved as stored and transposed on the leaf's device
                out[key] = torch.from_numpy(val.T).to(
                    device=ref.device, dtype=ref.dtype).T.contiguous()
            else:
                out[key] = torch.from_numpy(np.ascontiguousarray(val)).to(
                    device=ref.device, dtype=ref.dtype)
        else:
            if strict:
                raise ValueError(f"checkpoint missing tensor for {key}")
            out[key] = ref
    if unused and strict:
        raise ValueError("unmapped checkpoint tensors: "
                         + ", ".join(list(unused)[:8]))
    return out


# --------------------------------------------------------------------------
# BERT (HF BertForSequenceClassification → TextEncoder)
# --------------------------------------------------------------------------

def _bert_mapping(hf: Dict[str, np.ndarray], num_layers: int,
                  with_head: bool) -> Dict[Tuple[str, ...], np.ndarray]:
    def g(key):
        for prefix in ("bert.", ""):
            if prefix + key in hf:
                return hf[prefix + key]
        raise KeyError(key)

    m: Dict[Tuple[str, ...], np.ndarray] = {}
    tok = g("embeddings.word_embeddings.weight")
    pos = g("embeddings.position_embeddings.weight").copy()
    # fold segment-0 token-type embedding into every position (exact for
    # single-segment inputs — the reference classifier path)
    try:
        pos = pos + g("embeddings.token_type_embeddings.weight")[0:1]
    except KeyError:
        pass
    m[("tok_embed", "embedding")] = tok
    m[("pos_embed", "embedding")] = pos
    m[("ln_embed", "scale")] = g("embeddings.LayerNorm.weight")
    m[("ln_embed", "bias")] = g("embeddings.LayerNorm.bias")
    for i in range(num_layers):
        hfp = f"encoder.layer.{i}."
        our = f"layer_{i}"
        for hf_name, our_name in (("attention.self.query", "query"),
                                  ("attention.self.key", "key"),
                                  ("attention.self.value", "value"),
                                  ("attention.output.dense", "out")):
            m[(our, "attention", our_name, "kernel")] = \
                g(hfp + hf_name + ".weight").T
            m[(our, "attention", our_name, "bias")] = g(hfp + hf_name + ".bias")
        m[(our, "ln_att", "scale")] = g(hfp + "attention.output.LayerNorm.weight")
        m[(our, "ln_att", "bias")] = g(hfp + "attention.output.LayerNorm.bias")
        m[(our, "ffn_up", "kernel")] = g(hfp + "intermediate.dense.weight").T
        m[(our, "ffn_up", "bias")] = g(hfp + "intermediate.dense.bias")
        m[(our, "ffn_down", "kernel")] = g(hfp + "output.dense.weight").T
        m[(our, "ffn_down", "bias")] = g(hfp + "output.dense.bias")
        m[(our, "ln_ffn", "scale")] = g(hfp + "output.LayerNorm.weight")
        m[(our, "ln_ffn", "bias")] = g(hfp + "output.LayerNorm.bias")
    m[("pooler", "kernel")] = g("pooler.dense.weight").T
    m[("pooler", "bias")] = g("pooler.dense.bias")
    if with_head:
        m[("classifier", "kernel")] = hf["classifier.weight"].T
        m[("classifier", "bias")] = hf["classifier.bias"]
    return m


def import_bert(params: Mapping[str, torch.Tensor], checkpoint,
                num_layers: int, load_head: Optional[bool] = None
                ) -> Dict[str, torch.Tensor]:
    """Splice an HF BERT checkpoint (path or flat dict) into a
    ``TextEncoder`` state dict.  ``load_head=None`` loads the classifier
    head only when its shape matches (fine-tuning a new task keeps the
    fresh head, as ``from_pretrained`` re-initializes it)."""
    hf = read_checkpoint(checkpoint) if isinstance(checkpoint, str) else checkpoint
    if load_head is None:
        ref = params.get("classifier.kernel")
        load_head = ("classifier.weight" in hf and ref is not None
                     and hf["classifier.weight"].T.shape == tuple(ref.shape))
    mapped = _bert_mapping(hf, num_layers, with_head=load_head)
    return load_into_params(params, mapped, strict=False)


# --------------------------------------------------------------------------
# Llama (HF LlamaForCausalLM → LlamaModel)
# --------------------------------------------------------------------------

def _llama_mapping(hf: Dict[str, np.ndarray], num_layers: int,
                   tie_embeddings: bool) -> Dict[Tuple[str, ...], np.ndarray]:
    def g(key):
        for prefix in ("model.", ""):
            if prefix + key in hf:
                return hf[prefix + key]
        raise KeyError(key)

    m: Dict[Tuple[str, ...], np.ndarray] = {}
    m[("tok_embed", "embedding")] = g("embed_tokens.weight")
    for i in range(num_layers):
        hfp = f"layers.{i}."
        our = ("layers", str(i))
        m[our + ("ln_attn", "scale")] = g(hfp + "input_layernorm.weight")
        m[our + ("ln_mlp", "scale")] = g(hfp
                                         + "post_attention_layernorm.weight")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            m[our + ("attn", proj, "kernel")] = \
                g(hfp + f"self_attn.{proj}.weight").T
        for proj in ("gate_proj", "up_proj", "down_proj"):
            m[our + (proj, "kernel")] = g(hfp + f"mlp.{proj}.weight").T
    m[("ln_final", "scale")] = g("norm.weight")
    if not tie_embeddings:
        if "lm_head.weight" in hf:
            m[("lm_head", "kernel")] = hf["lm_head.weight"].T
        else:                      # tied checkpoint into an untied model
            m[("lm_head", "kernel")] = g("embed_tokens.weight").T
    return m


def import_llama(params: Mapping[str, torch.Tensor], checkpoint,
                 num_layers: int, tie_embeddings: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Splice an HF Llama checkpoint (path or flat dict) into a
    ``LlamaModel`` state dict."""
    hf = read_checkpoint(checkpoint) if isinstance(checkpoint, str) else checkpoint
    mapped = _llama_mapping(hf, num_layers, tie_embeddings)
    return load_into_params(params, mapped, strict=False)


# --------------------------------------------------------------------------
# ResNet (torchvision naming → ResNet)
# --------------------------------------------------------------------------

def _resnet_mapping(tv: Dict[str, np.ndarray], stage_sizes,
                    bottleneck: bool, load_head: bool
                    ) -> Dict[Tuple[str, ...], np.ndarray]:
    """torchvision resnet state_dict → the port's paths (parameters and
    batch statistics share one state dict)."""
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    block_name = ("BottleneckResNetBlock" if bottleneck else "ResNetBlock")

    def conv(dst: Tuple[str, ...], key: str):
        out[dst + ("kernel",)] = tv[key].transpose(2, 3, 1, 0)  # OIHW→HWIO

    def bn(dst_parent: Tuple[str, ...], bn_name: str, key: str):
        out[dst_parent + (bn_name, "scale")] = tv[key + ".weight"]
        out[dst_parent + (bn_name, "bias")] = tv[key + ".bias"]
        out[dst_parent + (bn_name, "mean")] = tv[key + ".running_mean"]
        out[dst_parent + (bn_name, "var")] = tv[key + ".running_var"]

    conv(("conv_init",), "conv1.weight")
    bn((), "bn_init", "bn1")
    n_convs = 3 if bottleneck else 2
    idx = 0
    for s, size in enumerate(stage_sizes):
        for j in range(size):
            blk = (f"{block_name}_{idx}",)
            tvp = f"layer{s + 1}.{j}"
            for c in range(n_convs):
                conv(blk + (f"Conv_{c}",), f"{tvp}.conv{c + 1}.weight")
                bn(blk, f"BatchNorm_{c}", f"{tvp}.bn{c + 1}")
            if f"{tvp}.downsample.0.weight" in tv:
                conv(blk + ("conv_proj",), f"{tvp}.downsample.0.weight")
                bn(blk, "norm_proj", f"{tvp}.downsample.1")
            idx += 1
    if load_head:
        out[("head", "kernel")] = tv["fc.weight"].T
        out[("head", "bias")] = tv["fc.bias"]
    return out


def import_resnet(variables: Mapping[str, torch.Tensor], checkpoint,
                  stage_sizes, bottleneck: bool,
                  load_head: Optional[bool] = None
                  ) -> Dict[str, torch.Tensor]:
    """Splice a torchvision-format resnet checkpoint into a ``ResNet``
    state dict (parameters and batch statistics)."""
    tv = read_checkpoint(checkpoint) if isinstance(checkpoint, str) else checkpoint
    tv = {re.sub(r"^(module|model)\.", "", k): v for k, v in tv.items()}
    if load_head is None:
        ref = variables.get("head.kernel")
        load_head = (ref is not None and "fc.weight" in tv
                     and tv["fc.weight"].T.shape == tuple(ref.shape))
    mapped = _resnet_mapping(tv, stage_sizes, bottleneck, load_head)
    return load_into_params(variables, mapped, strict=False)
