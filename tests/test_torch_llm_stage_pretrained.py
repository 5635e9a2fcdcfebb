"""The port's ``LLMTransformer`` and ``llama_from_pretrained`` held against
the JAX package's on the CPU (mirroring ``tests/test_llm.py``'s stage
tests and ``tests/test_checkpoint_import.py``'s pretrained test).

``LLMTransformer.transform`` gives the reference's completion strings on
carried weights (``LlamaConfig.tiny(num_layers=2, max_len=32)``, f32), with
and without a ``promptTemplate``, and refuses a ``maxNewTokens`` that
leaves no room for the prompt; a stage the reference saved loads as the
port's.  ``llama_from_pretrained`` reads an HF-layout directory that the
test writes itself (``config.json`` and a ``model.safetensors`` from a
small writer, random weights from a seed): tied and untied, its logits are
within 1e-5 of the reference's ``llama_from_pretrained`` on the same
directory, and a missing ``config.json`` raises.
"""

import json
import struct

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu import Dataset as JDataset
from synapseml_tpu.models import llm as J
from synapseml_tpu.models.dl.tokenizer import WordTokenizer as JTok
from synapseml_tpu_torch.core import Dataset as PDataset
from synapseml_tpu_torch.core import load_stage
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.models.dl.tokenizer import WordTokenizer as PTok
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

_WORDS = [f"w{i}" for i in range(400)]


@pytest.fixture(scope="module")
def pair():
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=32, dtype=jnp.float32)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=32, dtype=torch.float32)
    jm = J.LlamaModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((2, 8), jnp.int32))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu"))
    corpus = [" ".join(_WORDS[i:i + 20]) for i in range(0, 400, 20)]
    return (jm, variables, JTok.fit(corpus, vocab_size=512), tm,
            PTok.fit(corpus, vocab_size=512))


def _rows():
    rng = np.random.default_rng(4)
    prompts = [" ".join(rng.choice(_WORDS, n)) for n in (3, 5, 3, 5, 0)]
    return {"prompt": prompts, "topic": ["w7", "w9", "w11", "w13", "w15"]}


@pytest.mark.parametrize("template", [None, "say {topic} not {missing} "
                                      "{{lit}} {prompt}"],
                         ids=["plain", "template"])
def test_transformer_completions_equal_reference(pair, template):
    jm, variables, jtok, tm, ptok = pair
    kw = dict(inputCol="prompt", maxNewTokens=6)
    if template:
        kw["promptTemplate"] = template
    ref = J.LLMTransformer(bundle={"model": jm, "variables": variables,
                                   "tokenizer": jtok}, **kw).transform(
        JDataset(_rows()))
    got = P.LLMTransformer(bundle={"model": tm, "tokenizer": ptok},
                           **kw).transform(PDataset(_rows()))
    assert list(got["completion"]) == list(ref["completion"])
    assert any(c for c in got["completion"])        # words came out


def test_transformer_refuses_a_full_context_and_loads_reference(pair,
                                                                tmp_path):
    jm, variables, jtok, tm, ptok = pair
    with pytest.raises(ValueError, match="maxNewTokens"):
        P.LLMTransformer(bundle={"model": tm, "tokenizer": ptok},
                         maxNewTokens=tm.cfg.max_len).transform(
            PDataset(_rows()))
    # a stage the JAX package saved (no bundle) loads as the port's class
    J.LLMTransformer(inputCol="q", maxNewTokens=3,
                     promptTemplate="{q}!").save(str(tmp_path / "stage"))
    st = load_stage(str(tmp_path / "stage"))
    assert type(st) is P.LLMTransformer
    assert (st.get("inputCol"), st.get("maxNewTokens"),
            st.get("promptTemplate")) == ("q", 3, "{q}!")


def _write_safetensors(path, tensors):
    """A minimal safetensors writer: an 8-byte little-endian header
    length, the JSON header, then each tensor's little-endian f32 bytes."""
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        b = np.ascontiguousarray(arr, "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def _hf_dir(root, tie, seed=2):
    """config.json + model.safetensors in HF LlamaForCausalLM naming."""
    V, D, F, L, H, KV = 64, 32, 48, 2, 4, 2
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)
    sd = {"model.embed_tokens.weight": w(V, D),
          "model.norm.weight": 1 + w(D)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + w(D)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(D)
        for n, shape in (("q_proj", (D, D)), ("k_proj", (D // 2, D)),
                         ("v_proj", (D // 2, D)), ("o_proj", (D, D))):
            sd[p + f"self_attn.{n}.weight"] = w(*shape)
        sd[p + "mlp.gate_proj.weight"] = w(F, D)
        sd[p + "mlp.up_proj.weight"] = w(F, D)
        sd[p + "mlp.down_proj.weight"] = w(D, F)
    if not tie:
        sd["lm_head.weight"] = w(V, D)
    root.mkdir()
    _write_safetensors(str(root / "model.safetensors"), sd)
    cfg = {"vocab_size": V, "hidden_size": D, "intermediate_size": F,
           "num_hidden_layers": L, "num_attention_heads": H,
           "num_key_value_heads": KV, "max_position_embeddings": 32,
           "rms_norm_eps": 1e-6, "tie_word_embeddings": tie,
           "rope_scaling": {"rope_type": "llama3", "factor": 32.0}}
    (root / "config.json").write_text(json.dumps(cfg))
    return str(root)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_llama_from_pretrained_equals_reference(tmp_path, tie):
    path = _hf_dir(tmp_path / "llama", tie)
    jm, jv = J.llama_from_pretrained(path, dtype=jnp.float32, max_len=24)
    tm = P.llama_from_pretrained(path, dtype=torch.float32, max_len=24,
                                 device="cpu")
    assert tm.cfg.max_len == jm.cfg.max_len == 24
    assert tm.cfg.rope_theta == jm.cfg.rope_theta == 10_000.0
    assert tm.cfg.rms_norm_eps == 1e-6 and tm.cfg.tie_embeddings == tie
    assert tm.cfg.num_kv_heads == 2 and tm.device == torch.device("cpu")
    ids = np.random.default_rng(5).integers(0, 64, (2, 10)).astype(np.int32)
    ref = np.asarray(jax.jit(jm.apply)(jv, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # the weights are the file's: the same state as a carried JAX tree
    sd = P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(jv)), tm.cfg, "cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_llama_from_pretrained_without_config_raises(tmp_path):
    path = _hf_dir(tmp_path / "llama", True)
    (tmp_path / "llama" / "config.json").unlink()
    with pytest.raises(ValueError, match="config.json"):
        P.llama_from_pretrained(path, device="cpu")
    # an explicit config reads the bare weights file
    cfg = P.LlamaConfig(vocab_size=64, d_model=32, num_layers=2,
                        num_heads=4, num_kv_heads=2, d_ff=48, max_len=16,
                        tie_embeddings=True, dtype=torch.float32)
    m = P.llama_from_pretrained(path + "/model.safetensors", config=cfg,
                                device="cpu")
    assert m.cfg is cfg
