"""The port's weight-only int8 path (``quantize_int8``, ``QuantDense``,
``QuantEmbed``, ``weight_quant="int8"``) held against the JAX package's on
the CPU.

``quantize_int8`` gives the reference's int8 arrays and f32 scales bit for
bit, tied and untied, and a JAX int8 tree loads through
``params_from_reference`` into the same state dict.  At f32 the int8
model's logits are within 1e-5 of the JAX int8 model's.  The reference's
own bounds hold for the port (``tests/test_llm.py``'s int8 tests, at their
bf16 configuration): logits within 5% of full precision relative to their
largest magnitude, greedy tokens agreeing on at least 75% of steps.  The
int8 engine is token-exact against the port's int8 ``generate``.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.models import llm as P
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _carried(tie, dtype=jnp.float32, tdtype=torch.float32, seed=0, **kw):
    jcfg = J.LlamaConfig.tiny(num_layers=2, tie_embeddings=tie, dtype=dtype,
                              **kw)
    tcfg = P.LlamaConfig.tiny(num_layers=2, tie_embeddings=tie, dtype=tdtype,
                              **kw)
    jm = J.LlamaModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((2, 8), jnp.int32))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu"))
    return jm, variables, tm


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def quant_pair(request):
    tie = request.param
    jm, variables, tm = _carried(tie, max_len=64)
    jq = J.quantize_int8(variables)
    jqm = J.LlamaModel(dataclasses.replace(jm.cfg, weight_quant="int8"))
    return tie, jqm, jq, P.quantize_int8(tm)


def _np_tree(variables):
    return jax.tree.map(np.asarray, nn.meta.unbox(variables))


def test_quantize_int8_equals_reference_bitwise(quant_pair):
    tie, jqm, jq, tq = quant_pair
    sd = tq.state_dict()
    ref = P.params_from_reference(_np_tree(jq), tq.cfg, "cpu")
    assert set(sd) == set(ref)
    n_int8 = 0
    for k, v in ref.items():
        assert sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k], v), k
        n_int8 += v.dtype == torch.int8
    # every projection, the head or the tied table
    assert n_int8 == 2 * 7 + 1
    assert ("tok_embed.embedding_q" in sd) == tie
    assert ("lm_head.kernel_q" in sd) == (not tie)
    assert tq.cfg.weight_quant == "int8"


def test_int8_logits_within_1e5_of_reference(quant_pair):
    _, jqm, jq, tq = quant_pair
    ids = np.random.default_rng(0).integers(1, 512, (2, 11)).astype(np.int32)
    ref = np.asarray(jax.jit(jqm.apply)(jq, jnp.asarray(ids)))
    with torch.no_grad():
        got = tq(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_reference_tree_loads_into_an_int8_model(quant_pair):
    _, jqm, jq, tq = quant_pair
    m = P.LlamaModel(tq.cfg, device="cpu")
    m.load_state_dict(P.params_from_reference(_np_tree(jq), tq.cfg, "cpu"))
    ids = torch.as_tensor(np.arange(1, 13, dtype=np.int32)[None])
    with torch.no_grad():
        assert torch.equal(m(ids), tq(ids))
    # the int8 tensors stay int8 on the model: no dequantized copy
    assert m.layers[0].gate_proj.kernel_q.dtype == torch.int8
    with pytest.raises(ValueError, match="weight_quant"):
        P.params_from_reference(_np_tree(jq),
                                dataclasses.replace(tq.cfg,
                                                    weight_quant="none"),
                                "cpu")


@pytest.mark.parametrize("tie,seed", [(False, 0), (True, 1)],
                         ids=["untied", "tied"])
def test_reference_bounds_against_full_precision(tie, seed):
    """tests/test_llm.py's int8 bounds at its configuration (tiny, 4
    layers, bf16): relative logit error < 0.05, greedy agreement >=
    0.75."""
    jcfg = J.LlamaConfig.tiny(max_len=64, tie_embeddings=tie)
    tcfg = P.LlamaConfig.tiny(max_len=64, tie_embeddings=tie)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (2, 12)).astype(np.int32)
    variables = jax.jit(J.LlamaModel(jcfg).init)(jax.random.PRNGKey(seed),
                                                 jnp.asarray(ids))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(_np_tree(variables), tcfg,
                                               "cpu"))
    qm = P.quantize_int8(tm)
    with torch.no_grad():
        full = tm(torch.as_tensor(ids)).numpy()
        quant = qm(torch.as_tensor(ids)).numpy()
    rel = np.abs(full - quant).max() / (np.abs(full).max() + 1e-9)
    assert rel < 0.05, rel
    out_f = P.generate(tm, ids, max_new_tokens=8)
    out_q = P.generate(qm, ids, max_new_tokens=8)
    assert (out_f == out_q).mean() >= 0.75


def test_int8_engine_token_exact_vs_int8_generate(quant_pair):
    _, _, _, tq = quant_pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (9, 14, 6)]
    eng = P.SlotEngine(tq, n_slots=2, max_len=64, device="cpu",
                       warmup="sync", name="pt-int8-engine")
    assert eng.attention_backend == "paged"
    res = [eng.admit(prompts[0], 8), eng.admit(prompts[1], 6)]
    eng.step()
    outs = eng.run_to_completion()
    got = [outs[res[0].slot], outs[res[1].slot]]
    r3 = eng.admit(prompts[2], 10)
    got.append(eng.run_to_completion()[r3.slot])
    for p, n, g in zip(prompts, (8, 6, 10), got):
        np.testing.assert_array_equal(
            g, P.generate(tq, p[None], max_new_tokens=n)[0])
    assert eng.compile_plane.snapshot()["stalls"] == 0
