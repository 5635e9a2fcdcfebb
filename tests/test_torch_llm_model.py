"""The port's ``LlamaModel`` held against the JAX package's on the same
parameters (``convert.params_from_reference``) and inputs, on the CPU.

``LlamaConfig.tiny(num_layers=2, max_len=96)`` in f32, tied and untied
heads: logits with no cache, with a scalar-index prefill into a cache,
and with one vector-index decode step through the dense and the paged
read (the JAX side's paged read runs the Pallas kernel in interpret
mode).  Tolerance atol 1e-4 on logits: both sides compute in f32, and
XLA's and PyTorch's CPU matmuls, cos/sin and softmax round differently
by ulps that two layers and a 512-way head grow to ~1e-6.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.models import llm as P
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def pair(request):
    tie = request.param
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=jnp.float32,
                              tie_embeddings=tie)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=96,
                              dtype=torch.float32, tie_embeddings=tie)
    jm = J.LlamaModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables))
    tm = P.LlamaModel(tcfg, device="cpu", seed=1)
    tm.load_state_dict(P.params_from_reference(params, tcfg, "cpu"))
    return jm, variables, tm


def _ids(n, length, seed):
    return np.random.default_rng(seed).integers(1, 512, (n, length)).astype(
        np.int32)


def test_conversion_keeps_every_parameter(pair):
    jm, variables, tm = pair
    leaves = jax.tree_util.tree_leaves(nn.meta.unbox(variables))
    assert sum(x.size for x in leaves) == sum(
        p.numel() for p in tm.parameters())
    emb = np.asarray(nn.meta.unbox(variables)["params"]["tok_embed"]
                     ["embedding"])
    assert np.array_equal(tm.tok_embed.embedding.detach().numpy(), emb)


def test_logits_without_cache(pair):
    jm, variables, tm = pair
    ids = _ids(2, 11, 0)
    ref = np.asarray(jm.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_scalar_index_prefill_logits_and_cache(pair):
    jm, variables, tm = pair
    ids = _ids(2, 9, 1)
    pos = np.broadcast_to(np.arange(3, 12, dtype=np.int32)[None], (2, 9))
    jcache = J.init_cache(jm.cfg, 2, 96)
    ref, jcache = jm.apply(variables, jnp.asarray(ids),
                           positions=jnp.asarray(pos), cache=jcache,
                           cache_index=3)
    tcache = P.init_cache(tm.cfg, 2, 96, "cpu")
    with torch.no_grad():
        out, tcache = tm(torch.from_numpy(ids),
                         positions=torch.from_numpy(np.array(pos)),
                         cache=tcache, cache_index=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    for jc, tc in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), atol=1e-5,
                                       rtol=0)
    with pytest.raises(ValueError, match="overrun"):
        with torch.no_grad():
            tm(torch.from_numpy(ids), cache=tcache, cache_index=90)


def _decode_setup(jm, variables):
    """One batched prefill fills 3 slots' K/V; ragged lengths then say
    how much of each row is live (the reference's dispatch test)."""
    rng = np.random.default_rng(3)
    n = 3
    lengths = np.asarray([1, 37, 90], np.int32)
    ids = rng.integers(1, 512, (n, 90)).astype(np.int32)
    pos = np.broadcast_to(np.arange(90, dtype=np.int32)[None], (n, 90))
    _, jcache = jm.apply(variables, jnp.asarray(ids),
                         positions=jnp.asarray(pos),
                         cache=J.init_cache(jm.cfg, n, 96), cache_index=0)
    toks = rng.integers(1, 512, (n, 1)).astype(np.int32)
    return lengths, jcache, toks


@pytest.mark.parametrize("backend,jax_backend", [
    ("dense", "dense"), ("paged", "interpret"), ("interpret", "interpret")])
def test_vector_index_decode_step(pair, backend, jax_backend):
    jm, variables, tm = pair
    lengths, jcache, toks = _decode_setup(jm, variables)
    mask = np.asarray([True, False, True])
    ref, jnew = jm.apply(variables, jnp.asarray(toks),
                         positions=jnp.asarray(lengths)[:, None],
                         cache=jax.tree.map(lambda x: x, jcache),
                         cache_index=jnp.asarray(lengths),
                         slot_mask=jnp.asarray(mask),
                         attention_backend=jax_backend)
    tcache = [{k: torch.from_numpy(np.array(c[k])) for k in ("k", "v")}
              for c in jcache]
    before = [{k: c[k].clone() for k in c} for c in tcache]
    li = torch.from_numpy(lengths)
    with torch.no_grad():
        out, tcache = tm(torch.from_numpy(toks), positions=li[:, None],
                         cache=tcache, cache_index=li,
                         slot_mask=torch.from_numpy(mask),
                         attention_backend=backend)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    for jc, tc, b in zip(jnew, tcache, before):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), atol=1e-5,
                                       rtol=0)
            # the inactive slot writes nothing: its row is bitwise intact
            assert torch.equal(tc[name][1], b[name][1])


def test_paged_and_dense_reads_agree(pair):
    jm, variables, tm = pair
    lengths, jcache, toks = _decode_setup(jm, variables)
    li = torch.from_numpy(lengths)
    outs = {}
    for backend in ("dense", "paged"):
        tcache = [{k: torch.from_numpy(np.array(c[k])) for k in ("k", "v")}
                  for c in jcache]
        with torch.no_grad():
            outs[backend], _ = tm(torch.from_numpy(toks),
                                  positions=li[:, None], cache=tcache,
                                  cache_index=li,
                                  attention_backend=backend)
    torch.testing.assert_close(outs["paged"], outs["dense"], rtol=1e-5,
                               atol=1e-5)


def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    assert np.array_equal(P.rope_frequencies(16, 500_000.0),
                          J.rope_frequencies(16, 500_000.0))
    ref = np.asarray(J.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  500_000.0))
    out = P.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       500_000.0).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    h = rng.normal(size=(3, 32)).astype(np.float32)
    norm = J.RMSNorm(1e-5, jnp.float32)
    jv = norm.init(jax.random.PRNGKey(0), jnp.asarray(h))
    ref = np.asarray(norm.apply(jv, jnp.asarray(h)))
    out = P.RMSNorm(32, 1e-5, torch.float32, torch.device("cpu"))(
        torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_bf16_tied_head_promotes_to_compute_type():
    """flax's ``Embed.attend`` promotes the f32 query and the table to
    ``cfg.dtype``: under bf16 the tied head's logits are bf16 values
    widened to f32."""
    cfg = P.LlamaConfig.tiny(num_layers=1, max_len=32, dtype=torch.bfloat16,
                             tie_embeddings=True)
    m = P.LlamaModel(cfg, device="cpu")
    with torch.no_grad():
        logits = m(torch.as_tensor(_ids(1, 4, 5)))
    assert logits.dtype == torch.float32
    assert torch.equal(logits, logits.to(torch.bfloat16).float())


def test_unported_options_raise():
    with pytest.raises(ValueError, match="weight_quant"):
        P.LlamaModel(P.LlamaConfig.tiny(weight_quant="int4"), device="cpu")
    # int8 is ported: the model holds int8 kernels
    m8 = P.LlamaModel(P.LlamaConfig.tiny(num_layers=1, weight_quant="int8"),
                      device="cpu")
    assert m8.layers[0].attn.q_proj.kernel_q.dtype == torch.int8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.LlamaModel(P.LlamaConfig.tiny(num_layers=1))
