"""The port's paged decode attention (K3) held against the JAX package's
Pallas kernel, run through the Pallas interpreter on the CPU as the JAX
package's own tests run it.

On the CPU the port's wrapper takes the kernel's plain version, so these
tests pin the function both the plain version and the CUDA kernel compute
(``test_torch_llm_cuda.py`` pins the kernel against the plain version on
the card).  The span/tile matrix is ``tests/test_llm_paged.py``'s,
including the 58-of-64 shape; the verify spans S = 2 and 4 add the
in-span causal mask.  Tolerance: the JAX package's own kernel-vs-dense
bar, rtol 1e-5 / atol 1e-6 (both sides compute in f32 and differ only in
summation order and exp/division rounding).  The geometry, span buckets
and byte ledger are copies and must equal the JAX functions exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models.llm import pallas_attn as J
from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models.llm import paged_attn as P
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

B, T, KV, GROUP, D = 5, 96, 4, 2, 32
H = KV * GROUP


def _operands(seed=0, T=T, S=None):
    rng = np.random.default_rng(seed)
    qshape = (B, H, D) if S is None else (B, S, H, D)
    q = rng.normal(size=qshape).astype(np.float32)
    k = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    return q, k, v


def _both(q, k, v, spans, tile, num_tiles):
    ref = J.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(spans, jnp.int32), tile=tile, num_tiles=num_tiles,
        interpret=True)
    out = P.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.as_tensor(np.asarray(spans, np.int32)))
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("spans", [
    [1, 1, 1, 1, 1],              # single-token spans
    [96, 96, 96, 96, 96],         # the full max_len row
    [1, 33, 96, 58, 7],           # ragged, tile-misaligned
    [32, 64, 96, 31, 65],         # exact tile boundaries +/- 1
])
@pytest.mark.parametrize("tile", [32, 96])
def test_plain_matches_pallas_interpret(spans, tile):
    q, k, v = _operands()
    nt = J.span_bucket_tiles(max(spans), J.PagedGeometry(tile, T // tile, 0))
    ref, out = _both(q, k, v, spans, tile, nt)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_plain_matches_pallas_every_bucket():
    """Clamped (12 of 12 tiles) and short (one tile) buckets of the
    reference's grid give the port's one span-bounded read."""
    q, k, v = _operands(seed=1)
    ref, out = _both(q, k, v, [5, 17, 40, 63, 96], 8, 12)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    ref, out = _both(q, k, v, [5, 3, 8, 1, 7], 8, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_plain_matches_pallas_58_of_64():
    q, k, v = _operands(seed=2, T=64)
    ref, out = _both(q, k, v, [58, 64, 1, 58, 33], 32, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,spans", [
    (2, [2, 33, 96, 58, 7]),
    (4, [4, 32, 96, 65, 9]),
])
def test_plain_matches_pallas_verify_span(S, spans):
    """S > 1: query j attends keys < spans - (S-1) + j.  Every row here
    has a live key (spans >= S)."""
    q, k, v = _operands(seed=3 + S, S=S)
    nt = J.span_bucket_tiles(max(spans), J.PagedGeometry(32, T // 32, 0))
    ref, out = _both(q, k, v, spans, 32, nt)
    assert out.shape == (B, S, H, D)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _operands())
    spans = torch.as_tensor([1, 33, 96, 58, 7], dtype=torch.int32)
    launches.reset()
    out = P.paged_decode_attention(q, k, v, spans)
    plain = P.paged_decode_attention_plain(q, k, v, spans)
    assert torch.equal(out, plain)
    assert launches.total("paged_decode_attention") == 0
    assert launches.BY_SHAPE == {}


@pytest.mark.parametrize("args", [
    (96, 8, 4, 32, "float32", 1), (96, 8, 4, 32, "float32", 8),
    (8192, 32, 8, 128, "bfloat16", 1), (2048, 32, 8, 64, "bfloat16", 8),
    (512, 32, 8, 64, "float32", 4), (100, 8, 4, 32, "float32", 1),
    (64, 8, 4, 16, "float32", 2), (16, 8, 4, 16, "bfloat16", 1),
])
def test_geometry_buckets_and_ledger_equal_reference(args):
    max_len, heads, kv, d, dt, span = args
    jg = J.paged_geometry(max_len, heads, kv, d, getattr(jnp, dt),
                          max_query_span=span)
    tg = P.paged_geometry(max_len, heads, kv, d, getattr(torch, dt),
                          max_query_span=span)
    if jg is None:
        assert tg is None
        return
    assert (tg.tile, tg.total_tiles, tg.vmem_bytes) == (
        jg.tile, jg.total_tiles, jg.vmem_bytes)
    for s in (1, 2, jg.tile - 1, jg.tile, jg.tile + 1, max_len):
        assert P.span_bucket_tiles(s, tg) == J.span_bucket_tiles(s, jg)
    spans = np.random.default_rng(max_len).integers(1, max_len + 1, 7)
    item = 2 if dt == "bfloat16" else 4
    assert P.paged_read_bytes(spans, tg.tile, kv, d, item, 3) == \
        J.paged_read_bytes(spans, jg.tile, kv, d, item, 3)
    assert P.dense_read_bytes(7, max_len, kv, d, item, 3) == \
        J.dense_read_bytes(7, max_len, kv, d, item, 3)


def test_resolve_backend_on_the_cpu():
    kw = dict(max_len=256, num_heads=8, num_kv_heads=4, d_head=32,
              dtype=torch.float32)
    # 'auto' resolves to the paged wrapper whenever a geometry fits,
    # 'paged' never raises for the device, and 'interpret' is its CPU
    # spelling
    assert P.resolve_attention_backend("auto", **kw) == "paged"
    assert P.resolve_attention_backend("paged", **kw) == "paged"
    assert P.resolve_attention_backend("interpret", **kw) == "paged"
    assert P.resolve_attention_backend("dense", **kw) == "dense"
    with pytest.raises(ValueError, match="must be one of"):
        P.resolve_attention_backend("flash", **kw)
    kw["max_len"] = 100                     # no tile divides it
    assert P.resolve_attention_backend("auto", **kw) == "dense"
    with pytest.raises(ValueError, match="no paged geometry"):
        P.resolve_attention_backend("interpret", **kw)
    # the resolution gates on the geometry alone, as the reference's: a
    # head width the CUDA kernel is not built for and a verify width past
    # one block's rows still resolve to 'paged' (the layout check is the
    # engine's, for a cache on the card)
    kw.update(max_len=256, d_head=48)
    for backend in ("auto", "paged", "interpret"):
        assert P.resolve_attention_backend(backend, **kw) == "paged"
    kw.update(d_head=64, num_heads=32, num_kv_heads=8, max_query_span=32)
    assert P.resolve_attention_backend("auto", **kw) == "paged"
    with pytest.raises(ValueError, match="d_head"):
        P.check_kernel_layout(8, 4, 48, torch.float32)
    with pytest.raises(TypeError):
        P.check_kernel_layout(8, 4, 32, torch.float64)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        P.check_kernel_layout(32, 8, 64, dt)
