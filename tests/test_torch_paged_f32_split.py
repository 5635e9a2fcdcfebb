"""The f32 split kernel of K3 (``paged_f32_split_kernel`` in
``synapseml_tpu_torch/csrc/paged_attn.cu``), held on the CPU: its chunk
rule, and its arithmetic stated in plain torch against the JAX package's
Pallas kernel run through the interpreter.

The kernel itself runs only on the card (``test_torch_llm_cuda.py``
holds it against the plain version there).  What these tests pin is the
function its blocks compute together: each chunk of C keys of a slot's
span split into 64-key tiles, each tile's 16-key quarters kept by one
warp's running max, sum and accumulators; the warps merged by
exp(m_w - m_max) at the chunk's end into (m, l, acc) partials; the
partials merged the same way and normalised by max(l, 1e-30).
Tolerance: the JAX package's own kernel-vs-dense bar, rtol 1e-5 /
atol 1e-6 (both sides sum in f32, in other orders).  Rows with no live
key (a slot at span 1 in a verify step) have an unspecified output in
both and are not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models.llm import pallas_attn as J
from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models.llm import paged_attn as P
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

NEG = torch.finfo(torch.float32).min
WARPS, WARP_KEYS, TILE = 4, 16, 64


# ---------------------------------------------------------------------------
# the chunk rule
# ---------------------------------------------------------------------------

def _blocks(B, KV, T, rows, D, C):
    return B * KV * -(-rows // P.f32_rows_per_block(D)) * -(-T // C)


@pytest.mark.parametrize("B,KV,T,rows,D,want", [
    (16, 8, 2048, 4, 64, 256),     # phase 6: 16 slots x 2048, S=1
    (4, 8, 512, 4, 64, 64),        # phase 27a's servers, S=1
    (4, 8, 512, 32, 64, 64),       # 27a's geometry at S=8
    (4, 4, 128, 2, 16, 128),       # phase 20a's engines: one chunk
    (16, 8, 2048, 32, 64, 256),    # 16 x 2048 at S=8
])
def test_chunk_rule_at_the_phase_6_shapes(B, KV, T, rows, D, want):
    assert P.f32_chunk_keys(B, KV, T, rows, D) == want


@pytest.mark.parametrize("B,KV,T,rows,D", [
    (1, 1, 1, 1, 16), (3, 2, 100, 2, 16), (5, 4, 96, 8, 32),
    (2, 8, 1000, 4, 64), (7, 3, 4097, 12, 128), (1, 8, 640, 4, 64),
    # rows above SML_PA_MAX_ROWS: several row chunks of one key chunk
    (4, 8, 512, 128, 64), (16, 8, 2048, 256, 64), (2, 2, 200, 96, 128),
    (3, 4, 333, 130, 16),
])
def test_chunk_rule_bounds(B, KV, T, rows, D):
    """C is a multiple of the tile in [64, SPLIT_KEYS]; the chunks cover
    the cache row.  Either the row is one chunk, because the fewest keys
    within the grid bound would cut it into fewer than 4; or the grid is
    at most SML_PA_F32_BLOCKS unless C is at its cap, no shorter chunk
    meets that bound, and the row takes at least 4 chunks unless it is
    longer than one chunk can take."""
    C = P.f32_chunk_keys(B, KV, T, rows, D)
    assert C % TILE == 0 and TILE <= C <= P.SPLIT_KEYS
    n = -(-T // C)
    assert n * C >= T and (n - 1) * C < T
    assert P.f32_workspace_shape(B, 1, rows * KV, KV, D, T) == (
        B, KV, n, rows, D + 4)
    fewest = next((c for c in range(TILE, P.SPLIT_KEYS, TILE)
                   if _blocks(B, KV, T, rows, D, c) <= P._F32_BLOCKS),
                  P.SPLIT_KEYS)
    if n == 1 and -(-T // fewest) < P._F32_MIN_CHUNKS:
        assert C == -(-T // TILE) * TILE
        return
    assert C == fewest
    assert n >= P._F32_MIN_CHUNKS or C == P.SPLIT_KEYS
    rpb = P.f32_rows_per_block(D)
    assert rpb * D <= P._F32_ACC and rpb <= P._MAX_ROWS


# ---------------------------------------------------------------------------
# the split's arithmetic
# ---------------------------------------------------------------------------

def _online(state, s, v):
    """One online-softmax step: ``state`` (m, l, acc) over rows, ``s``
    (..., rows, keys) masked scores, ``v`` (..., keys, D)."""
    m, l, acc = state
    mx = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - mx)
    p = torch.exp(s - mx[..., None])
    return mx, l * alpha + p.sum(-1), acc * alpha[..., None] + p @ v


def _merge(ms, ls, accs):
    """Rescale partials stacked on dim 0 by exp(m - m_max) and sum."""
    mx = ms.amax(0)
    wt = torch.exp(ms - mx)
    return mx, (wt * ls).sum(0), (wt[..., None] * accs).sum(0)


def split_f32(q, k, v, spans):
    """The f32 split kernel's arithmetic in plain torch.  q (B, S, H, D),
    k and v (B, T, KV, D) f32, spans (B,) → (B, S, H, D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV
    rows = S * group
    C = P.f32_chunk_keys(B, KV, T, rows, D)
    sqrt_d = torch.tensor(np.float32(np.sqrt(D)))
    # rows r = j * group + g of kv head h, the kernel's row order
    qr = q.reshape(B, S, KV, group, D).permute(0, 2, 1, 3, 4).reshape(
        B, KV, rows, D)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # (B, KV, T, D)
    out = torch.zeros(B, KV, rows, D)
    for b in range(B):
        kmax = max(0, min(int(spans[b]), T))
        n_live = -(-kmax // C) if kmax > C else 1
        lim = int(spans[b]) - (S - 1) + torch.arange(rows) // group
        parts = []
        for c in range(n_live):
            c0, c1 = c * C, min(kmax, (c + 1) * C)
            warps = [(torch.full((KV, rows), NEG), torch.zeros(KV, rows),
                      torch.zeros(KV, rows, D)) for _ in range(WARPS)]
            for t0 in range(c0, c1, TILE):
                for w in range(WARPS):
                    kpos = t0 + w * WARP_KEYS + torch.arange(WARP_KEYS)
                    valid = (kpos[None] < lim[:, None]) & (kpos[None] < c1)
                    idx = kpos.clamp(max=T - 1)
                    kt = torch.where((kpos < c1)[:, None], kh[b][:, idx], 0)
                    vt = torch.where((kpos < c1)[:, None], vh[b][:, idx], 0)
                    s = (qr[b] @ kt.transpose(-1, -2)) / sqrt_d
                    s = torch.where(valid[None], s, NEG)
                    warps[w] = _online(warps[w], s, vt)
            parts.append(_merge(*(torch.stack(x) for x in zip(*warps))))
        _, l, acc = _merge(*(torch.stack(x) for x in zip(*parts)))
        out[b] = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, KV, S, group, D).permute(0, 2, 1, 3, 4).reshape(
        B, S, H, D)


def _case(seed, B, S, KV, group, D, T):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, KV * group, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("B,KV,group,D,T", [
    (6, 2, 2, 16, 256),   # C = 64: four chunks of a full span
    (6, 4, 4, 32, 768),   # C = 128: six chunks of a full span
])
def test_split_arithmetic_matches_pallas_interpret(S, B, KV, group, D, T):
    """Spans 1, C - 1, C, C + 1, T - 1 and T: one chunk, the chunk edge,
    several chunks and the full row; span 1 at S > 1 leaves dead rows."""
    C = P.f32_chunk_keys(B, KV, T, S * group, D)
    assert C < T // 2
    spans = np.array([1, C - 1, C, C + 1, T - 1, T][:B], np.int32)
    q, k, v = _case(S * 10 + D, B, S, KV, group, D, T)
    ref = np.asarray(J.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(spans),
        tile=64, num_tiles=T // 64, interpret=True))
    got = split_f32(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), torch.from_numpy(spans)).numpy()
    live = (spans[:, None] - (S - 1) + np.arange(S)[None]) > 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[live], ref[live], rtol=1e-5, atol=1e-6)
    # the wrapper's plain version, which the card's kernel is held to
    plain = P.paged_decode_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v, spans))).numpy()
    np.testing.assert_allclose(got[live], plain[live], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the variant rules at f32
# ---------------------------------------------------------------------------

def test_f32_takes_the_split_variant_and_cpu_runs_plain():
    q, k, v = (torch.from_numpy(x) for x in _case(0, 3, 1, 2, 2, 16, 128))
    spans = torch.as_tensor([1, 70, 128], dtype=torch.int32)
    assert P.default_variant(torch.float32) == "split"
    assert all(P.variant_ok(v_, dt) for v_ in P.PAGED_VARIANTS
               for dt in (torch.float32, torch.bfloat16, torch.float16))
    assert not P.variant_ok("tiled", torch.float32)
    plain = P.paged_decode_attention_plain(q, k, v, spans)
    launches.reset()
    for variant in (None, "split", "single"):
        assert torch.equal(P.paged_decode_attention(q, k, v, spans,
                                                    variant=variant), plain)
    assert launches.BY_SHAPE == {}
    with pytest.raises(ValueError, match="variant"):
        P.paged_decode_attention(q, k, v, spans, variant="tiled")
