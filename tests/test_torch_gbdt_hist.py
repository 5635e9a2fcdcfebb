"""The port's histogram ops (``synapseml_tpu_torch.models.gbdt.hist``) held
against the JAX package's Pallas kernels, run through the Pallas
interpreter on the CPU as the JAX package's own tests run them.

On the CPU the port's wrappers take the kernels' plain versions, so these
tests pin the function both the plain versions and the CUDA kernels
compute (the card test, ``test_torch_gbdt_cuda.py``, pins the kernels
against the plain versions bit for bit).  Histograms are exact int32 limb
sums in both packages, reconstructed to f32 by the same operations in the
same order, so the outputs compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models.gbdt import pallas_hist as jh
from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models.gbdt import hist as th
from synapseml_tpu_torch.models.gbdt import trainer as tt
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _vals(grad, hess, mask):
    """Limbs and scales from both packages on the same numpy inputs."""
    jv, js = jh.prep_hist_vals(jnp.asarray(grad), jnp.asarray(hess),
                               jnp.asarray(mask))
    tv, ts = th.prep_hist_vals(torch.from_numpy(np.asarray(grad)),
                               torch.from_numpy(np.asarray(hess)),
                               torch.from_numpy(np.asarray(mask)))
    return (np.asarray(jv), np.asarray(js)), (tv, ts)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", ["random", "exact_halves", "bf16"])
def test_prep_hist_vals_limbs_bit_identical(case):
    rng = np.random.default_rng(1)
    N = 4096
    grad = rng.normal(size=N).astype(np.float32)
    hess = (np.abs(grad) * 0.5 + 0.1).astype(np.float32)
    mask = (rng.random(N) < 0.8).astype(np.float32)
    if case == "exact_halves":
        # max|g| = _Q_MAX makes the scale exactly 1, so every value below
        # sits on a rounding tie: half-to-even must agree in both packages
        q = th._Q_MAX
        halves = np.array([q, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5, 64.5,
                           -64.5, 8191.5, -8192.5], np.float32)
        grad[:len(halves)] = halves
        hess[:len(halves)] = np.abs(halves)
        mask[:len(halves)] = 1.0
    (jv, js), (tv, ts) = _vals(grad, hess, mask)
    if case == "bf16":
        # the fused ingest: bf16 g/h times the f32 mask promote to f32
        gb = jnp.asarray(grad).astype(jnp.bfloat16)
        hb = jnp.asarray(hess).astype(jnp.bfloat16)
        jv, js = (np.asarray(a) for a in jh.prep_hist_vals(
            gb, hb, jnp.asarray(mask)))
        tv, ts = th.prep_hist_vals(_t(grad).to(torch.bfloat16),
                                   _t(hess).to(torch.bfloat16), _t(mask))
    assert tv.dtype == torch.int8 and tuple(tv.shape) == (N, 8)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_coarse_bins_matches():
    for B in (16, 64, 128, 255, 256, 512):
        for s in (1, 2, 3):
            assert th.coarse_bins(B, s) == jh.coarse_bins(B, s)


def _route_case(seed, N, F, B, S, n_real):
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, B, (F, N)).astype(np.int32)
    node_id = rng.integers(0, 2 * n_real, N).astype(np.int32)
    leaf = np.array(list(range(1, 2 * n_real, 2))
                    + [61] * (S - n_real), np.int32)         # junk tail
    feat = rng.integers(0, F, S).astype(np.int32)
    thr = rng.integers(0, B, S).astype(np.int32)
    l_id = np.arange(S, dtype=np.int32) * 2 + 2 * n_real
    r_id = l_id + 1
    grad = rng.normal(size=N).astype(np.float32)
    hess = (np.abs(grad) + 0.1).astype(np.float32)
    mask = (rng.random(N) < 0.8).astype(np.float32)
    route = dict(leaf=leaf, feat=feat, sel=bins_t[feat], t1=thr,
                 rlo=np.full(S, -1, np.int32), rhi=np.full(S, B, np.int32),
                 dflt=np.ones(S, np.int32), l_id=l_id, r_id=r_id)
    return bins_t, node_id, route, (grad, hess, mask)


@pytest.mark.parametrize("shape,shift,K", [
    ((2048, 9, 64, 16, 4), 0, 0),        # plain mode (maxBin=63 path)
    ((8192, 7, 256, 4, 4), 2, 0),        # coarse only
    ((8192, 7, 256, 4, 4), 3, 3),        # coarse + fine-K refine
    ((4096, 5, 64, 1, 1), 0, 0),         # one slot
])
def test_route_and_hist_matches_pallas(shape, shift, K):
    """The gathered-row form (the JAX signature) and the id form (split
    and refined features as row ids of bins_t, the grower's call) both
    equal the Pallas kernel."""
    N, F, B, S, n_real = shape
    bins_t, node_id, r, gh = _route_case(11, N, F, B, S, n_real)
    (jv, js), (tv, ts) = _vals(*gh)
    feat_k = np.array([0, 3, 5][:K], np.int32)
    sel_k = bins_t[feat_k] if K else None
    jout = route_and_hist_pallas_np(bins_t, node_id, r, jv, js, S, B, shift,
                                    sel_k)
    common = (_t(r["t1"]), _t(r["rlo"]), _t(r["rhi"]), _t(r["dflt"]),
              _t(r["l_id"]), _t(r["r_id"]), tv, S, B)
    tout = _hists(th.route_and_hist_limbs(
        _t(bins_t), _t(node_id), _t(r["leaf"]), _t(r["sel"]), *common,
        hist_shift=shift, sel_k=None if sel_k is None else _t(sel_k)), ts)
    iout = _hists(th.route_and_hist_ids_limbs(
        _t(bins_t), _t(node_id), _t(r["leaf"]), _t(r["feat"]), *common,
        hist_shift=shift, feat_k=_t(feat_k) if K else None), ts)
    assert len(tout) == len(iout) == len(jout)
    np.testing.assert_array_equal(tout[0].numpy(), jout[0])     # new ids
    for t_h, i_h, j_h in zip(tout, iout, jout):
        assert tuple(t_h.shape) == j_h.shape
        np.testing.assert_array_equal(t_h.numpy(), j_h)
        np.testing.assert_array_equal(i_h.numpy(), j_h)


def _hists(out, scales):
    """K2's limb sums → (new ids, hists[, fine hists]) as the grower
    reconstructs them."""
    return (out[0],) + tuple(tt._node_hists(o, scales) for o in out[1:]
                             if o is not None)


def route_and_hist_pallas_np(bins_t, node_id, r, jv, js, S, B, shift,
                             sel_k):
    out = jh.route_and_hist_pallas(
        jnp.asarray(bins_t), jnp.asarray(node_id), jnp.asarray(r["leaf"]),
        jnp.asarray(r["sel"]), jnp.asarray(r["t1"]), jnp.asarray(r["rlo"]),
        jnp.asarray(r["rhi"]), jnp.asarray(r["dflt"]),
        jnp.asarray(r["l_id"]), jnp.asarray(r["r_id"]), jnp.asarray(jv),
        jnp.asarray(js), S, B, hist_shift=shift,
        sel_k=None if sel_k is None else jnp.asarray(sel_k), interpret=True)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("shift", [0, 3])
def test_build_hist_nodes_matches_pallas(shift):
    rng = np.random.default_rng(3)
    N, F, B, S = 2048, 11, 64, 5
    bins_t = rng.integers(0, B, (F, N)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    hess = (np.abs(grad) + 0.1).astype(np.float32)
    mask = (rng.random(N) < 0.7).astype(np.float32) * 1.5
    slot = rng.integers(-1, S, N).astype(np.int32)
    (jv, js), (tv, ts) = _vals(grad, hess, mask)
    j = np.asarray(jh.build_hist_nodes_pallas(
        jnp.asarray(bins_t), jnp.asarray(slot), jnp.asarray(jv),
        jnp.asarray(js), S, B, hist_shift=shift, interpret=True))
    t = th.build_hist_nodes(_t(bins_t), _t(slot), tv, ts, S, B,
                            hist_shift=shift)
    assert tuple(t.shape) == j.shape
    np.testing.assert_array_equal(t.numpy(), j)
    # by feature ids: rows read in place from a matrix that holds them in
    # another order (the grower's two-level root build)
    feat = np.arange(F, dtype=np.int32)[::-1].copy()
    t_ids = th.build_hist_nodes(_t(bins_t[feat]), _t(slot), tv, ts, S, B,
                                hist_shift=shift, feat=_t(feat))
    np.testing.assert_array_equal(t_ids.numpy(), j)


def test_plain_versions_count_no_launches():
    """The CPU path never reaches a kernel, so the launch counters stay
    at zero; rows outside [0, width) and slots outside [0, S) add
    nothing."""
    launches.reset()
    rng = np.random.default_rng(4)
    N, F, B, S = 512, 3, 16, 2
    bins_t = rng.integers(-2, B + 3, (F, N)).astype(np.int32)
    slot = rng.integers(-1, S + 2, N).astype(np.int32)
    vals = torch.from_numpy(rng.integers(-64, 64, (N, 8)).astype(np.int8))
    out = th.build_hist_nodes_limbs(_t(bins_t), _t(slot), vals, S, B)
    exp = np.zeros((F, B, S, 8), np.int64)
    v = vals.numpy().astype(np.int64)
    for f in range(F):
        for i in range(N):
            b, s = bins_t[f, i], slot[i]
            if 0 <= b < B and 0 <= s < S:
                exp[f, b, s] += v[i]
    np.testing.assert_array_equal(out.numpy(), exp)
    assert launches.BY_SHAPE == {}


@pytest.mark.parametrize("two_level", ["off", "on"])
def test_grower_passes_feature_ids_and_gathers_no_rows(monkeypatch,
                                                       two_level):
    """The grower hands K2 the split features' ids (and K1/K2 the refined
    features' ids) and never gathers bin rows with index_select."""
    from synapseml_tpu_torch.models.gbdt import trainer as tt

    def no_gather(*a, **k):
        raise AssertionError("the grower gathered bin rows")
    monkeypatch.setattr(torch.Tensor, "index_select", no_gather)
    monkeypatch.setattr(torch, "index_select", no_gather)
    calls = []
    real = tt.route_and_hist_ids_limbs

    def spy(bins_t, node_id, leaf, feat, *a, feat_k=None, **k):
        calls.append((tuple(feat.shape), feat.dtype,
                      None if feat_k is None else tuple(feat_k.shape)))
        return real(bins_t, node_id, leaf, feat, *a, feat_k=feat_k, **k)
    monkeypatch.setattr(tt, "route_and_hist_ids_limbs", spy)
    rng = np.random.default_rng(2)
    N, F, B = 4096, 7, 256
    bins = torch.from_numpy(rng.integers(0, B, (F, N)).astype(np.int32))
    grad = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    hess = torch.from_numpy((np.abs(grad.numpy()) * 0.5 + 0.2)
                            .astype(np.float32))
    ub = torch.from_numpy(np.sort(rng.normal(size=(F, B - 1))
                                  .astype(np.float32), axis=1))
    p = tt.GrowthParams(num_leaves=15, min_data_in_leaf=5.0, total_bins=B,
                        two_level=two_level, refine_k=3)
    t, _ = tt.grow_tree_depthwise(
        bins, grad, hess, torch.ones(N), torch.ones(F, dtype=torch.bool), ub,
        torch.full((F,), B, dtype=torch.int32), 0.1, p, n_slots=8)
    assert int(t.num_nodes) > 1 and len(calls) >= 2
    K = 3 if two_level == "on" else None
    assert calls[0] == ((1,), torch.int32, None)            # the root
    assert all(c == ((8,), torch.int32, None if K is None else (K,))
               for c in calls[1:])


#: (nfeat, width, S) of chip_smoke.py's phase-2 shapes -> (features per
#: block, tile, groups, dynamic shared bytes) of hist_rows_kernel
PHASE2_GEOMETRY = {
    (28, 64, 1): (28, 128, 1, 83968),      # K2 root, maxBin=63
    (28, 64, 16): (5, 1024, 6, 225280),    # K2 wave, maxBin=63; K1 lossguide
    (28, 32, 1): (28, 256, 1, 92672),      # K2 root, coarse, maxBin=255
    (28, 32, 16): (10, 512, 3, 204800),    # K2 wave, coarse, maxBin=255
    (8, 256, 16): (1, 2048, 8, 212992),    # K2 wave, K=8 refined rows
    (8, 256, 1): (8, 512, 1, 110592),      # K1 two-level root, K=8
}


@pytest.mark.parametrize("dims", sorted(PHASE2_GEOMETRY))
def test_rows_geometry_at_the_phase2_shapes(dims):
    """The wrapper's geometry, mirrored from the kernel's shared-memory
    layout: histograms of fpb features at 7 int32 lanes per cell, then a
    ring of 3 entry stages and 2 stages of limbs and bins.  Every block
    fits the H100's 227 KB and keeps ~15-64 KB of gathers in flight per
    SM."""
    from synapseml_tpu_torch.kernels import _build
    nfeat, width, S = dims
    fpb, tile, groups, smem = th.rows_geometry(*dims)
    assert (fpb, tile, groups, smem) == PHASE2_GEOMETRY[dims]
    assert groups == -(-nfeat // fpb) and (groups - 1) * fpb < nfeat
    assert tile & (tile - 1) == 0 and th._TILE_MIN <= tile <= th._TILE_MAX
    assert smem == (-(-fpb * width * S * 7 * 4 // 16) * 16
                    + tile * (3 * 8 + 2 * 8 + 2 * 4 * fpb))
    assert smem <= _build.DEFINES["gbdt_hist"]["SML_MAX_SMEM"] <= 232448
    flight = th.rows_blocks_per_sm(smem) * tile * (8 + 4 * fpb)
    assert 15 * 1024 <= flight <= 64 * 1024
    src = (_build._PKG / _build.SOURCES["gbdt_hist"]).read_text()
    assert "fpb * width * S * kLive * 4 + 15) / 16 * 16" in src
    assert "tile * (3 * 8 + 2 * 8 + 2 * 4 * fpb)" in src
    assert f"kMaxFpb = {th._MAX_FPB};" in src


def test_rows_geometry_limits():
    """One feature's histogram must fit beside the smallest ring: at 16
    slots up to 501 bins (the tile shrinks), not 502; no features, no
    groups."""
    assert th.rows_geometry(0, 64, 16) == (0, 0, 0, 0)
    fpb, tile, groups, smem = th.rows_geometry(3, 501, 16)
    assert (fpb, groups) == (1, 3) and tile == th._TILE_MIN
    assert smem <= th._MAX_SMEM
    with pytest.raises(ValueError):
        th.rows_geometry(1, 502, 16)
    with pytest.raises(ValueError):
        th._check_smem(64, th._MAX_SLOTS + 1)
