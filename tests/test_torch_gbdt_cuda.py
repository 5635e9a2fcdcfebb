"""The port's CUDA histogram kernels against their plain PyTorch versions,
on the card.  Marked ``gpu``: every test skips where no card is present
(the check runs inside the fixture, so every worker collects the same
tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_gbdt_cuda.py
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models.gbdt import hist as H
from synapseml_tpu_torch.models.gbdt import trainer as T

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _vals(rng, N, dev):
    g = torch.as_tensor(rng.normal(size=N).astype(np.float32), device=dev)
    h = torch.as_tensor((rng.random(N) + 0.1).astype(np.float32), device=dev)
    m = torch.as_tensor((rng.random(N) < 0.8).astype(np.float32), device=dev)
    return H.prep_hist_vals(g.to(torch.bfloat16), h.to(torch.bfloat16), m)


def _slots(rng, N, S, kind):
    """Slots of K1's rows: random in [-1, S), none (an empty row list),
    all in slot 0 (a root, or one cell of extreme digits), or junk
    (values outside [-1, S) mixed in)."""
    if kind == "none":
        return np.full(N, -1, np.int32)
    if kind in ("all", "extreme"):
        return np.zeros(N, np.int32)
    lo, hi = (-3, S + 3) if kind == "junk" else (-1, S)
    return rng.integers(lo, hi, N).astype(np.int32)


@pytest.mark.parametrize("N,F,S,B,shift,kind", [
    (1, 1, 1, 16, 0, "random"), (4097, 3, 5, 64, 0, "random"),
    (100_003, 8, 1, 256, 0, "random"), (50_000, 28, 16, 64, 0, "random"),
    (50_000, 11, 4, 256, 3, "random"), (30_001, 9, 16, 64, 0, "none"),
    (70_001, 28, 1, 64, 0, "all"), (20_011, 4, 64, 16, 0, "junk"),
    (9_999, 30, 64, 32, 1, "random"), (16_000_000, 1, 1, 16, 0, "extreme")])
def test_build_hist_nodes_kernel_equals_plain(dev, N, F, S, B, shift, kind):
    """The kernel equals the plain version and the previous kernel, and
    its feature-id form equals it on the gathered rows.  "extreme" sends
    16M rows, their g digits at -64 and their h digits at +64, to one
    cell: every block adds thousands of them to one shared cell, and the
    lanes sum to -1.024e9 and +1.024e9, within int32."""
    rng = np.random.default_rng(N)
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    slot = torch.as_tensor(_slots(rng, N, S, kind), device=dev)
    vals, scales = _vals(rng, N, dev)
    if kind == "extreme":
        bins.zero_()
        vals = torch.tensor([-64, -64, -64, 64, 64, 64, 1, 0],
                            dtype=torch.int8, device=dev).repeat(N, 1)
    launches.reset()
    k = H.build_hist_nodes_limbs(bins, slot, vals, S, B, shift)
    assert launches.BY_SHAPE == {launches.launch_key(
        "build_hist_nodes", F=F, B=B, shift=shift, S=S, variant="rows"): 1}
    p = H.build_hist_nodes_plain(bins, slot, vals, S, B, shift)
    prev = H.build_hist_nodes_limbs_previous(bins, slot, vals, S, B, shift)
    feat = torch.as_tensor(rng.integers(0, F, 5).astype(np.int32),
                           device=dev)
    k_ids = H.build_hist_nodes_limbs(bins, slot, vals, S, B, shift,
                                     feat=feat)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert torch.equal(prev, p)
    assert torch.equal(k_ids, p[feat.long()])
    if kind == "none":
        assert not k.any()
    torch.testing.assert_close(
        H.build_hist_nodes(bins, slot, vals, scales, S, B, shift),
        H._reconstruct(p.permute(2, 0, 1, 3), scales), rtol=0, atol=0)


def _wave(rng, dev, N, F, S, B, kind):
    """A wave's routing inputs: S pending leaves among 2S node ids (the
    last slot junk), a root (every row in leaf 0 and sent left), or a
    wave whose leaves hold no row (an empty row list)."""
    i32 = torch.int32
    node_id = torch.as_tensor(rng.integers(0, 2 * S, N).astype(np.int32),
                              device=dev)
    leaf = torch.arange(S, dtype=i32, device=dev) * 2 + 1
    if kind == "root":
        node_id.zero_()
        leaf.zero_()
    elif kind == "none":
        leaf += 4 * S                                   # no row is there
    elif S > 1:
        leaf[-1] = 10_000                               # a junk slot
    feat = torch.as_tensor(rng.integers(0, F, S).astype(np.int32),
                           device=dev)
    t1 = torch.as_tensor(rng.integers(0, B, S).astype(np.int32), device=dev)
    rlo = torch.as_tensor(rng.integers(-1, 3, S).astype(np.int32),
                          device=dev)
    rhi = torch.as_tensor(rng.integers(B - 3, B + 1, S).astype(np.int32),
                          device=dev)
    dflt = torch.as_tensor(rng.integers(0, 2, S).astype(np.int32),
                           device=dev)
    if kind == "root":
        t1.fill_(B)
        rlo.fill_(-1)
        rhi.fill_(B)
    l_id = torch.arange(S, dtype=i32, device=dev) * 2 + 2 * S
    return node_id, leaf, feat, t1, rlo, rhi, dflt, l_id, l_id + 1


@pytest.mark.parametrize("N,F,S,B,shift,K,kind", [
    (3, 2, 2, 16, 0, 0, "wave"), (65_537, 9, 16, 64, 0, 0, "wave"),
    (65_537, 28, 16, 256, 3, 8, "wave"), (20_000, 5, 3, 256, 2, 2, "wave"),
    (70_001, 28, 1, 256, 3, 0, "root"), (40_003, 28, 1, 64, 0, 0, "root"),
    (30_001, 7, 16, 256, 3, 4, "none"), (25_013, 6, 64, 16, 0, 2, "wave")])
def test_route_and_hist_kernel_equals_plain(dev, N, F, S, B, shift, K, kind):
    """The kernel equals the plain version and the previous kernel on the
    gathered split rows, and its feature-id form equals both."""
    rng = np.random.default_rng(N + K)
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    node_id, leaf, feat, t1, rlo, rhi, dflt, l_id, r_id = _wave(
        rng, dev, N, F, S, B, kind)
    sel = bins.index_select(0, feat.long()).contiguous()
    vals, _ = _vals(rng, N, dev)
    feat_k = (torch.as_tensor(rng.permutation(F)[:K].astype(np.int32),
                              device=dev) if K else None)
    sel_k = bins.index_select(0, feat_k.long()).contiguous() if K else None
    args = (bins, node_id, leaf, sel, t1, rlo, rhi, dflt, l_id, r_id,
            vals, S, B, shift, sel_k)
    launches.reset()
    k = H.route_and_hist_limbs(*args)
    assert launches.BY_SHAPE == {launches.launch_key(
        "route_and_hist", F=F, B=B, shift=shift, K=K, S=S,
        variant="rows"): 1}
    p = H.route_and_hist_plain(*args)
    prev = H.route_and_hist_limbs_previous(*args)
    ids = H.route_and_hist_ids_limbs(bins, node_id, leaf, feat, t1, rlo,
                                     rhi, dflt, l_id, r_id, vals, S, B,
                                     shift, feat_k)
    torch.cuda.synchronize()
    for got in (k, prev, ids):
        assert torch.equal(got[0], p[0])
        assert torch.equal(got[1], p[1])
        assert (got[2] is None) == (K == 0)
        if K:
            assert torch.equal(got[2], p[2])
    if kind == "none":
        assert not k[1].any() and torch.equal(k[0], node_id)


@pytest.mark.parametrize("N,S,kind", [
    (1, 1, "root"), (100_003, 16, "wave"), (50_000, 64, "wave"),
    (30_001, 16, "none")])
def test_route_rows_lists_left_rows_in_block_order(dev, N, S, kind):
    """The route kernel alone: new ids as the plain routing gives them,
    and each row routed left listed once with its slot, in ascending order
    within each block's 2048 rows."""
    rng = np.random.default_rng(N + S)
    F, B = 6, 64
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    node_id, leaf, feat, t1, rlo, rhi, dflt, l_id, r_id = _wave(
        rng, dev, N, F, S, B, kind)
    new_id, lst, cnt = H.route_rows(node_id, leaf, bins, feat, t1, rlo, rhi,
                                    dflt, l_id, r_id, S)
    rows = [bins[f] for f in feat.tolist()]
    p_id, p_slot = H.route_plain(node_id, leaf, rows, t1, rlo, rhi, dflt,
                                 l_id, r_id)
    assert torch.equal(new_id, p_id)
    n = int(cnt)
    got = lst[:n].cpu().numpy()
    left = np.flatnonzero(p_slot.cpu().numpy() >= 0)
    assert n == len(left)
    order = np.argsort(got[:, 0], kind="stable")
    np.testing.assert_array_equal(got[order, 0], left)
    np.testing.assert_array_equal(got[order, 1], p_slot.cpu().numpy()[left])
    blk = got[:, 0] // 2048
    for b in np.unique(blk):
        seg = np.flatnonzero(blk == b)
        assert np.all(np.diff(seg) == 1)                # one contiguous run
        assert np.all(np.diff(got[seg, 0]) > 0)         # ascending in it


def test_wrappers_check_their_inputs(dev):
    bins = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    slot = torch.zeros(8, dtype=torch.int32, device=dev)
    vals = torch.zeros((8, 8), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        H.build_hist_nodes_limbs(bins.long(), slot, vals, 1, 16)
    with pytest.raises(ValueError):
        H.build_hist_nodes_limbs(bins.t(), slot, vals, 1, 16)
    with pytest.raises(ValueError):
        H.build_hist_nodes_limbs(bins, slot.cpu(), vals, 1, 16)
    with pytest.raises(ValueError):
        H.build_hist_nodes_limbs(bins, slot, vals, 64, 512)


def test_grower_on_card_equals_cpu(dev):
    """The same tree on the card and on the CPU: the kernels' sums are
    exact and every other sum runs in a fixed order on both devices."""
    rng = np.random.default_rng(9)
    N, F, B = 30_000, 9, 256
    bins = rng.integers(0, B, (F, N)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    hess = (np.abs(grad) * 0.5 + 0.2).astype(np.float32)
    ub = np.sort(rng.normal(size=(F, B - 1)).astype(np.float32), axis=1)
    nb = np.full(F, B, np.int32)
    p = T.GrowthParams(num_leaves=31, min_data_in_leaf=5.0, total_bins=B,
                       two_level="on", refine_k=4)
    out = {}
    for d in (dev, torch.device("cpu")):
        t, nid = T.grow_tree_depthwise(
            *(torch.as_tensor(a, device=d) for a in (
                bins, grad, hess, np.ones(N, np.float32), np.ones(F, bool),
                ub, nb)), 0.1, p, n_slots=16)
        out[d.type] = (T.Tree(*[a.cpu() for a in t]), nid.cpu())
    (tc, nc), (tp, np_) = out["cuda"], out["cpu"]
    assert torch.equal(nc, np_)
    for f in T.Tree._fields:
        assert torch.equal(getattr(tc, f), getattr(tp, f)), f
