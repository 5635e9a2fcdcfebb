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


@pytest.mark.parametrize("N,F,S,B,shift", [
    (1, 1, 1, 16, 0), (4097, 3, 5, 64, 0), (100_003, 8, 1, 256, 0),
    (50_000, 28, 16, 64, 0), (50_000, 11, 4, 256, 3)])
def test_build_hist_nodes_kernel_equals_plain(dev, N, F, S, B, shift):
    rng = np.random.default_rng(N)
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    slot = torch.as_tensor(rng.integers(-1, S, N).astype(np.int32),
                           device=dev)
    vals, scales = _vals(rng, N, dev)
    before = launches.total("build_hist_nodes")
    k = H.build_hist_nodes_limbs(bins, slot, vals, S, B, shift)
    assert launches.total("build_hist_nodes") == before + 1
    p = H.build_hist_nodes_plain(bins, slot, vals, S, B, shift)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    torch.testing.assert_close(
        H.build_hist_nodes(bins, slot, vals, scales, S, B, shift),
        H._reconstruct(p.permute(2, 0, 1, 3), scales), rtol=0, atol=0)


@pytest.mark.parametrize("N,F,S,B,shift,K", [
    (3, 2, 2, 16, 0, 0), (65_537, 9, 16, 64, 0, 0),
    (65_537, 28, 16, 256, 3, 8), (20_000, 5, 3, 256, 2, 2),
    (70_001, 28, 1, 256, 3, 0)])
def test_route_and_hist_kernel_equals_plain(dev, N, F, S, B, shift, K):
    rng = np.random.default_rng(N + K)
    i32 = torch.int32
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    node_id = torch.as_tensor(rng.integers(0, 2 * S, N).astype(np.int32),
                              device=dev)
    leaf = torch.arange(S, dtype=i32, device=dev) * 2 + 1
    if S > 1:
        leaf[-1] = 10_000                               # a junk slot
    feat = torch.as_tensor(rng.integers(0, F, S), device=dev)
    sel = bins.index_select(0, feat).contiguous()
    t1 = torch.as_tensor(rng.integers(0, B, S).astype(np.int32), device=dev)
    rlo = torch.as_tensor(rng.integers(-1, 3, S).astype(np.int32),
                          device=dev)
    rhi = torch.as_tensor(rng.integers(B - 3, B + 1, S).astype(np.int32),
                          device=dev)
    dflt = torch.as_tensor(rng.integers(0, 2, S).astype(np.int32),
                           device=dev)
    l_id = torch.arange(S, dtype=i32, device=dev) * 2 + 2 * S
    vals, _ = _vals(rng, N, dev)
    sel_k = bins[:K].contiguous() if K else None
    args = (bins, node_id, leaf, sel, t1, rlo, rhi, dflt, l_id, l_id + 1,
            vals, S, B, shift, sel_k)
    launches.reset()
    k = H.route_and_hist_limbs(*args)
    assert launches.BY_SHAPE == {launches.launch_key(
        "route_and_hist", F=F, B=B, shift=shift, K=K, S=S): 1}
    p = H.route_and_hist_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0])
    assert torch.equal(k[1], p[1])
    assert (k[2] is None) == (K == 0)
    if K:
        assert torch.equal(k[2], p[2])


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
