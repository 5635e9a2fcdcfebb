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
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

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
    last slot junk), a root (every row in leaf 0 and sent left), a wave
    whose leaves hold no row (an empty row list), or an EFB wave
    ("bundle": each split routes through a range (rlo, rhi] inside the
    column, its threshold within the range, the rows outside by
    ``dflt``)."""
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
    elif kind == "bundle":
        lo = rng.integers(0, B // 2, S)
        hi = lo + rng.integers(1, B // 2, S)
        rlo, rhi, t1 = (torch.as_tensor(a.astype(np.int32), device=dev)
                        for a in (lo, hi, lo + rng.integers(0, hi - lo + 1)))
    l_id = torch.arange(S, dtype=i32, device=dev) * 2 + 2 * S
    return node_id, leaf, feat, t1, rlo, rhi, dflt, l_id, l_id + 1


@pytest.mark.parametrize("N,F,S,B,shift,K,kind", [
    (3, 2, 2, 16, 0, 0, "wave"), (65_537, 9, 16, 64, 0, 0, "wave"),
    (65_537, 28, 16, 256, 3, 8, "wave"), (20_000, 5, 3, 256, 2, 2, "wave"),
    (70_001, 28, 1, 256, 3, 0, "root"), (40_003, 28, 1, 64, 0, 0, "root"),
    (30_001, 7, 16, 256, 3, 4, "none"), (25_013, 6, 64, 16, 0, 2, "wave"),
    (65_537, 36, 16, 256, 0, 0, "bundle"), (40_003, 12, 5, 64, 0, 0,
                                            "bundle")])
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


@pytest.mark.parametrize("two_level,rows", [
    ("on", "all"), ("off", "all"), ("on", "goss"), ("off", "bag")])
def test_lossguide_grower_on_card_equals_cpu(dev, two_level, rows):
    """The lossguide tree (K1 at one slot per split, coarse plus refined
    by id with two-level on) is the same on the card and on the CPU, with
    0/1 bag weights and GOSS weights."""
    rng = np.random.default_rng(11)
    N, F, B = 30_000, 9, 256
    bins = rng.integers(0, B, (F, N)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    hess = (np.abs(grad) * 0.5 + 0.2).astype(np.float32)
    rv = np.ones(N, np.float32)
    if rows == "bag":
        rv = (rng.random(N) < 0.8).astype(np.float32)
    elif rows == "goss":
        rv = np.where(np.abs(grad) > 1.2, 1.0,
                      np.where(rng.random(N) < 0.1, 8.0, 0.0)).astype(
                          np.float32)
    ub = np.sort(rng.normal(size=(F, B - 1)).astype(np.float32), axis=1)
    nb = np.full(F, B, np.int32)
    p = T.GrowthParams(num_leaves=31, min_data_in_leaf=5.0, total_bins=B,
                       two_level=two_level, refine_k=4)
    out = {}
    for d in (dev, torch.device("cpu")):
        launches.reset()
        t, nid = T.grow_tree(
            *(torch.as_tensor(a, device=d) for a in (
                bins, grad, hess, rv, np.ones(F, bool), ub, nb)), 0.1, p)
        out[d.type] = (T.Tree(*[a.cpu() for a in t]), nid.cpu())
        if d.type == "cuda":
            splits = (int(t.num_nodes) - 1) // 2
            assert launches.total("build_hist_nodes") == (
                (1 + splits) * (2 if two_level == "on" else 1))
    (tc, nc), (tp, np_) = out["cuda"], out["cpu"]
    assert torch.equal(nc, np_)
    for f in T.Tree._fields:
        assert torch.equal(getattr(tc, f), getattr(tp, f)), f


def test_prep_hist_vals_on_card_equals_cpu(dev):
    """The per-tree quantization scale is max|g| / Q_MAX as a true
    division on both devices: at these maxima a multiply by the
    reciprocal (what CUDA does for a Python divisor) differs in the last
    bit, which would change every limb."""
    rng = np.random.default_rng(4)
    q = np.float32(H._Q_MAX)
    for top in (1.4442534446716309, 3.6946444511413574, 0.6175495386123657):
        assert np.float32(top) * (np.float32(1) / q) != np.float32(top) / q
        g = rng.uniform(-1, 1, 10_000).astype(np.float32) * np.float32(top)
        g[17] = top
        h = np.abs(g) + np.float32(0.1)
        m = (rng.random(10_000) < 0.8).astype(np.float32)
        m[17] = 1.0
        got = H.prep_hist_vals(*(torch.as_tensor(a, device=dev)
                                 for a in (g, h, m)))
        want = H.prep_hist_vals(*(torch.from_numpy(a) for a in (g, h, m)))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("name", ["binary", "regression", "huber", "fair",
                                  "poisson", "gamma", "tweedie", "softmax",
                                  "ova"])
def test_objective_gradients_on_card_equal_cpu(dev, name):
    """The fit's gradients (``booster._grad_hess``: float64, rounded to
    f32) are the same bits on the card and on the CPU, though f32
    ``sigmoid``/``exp``/``softmax`` alone differ in the last bit."""
    from synapseml_tpu_torch.models.gbdt import objectives as O
    from synapseml_tpu_torch.models.gbdt.booster import _grad_hess
    rng = np.random.default_rng(5)
    n = 300_000
    s = torch.as_tensor(rng.normal(scale=2, size=(n, 3)).astype(np.float32))
    lab = torch.as_tensor(rng.integers(0, 3, n).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0.5, 2, n).astype(np.float32))
    if name in ("softmax", "ova"):
        fn = O.softmax_grad_hess if name == "softmax" else O.ova_grad_hess
        args = (s, torch.nn.functional.one_hot(lab.long(), 3).float(), w)
    else:
        fn = O.get_objective(name)
        y = (lab > 0).float() if name == "binary" else lab + 0.5
        args = (s[:, 0], y, w)
    got = _grad_hess(fn, *(a.to(dev) for a in args))
    want = _grad_hess(fn, *args)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_masks_drawn_on_card_equal_cpu(dev):
    """The threefry draws, the bagging mask and the GOSS weights are the
    same bits on the card and on the CPU."""
    from synapseml_tpu_torch.models.gbdt import prng
    from synapseml_tpu_torch.models.gbdt.booster import bag_mask, \
        goss_weights
    rng = np.random.default_rng(3)
    for n in (1, 7, 65_539, 1_000_003):
        key = prng.fold_in(prng.prng_key(3), n)
        assert torch.equal(prng.random_bits(key, n, dev).cpu(),
                           prng.random_bits(key, n, "cpu"))
        assert torch.equal(bag_mask(key, n, 0.8, dev).cpu(),
                           bag_mask(key, n, 0.8, torch.device("cpu")))
        g = np.abs(rng.normal(size=n)).astype(np.float32)
        bag = (rng.random(n) < 0.8).astype(np.float32)
        got = goss_weights(torch.as_tensor(g, device=dev),
                           torch.as_tensor(bag, device=dev), key, 0.2, 0.1)
        want = goss_weights(torch.from_numpy(g), torch.from_numpy(bag), key,
                            0.2, 0.1)
        assert torch.equal(got.cpu(), want)


def _fit_data(kind, n=20_000, F=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    s = 2 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3] + rng.normal(
        scale=0.5, size=n)
    if kind == "multi":
        return X, np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(
            np.float64)
    if kind == "poisson":
        return X, np.exp(0.5 * X[:, 0] + 0.2 * X[:, 1]) * rng.gamma(
            2.0, 0.5, n)
    if kind == "huber":
        return X, 0.3 * s
    if kind == "cat":
        # two categorical columns (codes); the label reads category subsets
        X[:, 1] = rng.integers(0, 30, n)
        X[:, 3] = rng.integers(0, 300, n)
        s = (X[:, 1] % 3 == 0) * 1.5 - (X[:, 3] % 5 == 1) * 1.2 + X[:, 0]
        return X, (s + rng.normal(scale=0.5, size=n) > 0.3).astype(
            np.float64)
    if kind == "onehot":
        # four one-hot blocks of 12 levels beside the dense columns
        codes = rng.integers(0, 12, (n, 4))
        oh = np.concatenate([np.eye(12, dtype=np.float32)[codes[:, j]]
                             for j in range(4)], axis=1)
        s = s + (codes[:, 0] < 4) * 1.5 - (codes[:, 1] > 8) * 1.2
        return (np.concatenate([oh, X], axis=1),
                (s > 0).astype(np.float64))
    if kind == "mono":
        return _mono_data(n, seed)
    return X, (s > 0).astype(np.float64)


def _mono_data(n, seed):
    """tests/test_gbdt_monotone.py's task: trends in x0 (up) and x1
    (down) with sine wiggles that an unconstrained fit follows."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    y = (1.2 * X[:, 0] + 1.5 * np.sin(3 * X[:, 0]) - 1.0 * X[:, 1]
         + 1.2 * np.sin(4 * X[:, 1]) + 0.3 * X[:, 2] ** 2
         + rng.normal(0, 0.3, n))
    return X, y.astype(np.float64)


#: the monotone cases' constraints: x0 up, x1 down
MONO = [1, -1, 0, 0]


FIT_CASES = {
    "lossguide": ("binary", dict(objective="binary",
                                 growth_policy="lossguide")),
    "lossguide_two_level": ("binary", dict(
        objective="binary", growth_policy="lossguide", two_level_hist="on")),
    "bagging": ("binary", dict(objective="binary", bagging_fraction=0.8,
                               bagging_freq=1)),
    "goss": ("binary", dict(objective="binary", boosting_type="goss")),
    "dart": ("binary", dict(objective="binary", boosting_type="dart",
                            skip_drop=0.0, drop_rate=0.5)),
    "rf": ("binary", dict(objective="binary", boosting_type="rf",
                          bagging_fraction=0.7, bagging_freq=1)),
    "multiclass": ("multi", dict(objective="multiclass", num_class=3,
                                 bagging_fraction=0.8, bagging_freq=1)),
    "multiclassova": ("multi", dict(objective="multiclassova", num_class=3)),
    "huber": ("huber", dict(objective="huber", min_sum_hessian_in_leaf=1.0)),
    "poisson": ("poisson", dict(objective="poisson")),
    "categorical": ("cat", dict(objective="binary",
                                categorical_feature=[1, 3])),
    "efb": ("onehot", dict(objective="binary", enable_bundle=True)),
    "efb_lossguide": ("onehot", dict(objective="binary", enable_bundle=True,
                                     growth_policy="lossguide")),
    **{f"monotone_{m}_{g}": ("mono", dict(
        objective="regression", monotone_constraints=MONO,
        monotone_constraints_method=m, growth_policy=g))
       for m in ("basic", "intermediate", "advanced")
       for g in ("depthwise", "lossguide")},
}


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_on_card_equals_cpu(dev, name):
    """The same fit through ``train`` on the card and on the CPU: every
    tree splits on the same features and bins, the margins agree to
    1e-4, and the fit's kernel ran on the card."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train
    kind, kw = FIT_CASES[name]
    X, y = _fit_data(kind)
    cfg = BoostingConfig(num_iterations=4, num_leaves=15, **kw)
    res = {}
    for d in ("cuda", "cpu"):
        launches.reset()
        b, _ = train(X, y, cfg, device=d)
        if d == "cuda":
            kern = ("build_hist_nodes" if kw.get("growth_policy")
                    == "lossguide" else "route_and_hist")
            assert launches.total(kern) > 0
        res[d] = b
    bc, bp = res["cuda"], res["cpu"]
    assert bc.tree_class == bp.tree_class
    assert bc.tree_weights == bp.tree_weights
    for tc, tp in zip(bc.trees, bp.trees):
        n = int(tc.num_nodes)
        assert int(tp.num_nodes) == n
        np.testing.assert_array_equal(tc.split_feature[:n],
                                      tp.split_feature[:n])
        np.testing.assert_array_equal(tc.split_bin[:n], tp.split_bin[:n])
    np.testing.assert_allclose(bc.predict_margin(X[:2000], device="cpu"),
                               bp.predict_margin(X[:2000], device="cpu"),
                               rtol=0, atol=1e-4)


def _sweep_violation(booster, feat, direction, n_base=16, n_grid=48):
    """The largest step against ``direction`` of the margin as feature
    ``feat`` sweeps -2.2 → 2.2 from 16 base rows."""
    rng = np.random.default_rng(3)
    probes = np.repeat(rng.uniform(-2, 2, (n_base, 4)).astype(np.float32),
                       n_grid, axis=0)
    probes[:, feat] = np.tile(np.linspace(-2.2, 2.2, n_grid,
                                          dtype=np.float32), n_base)
    m = booster.predict_margin(probes).reshape(n_base, n_grid)
    return float(-np.minimum(np.diff(m, axis=1) * direction, 0).min())


@pytest.mark.parametrize("method", ["basic", "intermediate", "advanced"])
def test_monotone_fit_on_card_has_no_violation(dev, method):
    """A constrained fit on the card, scored on the card: no sweep of a
    constrained feature moves the margin the wrong way, while the
    unconstrained fit does."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train
    X, y = _mono_data(20_000, 1)
    kw = dict(objective="regression", num_iterations=10, num_leaves=15,
              min_data_in_leaf=5)
    free, _ = train(X, y, BoostingConfig(**kw), device="cuda")
    mono, _ = train(X, y, BoostingConfig(
        monotone_constraints=MONO, monotone_constraints_method=method,
        **kw), device="cuda")
    assert _sweep_violation(free, 0, 1) > 1e-3
    assert _sweep_violation(mono, 0, 1) <= 1e-6
    assert _sweep_violation(mono, 1, -1) <= 1e-6


@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_efb_on_card_equals_unbundled_on_card(dev, policy):
    """EFB trees on the card equal the unbundled trees on the card, and
    the EFB waves launch K2 with the bundled ranges."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train
    X, y = _fit_data("onehot")
    kw = dict(objective="binary", num_iterations=4, num_leaves=15,
              growth_policy=policy)
    plain, _ = train(X, y, BoostingConfig(**kw), device="cuda")
    launches.reset()
    efb, _ = train(X, y, BoostingConfig(enable_bundle=True, **kw),
                   device="cuda")
    assert efb.bundler.num_bundles == 12
    # splits on one-hot features, which share a bundle: their waves route
    # through ranges inside the bundled column
    shares = np.bincount(efb.bundler.bundle_of)[efb.bundler.bundle_of] > 1
    assert sum(int(shares[t.split_feature[t.split_feature >= 0]].sum())
               for t in efb.trees) > 0
    if policy == "depthwise":
        assert launches.BY_SHAPE.get(launches.launch_key(
            "route_and_hist", F=12, B=256, shift=0, K=0, S=14,
            variant="rows"), 0) > 0
    for tp, te in zip(plain.trees, efb.trees):
        for f in ("split_feature", "split_bin", "leaf_value"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(te, f))


@pytest.mark.parametrize("boosting", ["gbdt", "goss", "rf"])
def test_resume_on_card_equals_uninterrupted(dev, tmp_path, boosting):
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train

    def cfg(iters):
        return BoostingConfig(objective="binary", num_iterations=iters,
                              num_leaves=15, boosting_type=boosting,
                              bagging_fraction=0.7, bagging_freq=1)
    X, y = _fit_data("binary")
    ck = str(tmp_path / "ck")
    full, _ = train(X, y, cfg(8), device="cuda")
    train(X, y, cfg(4), checkpoint_dir=ck, checkpoint_interval=2,
          device="cuda")
    resumed, _ = train(X, y, cfg(8), checkpoint_dir=ck,
                       checkpoint_interval=2, device="cuda")
    assert resumed.num_trees == full.num_trees == 8
    for a, b in zip(full.trees, resumed.trees):
        for f in ("split_feature", "split_bin", "leaf_value"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_validation_on_card_equals_cpu(dev):
    """An early-stopped fit with a validation set: the same eval history
    (within 1e-9) and best iteration on the card and on the CPU."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train
    X, y = _fit_data("binary", n=30_000)
    cfg = BoostingConfig(objective="binary", num_iterations=60,
                         num_leaves=15, learning_rate=0.5,
                         early_stopping_round=3, metric="auc")
    res = {}
    for d in ("cuda", "cpu"):
        res[d] = train(X[:20_000], y[:20_000], cfg,
                       valid=(X[20_000:], y[20_000:], None), device=d)
    (bc, hc), (bp, hp) = res["cuda"], res["cpu"]
    assert bc.best_iteration == bp.best_iteration >= 0
    assert len(hc) == len(hp) < 60
    np.testing.assert_allclose([r.value for r in hc],
                               [r.value for r in hp], rtol=0, atol=1e-9)


def random_tree_arrays(seed, M, F, B):
    """A tree grown by splitting random leaves until M nodes are used,
    as the growers' (M,) arrays hold it: children -1 at leaves."""
    rng = np.random.default_rng(seed)
    left, right = np.full(M, -1, np.int32), np.full(M, -1, np.int32)
    feat, sbin = np.full(M, -1, np.int32), np.zeros(M, np.int32)
    leaves, used = [0], 1
    while used + 2 <= M:
        a = leaves.pop(int(rng.integers(len(leaves))))
        left[a], right[a] = used, used + 1
        feat[a], sbin[a] = rng.integers(0, F), rng.integers(0, B - 1)
        leaves += [used, used + 1]
        used += 2
    raw = rng.normal(size=M).astype(np.float32)
    mono = rng.integers(-1, 2, F).astype(np.int32)
    return feat, sbin, left, right, raw, mono


def test_advanced_bounds_on_card_within_mask_budget(dev):
    """The advanced refresh on the card equals the CPU's, and its peak
    memory stays within the 5 bytes an (M, M, F) entry that the mask
    budget counts, plus (M, M) temporaries."""
    M, F, B = 509, 64, 256
    arrs = random_tree_arrays(0, M, F, B)
    cpu = T._advanced_bounds(*[torch.from_numpy(a) for a in arrs], B)
    args = [torch.from_numpy(a).to(dev) for a in arrs]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = T._advanced_bounds(*args, B)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak <= 5 * M * M * F + 64 * M * M, peak
    for g, c in zip(got, cpu):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=1e-6)


# -- breadth III: lambdarank, NDCG, streamed ingestion --------------------------


def _rank_fit_data(n=20_000, seed=3):
    """Groups of 1-239 rows (some past the objective's 128), relevance
    0-4 from a noisy linear score."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 240, n // 60)
    c = np.cumsum(sizes)
    sizes = sizes[:int(np.searchsorted(c, n)) + 1]
    sizes[-1] -= int(sizes.sum()) - n
    X = rng.normal(size=(n, 8)).astype(np.float32)
    rel = np.clip(X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n),
                  0, None)
    return X, np.digitize(rel, [0.5, 1.2, 2.0, 2.8]).astype(np.float64), \
        sizes


def test_lambdarank_gradients_on_card_equal_cpu(dev):
    """The fit's lambdarank gradients (float64, rounded to f32) are the
    same bits on the card and on the CPU, over groups past 128 rows."""
    from synapseml_tpu_torch.models.gbdt.booster import _grad_hess
    from synapseml_tpu_torch.models.gbdt.ranking import (
        build_group_index, make_lambdarank_objective)
    X, y, sizes = _rank_fit_data()
    q, m = build_group_index(sizes)
    n = len(y)
    rng = np.random.default_rng(1)
    s = torch.as_tensor(np.round(rng.normal(size=n), 2).astype(np.float32))
    lab = torch.as_tensor(y.astype(np.float32))
    w = torch.as_tensor(rng.uniform(0.5, 2, n).astype(np.float32))
    for gain in (None, [0.0, 1.0, 2.5, 6.0, 20.0]):
        fc = make_lambdarank_objective(q, m, n, label_gain=gain, device=dev)
        fp = make_lambdarank_objective(q, m, n, label_gain=gain)
        got = _grad_hess(fc, s.to(dev), lab.to(dev), w.to(dev))
        want = _grad_hess(fp, s, lab, w)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_ndcg_on_card_equals_cpu(dev):
    from synapseml_tpu_torch.models.gbdt.metrics import GroupGrid, ndcg_t
    X, y, sizes = _rank_fit_data()
    s = torch.as_tensor(np.round(X[:, 0] + X[:, 2], 1))
    for k in (1, 10, 1000):
        got = ndcg_t(torch.as_tensor(y).to(dev), s.to(dev),
                     GroupGrid(sizes, dev), None, k)
        want = ndcg_t(torch.as_tensor(y), s, GroupGrid(sizes), None, k)
        assert abs(float(got) - float(want)) <= 1e-12


@pytest.mark.parametrize("case", ["plain", "label_gain", "validation"])
def test_ranker_fit_on_card_equals_cpu(dev, case):
    """A lambdarank fit (with ``label_gain``; with an NDCG validation set
    and early stopping) splits the same on the card and on the CPU."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train
    X, y, sizes = _rank_fit_data()
    kw = dict(objective="lambdarank", num_iterations=4, num_leaves=15)
    tkw = dict(group=sizes)
    if case == "label_gain":
        kw["label_gain"] = [0.0, 1.0, 2.5, 6.0, 20.0]
    if case == "validation":
        Xv, yv, vs = _rank_fit_data(n=4_000, seed=4)
        kw.update(num_iterations=30, learning_rate=0.5,
                  early_stopping_round=2)
        tkw.update(valid=(Xv, yv, None), valid_group=vs)
    res = {}
    for d in ("cuda", "cpu"):
        launches.reset()
        res[d] = train(X, y, BoostingConfig(**kw), device=d, **tkw)
        if d == "cuda":
            assert launches.total("route_and_hist") > 0
    (bc, hc), (bp, hp) = res["cuda"], res["cpu"]
    for tc, tp in zip(bc.trees, bp.trees):
        n = int(tc.num_nodes)
        np.testing.assert_array_equal(tc.split_feature[:n],
                                      tp.split_feature[:n])
        np.testing.assert_array_equal(tc.split_bin[:n], tp.split_bin[:n])
    np.testing.assert_allclose(bc.predict_margin(X[:2000], device="cpu"),
                               bp.predict_margin(X[:2000], device="cpu"),
                               rtol=0, atol=1e-4)
    assert bc.best_iteration == bp.best_iteration
    np.testing.assert_allclose([r.value for r in hc],
                               [r.value for r in hp], rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["dense", "sparse_efb"])
def test_streamed_fit_on_card_equals_cpu(dev, tmp_path, case):
    """A streamed fit (an SMLC file at an odd chunk size; an SMLS file
    with EFB) splits the same on the card and on the CPU, and the card's
    streamed fit equals the card's in-memory fit."""
    from synapseml_tpu_torch.io import colstore as CS
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train
    X, y = _fit_data("onehot" if case == "sparse_efb" else "binary")
    kw = dict(objective="binary", num_iterations=4, num_leaves=15,
              enable_bundle=case == "sparse_efb")
    if case == "dense":
        p = str(tmp_path / "x.smlc")
        CS.write_matrix(p, np.concatenate([X, y[:, None]], axis=1))

        def src():
            return CS.ChunkedColumnSource(p, label_col=X.shape[1],
                                          chunk_rows=4099)
    else:
        p = str(tmp_path / "x.smls")
        CS.write_csr(p, *CS.dense_to_csr(X), X.shape[1], labels=y)

        def src():
            return CS.SparseChunkedSource(p, chunk_rows=3001)
    launches.reset()
    bc, _ = train(src(), None, BoostingConfig(**kw), device="cuda")
    assert launches.total("route_and_hist") > 0
    bp, _ = train(src(), None, BoostingConfig(**kw), device="cpu")
    bm, _ = train(X, y, BoostingConfig(**kw), device="cuda")
    for tc, tp, tm in zip(bc.trees, bp.trees, bm.trees):
        for f in ("split_feature", "split_bin"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(tp, f))
            np.testing.assert_array_equal(getattr(tc, f), getattr(tm, f))
    np.testing.assert_allclose(bc.predict_margin(X[:2000], device="cpu"),
                               bp.predict_margin(X[:2000], device="cpu"),
                               rtol=0, atol=1e-4)


def test_treeshap_sums_to_the_card_margin(dev):
    """TreeSHAP on the host (as in the JAX package) against a margin
    computed on the card."""
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, \
        train
    X, y = _fit_data("binary")
    b, _ = train(X, y, BoostingConfig(objective="binary", num_iterations=4),
                 device="cuda")
    contrib = b.predict_contrib(X[:300])
    np.testing.assert_allclose(contrib.sum(1), b.predict_margin(X[:300]),
                               rtol=0, atol=1e-4)
