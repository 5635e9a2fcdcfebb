"""Histogram tree growth on one device.

The PyTorch port of the JAX package's ``models/gbdt/trainer.py`` for its
two single-device growers: :func:`grow_tree_depthwise` (the default),
which splits every selected leaf of a wave at once, with one pass over
the binned matrix per wave (:func:`~.hist.route_and_hist_ids`, K2), and
:func:`grow_tree`, strict leaf-wise (lossguide) growth with one K1 build
per split (:func:`~.hist.build_hist_nodes`); both take, for wide bins,
the two-level (coarse-then-refine) histograms.  Split gain follows LightGBM:
with G/H the child gradient/hessian sums, ``score(G,H) = T(G)^2 / (H +
λ2)`` where T is the L1 soft-threshold, and ``gain = score(GL,HL) +
score(GR,HR) - score(G,H)``.  NaN maps to bin 0 and routes left.

The JAX grower runs inside ``jit`` with static shapes; here the wave loop
is a Python loop, and the few scalars that steer it (leaf count, best
gain, how many leaves a wave splits) are read back once per wave.  Only
the leaves a wave really splits update the tree state, so the bookkeeping
writes the JAX grower sends to its junk node never happen here; the
kernels still see all ``n_slots`` slots, the unused ones pointing at the
junk node, as in the JAX package.

Not ported yet (ROADMAP queue A, GBDT breadth): feature- and
voting-parallel growth, EFB bundle maps, monotone constraints.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .hist import build_hist_nodes, coarse_bins, prep_hist_vals, \
    route_and_hist_ids


class GrowthParams(NamedTuple):
    """Growth hyperparameters (the JAX package's fields and defaults)."""
    num_leaves: int = 31
    max_depth: int = -1               # <=0: unlimited (bounded by num_leaves)
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    total_bins: int = 256             # B (incl. missing bin 0)
    voting_k: int = 0                 # >0: voting-parallel (not ported)
    monotone_constraints: Optional[Tuple[int, ...]] = None   # not ported
    monotone_penalty: float = 0.0
    monotone_method: str = "basic"
    #: two-level histograms for wide-bin growth: "off" | "auto" (on for
    #: N >= TWO_LEVEL_MIN_ROWS) | "on".  Histograms build and store at
    #: coarse (bin >> TWO_LEVEL_SHIFT) resolution; the top ``refine_k``
    #: features — chosen once per tree from the root's coarse per-feature
    #: gains — are refined at full resolution every wave, and each split
    #: picks the better of the refined fine candidates and the unrefined
    #: coarse-boundary candidates
    two_level: str = "off"
    refine_k: int = 0
    #: the TPU kernels' tuned rows-per-chunk; kept so the two packages'
    #: params compare equal, ignored by the CUDA kernels
    hist_chunk: int = 0


class Tree(NamedTuple):
    """Flat tree arrays; node 0 is the root. -1 children ⇒ leaf."""
    split_feature: torch.Tensor       # (MAX_NODES,) int32
    split_bin: torch.Tensor           # (MAX_NODES,) int32 (go left if bin<=)
    threshold: torch.Tensor           # (MAX_NODES,) f32 raw-value threshold
    split_gain: torch.Tensor          # (MAX_NODES,) f32 (0 for leaves)
    left_child: torch.Tensor          # (MAX_NODES,) int32
    right_child: torch.Tensor         # (MAX_NODES,) int32
    leaf_value: torch.Tensor          # (MAX_NODES,) f32 (already shrunk)
    node_value: torch.Tensor          # (MAX_NODES,) f32 output at every node
    num_nodes: torch.Tensor           # () int32
    default_left: torch.Tensor        # (MAX_NODES,) bool missing routing
    node_count: torch.Tensor          # (MAX_NODES,) f32 rows per node
    missing_zero: torch.Tensor        # (MAX_NODES,) bool LightGBM
                                      # missing_type=Zero (imports only)


def max_nodes(num_leaves: int) -> int:
    return 2 * num_leaves


def _soft_threshold(g, l1):
    return torch.sign(g) * torch.clamp_min(torch.abs(g) - l1, 0.0)


def _leaf_score(g, h, l1, l2):
    t = _soft_threshold(g, l1)
    return t * t / (h + l2 + 1e-32)


def _leaf_output(g, h, l1, l2):
    return -_soft_threshold(g, l1) / (h + l2 + 1e-32)


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the pairwise order of
    ``lax.associative_scan`` (the JAX grower's scan), so both packages
    add the same f32 numbers in the same order on every device —
    ``torch.cumsum`` adds sequentially on the CPU and in another tree on
    a card, and a near-tie split could flip between them."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = _prefix_sum(x[..., :-1:2] + x[..., 1::2])
    if n % 2 == 0:
        even = odd[..., :-1] + x[..., 2::2]
    else:
        even = odd + x[..., 2::2]
    even = torch.cat([x[..., :1], even], dim=-1)
    m = odd.shape[-1]
    inter = torch.stack([even[..., :m], odd], dim=-1).flatten(-2)
    return torch.cat([inter, even[..., m:]], dim=-1)


def _topk_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of a 1-D tensor, ties to the
    lower index — ``lax.top_k``'s rule, which ``torch.topk`` does not
    promise."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k].to(torch.int32)


def _gain_matrix(hist, sum_g, sum_h, sum_c, num_bins, feature_mask,
                 node_depth, p: GrowthParams):
    """Split-gain matrix (..., F, B) with invalid candidates at -inf, plus
    the cumulative left sums (gl, hl, cl), for histograms (..., F, B, 3)
    and node stats of shape (...).  A split at bin b sends bins <= b
    left, b ∈ [0, B-2]."""
    B = hist.shape[-2]
    # one scan over the three channels at once: the same adds per channel
    gl, hl, cl = _prefix_sum(hist.movedim(-1, 0))
    sg, sh, sc = sum_g[..., None, None], sum_h[..., None, None], \
        sum_c[..., None, None]
    gr, hr, cr = sg - gl, sh - hl, sc - cl
    gain = (_leaf_score(gl, hl, p.lambda_l1, p.lambda_l2)
            + _leaf_score(gr, hr, p.lambda_l1, p.lambda_l2)
            - _leaf_score(sg, sh, p.lambda_l1, p.lambda_l2))
    bins_idx = torch.arange(B, device=hist.device)[None, :]
    valid = ((cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
             & (hl >= p.min_sum_hessian_in_leaf)
             & (hr >= p.min_sum_hessian_in_leaf)
             & (bins_idx < num_bins[:, None])     # inside feature's bin range
             & (bins_idx < B - 1)
             & feature_mask[:, None])
    if p.max_depth > 0:
        valid = valid & (node_depth[..., None, None] < p.max_depth)
    return torch.where(valid, gain, -torch.inf), (gl, hl, cl)


def _pick(gain, cum):
    """Per batch entry: first argmax of a (..., F, B) gain matrix →
    (gain, feature, bin, gl, hl, cl)."""
    B = gain.shape[-1]
    flat = gain.flatten(-2).argmax(-1, keepdim=True)
    out = [t.flatten(-2).gather(-1, flat)[..., 0] for t in (gain, *cum)]
    flat = flat[..., 0]
    return (out[0], (flat // B).to(torch.int32), (flat % B).to(torch.int32),
            out[1], out[2], out[3])


def _best_split(hist, sum_g, sum_h, sum_c, num_bins, feature_mask,
                node_depth, p: GrowthParams):
    """Best (gain, feature, bin, left sums) per node histogram (..., F, B,
    3)."""
    return _pick(*_gain_matrix(hist, sum_g, sum_h, sum_c, num_bins,
                               feature_mask, node_depth, p))


# -- two-level (coarse-then-refine) histograms ------------------------------

#: rows below which "auto" two-level stays off
TWO_LEVEL_MIN_ROWS = 500_000
#: the coarse level is bin >> this shift (255-bin fine → 32-bin coarse)
TWO_LEVEL_SHIFT = 3


def _tl_coarse_gains(c_hists, sum_g, sum_h, sum_c, depth, num_bins_c,
                     feature_mask, p: GrowthParams):
    """Batched coarse gain matrices → (gains (S', F, Bc), cum 3-tuple,
    per-feature max gains (S', F))."""
    cg, ccum = _gain_matrix(c_hists, sum_g, sum_h, sum_c, num_bins_c,
                            feature_mask, depth, p)
    return cg, ccum, cg.max(dim=-1).values


def _tl_final_pick(cg, ccum, f_hists, topk, sum_g, sum_h, sum_c, depth,
                   num_bins, feature_mask, p: GrowthParams, shift: int):
    """Merge the refined fine candidates (``f_hists`` (S', K, B, 3) of the
    ``topk`` features) with the unrefined coarse candidates → per-node
    best split in FINE bin space.  A coarse candidate at coarse bin c maps
    to the fine boundary ``(c+1)·2^shift - 1``."""
    # refined features compete fine
    cg = cg.index_fill(1, topk.long(), -torch.inf)
    cgain, cf, cc, cgl, chl, ccl = _pick(cg, ccum)
    step = 1 << shift
    cbin = torch.minimum(cc * step + step - 1, num_bins[cf.long()] - 1)
    tk = topk.long()
    fgain, fk, fb, fgl, fhl, fcl = _best_split(
        f_hists, sum_g, sum_h, sum_c, num_bins[tk], feature_mask[tk], depth,
        p)
    use_f = fgain >= cgain
    return (torch.where(use_f, fgain, cgain),
            torch.where(use_f, topk[fk.long()], cf).to(torch.int32),
            torch.where(use_f, fb, cbin).to(torch.int32),
            torch.where(use_f, fgl, cgl),
            torch.where(use_f, fhl, chl),
            torch.where(use_f, fcl, ccl))


def _tl_root_pick(bins_t, root_hist, root_stats, row_valid, vals8, scales,
                  num_bins, num_bins_c, feature_mask, p: GrowthParams):
    """The two-level root, shared by both growers: coarse gains → the
    tree's refined feature set → the root's fine histograms of those
    features (K1 by id) → the merged root pick.  The refined set is chosen
    ONCE per tree from the root's coarse per-feature gains, so every later
    build refines left children only and derives right children by fine
    subtraction.  → (topk (K,) int32, root_fine (1, K, B, 3), the root's
    (gain, feature, bin, gl, hl, cl))."""
    B = p.total_bins
    z1 = torch.zeros(1, dtype=torch.int32, device=bins_t.device)
    g, h, c = (root_stats[i][None] for i in range(3))
    cg0, ccum0, fgain0 = _tl_coarse_gains(root_hist[None], g, h, c, z1,
                                          num_bins_c, feature_mask, p)
    topk = _topk_index(fgain0[0], p.refine_k)[1]
    rslot = torch.where(row_valid > 0, 0, -1).to(torch.int32)
    root_fine = build_hist_nodes(bins_t, rslot, vals8, scales, 1, B,
                                 feat=topk)
    rbest = _tl_final_pick(cg0, ccum0, root_fine, topk, g, h, c, z1,
                           num_bins, feature_mask, p, TWO_LEVEL_SHIFT)
    return topk, root_fine, tuple(x[0] for x in rbest)


def _two_level_on(p: GrowthParams, F: int, N: int) -> bool:
    """Two-level histograms: wide bins, a refined set smaller than the
    features, and enough rows (or "on")."""
    return (p.refine_k > 0 and p.two_level != "off" and p.total_bins >= 128
            and F > p.refine_k
            and (p.two_level == "on" or N >= TWO_LEVEL_MIN_ROWS))


def _route_left(xb, t1, rlo, rhi, dflt):
    in_range = (xb > rlo) & (xb <= rhi)
    return torch.where(in_range, xb <= t1, dflt != 0)


def default_n_slots(num_leaves: int) -> int:
    """Node slots per wave: 16, fewer when the leaf budget is smaller."""
    return max(1, min(16, num_leaves - 1))


def grow_tree_depthwise(bins_t: torch.Tensor,       # (F, N) int32
                        grad: torch.Tensor,         # (N,) f32 or bf16
                        hess: torch.Tensor,         # (N,) f32 or bf16
                        row_valid: torch.Tensor,    # (N,) f32 row weight
                        feature_mask: torch.Tensor,     # (F,) bool
                        upper_bounds: torch.Tensor,     # (F, B-1) f32
                        num_bins: torch.Tensor,         # (F,) int32
                        learning_rate: float,
                        p: GrowthParams,
                        n_slots: int = 16) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree wave by wave → (tree, per-row leaf node ids).

    Within a wave the best ``n_slots`` splittable leaves split together;
    one :func:`~.hist.route_and_hist_ids` pass routes their rows and
    builds the left children's histograms (right children by subtraction
    from the parent), reading the split and refined features' bins in
    place by their row ids.  All tensors lie on one device; the
    histogram kernels run there."""
    if p.voting_k or (p.monotone_constraints
                      and any(p.monotone_constraints)):
        raise NotImplementedError(
            "voting-parallel growth and monotone constraints are not "
            "ported yet (ROADMAP queue A, GBDT breadth)")
    dev = bins_t.device
    i32, f32 = torch.int32, torch.float32
    F, N = bins_t.shape
    B = p.total_bins
    L = p.num_leaves
    M = max_nodes(L)
    S = n_slots
    JUNK = M - 1              # node index never reached (num_nodes <= M-1)

    def ifull(n, v):
        return torch.full((n,), v, dtype=i32, device=dev)

    vals8, scales = prep_hist_vals(grad, hess, row_valid)
    tl = _two_level_on(p, F, N)
    SH = TWO_LEVEL_SHIFT
    Bh = coarse_bins(B, SH) if tl else B   # stored-histogram width
    K = p.refine_k
    num_bins = num_bins.to(i32)
    num_bins_c = (num_bins + (1 << SH) - 1) >> SH
    depth0 = torch.zeros((), dtype=i32, device=dev)

    # root: one pass with every row in one slot, riding the fused kernel
    # with a degenerate all-left split of leaf 0 (t1=B → every row left,
    # child id 0 → node ids unchanged)
    _, root_hists = route_and_hist_ids(
        bins_t, torch.zeros(N, dtype=i32, device=dev), ifull(1, 0),
        ifull(1, 0), ifull(1, B), ifull(1, -1), ifull(1, B), ifull(1, 1),
        ifull(1, 0), ifull(1, 0), vals8, scales, 1, B,
        hist_shift=(SH if tl else 0))
    root_hist = root_hists[0]                              # (F, Bh, 3)
    # the scan's last entry: the same adds in the same order on every
    # device (see _prefix_sum)
    root_stats = _prefix_sum(root_hist[0].t())[:, -1]
    root_g, root_h, root_c = root_stats[0], root_stats[1], root_stats[2]

    topk = None
    if tl:
        topk, root_fine, rbest = _tl_root_pick(
            bins_t, root_hist, root_stats, row_valid, vals8, scales,
            num_bins, num_bins_c, feature_mask, p)
        bg, bf_, bb, bgl, bhl, bcl = rbest
    else:
        bg, bf_, bb, bgl, bhl, bcl = _best_split(
            root_hist, root_g, root_h, root_c, num_bins, feature_mask,
            depth0, p)

    zi = torch.zeros(M, dtype=i32, device=dev)
    zf = torch.zeros(M, dtype=f32, device=dev)
    node_id = torch.zeros(N, dtype=i32, device=dev)
    hist = torch.zeros((L + 2, F * Bh, 3), dtype=f32, device=dev)
    hist[0] = root_hist.reshape(F * Bh, 3)
    hist_f = None
    if tl:
        hist_f = torch.zeros((L + 2, K * B, 3), dtype=f32, device=dev)
        hist_f[0] = root_fine[0].reshape(K * B, 3)
    slot = zi.clone()
    sum_g, sum_h, sum_c = zf.clone(), zf.clone(), zf.clone()
    sum_g[0], sum_h[0], sum_c[0] = root_g, root_h, root_c
    depth = zi.clone()
    best_gain = torch.full((M,), -torch.inf, dtype=f32, device=dev)
    best_feat, best_bin = zi.clone(), zi.clone()
    best_gl, best_hl, best_cl = zf.clone(), zf.clone(), zf.clone()
    best_gain[0], best_feat[0], best_bin[0] = bg, bf_, bb
    best_gl[0], best_hl[0], best_cl[0] = bgl, bhl, bcl
    active = torch.zeros(M, dtype=torch.bool, device=dev)
    active[0] = True
    split_feature = torch.full((M,), -1, dtype=i32, device=dev)
    split_bin, split_gain, threshold = zi.clone(), zf.clone(), zf.clone()
    left_child = torch.full((M,), -1, dtype=i32, device=dev)
    right_child = left_child.clone()
    num_nodes, next_slot = 1, 1
    jidx = torch.arange(S, dtype=i32, device=dev)

    while True:
        leaves = (num_nodes + 1) // 2
        gains = torch.where(active, best_gain, -torch.inf)
        tv, ti = _topk_index(gains, S)                   # leaves to split
        valid = (tv > p.min_gain_to_split) & (jidx < L - leaves)
        # valid slots are packed first by the sort: a prefix of n_valid
        nv = int(valid.sum())
        if leaves >= L or nv == 0:
            break
        parents = torch.where(valid, ti, JUNK)
        l_ids = torch.where(valid, num_nodes + 2 * jidx, JUNK)
        r_ids = torch.where(valid, num_nodes + 2 * jidx + 1, JUNK)
        pl = parents[:nv].long()
        bf_p, bb_p = best_feat[parents.long()], best_bin[parents.long()]
        # plain splits: the universal routing form with the full range
        last_wave = leaves + nv >= L
        if last_wave:
            # this wave fills the leaf budget: its children never split
            # again, so it routes in plain tensor code and skips the
            # histogram pass, as the JAX grower does
            new_node_id = node_id
            for j, f in enumerate(bf_p[:nv].tolist()):
                gl = _route_left(bins_t[f], bb_p[j], -1, B, 1)
                new_node_id = torch.where(
                    node_id == parents[j],
                    torch.where(gl, l_ids[j], r_ids[j]), new_node_id)
        else:
            out = route_and_hist_ids(
                bins_t, node_id, parents, bf_p, bb_p, ifull(S, -1),
                ifull(S, B), ifull(S, 1), l_ids, r_ids, vals8, scales, S, B,
                hist_shift=(SH if tl else 0), feat_k=topk)
            new_node_id, l_hists = out[0], out[1]
            lf = out[2] if tl else None

        lid, rid = l_ids[:nv].long(), r_ids[:nv].long()
        cids = torch.cat([lid, rid])
        pslot = slot[pl].long()
        r_slots = torch.arange(next_slot, next_slot + nv, device=dev)
        lg, lh, lc = best_gl[pl], best_hl[pl], best_cl[pl]
        rg, rh, rc = sum_g[pl] - lg, sum_h[pl] - lh, sum_c[pl] - lc
        cdepth = depth[pl] + 1
        cg = torch.cat([lg, rg])
        ch = torch.cat([lh, rh])
        cc = torch.cat([lc, rc])
        cd = torch.cat([cdepth, cdepth])
        if not last_wave:
            # the budget-filling wave's children never split again: their
            # histograms and picks would never be read
            l_flat = l_hists[:nv].reshape(nv, F * Bh, 3)
            r_flat = hist[pslot] - l_flat
            hist[pslot] = l_flat
            hist[r_slots] = r_flat
            child_hists = torch.cat([l_flat, r_flat]).reshape(
                2 * nv, F, Bh, 3)
            if tl:
                cgm, ccum, _ = _tl_coarse_gains(
                    child_hists, cg, ch, cc, cd, num_bins_c, feature_mask,
                    p)
                lf_flat = lf[:nv].reshape(nv, K * B, 3)
                rf_flat = hist_f[pslot] - lf_flat
                hist_f[pslot] = lf_flat
                hist_f[r_slots] = rf_flat
                f_hists = torch.cat([lf_flat, rf_flat]).reshape(
                    2 * nv, K, B, 3)
                picks = _tl_final_pick(cgm, ccum, f_hists, topk, cg, ch, cc,
                                       cd, num_bins, feature_mask, p, SH)
            else:
                picks = _best_split(child_hists, cg, ch, cc, num_bins,
                                    feature_mask, cd, p)
            for t, v in zip((best_gain, best_feat, best_bin, best_gl,
                             best_hl, best_cl), picks):
                t[cids] = v
        bfv, bbv = bf_p[:nv], bb_p[:nv]
        thr = torch.where(
            bbv >= 1,
            upper_bounds[bfv.long(), torch.clamp_min(bbv - 1, 0).long()],
            -torch.inf)
        split_feature[pl] = bfv
        split_bin[pl] = bbv
        split_gain[pl] = best_gain[pl]
        threshold[pl] = thr
        left_child[pl] = lid.to(i32)
        right_child[pl] = rid.to(i32)
        slot[lid] = pslot.to(i32)
        slot[rid] = r_slots.to(i32)
        sum_g[cids], sum_h[cids], sum_c[cids] = cg, ch, cc
        depth[cids] = cd
        active[pl] = False
        active[cids] = True
        node_id = new_node_id
        num_nodes += 2 * nv
        next_slot += nv
        if last_wave:
            break

    node_value = learning_rate * _leaf_output(sum_g, sum_h, p.lambda_l1,
                                              p.lambda_l2)
    leaf_value = torch.where(left_child < 0, node_value, 0.0)
    tree = Tree(split_feature=split_feature, split_bin=split_bin,
                threshold=threshold, split_gain=split_gain,
                left_child=left_child, right_child=right_child,
                leaf_value=leaf_value, node_value=node_value,
                num_nodes=torch.tensor(num_nodes, dtype=i32, device=dev),
                default_left=torch.ones(M, dtype=torch.bool, device=dev),
                node_count=sum_c,
                missing_zero=torch.zeros(M, dtype=torch.bool, device=dev))
    return tree, node_id


def grow_tree(bins_t: torch.Tensor,         # (F, N) int32
              grad: torch.Tensor,           # (N,) f32 or bf16
              hess: torch.Tensor,           # (N,) f32 or bf16
              row_valid: torch.Tensor,      # (N,) f32 bag or GOSS weight
              feature_mask: torch.Tensor,   # (F,) bool
              upper_bounds: torch.Tensor,   # (F, B-1) f32
              num_bins: torch.Tensor,       # (F,) int32
              learning_rate: float,
              p: GrowthParams) -> Tuple[Tree, torch.Tensor]:
    """Strict leaf-wise (lossguide) growth → (tree, per-row leaf node ids).

    Each of at most ``num_leaves - 1`` splits takes the leaf of largest
    gain, routes its rows, builds the left child's histogram with K1 at
    one slot over the left child's rows (coarse when two-level is on,
    plus the refined features' fine histograms by id) and the right
    child's by subtraction from the parent, then picks both children's
    best splits.  One host sync per split decides whether any leaf can
    still split (the JAX grower's ``lax.cond``); everything else stays on
    the device, with the chosen leaf as a one-element index tensor."""
    if p.voting_k or (p.monotone_constraints
                      and any(p.monotone_constraints)):
        raise NotImplementedError(
            "voting-parallel growth and monotone constraints are not "
            "ported yet (ROADMAP queue A, GBDT breadth)")
    dev = bins_t.device
    i32, f32 = torch.int32, torch.float32
    F, N = bins_t.shape
    B = p.total_bins
    L = p.num_leaves
    M = max_nodes(L)
    tl = _two_level_on(p, F, N)
    SH = TWO_LEVEL_SHIFT if tl else 0
    Bh = coarse_bins(B, SH) if tl else B
    K = p.refine_k
    num_bins = num_bins.to(i32)
    num_bins_c = (num_bins + (1 << TWO_LEVEL_SHIFT) - 1) >> TWO_LEVEL_SHIFT

    vals8, scales = prep_hist_vals(grad, hess, row_valid)
    valid = row_valid > 0

    def build(in_node, feat=None):
        """K1 at one slot over the rows of ``in_node`` that carry weight:
        (F, Bh, 3), or (K, B, 3) for the refined rows ``feat``."""
        slot = torch.where(in_node & valid, 0, -1).to(i32)
        return build_hist_nodes(bins_t, slot, vals8, scales, 1, B,
                                hist_shift=(0 if feat is not None else SH),
                                feat=feat)[0]

    root_hist = build(torch.ones_like(valid))
    # the scan's last entry: the same adds in the same order on every
    # device (see _prefix_sum)
    root_stats = _prefix_sum(root_hist[0].t())[:, -1]
    topk = None
    if tl:
        topk, root_fine, rbest = _tl_root_pick(
            bins_t, root_hist, root_stats, row_valid, vals8, scales,
            num_bins, num_bins_c, feature_mask, p)
    else:
        rbest = _best_split(root_hist, root_stats[0], root_stats[1],
                            root_stats[2], num_bins, feature_mask,
                            torch.zeros((), dtype=i32, device=dev), p)

    zi = torch.zeros(M, dtype=i32, device=dev)
    zf = torch.zeros(M, dtype=f32, device=dev)
    node_id = torch.zeros(N, dtype=i32, device=dev)
    hist = torch.zeros((L + 1, F * Bh, 3), dtype=f32, device=dev)
    hist[0] = root_hist.reshape(F * Bh, 3)
    if tl:
        hist_f = torch.zeros((L + 1, K * B, 3), dtype=f32, device=dev)
        hist_f[0] = root_fine[0].reshape(K * B, 3)
    slot = zi.clone()
    sum_g, sum_h, sum_c = zf.clone(), zf.clone(), zf.clone()
    sum_g[0], sum_h[0], sum_c[0] = root_stats
    depth = zi.clone()
    best_gain = torch.full((M,), -torch.inf, dtype=f32, device=dev)
    best_feat, best_bin = zi.clone(), zi.clone()
    best_gl, best_hl, best_cl = zf.clone(), zf.clone(), zf.clone()
    for t, v in zip((best_gain, best_feat, best_bin, best_gl, best_hl,
                     best_cl), rbest):
        t[0] = v
    active = torch.zeros(M, dtype=torch.bool, device=dev)
    active[0] = True
    split_feature = torch.full((M,), -1, dtype=i32, device=dev)
    split_bin, split_gain, threshold = zi.clone(), zf.clone(), zf.clone()
    left_child = torch.full((M,), -1, dtype=i32, device=dev)
    right_child = left_child.clone()
    num_nodes = 1

    for _ in range(L - 1):
        gains = torch.where(active, best_gain, -torch.inf)
        if not bool(gains.max() > p.min_gain_to_split):   # the host sync
            break
        leaf = gains.argmax().view(1)                  # first best leaf
        feat, sbin = best_feat[leaf], best_bin[leaf]
        l_id, r_id = num_nodes, num_nodes + 1
        kids = slice(l_id, l_id + 2)
        r_slot = num_nodes // 2 + 1           # one fresh slot per split
        go_left = _route_left(bins_t.index_select(0, feat.long())[0], sbin,
                              -1, B, 1)
        node_id = torch.where(node_id == leaf,
                              torch.where(go_left, l_id, r_id),
                              node_id).to(i32)
        in_left = node_id == l_id
        # left child by one K1 pass, right child by subtraction
        pslot = slot[leaf].long()
        l_hist = build(in_left).reshape(1, F * Bh, 3)
        r_hist = hist[pslot] - l_hist
        hist[pslot] = l_hist
        hist[r_slot] = r_hist[0]
        lg, lh, lc = best_gl[leaf], best_hl[leaf], best_cl[leaf]
        cg = torch.cat([lg, sum_g[leaf] - lg])
        ch = torch.cat([lh, sum_h[leaf] - lh])
        cc = torch.cat([lc, sum_c[leaf] - lc])
        cd = (depth[leaf] + 1).expand(2)
        child_hists = torch.cat([l_hist, r_hist]).reshape(2, F, Bh, 3)
        if tl:
            lf = build(in_left, feat=topk).reshape(1, K * B, 3)
            rf = hist_f[pslot] - lf
            hist_f[pslot] = lf
            hist_f[r_slot] = rf[0]
            cgm, ccum, _ = _tl_coarse_gains(child_hists, cg, ch, cc, cd,
                                            num_bins_c, feature_mask, p)
            picks = _tl_final_pick(
                cgm, ccum, torch.cat([lf, rf]).reshape(2, K, B, 3), topk,
                cg, ch, cc, cd, num_bins, feature_mask, p, TWO_LEVEL_SHIFT)
        else:
            picks = _best_split(child_hists, cg, ch, cc, num_bins,
                                feature_mask, cd, p)
        split_feature[leaf] = feat
        split_bin[leaf] = sbin
        split_gain[leaf] = best_gain[leaf]
        threshold[leaf] = torch.where(
            sbin >= 1,
            upper_bounds[feat.long(), torch.clamp_min(sbin - 1, 0).long()],
            -torch.inf)
        # index_fill_ takes the ids as kernel arguments (an index_put_ of a
        # Python int would copy it from the host)
        left_child.index_fill_(0, leaf, l_id)
        right_child.index_fill_(0, leaf, r_id)
        for t, v in zip((best_gain, best_feat, best_bin, best_gl, best_hl,
                         best_cl), picks):
            t[kids] = v
        slot[l_id] = pslot[0]
        slot[r_id] = r_slot
        sum_g[kids], sum_h[kids], sum_c[kids] = cg, ch, cc
        depth[kids] = cd
        active.index_fill_(0, leaf, False)
        active[kids] = True
        num_nodes += 2

    node_value = learning_rate * _leaf_output(sum_g, sum_h, p.lambda_l1,
                                              p.lambda_l2)
    leaf_value = torch.where(left_child < 0, node_value, 0.0)
    tree = Tree(split_feature=split_feature, split_bin=split_bin,
                threshold=threshold, split_gain=split_gain,
                left_child=left_child, right_child=right_child,
                leaf_value=leaf_value, node_value=node_value,
                num_nodes=torch.tensor(num_nodes, dtype=i32, device=dev),
                default_left=torch.ones(M, dtype=torch.bool, device=dev),
                node_count=sum_c,
                missing_zero=torch.zeros(M, dtype=torch.bool, device=dev))
    return tree, node_id


def predict_raw_features(features: torch.Tensor, trees_stacked: Tree,
                         depth_bound: int):
    """Sum of all trees' outputs on raw (N, F) float features, and the
    (T, N) leaf node of each row in each tree.  ``trees_stacked`` carries
    a leading tree axis (T, M) on the features' device."""
    N = features.shape[0]
    t = trees_stacked
    total = torch.zeros(N, dtype=torch.float32, device=features.device)
    leaves = []
    for k in range(t.split_feature.shape[0]):
        sf, thr = t.split_feature[k].long(), t.threshold[k]
        lc, rc = t.left_child[k].long(), t.right_child[k].long()
        dl, mz = t.default_left[k], t.missing_zero[k]
        node = torch.zeros(N, dtype=torch.long, device=features.device)
        for _ in range(depth_bound):
            feat = sf[node]
            is_leaf = feat < 0
            x = features.gather(1, torch.clamp_min(feat, 0)[:, None])[:, 0]
            # LightGBM kZeroThreshold: missing_type=Zero treats |x|<=1e-35
            # (and NaN) as missing
            missing = torch.isnan(x) | (mz[node] & (torch.abs(x) <= 1e-35))
            go_left = torch.where(missing, dl[node], x <= thr[node])
            child = torch.where(go_left, lc[node], rc[node])
            node = torch.where(is_leaf, node, child)
        total = total + t.leaf_value[k][node]
        leaves.append(node.to(torch.int32))
    return total, torch.stack(leaves)


def predict_binned_tree(bins_t: torch.Tensor, tree: Tree,
                        depth_bound: int) -> torch.Tensor:
    """One tree's leaf values (N,) on the (F, N) binned training matrix
    (DART's rescoring): each node sends bins <= its split bin left."""
    N = bins_t.shape[1]
    node = torch.zeros(N, dtype=torch.long, device=bins_t.device)
    sf, sb = tree.split_feature.long(), tree.split_bin
    lc, rc = tree.left_child.long(), tree.right_child.long()
    for _ in range(depth_bound):
        feat = sf[node]
        xb = bins_t.gather(0, torch.clamp_min(feat, 0)[None])[0]
        child = torch.where(xb <= sb[node], lc[node], rc[node])
        node = torch.where(feat < 0, node, child)
    return tree.leaf_value[node]


def stack_trees(trees) -> Tree:
    return Tree(*[torch.stack([torch.as_tensor(getattr(t, f)) for t in trees])
                  for f in Tree._fields])


def tree_depth(tree: Tree) -> int:
    """Host-side actual depth (for tight traversal bounds)."""
    lc = np.asarray(tree.left_child)
    rc = np.asarray(tree.right_child)
    depth = np.zeros(lc.shape, np.int32)
    out = 0
    for node in range(len(lc)):
        for child in (lc[node], rc[node]):
            if child >= 0:
                depth[child] = depth[node] + 1
                out = max(out, int(depth[child]))
    return out + 1
