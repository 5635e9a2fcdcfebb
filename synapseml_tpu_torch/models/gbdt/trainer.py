"""Histogram tree growth on one device.

The PyTorch port of the JAX package's ``models/gbdt/trainer.py`` for its
two single-device growers: :func:`grow_tree_depthwise` (the default),
which splits every selected leaf of a wave at once, with one pass over
the binned matrix per wave (:func:`~.hist.route_and_hist_ids_limbs`,
K2), and :func:`grow_tree`, strict leaf-wise (lossguide) growth with one
K1 build per split (:func:`~.hist.build_hist_nodes_limbs`); both take,
for wide bins, the two-level (coarse-then-refine) histograms.  Split
gain follows LightGBM: with G/H the child gradient/hessian sums,
``score(G,H) = T(G)^2 / (H + λ2)`` where T is the L1 soft-threshold, and
``gain = score(GL,HL) + score(GR,HR) - score(G,H)``.  NaN maps to bin 0
and routes left.

Both growers take EFB-bundled matrices (``bundle_map``): splits route
through each feature's bundled range (:func:`_slot_route_params`, K2's
``rlo``/``rhi``/``dflt``), and each histogram the kernels build over the
bundled columns unbundles to the original features in the kernels'
int limb space (:func:`_unbundle_hists`), where the default bin's
residual is exact, so split search and the trees stay in original
feature space.  Monotone constraints take the basic, intermediate or
advanced method; the whole-tree refresh of the last two runs on the
device (:func:`_tree_bounds`).

The JAX grower runs inside ``jit`` with static shapes; here the wave loop
is a Python loop, and the few scalars that steer it (leaf count, best
gain, how many leaves a wave splits) are read back once per wave.  Only
the leaves a wave really splits update the tree state, so the bookkeeping
writes the JAX grower sends to its junk node never happen here; the
kernels still see all ``n_slots`` slots, the unused ones pointing at the
junk node, as in the JAX package.

Data-parallel growth: with ``hist_allreduce`` (the booster passes the
planner's ``planned_psum`` over the mesh's data axis) each rank builds
its histograms over its own rows, quantized with its own scales and
decoded, and every decoded histogram is summed across the ranks at the
places where the JAX grower calls ``ar``: the root, the two-level root's
refined build, each wave's coarse and refined builds, and each lossguide
build.  Every host decision (how many leaves a wave splits, the last
wave's routing columns, whether a lossguide leaf can split) is read from
the reduced histograms, so all ranks take the same branches and grow the
same tree.  Voting-parallel growth (``voting_k > 0``: each rank votes
its top features, and only the voted histograms are summed) and
feature-parallel growth (rows replicated, each rank building and
choosing over its own block of features) run here too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .hist import _reconstruct, build_hist_nodes, build_hist_nodes_limbs, \
    coarse_bins, prep_hist_vals, route_and_hist_ids_limbs


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
    voting_k: int = 0                 # >0: voting-parallel with this top-k
    #: per-feature {-1, 0, +1} (None: unconstrained): violating splits
    #: are discarded and child outputs clamped to bounds
    monotone_constraints: Optional[Tuple[int, ...]] = None
    #: gain penalization for splits on constrained features near the root
    monotone_penalty: float = 0.0
    #: "basic" (midpoint bounds propagated down the tree) |
    #: "intermediate" (bounds from the opposite subtrees' leaf outputs,
    #: refreshed over the whole tree after every wave or split) |
    #: "advanced" (the exact pairwise constraints between ordered,
    #: overlapping leaf boxes; see :func:`_advanced_bounds`)
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
    """(values, indices) of the k largest along the last axis, ties to
    the lower index — ``lax.top_k``'s rule, which ``torch.topk`` does not
    promise."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


def _mono_penalty_factor(node_depth, penalty: float):
    """LightGBM's ComputeMonotoneSplitGainPenalty: 1 forbids constrained
    splits at the root, higher values reach deeper."""
    eps = 1e-10
    d = node_depth.to(torch.float32)
    if penalty <= 1.0:
        fac = 1.0 - penalty / torch.exp2(d) + eps
    else:
        fac = 1.0 - torch.exp2(torch.tensor(penalty, dtype=torch.float32,
                                            device=d.device) - 1.0 - d) + eps
    return torch.where(penalty >= d + 1.0, eps, fac)


def _obj2(g, h, w, l1, l2):
    """2x the objective reduction at leaf output ``w``: equals
    :func:`_leaf_score` at the unclamped optimum, so constrained gains
    reduce to the unconstrained formula where no bound binds."""
    return -(2.0 * g * w + (h + l2) * w * w + 2.0 * l1 * torch.abs(w))


def _clip(x, lo, hi):
    """``jnp.clip``: max with ``lo``, then min with ``hi``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _gain_matrix(hist, sum_g, sum_h, sum_c, num_bins, feature_mask,
                 node_depth, p: GrowthParams, node_lo=None, node_hi=None,
                 mono_c=None):
    """Split-gain matrix (..., F, B) with invalid candidates at -inf, plus
    the cumulative left sums (gl, hl, cl), for histograms (..., F, B, 3)
    and node stats of shape (...).  A split at bin b sends bins <= b
    left, b ∈ [0, B-2].

    With ``mono_c`` ((F,) int32 in {-1, 0, 1}) and the nodes' output
    bounds ``node_lo``/``node_hi`` (...), gains come from the clamped
    child outputs, splits whose clamped outputs break their feature's
    direction are discarded, and constrained features' gains are
    penalized by depth (``monotone_penalty``)."""
    B = hist.shape[-2]
    # one scan over the three channels at once: the same adds per channel
    gl, hl, cl = _prefix_sum(hist.movedim(-1, 0))
    sg, sh, sc = sum_g[..., None, None], sum_h[..., None, None], \
        sum_c[..., None, None]
    gr, hr, cr = sg - gl, sh - hl, sc - cl
    l1, l2 = p.lambda_l1, p.lambda_l2
    if mono_c is None:
        gain = (_leaf_score(gl, hl, l1, l2) + _leaf_score(gr, hr, l1, l2)
                - _leaf_score(sg, sh, l1, l2))
    else:
        lo, hi = node_lo[..., None, None], node_hi[..., None, None]
        wl = _clip(_leaf_output(gl, hl, l1, l2), lo, hi)
        wr = _clip(_leaf_output(gr, hr, l1, l2), lo, hi)
        wp = _clip(_leaf_output(sg, sh, l1, l2), lo, hi)
        gain = (_obj2(gl, hl, wl, l1, l2) + _obj2(gr, hr, wr, l1, l2)
                - _obj2(sg, sh, wp, l1, l2))
        cvec = mono_c[..., None]
        viol = ((cvec == 1) & (wl > wr)) | ((cvec == -1) & (wl < wr))
        gain = torch.where(viol, -torch.inf, gain)
        if p.monotone_penalty > 0.0:
            fac = _mono_penalty_factor(node_depth, p.monotone_penalty)
            gain = torch.where(cvec != 0, gain * fac[..., None, None], gain)
    bins_idx = torch.arange(B, device=hist.device)[None, :]
    valid = ((cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
             & (hl >= p.min_sum_hessian_in_leaf)
             & (hr >= p.min_sum_hessian_in_leaf)
             & (bins_idx < num_bins[..., None])   # inside feature's bin range
             & (bins_idx < B - 1)
             & feature_mask[..., None])
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
                node_depth, p: GrowthParams, node_lo=None, node_hi=None,
                mono_c=None):
    """Best (gain, feature, bin, left sums) per node histogram (..., F, B,
    3)."""
    return _pick(*_gain_matrix(hist, sum_g, sum_h, sum_c, num_bins,
                               feature_mask, node_depth, p, node_lo,
                               node_hi, mono_c))


def _best_split_voting(local_hist, sum_g, sum_h, sum_c, num_bins,
                       feature_mask, node_depth, p: GrowthParams,
                       psum: Callable, node_lo=None, node_hi=None,
                       mono_c=None):
    """Voting-parallel split selection (LightGBM ``voting_parallel``, the
    PV-Tree algorithm) for a batch of n nodes: ``local_hist`` (n, F, B,
    3) holds this rank's histograms, ``sum_*`` (n,) the nodes' global
    stats, ``psum`` sums a tensor across the ranks.

    Each rank ranks the features by their best gain against its LOCAL
    node stats and votes for its top ``voting_k``; one psum of the (n, F)
    votes lets every rank select the same global top 2k features (votes
    descending, lower index first: the score ``votes·(F+1) + (F-1-f)``
    is exact in f32 and has no ties), and one psum of the selected (n,
    2k, B, 3) histograms gives the global best split among them →
    (gain, feature, bin, gl, hl, cl), each (n,).  The JAX package's
    ``_best_split_voting`` for one node; the batch shares the two
    psums."""
    n, F, B, _ = local_hist.shape
    dev = local_hist.device
    k = min(p.voting_k, F)
    sel_n = min(2 * k, F)
    # (1) the local view: the local node sums live in every feature's
    # bins; feature 0's scan gives them
    lsum = _prefix_sum(local_hist[:, 0].transpose(1, 2))[..., -1]  # (n, 3)
    lgain, _ = _gain_matrix(local_hist, lsum[:, 0], lsum[:, 1], lsum[:, 2],
                            num_bins, feature_mask, node_depth, p, node_lo,
                            node_hi, mono_c)
    tv, top = _topk_index(lgain.max(dim=-1).values, k)        # (n, k)
    votes = psum(torch.zeros((n, F), dtype=torch.float32, device=dev)
                 .scatter_add_(1, top.long(),
                               (tv > -torch.inf).to(torch.float32)))
    # (2) the same global top 2k on every rank
    rev = torch.arange(F - 1, -1, -1, dtype=torch.float32, device=dev)
    sel = _topk_index(votes * float(F + 1) + rev, sel_n)[1]   # (n, sel_n)
    sl = sel.long()
    # (3) only the voted features' histograms cross the ranks
    glob = psum(torch.take_along_dim(local_hist, sl[:, :, None, None], 1))
    ggain, cum = _gain_matrix(glob, sum_g, sum_h, sum_c, num_bins[sl],
                              feature_mask[sl], node_depth, p, node_lo,
                              node_hi, None if mono_c is None else mono_c[sl])
    g, bi, bb, gl, hl, cl = _pick(ggain, cum)
    return g, sel.gather(1, bi.long()[:, None])[:, 0], bb, gl, hl, cl


# -- monotone constraints ----------------------------------------------------

def _mono_vec(p: GrowthParams, F: int, device) -> Optional[torch.Tensor]:
    """(F,) int32 constraint vector padded/truncated to ``F`` features, or
    None when unconstrained."""
    if p.monotone_constraints is None or not any(p.monotone_constraints):
        return None
    c = tuple(p.monotone_constraints)[:F]
    c = c + (0,) * (F - len(c))
    return torch.tensor(c, dtype=torch.int32, device=device)


def _mono_child_bounds(cf, lo, hi, wl, wr):
    """Child output bounds after a split on a feature of constraint
    ``cf`` (basic method): the clamped child outputs' midpoint caps the
    side that would break the direction; unconstrained split features
    pass the bounds through."""
    mid = 0.5 * (wl + wr)
    l_lo = torch.where(cf == -1, torch.maximum(lo, mid), lo)
    l_hi = torch.where(cf == 1, torch.minimum(hi, mid), hi)
    r_lo = torch.where(cf == 1, torch.maximum(lo, mid), lo)
    r_hi = torch.where(cf == -1, torch.minimum(hi, mid), hi)
    return l_lo, l_hi, r_lo, r_hi


def _mono_node_bounds(mono_cf, p_lo, p_hi, lg, lh, rg, rh, p: GrowthParams):
    """One split's child bounds: the parent's when unconstrained
    (``mono_cf`` None), else the children's leaf outputs clamped to the
    parent's bounds and the violating side capped at their midpoint."""
    if mono_cf is None:
        return p_lo, p_hi, p_lo, p_hi
    wl = _clip(_leaf_output(lg, lh, p.lambda_l1, p.lambda_l2), p_lo, p_hi)
    wr = _clip(_leaf_output(rg, rh, p.lambda_l1, p.lambda_l2), p_lo, p_hi)
    return _mono_child_bounds(mono_cf, p_lo, p_hi, wl, wr)


def _bool_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean matrix product (exact: 0/1 products, sums below 2^24)."""
    return (a.to(torch.float32) @ b.to(torch.float32)) > 0


def _descendants(left_child, right_child) -> torch.Tensor:
    """(M, M) bool: ``desc[a, i]`` when node i lies in a's subtree (a
    included), by squaring the child relation to its closure."""
    M = left_child.shape[0]
    dev = left_child.device
    ar = torch.arange(M, device=dev)
    desc = torch.eye(M, dtype=torch.bool, device=dev)
    internal = left_child >= 0
    for child in (left_child, right_child):
        c = child.clamp_min(0).long()
        desc[ar, c] = desc[ar, c] | internal       # no data-sized shape
    for _ in range(max(int(np.ceil(np.log2(max(M, 2)))), 1)):
        desc = desc | _bool_mm(desc, desc)
    return desc


def _intermediate_bounds(split_feature, left_child, right_child, raw_value,
                         mono_c):
    """Intermediate-method bounds: a constrained split bounds each child
    subtree by the opposite subtree's leaf outputs.  The constraints are
    explicit pairs (for a split at node a on a feature with c=+1, every
    node of L(a) <= every leaf of R(a), every node of R(a) >= every leaf
    of L(a)), projected by :func:`_project_pairs`.  → (lo, hi, clamped
    value), each (M,)."""
    leaf = left_child < 0
    desc = _descendants(left_child, right_child)
    internal = left_child >= 0
    inL = desc[left_child.clamp_min(0).long()] & internal[:, None]
    inR = desc[right_child.clamp_min(0).long()] & internal[:, None]
    c = torch.where(internal, mono_c[split_feature.clamp_min(0).long()], 0)
    inc, dec = (c == 1)[:, None], (c == -1)[:, None]
    low_side = (inc & inL) | (dec & inR)
    high_side = (inc & inR) | (dec & inL)
    P = _bool_mm(low_side.t(), high_side & leaf[None, :])
    Q = _bool_mm(high_side.t(), low_side & leaf[None, :])
    return _project_pairs(P, Q, raw_value, leaf)


def _project_pairs(P, Q, raw_value, leaf):
    """Feasible monotone values and bounds from explicit constraints:
    ``P[i, j]``: ``val_i <= val_j``, ``Q[i, j]``: ``val_i >= val_j``, j a
    leaf.  Leaves take ``(L + U) / 2`` with ``L`` the max of the raw
    values over the leaf's transitive predecessors (itself included) and
    ``U`` the min over its successors: feasible by construction, and the
    raw value wherever that already was.  Internal nodes clamp to the
    bounds the leaf values imply.  → (lo, hi, val), each (M,)."""
    M = raw_value.shape[0]
    close = P & leaf[:, None]
    for _ in range(max(int(np.ceil(np.log2(max(M, 2)))), 1)):
        close = close | _bool_mm(close, close)
    inf = torch.full_like(raw_value, torch.inf)[None, :]
    L = torch.maximum(raw_value, torch.where(
        close.t(), raw_value[None, :], -inf).max(dim=1).values)
    U = torch.minimum(raw_value, torch.where(
        close, raw_value[None, :], inf).min(dim=1).values)
    vleaf = torch.where(leaf, 0.5 * (L + U), raw_value)
    hi = torch.where(P, vleaf[None, :], inf).min(dim=1).values
    lo = torch.where(Q, vleaf[None, :], -inf).max(dim=1).values
    return lo, hi, torch.where(leaf, vleaf, _clip(raw_value, lo, hi))


def _advanced_bounds(split_feature, split_bin, left_child, right_child,
                     raw_value, mono_c, total_bins: int):
    """Advanced-method bounds: the exact minimal constraint set for one
    tree's monotonicity.  ``val_i <= val_j`` is required iff leaves i and
    j are ordered on a constrained feature f (i's bin box strictly left
    of j's) and their boxes overlap on every other feature.  Each node's
    bin box (lo, hi] per feature comes from its ancestors' splits.  Needs
    O(M^2 F) memory (``booster._advanced_mask_budget_bytes``).  → (lo, hi,
    clamped value), each (M,)."""
    F = mono_c.shape[0]
    M = split_feature.shape[0]
    leaf = left_child < 0
    desc = _descendants(left_child, right_child)
    internal = (left_child >= 0)[:, None]
    inL = desc[left_child.clamp_min(0).long()] & internal    # (a, i)
    inR = desc[right_child.clamp_min(0).long()] & internal
    # hi[i, f]: the smallest split bin of an ancestor a on f with i in
    # L(a); lo[i, f]: the largest of one with i in R(a).  Each ancestor
    # splits on one feature, so (a, i) pairs reduce into (i, f) directly.
    on_a = split_feature.clamp_min(0).long()[None, :].expand(M, M)
    sb = split_bin[:, None].to(torch.int32)
    hi = torch.full((M, F), total_bins - 1, dtype=torch.int32,
                    device=split_feature.device).scatter_reduce_(
        1, on_a, torch.where(inL, sb, total_bins - 1).T, "amin")
    lo = torch.full_like(hi, -1).scatter_reduce_(
        1, on_a, torch.where(inR, sb, -1).T, "amax")
    # boxes (lo, hi] intersect iff lo_i < hi_j and lo_j < hi_i; ov_exc:
    # they intersect on every feature but f.  The (M, M, F) bool masks
    # live at most five at a time, the 5 bytes an entry that
    # booster._advanced_mask_budget_bytes is held against.
    ov = (lo[:, None, :] < hi[None, :, :]) & (lo[None, :, :] < hi[:, None, :])
    n_ov = ov.sum(-1, dtype=torch.int32)[:, :, None]
    ov_exc = torch.where(ov, n_ov == F, n_ov == F - 1)
    del ov
    inc_f = ov_exc & (mono_c == 1)
    dec_f = ov_exc & (mono_c == -1)
    del ov_exc
    ordered = hi[:, None, :] <= lo[None, :, :]          # i left of j on f
    ordered_t = ordered.transpose(0, 1)
    P_any = ((ordered & inc_f).any(-1)) | ((ordered_t & dec_f).any(-1))
    Q_any = ((ordered_t & inc_f).any(-1)) | ((ordered & dec_f).any(-1))
    return _project_pairs(P_any & leaf[None, :], Q_any & leaf[None, :],
                          raw_value, leaf)


def _tree_bounds(split_feature, split_bin, left_child, right_child,
                 raw_value, mono_c, p: GrowthParams):
    """Whole-tree bounds for ``p.monotone_method`` (intermediate or
    advanced) → (lo, hi, clamped value)."""
    if p.monotone_method == "advanced":
        return _advanced_bounds(split_feature, split_bin, left_child,
                                right_child, raw_value, mono_c, p.total_bins)
    return _intermediate_bounds(split_feature, left_child, right_child,
                                raw_value, mono_c)


def _refresh_on(mono_c, p: GrowthParams) -> bool:
    return mono_c is not None and p.monotone_method in ("intermediate",
                                                        "advanced")


# -- EFB ----------------------------------------------------------------------

def _slot_route_params(feat, tbin, B: int, bundle_map):
    """Routing of splits chosen on ORIGINAL features → (col, t1, rlo, rhi,
    dflt): rows of column ``col`` go left iff ``x in (rlo, rhi] ? x <= t1
    : dflt``.  Plain training routes the feature's own column with the
    full range (``x <= tbin``); under EFB the split feature's bundled
    range maps the original-bin threshold onto the bundled column (rank(b)
    = b + (b < default)), and rows outside the range (the feature at its
    default bin) take the default bin's direction."""
    if bundle_map is None:
        return (feat, tbin, torch.full_like(feat, -1),
                torch.full_like(feat, B), torch.ones_like(feat))
    f = feat.long()
    col = bundle_map["col"][f]
    lo = bundle_map["lo"][f]
    d = bundle_map["default_bin"][f]
    t1 = lo + tbin + (tbin < d).to(tbin.dtype)
    return col, t1, lo, bundle_map["hi"][f], (d <= tbin).to(torch.int32)


def _unbundle_hists(hists, gather_src, tot):
    """Bundled histograms (..., Fb, Bb, C) → ORIGINAL-feature histograms
    (..., F, B, C) by gather; a feature's DEFAULT bin takes the residual
    ``tot`` (..., C) minus its other bins (the rows at its default sit at
    bundled bin 0 or inside other features' ranges), out-of-range bins
    take 0.  Any dtype: the growers unbundle the kernels' int64 limb
    sums, where the residual is exact."""
    lead = hists.shape[:-3]
    F, B = gather_src.shape
    C = hists.shape[-1]
    flat = hists.reshape(lead + (-1, C))
    V = flat.index_select(-2, gather_src.clamp_min(0).reshape(-1).long())
    V = V.reshape(lead + (F, B, C))
    V = torch.where((gather_src >= 0)[..., None], V, torch.zeros_like(V))
    resid = tot[..., None, None, :] - V.sum(dim=-2, keepdim=True)
    return torch.where((gather_src == -2)[..., None], resid, V)


def _node_hists(limbs, scales, bundle_map=None):
    """A kernel's int32 limb sums (R, Bh, S, 8) → (S, F, Bh, 3) f32
    [grad, hess, count] histograms.  Under EFB (R bundled columns) they
    unbundle first, in int64 limb space with every row's limbs counted
    once by bundled column 0, so each original feature's histogram is
    exactly the one its own column would give."""
    h = limbs.permute(2, 0, 1, 3)
    if bundle_map is not None:
        h = h.to(torch.int64)
        h = _unbundle_hists(h, bundle_map["gather_src"], h[:, 0].sum(dim=1))
    return _reconstruct(h, scales)


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
                  num_bins, num_bins_c, feature_mask, p: GrowthParams,
                  ar: Callable = lambda h: h):
    """The two-level root, shared by both growers: coarse gains → the
    tree's refined feature set → the root's fine histograms of those
    features (K1 by id) → the merged root pick.  The refined set is chosen
    ONCE per tree from the root's coarse per-feature gains, so every later
    build refines left children only and derives right children by fine
    subtraction.  ``ar`` sums the refined build across data-parallel
    ranks.  → (topk (K,) int32, root_fine (1, K, B, 3), the root's
    (gain, feature, bin, gl, hl, cl))."""
    B = p.total_bins
    z1 = torch.zeros(1, dtype=torch.int32, device=bins_t.device)
    g, h, c = (root_stats[i][None] for i in range(3))
    cg0, ccum0, fgain0 = _tl_coarse_gains(root_hist[None], g, h, c, z1,
                                          num_bins_c, feature_mask, p)
    topk = _topk_index(fgain0[0], p.refine_k)[1]
    rslot = torch.where(row_valid > 0, 0, -1).to(torch.int32)
    root_fine = ar(build_hist_nodes(bins_t, rslot, vals8, scales, 1, B,
                                    feat=topk))
    rbest = _tl_final_pick(cg0, ccum0, root_fine, topk, g, h, c, z1,
                           num_bins, feature_mask, p, TWO_LEVEL_SHIFT)
    return topk, root_fine, tuple(x[0] for x in rbest)


def _two_level_on(p: GrowthParams, F: int, N: int, bundle_map=None) -> bool:
    """Two-level histograms: wide bins, a refined set smaller than the
    features, and enough rows (or "on"); never under EFB or monotone
    constraints, whose splits the JAX package keeps at full
    resolution."""
    mono = bool(p.monotone_constraints) and any(p.monotone_constraints)
    return (p.refine_k > 0 and p.two_level != "off" and p.total_bins >= 128
            and bundle_map is None and not mono and F > p.refine_k
            and (p.two_level == "on" or N >= TWO_LEVEL_MIN_ROWS))


def _route_left(xb, t1, rlo, rhi, dflt):
    in_range = (xb > rlo) & (xb <= rhi)
    return torch.where(in_range, xb <= t1, dflt != 0)


def default_n_slots(num_leaves: int) -> int:
    """Node slots per wave: 16, fewer when the leaf budget is smaller."""
    return max(1, min(16, num_leaves - 1))


def grow_tree_depthwise(bins_t: torch.Tensor,       # (Fb, N) int32
                        grad: torch.Tensor,         # (N,) f32 or bf16
                        hess: torch.Tensor,         # (N,) f32 or bf16
                        row_valid: torch.Tensor,    # (N,) f32 row weight
                        feature_mask: torch.Tensor,     # (F,) bool
                        upper_bounds: torch.Tensor,     # (F, B-1) f32
                        num_bins: torch.Tensor,         # (F,) int32
                        learning_rate: float,
                        p: GrowthParams,
                        n_slots: int = 16,
                        bundle_map: Optional[dict] = None,
                        hist_allreduce: Optional[Callable] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree wave by wave → (tree, per-row leaf node ids).

    Within a wave the best ``n_slots`` splittable leaves split together;
    one :func:`~.hist.route_and_hist_ids_limbs` pass routes their rows and
    builds the left children's histograms (right children by subtraction
    from the parent), reading the split and refined features' bins in
    place by their row ids.  All tensors lie on one device; the
    histogram kernels run there.  ``bundle_map`` (EFB,
    ``FeatureBundler.route_tables`` on the device): ``bins_t`` holds the
    bundled columns, while the features, bounds and the tree are the
    original ones.  ``hist_allreduce``: the data-parallel sum of a
    decoded histogram across ranks (see the module docstring)."""
    ar = hist_allreduce or (lambda h: h)
    dev = bins_t.device
    i32, f32 = torch.int32, torch.float32
    N = bins_t.shape[1]
    F = num_bins.shape[0]          # original features (bundles under EFB)
    B = p.total_bins
    L = p.num_leaves
    M = max_nodes(L)
    S = n_slots
    JUNK = M - 1              # node index never reached (num_nodes <= M-1)
    mono_c = _mono_vec(p, F, dev)
    refresh = _refresh_on(mono_c, p)

    def ifull(n, v):
        return torch.full((n,), v, dtype=i32, device=dev)

    vals8, scales = prep_hist_vals(grad, hess, row_valid)
    tl = _two_level_on(p, F, N, bundle_map)
    SH = TWO_LEVEL_SHIFT
    Bh = coarse_bins(B, SH) if tl else B   # stored-histogram width
    K = p.refine_k
    num_bins = num_bins.to(i32)
    num_bins_c = (num_bins + (1 << SH) - 1) >> SH
    depth0 = torch.zeros((), dtype=i32, device=dev)

    def pick(hists, g, h, c, d, lo, hi):
        return _best_split(hists, g, h, c, num_bins, feature_mask, d, p, lo,
                           hi, mono_c)

    # root: one pass with every row in one slot, riding the fused kernel
    # with a degenerate all-left split of leaf 0 (t1=B → every row left,
    # child id 0 → node ids unchanged)
    out = route_and_hist_ids_limbs(
        bins_t, torch.zeros(N, dtype=i32, device=dev), ifull(1, 0),
        ifull(1, 0), ifull(1, B), ifull(1, -1), ifull(1, B), ifull(1, 1),
        ifull(1, 0), ifull(1, 0), vals8, 1, B,
        hist_shift=(SH if tl else 0))
    root_hist = ar(_node_hists(out[1], scales, bundle_map)[0])  # (F, Bh, 3)
    # the scan's last entry: the same adds in the same order on every
    # device (see _prefix_sum)
    root_stats = _prefix_sum(root_hist[0].t())[:, -1]
    root_g, root_h, root_c = root_stats[0], root_stats[1], root_stats[2]
    node_lo = torch.full((M,), -torch.inf, dtype=f32, device=dev)
    node_hi = torch.full((M,), torch.inf, dtype=f32, device=dev)

    topk = None
    if tl:
        topk, root_fine, rbest = _tl_root_pick(
            bins_t, root_hist, root_stats, row_valid, vals8, scales,
            num_bins, num_bins_c, feature_mask, p, ar)
        bg, bf_, bb, bgl, bhl, bcl = rbest
    else:
        bg, bf_, bb, bgl, bhl, bcl = pick(root_hist, root_g, root_h, root_c,
                                          depth0, node_lo[0], node_hi[0])

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
        # the universal routing form: the full range, or under EFB the
        # split feature's range in its bundled column
        col, t1, rlo, rhi, dflt = _slot_route_params(bf_p, bb_p, B,
                                                     bundle_map)
        last_wave = leaves + nv >= L
        if last_wave:
            # this wave fills the leaf budget: its children never split
            # again, so it routes in plain tensor code and skips the
            # histogram pass, as the JAX grower does
            new_node_id = node_id
            for j, c in enumerate(col[:nv].tolist()):
                gl = _route_left(bins_t[c], t1[j], rlo[j], rhi[j], dflt[j])
                new_node_id = torch.where(
                    node_id == parents[j],
                    torch.where(gl, l_ids[j], r_ids[j]), new_node_id)
        else:
            out = route_and_hist_ids_limbs(
                bins_t, node_id, parents, col, t1, rlo, rhi, dflt, l_ids,
                r_ids, vals8, S, B, hist_shift=(SH if tl else 0),
                feat_k=topk)
            new_node_id = out[0]
            # only the wave's nv real slots are read: they are reduced
            l_hists = ar(_node_hists(out[1], scales, bundle_map)[:nv])
            lf = ar(_node_hists(out[2], scales)[:nv]) if tl else None

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
        if mono_c is not None and not refresh:
            l_lo, l_hi, r_lo, r_hi = _mono_node_bounds(
                mono_c[bf_p[:nv].long()], node_lo[pl], node_hi[pl], lg, lh,
                rg, rh, p)
            node_lo[cids] = torch.cat([l_lo, r_lo])
            node_hi[cids] = torch.cat([l_hi, r_hi])
        bfv, bbv = bf_p[:nv], bb_p[:nv]
        split_feature[pl] = bfv
        split_bin[pl] = bbv
        split_gain[pl] = best_gain[pl]
        threshold[pl] = torch.where(
            bbv >= 1,
            upper_bounds[bfv.long(), torch.clamp_min(bbv - 1, 0).long()],
            -torch.inf)
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
            # the budget-filling wave's children never split again: their
            # histograms and picks would never be read
            break
        l_flat = l_hists.reshape(nv, F * Bh, 3)
        r_flat = hist[pslot] - l_flat
        hist[pslot] = l_flat
        hist[r_slots] = r_flat
        child_hists = torch.cat([l_flat, r_flat]).reshape(2 * nv, F, Bh, 3)
        if refresh:
            # intermediate / advanced: the whole tree's bounds, on the
            # device; this wave's children pick under them
            node_lo, node_hi, _ = _tree_bounds(
                split_feature, split_bin, left_child, right_child,
                _leaf_output(sum_g, sum_h, p.lambda_l1, p.lambda_l2), mono_c,
                p)
        if tl:
            cgm, ccum, _ = _tl_coarse_gains(
                child_hists, cg, ch, cc, cd, num_bins_c, feature_mask, p)
            lf_flat = lf.reshape(nv, K * B, 3)
            rf_flat = hist_f[pslot] - lf_flat
            hist_f[pslot] = lf_flat
            hist_f[r_slots] = rf_flat
            f_hists = torch.cat([lf_flat, rf_flat]).reshape(2 * nv, K, B, 3)
            picks = _tl_final_pick(cgm, ccum, f_hists, topk, cg, ch, cc, cd,
                                   num_bins, feature_mask, p, SH)
        else:
            picks = pick(child_hists, cg, ch, cc, cd, node_lo[cids],
                         node_hi[cids])
        for t, v in zip((best_gain, best_feat, best_bin, best_gl, best_hl,
                         best_cl), picks):
            t[cids] = v

    return _finish_tree(split_feature, split_bin, threshold, split_gain,
                        left_child, right_child, sum_g, sum_h, sum_c,
                        num_nodes, node_lo, node_hi, mono_c, learning_rate,
                        p), node_id


def _finish_tree(split_feature, split_bin, threshold, split_gain, left_child,
                 right_child, sum_g, sum_h, sum_c, num_nodes: int, node_lo,
                 node_hi, mono_c, learning_rate: float, p: GrowthParams):
    """The grown tree: node outputs from the node sums, under monotone
    constraints clamped to the basic method's bounds or projected by the
    whole-tree refresh, then shrunk."""
    dev = sum_g.device
    M = sum_g.shape[0]
    node_value = _leaf_output(sum_g, sum_h, p.lambda_l1, p.lambda_l2)
    if _refresh_on(mono_c, p):
        node_value = _tree_bounds(split_feature, split_bin, left_child,
                                  right_child, node_value, mono_c, p)[2]
    elif mono_c is not None:
        node_value = _clip(node_value, node_lo, node_hi)
    node_value = learning_rate * node_value
    leaf_value = torch.where(left_child < 0, node_value, 0.0)
    return Tree(split_feature=split_feature, split_bin=split_bin,
                threshold=threshold, split_gain=split_gain,
                left_child=left_child, right_child=right_child,
                leaf_value=leaf_value, node_value=node_value,
                num_nodes=torch.tensor(num_nodes, dtype=torch.int32,
                                       device=dev),
                default_left=torch.ones(M, dtype=torch.bool, device=dev),
                node_count=sum_c,
                missing_zero=torch.zeros(M, dtype=torch.bool, device=dev))


def grow_tree(bins_t: torch.Tensor,         # (Fb, N) int32
              grad: torch.Tensor,           # (N,) f32 or bf16
              hess: torch.Tensor,           # (N,) f32 or bf16
              row_valid: torch.Tensor,      # (N,) f32 bag or GOSS weight
              feature_mask: torch.Tensor,   # (F,) bool
              upper_bounds: torch.Tensor,   # (F, B-1) f32
              num_bins: torch.Tensor,       # (F,) int32
              learning_rate: float,
              p: GrowthParams,
              bundle_map: Optional[dict] = None,
              hist_allreduce: Optional[Callable] = None,
              vote_psum: Optional[Callable] = None
              ) -> Tuple[Tree, torch.Tensor]:
    """Strict leaf-wise (lossguide) growth → (tree, per-row leaf node ids).

    Each of at most ``num_leaves - 1`` splits takes the leaf of largest
    gain, routes its rows, builds the left child's histogram with K1 at
    one slot over the left child's rows (coarse when two-level is on,
    plus the refined features' fine histograms by id) and the right
    child's by subtraction from the parent, then picks both children's
    best splits.  One host sync per split decides whether any leaf can
    still split (the JAX grower's ``lax.cond``); everything else stays on
    the device, with the chosen leaf as a one-element index tensor.
    ``bundle_map`` and ``hist_allreduce``: as in
    :func:`grow_tree_depthwise`.

    Voting-parallel growth (``p.voting_k`` > 0 with ``vote_psum``, the
    sum across the ranks of the mesh's data axis): each rank's
    histograms stay local, the root's feature-0 histogram is summed for
    the global root stats (the data-parallel grower's scan over the same
    sums), and every pick is :func:`_best_split_voting` (two psums for
    both children of a split); two-level is off, as in the JAX
    package."""
    voting = p.voting_k > 0 and vote_psum is not None
    ar = (lambda h: h) if voting else (hist_allreduce or (lambda h: h))
    dev = bins_t.device
    i32, f32 = torch.int32, torch.float32
    N = bins_t.shape[1]
    F = num_bins.shape[0]          # original features (bundles under EFB)
    B = p.total_bins
    L = p.num_leaves
    M = max_nodes(L)
    mono_c = _mono_vec(p, F, dev)
    refresh = _refresh_on(mono_c, p)
    tl = _two_level_on(p, F, N, bundle_map) and not voting
    SH = TWO_LEVEL_SHIFT if tl else 0
    Bh = coarse_bins(B, SH) if tl else B
    K = p.refine_k
    num_bins = num_bins.to(i32)
    num_bins_c = (num_bins + (1 << TWO_LEVEL_SHIFT) - 1) >> TWO_LEVEL_SHIFT

    vals8, scales = prep_hist_vals(grad, hess, row_valid)
    valid = row_valid > 0

    def build(in_node):
        """K1 at one slot over the rows of ``in_node`` that carry weight
        → (F, Bh, 3), unbundled under EFB."""
        slot = torch.where(in_node & valid, 0, -1).to(i32)
        return ar(_node_hists(build_hist_nodes_limbs(
            bins_t, slot, vals8, 1, B, hist_shift=SH), scales,
            bundle_map)[0])

    def pick(hists, g, h, c, d, lo, hi):
        if voting:
            return _best_split_voting(hists, g, h, c, num_bins,
                                      feature_mask, d, p, vote_psum, lo, hi,
                                      mono_c)
        return _best_split(hists, g, h, c, num_bins, feature_mask, d, p, lo,
                           hi, mono_c)

    node_lo = torch.full((M,), -torch.inf, dtype=f32, device=dev)
    node_hi = torch.full((M,), torch.inf, dtype=f32, device=dev)
    root_hist = build(torch.ones_like(valid))
    # the scan's last entry: the same adds in the same order on every
    # device (see _prefix_sum); under voting over the summed feature 0
    root_stats = _prefix_sum((vote_psum(root_hist[0]) if voting
                              else root_hist[0]).t())[:, -1]
    topk = None
    if tl:
        topk, root_fine, rbest = _tl_root_pick(
            bins_t, root_hist, root_stats, row_valid, vals8, scales,
            num_bins, num_bins_c, feature_mask, p, ar)
    elif voting:
        rbest = tuple(x[0] for x in pick(
            root_hist[None], root_stats[0:1], root_stats[1:2],
            root_stats[2:3], torch.zeros(1, dtype=i32, device=dev),
            node_lo[:1], node_hi[:1]))
    else:
        rbest = pick(root_hist, root_stats[0], root_stats[1], root_stats[2],
                     torch.zeros((), dtype=i32, device=dev), node_lo[0],
                     node_hi[0])

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
        col, t1, rlo, rhi, dflt = _slot_route_params(feat, sbin, B,
                                                     bundle_map)
        go_left = _route_left(bins_t.index_select(0, col.long())[0], t1,
                              rlo, rhi, dflt)
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
        slot[l_id] = pslot[0]
        slot[r_id] = r_slot
        sum_g[kids], sum_h[kids], sum_c[kids] = cg, ch, cc
        depth[kids] = cd
        if refresh:
            # intermediate / advanced: the whole tree's bounds, on the
            # device; both children pick under them
            node_lo, node_hi, _ = _tree_bounds(
                split_feature, split_bin, left_child, right_child,
                _leaf_output(sum_g, sum_h, p.lambda_l1, p.lambda_l2), mono_c,
                p)
        elif mono_c is not None:
            l_lo, l_hi, r_lo, r_hi = _mono_node_bounds(
                mono_c[feat.long()], node_lo[leaf], node_hi[leaf], cg[:1],
                ch[:1], cg[1:], ch[1:], p)
            node_lo[kids] = torch.cat([l_lo, r_lo])
            node_hi[kids] = torch.cat([l_hi, r_hi])
        if tl:
            lf = ar(_node_hists(build_hist_nodes_limbs(
                bins_t, torch.where(in_left & valid, 0, -1).to(i32), vals8,
                1, B, feat=topk), scales)).reshape(1, K * B, 3)
            rf = hist_f[pslot] - lf
            hist_f[pslot] = lf
            hist_f[r_slot] = rf[0]
            cgm, ccum, _ = _tl_coarse_gains(child_hists, cg, ch, cc, cd,
                                            num_bins_c, feature_mask, p)
            picks = _tl_final_pick(
                cgm, ccum, torch.cat([lf, rf]).reshape(2, K, B, 3), topk,
                cg, ch, cc, cd, num_bins, feature_mask, p, TWO_LEVEL_SHIFT)
        else:
            picks = pick(child_hists, cg, ch, cc, cd, node_lo[kids],
                         node_hi[kids])
        for t, v in zip((best_gain, best_feat, best_bin, best_gl, best_hl,
                         best_cl), picks):
            t[kids] = v
        active.index_fill_(0, leaf, False)
        active[kids] = True
        num_nodes += 2

    return _finish_tree(split_feature, split_bin, threshold, split_gain,
                        left_child, right_child, sum_g, sum_h, sum_c,
                        num_nodes, node_lo, node_hi, mono_c, learning_rate,
                        p), node_id


# -- feature-parallel growth ---------------------------------------------------

def _fp_mesh(mesh):
    from ...parallel.mesh import DATA_AXIS
    return mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS)


def _fp_route_left(bins_t, wf, wb, valid, B: int, F_loc: int, rank: int,
                   mesh, bundle_map=None) -> torch.Tensor:
    """Owner-exclusive routing of splits on GLOBAL features ``wf`` at
    bins ``wb`` (each (n,)): the rank that owns a split's feature routes
    every row through its own column (the universal routing form, so EFB
    columns too), the others contribute 0, and one psum of the (n, N)
    int8 masks gives every rank every split's go-left rows → (n, N)
    bool.  int8 on both backends: the owner-exclusive 0/1 masks sum to at
    most 1, and gloo and NCCL reduce int8 on CPU and CUDA tensors."""
    from ...parallel.collectives import psum
    mine = ((wf // F_loc) == rank) & valid
    floc = torch.clamp(wf - rank * F_loc, 0, F_loc - 1)
    col, t1, rlo, rhi, dflt = _slot_route_params(floc, wb, B, bundle_map)
    gl = _route_left(bins_t.index_select(0, col.long()), t1[:, None],
                     rlo[:, None], rhi[:, None], dflt[:, None])
    masks = (gl & mine[:, None]).to(torch.int8)
    return psum(masks, mesh, op="featpar_route_psum") > 0


def grow_tree_feature_parallel(bins_t: torch.Tensor,   # (Fb_loc, N) int32
                               grad: torch.Tensor,      # (N,) replicated
                               hess: torch.Tensor,      # (N,) replicated
                               row_valid: torch.Tensor,  # (N,) replicated
                               feature_mask: torch.Tensor,   # (F_loc,)
                               upper_bounds: torch.Tensor,   # (F_loc, B-1)
                               num_bins: torch.Tensor,       # (F_loc,)
                               learning_rate: float,
                               p: GrowthParams,
                               mesh,
                               n_slots: int = 16,
                               bundle_map: Optional[dict] = None
                               ) -> Tuple[Tree, torch.Tensor]:
    """Wave growth with the FEATURE axis sharded over the mesh's data axis
    (LightGBM's ``tree_learner=feature``) → (tree, per-row leaf node ids),
    the same tree on every rank; ``split_feature`` holds GLOBAL ids
    (rank · F_loc + local id).  The JAX package's
    ``grow_tree_feature_parallel``.

    Every rank holds all rows and its slice of the features (padded with
    masked one-bin features to the same F_loc on each rank).  Histograms
    never cross the ranks: each wave builds the left children of its
    splits node-batched with K1 over the rank's features
    (:func:`~.hist.build_hist_nodes_limbs`, all ``n_slots`` slots in one
    launch; the root is slot 0 of the same launch shape), the right
    children by subtraction.  Each node's local best split (gain, global
    feature, bin, left sums, the owner's threshold: a packed (7,) f32)
    rides one all-gather a wave, and the winner is the first rank of the
    largest gain, so ties go to the lower global feature as in the
    one-process pick.  The split owner's go-left rows reach every rank
    through one int8 psum of owner-exclusive (n, N) masks a wave
    (:func:`_fp_route_left`).

    The root stats are the scan of rank 0's feature-0 root histogram, as
    :func:`grow_tree_depthwise` takes them, so on the same data both
    growers make the same picks and the trees are equal bit for bit when
    the one-process fit runs without two-level histograms (this grower
    has no coarse/refined pass, as in the JAX package).  The
    budget-filling wave routes only.  ``n_slots`` = 1 is lossguide's
    strict best-first order (one split a wave).  Monotone constraints
    slice the global vector for the local picks; bounds and the
    intermediate/advanced refresh run replicated on the global tree.
    ``bundle_map``: this rank's EFB route tables over its bundled
    columns."""
    from ...parallel.collectives import all_gather
    rank, R = _fp_mesh(mesh)
    dev = bins_t.device
    i32, f32 = torch.int32, torch.float32
    N = bins_t.shape[1]
    F_loc = num_bins.shape[0]      # original features of this rank
    B = p.total_bins
    L = p.num_leaves
    M = max_nodes(L)
    S = n_slots
    num_bins = num_bins.to(i32)
    mono_global = _mono_vec(p, F_loc * R, dev)
    mono_local = (None if mono_global is None
                  else mono_global[rank * F_loc:(rank + 1) * F_loc])
    refresh = _refresh_on(mono_global, p)
    vals8, scales = prep_hist_vals(grad, hess, row_valid)

    def build(slot):
        """K1 over this rank's columns, all S slots → (S, F_loc, B, 3)."""
        return _node_hists(build_hist_nodes_limbs(bins_t, slot, vals8, S, B),
                           scales, bundle_map)

    def global_pick(hists, g, h, c, d, lo, hi):
        """Per node: the local best over this rank's features, then one
        all-gather of the packed (n, 7) picks → the winners' (gain,
        global feature, bin, gl, hl, cl, threshold)."""
        bg, bf, bb, bgl, bhl, bcl = _best_split(
            hists, g, h, c, num_bins, feature_mask, d, p, lo, hi, mono_local)
        thr = torch.where(bb >= 1, upper_bounds[
            bf.long(), torch.clamp_min(bb - 1, 0).long()], -torch.inf)
        packed = torch.stack([bg, (rank * F_loc + bf).to(f32), bb.to(f32),
                              bgl, bhl, bcl, thr], dim=-1)       # (n, 7)
        allp = all_gather(packed, mesh, op="featpar_pick_gather")
        win = allp[..., 0].argmax(dim=0)                         # first max
        w = allp.gather(0, win[None, :, None].expand(1, -1, 7))[0]
        return (w[:, 0], w[:, 1].to(i32), w[:, 2].to(i32), w[:, 3],
                w[:, 4], w[:, 5], w[:, 6])

    root_hist = build(torch.zeros(N, dtype=i32, device=dev))[0]
    # rank 0 owns global feature 0: its scan gives the root stats, as in
    # the one-process grower; an all-gather hands them on unchanged
    root_stats = all_gather(_prefix_sum(root_hist[0].t())[:, -1], mesh,
                            op="featpar_root_gather")[0]
    node_lo = torch.full((M,), -torch.inf, dtype=f32, device=dev)
    node_hi = torch.full((M,), torch.inf, dtype=f32, device=dev)
    rbest = global_pick(root_hist[None], root_stats[0:1], root_stats[1:2],
                        root_stats[2:3], torch.zeros(1, dtype=i32,
                                                     device=dev),
                        node_lo[:1], node_hi[:1])

    zi = torch.zeros(M, dtype=i32, device=dev)
    zf = torch.zeros(M, dtype=f32, device=dev)
    node_id = torch.zeros(N, dtype=i32, device=dev)
    hist = torch.zeros((L + 2, F_loc * B, 3), dtype=f32, device=dev)
    hist[0] = root_hist.reshape(F_loc * B, 3)
    slot = zi.clone()
    sum_g, sum_h, sum_c = zf.clone(), zf.clone(), zf.clone()
    sum_g[0], sum_h[0], sum_c[0] = root_stats
    depth = zi.clone()
    best_gain = torch.full((M,), -torch.inf, dtype=f32, device=dev)
    best_feat, best_bin = zi.clone(), zi.clone()
    best_gl, best_hl, best_cl, best_thr = (zf.clone(), zf.clone(),
                                           zf.clone(), zf.clone())
    bests = (best_gain, best_feat, best_bin, best_gl, best_hl, best_cl,
             best_thr)
    for t, v in zip(bests, rbest):
        t[0] = v[0]
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
        tv, ti = _topk_index(gains, S)
        valid = (tv > p.min_gain_to_split) & (jidx < L - leaves)
        nv = int(valid.sum())        # a prefix: the sort packs them first
        if leaves >= L or nv == 0:
            break
        pl = ti[:nv].long()
        j = jidx[:nv]
        lid = (num_nodes + 2 * j).long()
        rid = lid + 1
        wf, wb = best_feat[pl], best_bin[pl]
        gl_slots = _fp_route_left(bins_t, wf, wb, valid[:nv], B, F_loc,
                                  rank, mesh, bundle_map)        # (nv, N)
        slot_of = torch.full((M,), -1, dtype=torch.long, device=dev)
        slot_of[pl] = j.long()
        rslot = slot_of[node_id.long()]
        routed = rslot >= 0
        rs = rslot.clamp_min(0)
        go_left = gl_slots.gather(0, rs[None])[0] & routed
        new_node_id = torch.where(routed, torch.where(
            go_left, lid[rs], rid[rs]), node_id.long()).to(i32)
        last_wave = leaves + nv >= L
        if not last_wave:
            l_hists = build(torch.where(go_left, rs, -1).to(i32))[:nv]

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
        if mono_global is not None and not refresh:
            l_lo, l_hi, r_lo, r_hi = _mono_node_bounds(
                mono_global[wf.long()], node_lo[pl], node_hi[pl], lg, lh,
                rg, rh, p)
            node_lo[cids] = torch.cat([l_lo, r_lo])
            node_hi[cids] = torch.cat([l_hi, r_hi])
        split_feature[pl] = wf
        split_bin[pl] = wb
        split_gain[pl] = best_gain[pl]
        threshold[pl] = best_thr[pl]
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
        l_flat = l_hists.reshape(nv, F_loc * B, 3)
        r_flat = hist[pslot] - l_flat
        hist[pslot] = l_flat
        hist[r_slots] = r_flat
        child_hists = torch.cat([l_flat, r_flat]).reshape(2 * nv, F_loc, B,
                                                           3)
        if refresh:
            node_lo, node_hi, _ = _tree_bounds(
                split_feature, split_bin, left_child, right_child,
                _leaf_output(sum_g, sum_h, p.lambda_l1, p.lambda_l2),
                mono_global, p)
        picks = global_pick(child_hists, cg, ch, cc, cd, node_lo[cids],
                            node_hi[cids])
        for t, v in zip(bests, picks):
            t[cids] = v

    return _finish_tree(split_feature, split_bin, threshold, split_gain,
                        left_child, right_child, sum_g, sum_h, sum_c,
                        num_nodes, node_lo, node_hi, mono_global,
                        learning_rate, p), node_id


def predict_binned_tree_featpar(bins_t: torch.Tensor, tree: Tree,
                                depth_bound: int, total_bins: int, mesh,
                                bundle_map: Optional[dict] = None
                                ) -> torch.Tensor:
    """One tree's leaf values (N,) over a FEATURE-SHARDED binned matrix
    (this rank's (Fb_loc, N) columns; DART's rescoring under
    feature_parallel): at each level the owner of each row's split
    feature routes it and one int8 psum of the owner-exclusive go-left
    mask reaches every rank, the grower's routing pattern — one
    all-reduce a level.  ``bundle_map``: this rank's EFB route tables."""
    from ...parallel.collectives import psum
    rank, _ = _fp_mesh(mesh)
    F_loc = (bundle_map["col"].shape[0] if bundle_map is not None
             else bins_t.shape[0])
    N = bins_t.shape[1]
    rows = torch.arange(N, device=bins_t.device)
    node = torch.zeros(N, dtype=torch.long, device=bins_t.device)
    lc, rc = tree.left_child.long(), tree.right_child.long()
    for _ in range(depth_bound):
        feat = tree.split_feature[node]                    # global ids
        f = torch.clamp_min(feat, 0)
        floc = torch.clamp(f - rank * F_loc, 0, F_loc - 1)
        col, t1, rlo, rhi, dflt = _slot_route_params(
            floc, tree.split_bin[node], total_bins, bundle_map)
        gl = _route_left(bins_t[col.long(), rows], t1, rlo, rhi, dflt)
        mine = ((f // F_loc) == rank).to(torch.int8)
        gl = psum(gl.to(torch.int8) * mine, mesh,
                  op="featpar_predict_psum") > 0
        child = torch.where(gl, lc[node], rc[node])
        node = torch.where(feat < 0, node, child)
    return tree.leaf_value[node]


#: (trees x rows) elements one traversal chunk of
#: :func:`predict_raw_features` holds: each (T, rows) int64 temporary stays
#: at 128 MB
PREDICT_CHUNK_ELEMENTS = 1 << 24


def predict_raw_features(features: torch.Tensor, trees_stacked: Tree,
                         depth_bound: int):
    """Sum of all trees' outputs on raw (N, F) float features, and the
    (T, N) leaf node of each row in each tree.  ``trees_stacked`` carries
    a leading tree axis (T, M) on the features' device.

    All trees walk together: a level is one set of ops over (T, rows)
    (rows in chunks of :data:`PREDICT_CHUNK_ELEMENTS` / T), ~17 launches
    a level instead of 17 a level and tree.  Each (tree, row) makes the
    same comparisons as in :func:`predict_raw_features_per_tree`, and the
    leaf values are added in tree order, so the sums are equal bit for
    bit."""
    N = features.shape[0]
    t = trees_stacked
    T, M = t.split_feature.shape
    dev = features.device
    base = (torch.arange(T, device=dev) * M)[:, None]
    sf, thr = t.split_feature.reshape(-1).long(), t.threshold.reshape(-1)
    lc = t.left_child.reshape(-1).long()
    rc = t.right_child.reshape(-1).long()
    dl, mz = t.default_left.reshape(-1), t.missing_zero.reshape(-1)
    lv = t.leaf_value.reshape(-1)
    chunk = max(1, PREDICT_CHUNK_ELEMENTS // max(T, 1))
    totals, leaves = [], []
    for lo in range(0, N, chunk) if N else (0,):
        rows_t = features[lo:lo + chunk].t()          # (F, n)
        n = rows_t.shape[1]
        node = torch.zeros((T, n), dtype=torch.long, device=dev)
        for _ in range(depth_bound):
            g = node + base
            feat = sf[g]
            is_leaf = feat < 0
            x = rows_t.gather(0, torch.clamp_min(feat, 0))
            # LightGBM kZeroThreshold: missing_type=Zero treats |x|<=1e-35
            # (and NaN) as missing
            missing = torch.isnan(x) | (mz[g] & (torch.abs(x) <= 1e-35))
            go_left = torch.where(missing, dl[g], x <= thr[g])
            child = torch.where(go_left, lc[g], rc[g])
            node = torch.where(is_leaf, node, child)
        vals = lv[node + base]
        total = torch.zeros(n, dtype=torch.float32, device=dev)
        for k in range(T):
            total = total + vals[k]
        totals.append(total)
        leaves.append(node.to(torch.int32))
    return torch.cat(totals), torch.cat(leaves, dim=1)


def predict_raw_features_per_tree(features: torch.Tensor,
                                  trees_stacked: Tree, depth_bound: int):
    """:func:`predict_raw_features` one tree at a time (the previous
    walk): the plain version the tests hold the batched walk against."""
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
                        depth_bound: int, bundle_map: Optional[dict] = None,
                        total_bins: int = 1 << 20) -> torch.Tensor:
    """One tree's leaf values (N,) on an (F, N) binned matrix (DART's
    rescoring, validation): each node sends bins <= its split bin left.
    ``bundle_map``: the matrix holds EFB-bundled columns, and each split
    routes through its feature's bundled range as in training
    (:func:`_slot_route_params`)."""
    return tree.leaf_value[_binned_leaves(bins_t, tree, depth_bound,
                                          bundle_map, total_bins)]


def _binned_leaves(bins_t, tree: Tree, depth_bound: int, bundle_map=None,
                   total_bins: int = 1 << 20) -> torch.Tensor:
    """Each row's leaf node (N,) int64 in one tree on binned features."""
    N = bins_t.shape[1]
    rows = torch.arange(N, device=bins_t.device)
    node = torch.zeros(N, dtype=torch.long, device=bins_t.device)
    lc, rc = tree.left_child.long(), tree.right_child.long()
    for _ in range(depth_bound):
        feat = tree.split_feature[node]
        col, t1, rlo, rhi, dflt = _slot_route_params(
            torch.clamp_min(feat, 0), tree.split_bin[node], total_bins,
            bundle_map)
        go_left = _route_left(bins_t[col.long(), rows], t1, rlo, rhi, dflt)
        child = torch.where(go_left, lc[node], rc[node])
        node = torch.where(feat < 0, node, child)
    return node


def predict_binned_stacked(bins_t: torch.Tensor, trees_stacked: Tree,
                           depth_bound: int):
    """Sum of all trees' outputs on (F, N) binned features, and the (T,
    N) leaf node of each row in each tree: the predict path of models
    that split in bin space (categorical features)."""
    total = torch.zeros(bins_t.shape[1], dtype=torch.float32,
                        device=bins_t.device)
    leaves = []
    for k in range(trees_stacked.split_feature.shape[0]):
        tree = Tree(*[a[k] for a in trees_stacked])
        node = _binned_leaves(bins_t, tree, depth_bound)
        total = total + tree.leaf_value[node]
        leaves.append(node.to(torch.int32))
    return total, torch.stack(leaves)


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
