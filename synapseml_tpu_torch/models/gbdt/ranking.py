"""LambdaRank objective for the GBDT ranker.

The PyTorch port of the JAX package's ``models/gbdt/ranking.py`` on one
device.  Rows are laid out group-contiguously and padded into a
``(Q, D)`` index grid (:func:`build_group_index`, numpy); each objective
call computes all pairwise NDCG-weighted lambdas within groups, O(Q·D²),
on the scores' device, and writes grad/hess back to the flat rows.
Groups longer than ``max_group_size`` (128) are truncated as in the JAX
package: their rows past D get zero gradient and a hessian of 1e-9.

The objective runs in float64 and the fit rounds it to float32
(``booster._grad_hess``), so the card and the CPU give the same bits.
At most ``_PAIR_BUDGET`` (query, i, j) pairs are alive at a time: the
grid is processed in query chunks, and every row belongs to one query,
so the result does not depend on the chunking.

Distributed training follows the reference's partition rule: whole
groups pack onto the ranks (greedy, largest first onto the lightest,
:func:`pack_groups_for_shards`, numpy, the JAX package's), each rank's
slab pads to a common row count with zero-weight rows, and each rank's
objective (:func:`make_lambdarank_objective_sharded`) computes lambdas
over its own groups only: they never cross ranks, and the histogram
all-reduce is the only communication.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: (query, i, j) pairs per chunk: ~16 float64 (Q, D, D) temporaries of
#: 2^24 entries stay near 2 GB
_PAIR_BUDGET = 1 << 24


def build_group_index(group_sizes: np.ndarray,
                      max_group_size: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """(row index grid (Q, D) int32 with -1 padding, valid mask (Q, D))."""
    Q = len(group_sizes)
    D = min(int(max(group_sizes.max(), 1)), max_group_size)
    qidx = np.full((Q, D), -1, np.int64)
    start = 0
    for q, g in enumerate(group_sizes):
        g = int(g)
        take = min(g, D)
        qidx[q, :take] = np.arange(start, start + take)
        start += g
    return qidx.astype(np.int32), (qidx >= 0)


def pack_groups_for_shards(group_sizes: np.ndarray, shards: int,
                           row_unit: int = 1, max_group_size: int = 128):
    """Assign WHOLE groups to shards and lay rows out slab-contiguously.

    Greedy balance: largest group first onto the lightest shard; each
    shard's slab pads to the common length L (a multiple of
    ``row_unit``).  Returns ``(perm, stacked_qidx, stacked_mask, L)``
    where ``perm`` (shards·L,) holds original row indices (-1 ⇒ pad row)
    and ``stacked_qidx`` (shards, Qmax, D) indexes each shard's LOCAL
    rows (the JAX package's function, bit for bit)."""
    sizes = np.asarray(group_sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = np.argsort(-sizes, kind="stable")
    shard_groups: list = [[] for _ in range(shards)]
    shard_rows = np.zeros(shards, np.int64)
    for g in order:
        s = int(np.argmin(shard_rows))
        shard_groups[s].append(int(g))
        shard_rows[s] += sizes[g]
    L = int(-(-max(int(shard_rows.max()), 1) // row_unit) * row_unit)
    D = min(int(sizes.max()), max_group_size)
    Qmax = max(len(gs) for gs in shard_groups) or 1
    perm = np.full(shards * L, -1, np.int64)
    qidx = np.full((shards, Qmax, D), -1, np.int64)
    for s, gs in enumerate(shard_groups):
        pos = 0
        for qi, g in enumerate(sorted(gs)):    # stable within-shard order
            gsz = int(sizes[g])
            take = min(gsz, D)
            perm[s * L + pos: s * L + pos + gsz] = \
                np.arange(starts[g], starts[g] + gsz)
            qidx[s, qi, :take] = pos + np.arange(take)
            pos += gsz
    return perm, qidx.astype(np.int32), (qidx >= 0), L


def _lambda_grids(s, lab, mask, sigma: float, max_position: int,
                  label_gain: Optional[torch.Tensor]):
    """Pairwise NDCG-weighted lambdas for one (Q, D) chunk of the grid:
    scores ``s`` and labels ``lab`` gathered per slot, ``mask`` the real
    slots → (grad grid, hess grid), each (Q, D), zero on pads."""
    mf = mask.to(s.dtype)
    lab = lab * mf
    if label_gain is None:
        gains = (torch.pow(2.0, lab) - 1.0) * mf
    else:
        gains = label_gain[torch.clamp(lab.to(torch.int64), 0,
                                       len(label_gain) - 1)] * mf
    D = lab.shape[1]
    dev = s.device
    sorted_gains = torch.sort(gains, dim=1, descending=True).values
    pos = torch.arange(D, device=dev, dtype=s.dtype)
    disc_ideal = 1.0 / torch.log2(pos + 2.0)
    trunc = (pos < max_position).to(s.dtype)
    max_dcg = (sorted_gains * disc_ideal * trunc).sum(1)              # (Q,)
    inv_max_dcg = torch.where(max_dcg > 0, 1.0 / max_dcg,
                              torch.zeros_like(max_dcg))
    # pads take a large finite negative: -inf would make pad-pad
    # differences NaN, and NaN * 0 poisons the masked pair products
    s = torch.where(mask, s, torch.full_like(s, -1e9))
    # positions are a strict permutation even under tied scores (double
    # argsort, ties broken by index), or the NDCG deltas degenerate to 0
    order = torch.argsort(-s, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True).to(s.dtype)
    disc = torch.where(mask, 1.0 / torch.log2(rank + 2.0),
                       torch.zeros_like(rank))
    rho = torch.sigmoid(-sigma * (s[:, :, None] - s[:, None, :]))
    delta_ndcg = ((disc[:, :, None] - disc[:, None, :]).abs()
                  * (gains[:, :, None] - gains[:, None, :]).abs()
                  * inv_max_dcg[:, None, None])
    sij = ((lab[:, :, None] > lab[:, None, :])
           & mask[:, :, None] & mask[:, None, :]).to(s.dtype)
    lam = -sigma * rho * delta_ndcg * sij                   # i beats j
    hess_pair = sigma * sigma * rho * (1.0 - rho) * delta_ndcg * sij
    grad = (lam.sum(2) - lam.sum(1)) * mf
    hess = (hess_pair.sum(2) + hess_pair.sum(1)) * mf
    return grad, hess


def make_lambdarank_objective(qidx: np.ndarray, mask: np.ndarray,
                              n_rows: int, sigma: float = 1.0,
                              max_position: int = 10,
                              label_gain: Optional[np.ndarray] = None,
                              device="cpu"):
    """(scores, labels, weights) -> (grad, hess) over one group grid on
    ``device``, in the scores' dtype.  ``label_gain`` takes float32
    values, as the JAX package stores them."""
    dev = torch.device(device)
    qidx = np.asarray(qidx)
    mask_np = np.asarray(mask, bool)
    Q, D = qidx.shape
    idx = torch.as_tensor(np.maximum(qidx, 0).astype(np.int64), device=dev)
    mask_t = torch.as_tensor(mask_np, device=dev)
    # the real slots' positions in the flat grid and their rows: each row
    # is in at most one slot, so the results are copied, not summed
    flat = np.flatnonzero(mask_np.reshape(-1))
    flat_t = torch.as_tensor(flat, device=dev)
    rows_t = torch.as_tensor(qidx.reshape(-1)[flat].astype(np.int64),
                             device=dev)
    lg = (None if label_gain is None
          else np.asarray(label_gain, np.float32).astype(np.float64))
    qc = max(1, _PAIR_BUDGET // max(D * D, 1))

    def objective(scores, labels, weights):
        dt = scores.dtype
        gain_t = None if lg is None else torch.as_tensor(lg, dtype=dt,
                                                         device=dev)
        s_all, lab_all = scores[idx], labels.to(dt)[idx]
        grads, hesses = [], []
        for q0 in range(0, Q, qc):
            g, h = _lambda_grids(s_all[q0:q0 + qc], lab_all[q0:q0 + qc],
                                 mask_t[q0:q0 + qc], sigma, max_position,
                                 gain_t)
            grads.append(g)
            hesses.append(h)
        grad = torch.zeros(n_rows, dtype=dt, device=dev).index_copy_(
            0, rows_t, torch.cat(grads).reshape(-1)[flat_t])
        hess = torch.zeros(n_rows, dtype=dt, device=dev).index_copy_(
            0, rows_t, torch.cat(hesses).reshape(-1)[flat_t])
        w = weights.to(dt)
        return grad * w, torch.clamp_min(hess, 1e-9) * w

    return objective


def make_lambdarank_objective_sharded(stacked_qidx: np.ndarray,
                                      stacked_mask: np.ndarray,
                                      n_rows_local: int, rank: int,
                                      sigma: float = 1.0,
                                      max_position: int = 10,
                                      label_gain: Optional[np.ndarray] = None,
                                      device="cpu"):
    """Rank ``rank``'s objective over its slab of
    :func:`pack_groups_for_shards`: its own (Qmax, D) group grid of
    local row indices over its ``n_rows_local`` rows.  Groups never span
    ranks, so no lambda crosses them (the JAX package's
    ``make_lambdarank_objective_sharded``, which picks the grid by
    ``lax.axis_index`` inside ``shard_map``)."""
    return make_lambdarank_objective(
        np.asarray(stacked_qidx)[rank], np.asarray(stacked_mask)[rank],
        n_rows_local, sigma=sigma, max_position=max_position,
        label_gain=label_gain, device=device)
