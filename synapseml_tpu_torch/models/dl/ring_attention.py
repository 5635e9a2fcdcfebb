"""Ring attention: exact attention over a sequence sharded on a mesh axis.

The PyTorch port of the JAX package's ``models/dl/ring_attention.py``.
Each rank of the ``seq`` axis holds a contiguous block of every sequence:
its queries stay, and the key, value and key-mask blocks travel the ring
one hop a step (:func:`~synapseml_tpu_torch.parallel.collectives.
ring_shift`) while f32 online-softmax accumulators ``m``, ``l`` and ``o``
take each block's contribution (:func:`_block_attn`).  After ``n`` steps
every query has met every key block.  The shifts are differentiable (the
gradient rides the ring the other way), so the whole computation is.

The port skips the reference's last shift, which only returns each block
to its owner and feeds nothing: ``n - 1`` exchanges of K, V and the mask
where the reference makes ``n``.  The mask travels as ``uint8`` (gloo
moves no booleans).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...parallel.mesh import DATA_AXIS, SEQ_AXIS

#: the key mask's fill: f32's finite minimum
BIG_NEG = float(np.finfo(np.float32).min)


def _block_attn(q, k, v, key_mask, m, l, o, scale: float,
                p_for_values=None):
    """One K/V block's contribution with an online softmax.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D); key_mask: (B, Sk) bool or None;
    m/l: (B, H, Sq) f32 running max / normalizer; o: (B, Sq, H, D) f32.
    ``p_for_values`` transforms the unnormalized probabilities on the
    value path only (the blockwise scan's probabilities dropout), so
    train- and eval-time attention share this one update."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits,
                             torch.full((), BIG_NEG, device=logits.device))
    new_m = torch.maximum(m, logits.amax(-1))
    correction = torch.exp(m - new_m)
    p = torch.exp(logits - new_m[..., None])
    new_l = l * correction + p.sum(-1)
    pv_p = p if p_for_values is None else p_for_values(p)
    pv = torch.einsum("bhqk,bkhd->bqhd", pv_p, v.float())
    new_o = o * correction.transpose(1, 2)[..., None] + pv
    return new_m, new_l, new_o


def ring_attention_inner(q, k, v, key_mask, mesh,
                         axis: str = SEQ_AXIS) -> torch.Tensor:
    """This rank's part of ring attention over ``axis``.

    q/k/v: (B, S_local, H, D) this rank's blocks; key_mask: (B, S_local)
    bool or None.  → (B, S_local, H, D) in ``q``'s dtype."""
    from ...parallel.collectives import ring_shift
    B, Sq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    n = mesh.axis_size(axis)
    m = torch.full((B, H, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    o = torch.zeros((B, Sq, H, D), device=q.device)
    km = None if key_mask is None else key_mask.to(torch.uint8)
    for step in range(n):
        m, l, o = _block_attn(q, k, v, None if km is None else km.bool(),
                              m, l, o, scale)
        if step + 1 < n:
            k = ring_shift(k, mesh, axis, op="ring_attn_kv")
            v = ring_shift(v, mesh, axis, op="ring_attn_kv")
            if km is not None:
                km = ring_shift(km, mesh, axis, op="ring_attn_mask")
    out = o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def shard_blocks(x, mesh, axes=(DATA_AXIS, SEQ_AXIS)) -> torch.Tensor:
    """This rank's block of a global array whose leading dims shard over
    ``axes`` in order (dim 0 over ``axes[0]``, ...), on the mesh's device:
    the JAX package's ``P(data, seq)`` placement, one shard.  Each dim
    must divide by its axis size."""
    x = np.asarray(x)
    index = []
    for dim, axis in enumerate(axes):
        size = mesh.axis_size(axis)
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {x.shape} does not split over "
                             f"the {axis!r} axis of {size}")
        per = x.shape[dim] // size
        lo = mesh.axis_index(axis) * per
        index.append(slice(lo, lo + per))
    return torch.as_tensor(np.ascontiguousarray(x[tuple(index)]),
                           device=mesh.device)


def ring_attention(q, k, v, key_mask: Optional[torch.Tensor], mesh,
                   data_axis: str = DATA_AXIS,
                   seq_axis: str = SEQ_AXIS) -> torch.Tensor:
    """The standalone entry (the reference's ``ring_attention``): ``q``,
    ``k``, ``v`` (B_local, S_local, H, D) and ``key_mask`` (B_local,
    S_local) are this rank's block of arrays sharded over ``(data_axis,
    seq_axis)`` (:func:`shard_blocks`) → this rank's output block.  The
    data axis needs no communication: each data slice runs its own
    ring (``data_axis`` names the rows' axis, which may be absent)."""
    shape = getattr(mesh, "shape", {})
    if seq_axis not in shape:
        raise ValueError(f"ring attention needs a mesh with a {seq_axis!r} "
                         f"axis; this mesh has {shape or None}")
    return ring_attention_inner(q, k, v, key_mask, mesh, seq_axis)
