"""Mixture-of-Experts FFN on one card.

The PyTorch port of the JAX package's ``models/dl/moe.py`` (GShard/Switch
top-k routing).  It keeps the reference's routing and numerics:

- the router runs in f32 (``tokens.float() @ router``), then softmax and
  top-k; ties go to the lower expert index, as ``lax.top_k`` breaks them
  (a stable descending sort);
- each expert holds ``C = ceil(capacity_factor · K · N / E)`` slots; a
  token's k-th choice takes the next free slot of its expert in
  slot-major order (every token's first choice before any second choice,
  the Switch priority rule), counted with an integer cumsum; a choice
  past the capacity is dropped and its gate is 0, so the token passes
  through the residual;
- each expert's up-projection, GELU (tanh form) and down-projection run
  in the model dtype over its ``(C, D)`` buffer;
- the combine casts the gates to the model dtype first;
- the Switch load-balance loss ``aux_loss_weight · E · Σ_e f_e · p_e``
  (f = the share of tokens whose first choice is e, p = the mean router
  probability), kept as :attr:`MoEFFN.aux_loss` after each forward for
  the trainer to add to the objective.

The reference forms dense ``(N, E, C)`` dispatch and combine tensors and
contracts them with einsums (the XLA-friendly form, and the all_to_all
boundary under an expert mesh).  At BERT-base width and batch 128 x 128
each would be 16,384 x 8 x 5,120 f32, 2.7 GB, in each of 6 layers, so
the main path here gathers instead: the dispatch copies each kept token
into its ``(e, c)`` slot by index (each slot holds at most one token, so
the sums are the same), and the combine is a K-term weighted gather of
the experts' outputs.  :meth:`MoEFFN.forward` with ``dense=True`` runs the
reference's einsum form, the plain version the tests hold the gather
form against.

Over a mesh (``mesh=``, a :class:`~synapseml_tpu_torch.parallel.mesh.
ProcessMesh`), the layer computes what the reference computes under
GSPMD, where the MoE sees the global batch:

- with ``rows=`` (a training step's batch sharded over ``data``) the
  capacity is ``capacity(cf, K, N_global, E)`` and the slot positions are
  slot-major over the global token order (every first choice of every
  shard before any second choice, shard 0's tokens before shard 1's):
  one all-gather of each shard's ``(K, E)`` choice counts gives this
  shard's offsets (:func:`route_sharded`).  The Switch loss takes
  ``f_e`` and ``p_e`` over the global batch: the counts already hold
  ``f_e``, and the router's probability sums are summed over ``data``
  with the gradient passed through (:func:`~synapseml_tpu_torch.parallel.
  collectives.reduce_forward`);
- on an ``expert`` axis of size ep each rank holds only the ``E / ep``
  experts ``[i·E/ep, (i+1)·E/ep)`` of its expert index ``i`` (``w_up``
  and ``w_down`` local; the router replicated).  No all-to-all: a
  token's expert output depends only on the token and that expert's
  weights, so each rank runs its own rows' kept tokens through the
  experts it owns, adds their gated outputs into an f32 partial sum and
  the partials are summed over ``expert`` (forward sum, the gradient
  passed through).  The tokens that enter the experts and the gates
  pass through ``reduce_backward`` (forward identity, gradient summed
  over ``expert``), so every replicated parameter's gradient is whole
  on every expert rank and the expert weights' gradients are their
  owner's: the trainer then reduces every gradient over ``data`` only.
  At K = 2 the f32 sum of two partials equals the one-card combine bit
  for bit.  On a ``(data > 1, expert > 1)`` mesh each rank's expert
  buffer keeps all ``C`` slots of the global capacity, of which its
  rows fill about ``1 / data``;
- on a ``model`` axis of size tp (tensor parallelism, the reference's
  ``w_up (expert, embed, mlp)`` / ``w_down (expert, mlp, embed)`` logical
  names) each rank holds ``d_ff / tp`` of every expert's hidden units:
  the tokens entering the experts pass ``reduce_backward`` over
  ``model``, the down-projection's f32 partial products are summed over
  ``model`` (``reduce_forward``) and rounded to the model dtype, and
  everything after, the combine included, is replicated work.  The
  router stays replicated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, axis_index,
                              axis_size)
from .transformer import _param, trunc_normal


def capacity(capacity_factor: float, top_k: int, n_tokens: int,
             num_experts: int) -> int:
    """Slots per expert, the reference's ``max(1, int(cf·K·N/E + 0.999))``."""
    return max(1, int(capacity_factor * top_k * n_tokens / num_experts
                      + 0.999))


def route(probs: torch.Tensor, top_k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with capacity.  ``probs`` (N, E) f32 →

    - ``gate_vals`` (N, K) f32, the chosen experts' probabilities;
    - ``gate_idx`` (N, K) int64, the chosen experts (ties: lower index);
    - ``pos`` (N, K) int64, each choice's slot in its expert, slot-major;
    - ``keep`` (N, K) bool, ``pos < cap``.
    """
    N, E = probs.shape
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[:, :top_k]
    gate_idx = order.indices[:, :top_k]
    flat = gate_idx.t().reshape(-1)                         # slot-major
    # per expert, the choices up to and including each one (exact ints),
    # scanned along the contiguous last axis: PyTorch's scan down the K·N
    # rows of a (K·N, E) tensor took 5.9 ms a layer on an H100 at
    # K·N = 32,768, E = 8
    counts = torch.cumsum(F.one_hot(flat, E).t().contiguous(), dim=1)
    pos = counts.gather(0, flat[None]).squeeze(0) - 1
    pos = pos.reshape(top_k, N).t()
    return gate_vals, gate_idx, pos, pos < cap


def route_sharded(probs: torch.Tensor, top_k: int, cap: int, mesh,
                  axis: str = DATA_AXIS):
    """:func:`route` for this rank's shard of a batch sharded over
    ``axis``: positions slot-major over the GLOBAL token order (shard
    ``d``'s tokens after those of shards ``< d``).  → ``(gate_vals,
    gate_idx, pos, keep, counts)``, ``counts`` the global ``(K, E)``
    choice counts (int64).  Without a sharded axis the positions equal
    :func:`route`'s."""
    from ...parallel.collectives import all_gather
    N, E = probs.shape
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[:, :top_k]
    gate_idx = order.indices[:, :top_k]
    oh = F.one_hot(gate_idx, E).permute(1, 2, 0).contiguous()   # (K, E, N)
    local = oh.sum(-1)                                           # (K, E)
    within = torch.cumsum(oh, dim=-1) - oh    # earlier tokens, same choice
    local_pos = within.gather(1, gate_idx.t()[:, None, :]).squeeze(1).t()
    if axis_size(mesh, axis) > 1:
        every = all_gather(local, mesh, axis, op="moe_counts")   # (D, K, E)
        counts = every.sum(0)
        earlier = every[:axis_index(mesh, axis)].sum(0)
    else:
        counts, earlier = local, torch.zeros_like(local)
    offset = torch.cumsum(counts, dim=0) - counts + earlier      # (K, E)
    pos = local_pos + offset.gather(1, gate_idx.t()).t()
    return gate_vals, gate_idx, pos, pos < cap, counts


def kept_choices(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """The (token, choice) pairs the capacity keeps, from the global
    ``(K, E)`` counts: choice ``k`` of expert ``e`` fills the positions
    after every earlier choice's, and the first ``cap`` are kept."""
    before = torch.cumsum(counts, dim=0) - counts
    return torch.minimum(torch.clamp(cap - before, min=0), counts).sum()


class MoEFFN(nn.Module):
    """Drop-in FFN replacement: (B, S, D) → (B, S, D) through E experts.
    Parameters keep the flax names and layouts: ``router`` (D, E) f32,
    ``w_up`` (E, D, d_ff) and ``w_down`` (E, d_ff, D); on a mesh with an
    ``expert`` axis of size ep, ``w_up``/``w_down`` hold this rank's
    ``E / ep`` experts from :attr:`expert_lo`."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, dtype=torch.bfloat16,
                 device=None, mesh=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.dtype = dtype
        self.mesh = mesh
        self.ep = axis_size(mesh, EXPERT_AXIS)
        if num_experts % self.ep:
            raise ValueError(f"{num_experts} experts do not split over an "
                             f"expert axis of {self.ep}")
        self.local_experts = num_experts // self.ep
        self.expert_lo = axis_index(mesh, EXPERT_AXIS) * self.local_experts
        self.tp = axis_size(mesh, MODEL_AXIS)
        if d_ff % self.tp:
            raise ValueError(f"d_ff={d_ff} does not split over a model axis "
                             f"of {self.tp}")
        self.d_ff = d_ff
        ff = d_ff // self.tp
        self.ff_lo = axis_index(mesh, MODEL_AXIS) * ff
        self.router = _param((d_model, num_experts), device)
        self.w_up = _param((self.local_experts, d_model, ff), device)
        self.w_down = _param((self.local_experts, ff, d_model), device)
        #: the last forward's load-balance loss (f32 scalar)
        self.aux_loss = None
        #: the last forward's share of (token, choice) pairs dropped by
        #: the capacity (a device scalar)
        self.dropped = None

    def shard_dims(self):
        """Parameter name → the ``(axis, dim)`` splits of its shard."""
        out = {"w_up": [], "w_down": []}
        if self.ep > 1:
            out["w_up"].append((EXPERT_AXIS, 0))
            out["w_down"].append((EXPERT_AXIS, 0))
        if self.tp > 1:
            out["w_up"].append((MODEL_AXIS, 2))
            out["w_down"].append((MODEL_AXIS, 1))
        return out

    def reset_parameters(self, gen: torch.Generator) -> None:
        # every expert is drawn whole, so a rank's shard is the one-card
        # model's from the same seed
        self.router.copy_(trunc_normal(self.router.shape, gen, 0.02))
        lo, hi = self.expert_lo, self.expert_lo + self.local_experts
        D = self.router.shape[0]
        for p, full, dim in ((self.w_up, (self.num_experts, D, self.d_ff), 2),
                             (self.w_down, (self.num_experts, self.d_ff, D),
                              1)):
            w = trunc_normal(full, gen, 0.02)[lo:hi]
            p.copy_(w.narrow(dim, self.ff_lo, p.shape[dim]))

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """(E, C, D) in the model dtype → (E, C, D)."""
        h = torch.bmm(expert_in, self.w_up.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        if self.tp == 1:
            return torch.bmm(h, self.w_down.to(self.dtype))
        from ...parallel.collectives import reduce_forward
        part = torch.bmm(h.float(), self.w_down.to(self.dtype).float())
        return reduce_forward(part, self.mesh, MODEL_AXIS,
                              op="moe_tp_sum").to(self.dtype)

    def forward(self, x: torch.Tensor, dense: bool = False,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``x`` (B, S, D) → (B, S, D).  ``rows`` (``(lo, total)``, set by
        a training step over a mesh) says ``x`` holds rows ``[lo, lo+B)``
        of a ``total``-row batch sharded over the mesh's ``data`` axis:
        capacity, positions and the Switch loss are then the global
        batch's (module docstring)."""
        B, S, D = x.shape
        sharded = rows is not None and axis_size(self.mesh, DATA_AXIS) > 1
        if not sharded and self.ep == 1 and self.tp == 1:
            return self._one_card(x, dense)
        if dense and (self.ep > 1 or self.tp > 1):
            raise ValueError("dense=True is the one-card plain version; "
                             "a sharded layer gathers")
        E, K = self.num_experts, self.top_k
        N = B * S
        n_global = (rows[1] if sharded else B) * S
        C = capacity(self.capacity_factor, K, n_global, E)
        tokens = x.reshape(N, D)
        probs = torch.softmax(tokens.float() @ self.router, dim=-1)
        gate_vals, gate_idx, pos, keep, counts = route_sharded(
            probs, K, C, self.mesh if sharded else None)
        gates = gate_vals * keep
        if dense:
            out = self._dense(tokens, gate_idx, pos, keep, gates, C)
        else:
            out = self._gather(tokens, gate_idx, pos, keep, gates, C)
        from ...parallel.collectives import reduce_forward
        p_sum = probs.sum(0)
        if sharded:
            p_sum = reduce_forward(p_sum, self.mesh, DATA_AXIS,
                                   op="moe_probs")
        n_t = torch.tensor(float(n_global), device=x.device)
        f_e = counts[0].float() / n_t
        self.aux_loss = (self.aux_loss_weight * E
                         * torch.sum(f_e * (p_sum / n_t)))
        self.dropped = 1.0 - kept_choices(counts, C).float() / (n_t * K)
        return out.reshape(B, S, D)

    def _one_card(self, x, dense):
        """The layer over the whole batch with every expert."""
        B, S, D = x.shape
        E, K = self.num_experts, self.top_k
        N = B * S
        C = capacity(self.capacity_factor, K, N, E)
        tokens = x.reshape(N, D)
        probs = torch.softmax(tokens.float() @ self.router, dim=-1)
        gate_vals, gate_idx, pos, keep = route(probs, K, C)
        gates = gate_vals * keep
        if dense:
            out = self._dense(tokens, gate_idx, pos, keep, gates, C)
        else:
            out = self._gather(tokens, gate_idx, pos, keep, gates, C)
        f_e = F.one_hot(gate_idx[:, 0], E).float().mean(0)
        p_e = probs.mean(0)
        self.aux_loss = self.aux_loss_weight * E * torch.sum(f_e * p_e)
        self.dropped = 1.0 - keep.float().mean()
        return out.reshape(B, S, D)

    def _gather(self, tokens, gate_idx, pos, keep, gates, C):
        N, D = tokens.shape
        E, lo = self.local_experts, self.expert_lo
        mine = keep
        if self.tp > 1:
            from ...parallel.collectives import reduce_backward
            # each rank runs part of every expert's hidden units: the
            # tokens' gradient through the experts sums over model
            tokens = reduce_backward(tokens.float(), self.mesh, MODEL_AXIS,
                                     op="moe_tp_token_grad")
        if self.ep > 1:
            from ...parallel.collectives import reduce_backward
            # the experts this rank runs see part of each token's and
            # gate's uses: their gradients sum over the expert axis
            tokens = reduce_backward(tokens, self.mesh, EXPERT_AXIS,
                                     op="moe_token_grad")
            gates = reduce_backward(gates, self.mesh, EXPERT_AXIS,
                                    op="moe_gate_grad")
            mine = keep & (gate_idx >= lo) & (gate_idx < lo + E)
        # slot of each kept choice of this rank's experts; any other
        # choice aims at a spare slot E·C
        slot = torch.where(mine, (gate_idx - lo) * C + pos,
                           torch.full_like(pos, E * C))
        src = torch.full((E * C + 1,), N, dtype=torch.int64,
                         device=tokens.device)
        rows = torch.arange(N, device=tokens.device)[:, None].expand_as(slot)
        src.scatter_(0, slot.reshape(-1), rows.reshape(-1))
        # row N is the zero row every empty slot reads
        padded = torch.cat([tokens.to(self.dtype),
                            tokens.new_zeros((1, D), dtype=self.dtype)])
        expert_in = padded.index_select(0, src[:E * C]).reshape(E, C, D)
        expert_out = self._experts(expert_in).reshape(E * C, D)
        expert_out = torch.cat([expert_out, expert_out.new_zeros((1, D))])
        picked = expert_out.index_select(0, slot.reshape(-1)) \
            .reshape(N, -1, D)
        g = gates.to(self.dtype)
        out = (g.float()[..., None] * picked.float()).sum(1)
        if self.ep > 1:
            from ...parallel.collectives import reduce_forward
            out = reduce_forward(out, self.mesh, EXPERT_AXIS,
                                 op="moe_combine")
        return out.to(self.dtype)

    def _dense(self, tokens, gate_idx, pos, keep, gates, C):
        """The reference's form: (N, E, C) dispatch/combine einsums."""
        E = self.num_experts
        onehot = F.one_hot(gate_idx, E).float()                  # (N, K, E)
        slot_oh = F.one_hot(pos.clamp(max=C - 1), C).float() \
            * keep[..., None]
        assign = onehot[:, :, :, None] * slot_oh[:, :, None, :]
        dispatch = assign.sum(1)                                 # (N, E, C)
        combine = (gates[:, :, None, None] * assign).sum(1)
        expert_in = torch.einsum("nec,nd->ecd", dispatch,
                                 tokens.float()).to(self.dtype)
        expert_out = self._experts(expert_in)
        return torch.einsum("nec,ecd->nd", combine.to(self.dtype),
                            expert_out)
