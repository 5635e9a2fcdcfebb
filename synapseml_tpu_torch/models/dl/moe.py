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
form against.  Expert parallelism over a mesh is not ported (ROADMAP
A5).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

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


class MoEFFN(nn.Module):
    """Drop-in FFN replacement: (B, S, D) → (B, S, D) through E experts.
    Parameters keep the flax names and layouts: ``router`` (D, E) f32,
    ``w_up`` (E, D, d_ff) and ``w_down`` (E, d_ff, D)."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.dtype = dtype
        self.router = _param((d_model, num_experts), device)
        self.w_up = _param((num_experts, d_model, d_ff), device)
        self.w_down = _param((num_experts, d_ff, d_model), device)
        #: the last forward's load-balance loss (f32 scalar)
        self.aux_loss = None
        #: the last forward's share of (token, choice) pairs dropped by
        #: the capacity (a device scalar)
        self.dropped = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in (self.router, self.w_up, self.w_down):
            p.copy_(trunc_normal(p.shape, gen, 0.02))

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """(E, C, D) in the model dtype → (E, C, D)."""
        h = torch.bmm(expert_in, self.w_up.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.w_down.to(self.dtype))

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
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
        E = self.num_experts
        # slot of each kept choice; dropped ones aim at a spare slot E·C
        slot = torch.where(keep, gate_idx * C + pos,
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
        return (g.float()[..., None] * picked.float()).sum(1).to(self.dtype)

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
