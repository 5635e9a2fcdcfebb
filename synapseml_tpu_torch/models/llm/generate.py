"""Autoregressive generation over the dense cache, and sampling.

The PyTorch port of the JAX package's ``models/llm/generate.py``: the
reference compiles prefill plus a ``lax.scan`` of one-token steps into
one XLA program; here the same steps run as an eager loop on the model's
device.  This is the dense-cache reference the continuous-batching
engine (:mod:`.slots`) is held against.

Sampling: greedy (temperature <= 0), temperature, top-k and nucleus
(top-p), in that order, drawing from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .model import LlamaModel, init_cache


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_k: int,
                  top_p: float) -> torch.Tensor:
    """Sample token ids from (B, V) logits → (B,) int32.  temperature <= 0
    → argmax (the first maximal index, as ``jnp.argmax``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / float(np.float32(max(temperature, 1e-6)))
    V = logits.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -float("inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with mass >= top_p (always >= 1 token);
        # an index past the end (rounding) keeps every token
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True).clamp(
            max=V - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -float("inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(model: LlamaModel, prompt_ids, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             eos_id: Optional[int] = None, pad_id: int = 0,
             seed: int = 0) -> np.ndarray:
    """Generate ``max_new_tokens`` continuations for a batch of
    equal-length prompts (B, P) → (B, max_new_tokens) int32, on the
    model's device: one prefill, then one cached step per token.  After
    ``eos_id`` a row emits ``pad_id``."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(np.asarray(prompt_ids, np.int32), device=dev)
    B, P = ids.shape
    cache = init_cache(cfg, B, P + max_new_tokens, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    positions = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(
        B, P)
    logits, cache = model(ids, positions=positions, cache=cache,
                          cache_index=0)
    tok = sample_logits(logits[:, -1], gen, temperature, top_k, top_p)
    done = (torch.zeros(B, dtype=torch.bool, device=dev) if eos_id is None
            else tok == eos_id)
    out = [tok]
    for t in range(1, max_new_tokens):
        # step t feeds generated token #t-1 at position P + t - 1
        pos = torch.full((B, 1), P + t - 1, dtype=torch.int32, device=dev)
        logits, cache = model(tok[:, None], positions=pos, cache=cache,
                              cache_index=P + t - 1)
        nxt = sample_logits(logits[:, -1], gen, temperature, top_k, top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).cpu().numpy()


def cast_params(model: LlamaModel, dtype=torch.bfloat16) -> LlamaModel:
    """Serving-precision cast, in place: every floating parameter to
    ``dtype``.  Decode streams the whole parameter set per step, so
    weights stored in the compute type halve its bytes against f32 (the
    projections already compute in ``cfg.dtype``)."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model
