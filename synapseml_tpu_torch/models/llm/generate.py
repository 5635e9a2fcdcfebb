"""Autoregressive generation over the dense cache, and sampling.

The PyTorch port of the JAX package's ``models/llm/generate.py``: the
reference compiles prefill plus a ``lax.scan`` of one-token steps into
one XLA program; here the same steps run as an eager loop on the model's
device.  This is the dense-cache reference the continuous-batching
engine (:mod:`.slots`) is held against.

Sampling: greedy (temperature <= 0), temperature, top-k and nucleus
(top-p), in that order, drawing from an explicit ``torch.Generator``.

Beside it: :func:`generate_speculative` (greedy decode with prompt-lookup
drafts verified ``draft_len`` at a time, token-exact with greedy
:func:`generate`; each verify step stays on the device, one host read of
the loop's ``done`` flags a step), :func:`cast_params` and
:func:`quantize_int8` (the reference's weight-only int8 quantization).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    ``eos_id`` a row emits ``pad_id``.  On a model sharded over a
    ``model`` axis every rank of the axis calls it with the same
    arguments: each caches its own key-value heads, the logits are
    all-gathered before sampling, and every rank returns the same
    tokens (the replicated model's)."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(np.asarray(prompt_ids, np.int32), device=dev)
    B, P = ids.shape
    cache = init_cache(cfg, B, P + max_new_tokens, dev, tp=getattr(model, "tp", 1))
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


def _quant(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along ``axis`` → (q int8, scale f32): the
    reference's ``absmax / 127`` floored at 1e-12, ``round`` half to even
    and a clip to ±127.  The divisors are tensors: a CUDA tensor divided by
    a Python number is multiplied by its reciprocal, which can differ from
    the quotient in the last bit."""
    wf = w.float()
    q_max = torch.full((), 127.0, dtype=torch.float32, device=w.device)
    scale = torch.clamp_min(torch.amax(torch.abs(wf), dim=axis) / q_max,
                            1e-12)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


@torch.no_grad()
def quantize_int8(model: LlamaModel) -> LlamaModel:
    """Weight-only int8 copy of ``model`` (``weight_quant="int8"``), on its
    device: every projection kernel (lm_head included) quantizes per output
    channel, and a TIED embedding table per vocabulary row (for
    :class:`~.model.QuantEmbed`); norms and an untied table keep their
    values and types.  The int8 arrays and f32 scales equal the
    reference's ``quantize_int8`` bit for bit.  A model sharded over a
    ``model`` axis quantizes its whole weights (gathered: every rank
    calls it) and keeps its shard, so each row-parallel channel's scale
    sees the whole channel."""
    cfg = dataclasses.replace(model.cfg, weight_quant="int8")
    tp = getattr(model, "tp", 1)
    sd = {}
    whole = model.full_state_dict() if tp > 1 else model.state_dict()
    for name, t in whole.items():
        if name.endswith(".kernel"):
            q, scale = _quant(t, 0)
            sd[name[:-len("kernel")] + "kernel_q"] = q
            sd[name[:-len("kernel")] + "scale"] = scale
        elif name == "tok_embed.embedding" and cfg.tie_embeddings:
            q, scale = _quant(t, 1)
            sd["tok_embed.embedding_q"] = q
            sd["tok_embed.scale"] = scale
        else:
            sd[name] = t
    out = LlamaModel(cfg, device=model.device, mesh=model.mesh)
    if tp > 1:
        from ..dl.transformer import slice_full
        sd = slice_full(sd, out.shard_specs(), model.mesh)
    out.load_state_dict(sd, assign=True)
    return out


def _ngram_draft(ctx: torch.Tensor, cur_len: torch.Tensor, draft_len: int,
                 ngram: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup drafting, the reference's ``_ngram_draft``: find the
    latest earlier occurrence of each row's last ``ngram`` tokens and
    propose the tokens that followed it → ``(draft (B, draft_len) int32,
    vlen (B,) int32)``, where ``vlen`` counts the draft positions that came
    from a real known continuation (a row without a match repeats its last
    token, which only luck accepts)."""
    B, L = ctx.shape
    dev = ctx.device
    cl = cur_len.long()
    gpos = torch.clamp_min(cl[:, None] - ngram
                           + torch.arange(ngram, device=dev), 0)
    tail = torch.gather(ctx, 1, gpos)                          # (B, n)
    windows = ctx.unfold(1, ngram, 1)                          # (B, L-n+1, n)
    match = torch.all(windows == tail[:, None, :], dim=-1)
    p_idx = torch.arange(L - ngram + 1, device=dev)[None, :]
    # the match must END strictly before the tail and have at least one
    # known continuation token
    valid = match & (p_idx + ngram < cl[:, None])
    has = torch.any(valid, dim=1)
    p_best = torch.argmax(torch.where(valid, p_idx, -1), dim=1)  # latest
    src = p_best[:, None] + ngram + torch.arange(draft_len, device=dev)
    src = torch.minimum(src, cl[:, None] - 1)
    draft = torch.gather(ctx, 1, src)
    last = torch.gather(ctx, 1, cl[:, None] - 1)
    vlen = torch.where(has, torch.clamp(cl - (p_best + ngram), 0, draft_len),
                       0).to(torch.int32)
    return torch.where(has[:, None], draft,
                       last.expand_as(draft)).to(torch.int32), vlen


@torch.no_grad()
def _generate_spec(model: LlamaModel, prompt: torch.Tensor,
                   max_new_tokens: int, draft_len: int, ngram: int,
                   eos_id: Optional[int], pad_id: int) -> torch.Tensor:
    """The reference's ``_generate_spec_jit`` loop over the dense cache →
    the packed (B, max_new_tokens + 5) int32 result on the model's
    device."""
    cfg = model.cfg
    dev = prompt.device
    B, P = prompt.shape
    K = draft_len
    L = P + max_new_tokens + K + 2        # ctx/cache capacity with slack
    cache = init_cache(cfg, B, L, dev, tp=getattr(model, "tp", 1))
    # K + 1 junk columns past L: a done row's unaccepted positions can
    # reach past the context; the reference's one-hot scatter drops them
    ctx = torch.full((B, L + K + 1), pad_id, dtype=torch.int32, device=dev)
    ctx[:, :P] = prompt
    # prefill the prompt minus its last token (the last token is the first
    # verify block's input 0, so its K/V lands there)
    positions = torch.arange(P - 1, dtype=torch.int32, device=dev)[
        None].expand(B, P - 1)
    model(prompt[:, :-1], positions=positions, cache=cache, cache_index=0)
    ar = torch.arange(K + 1, dtype=torch.int32, device=dev)[None, :]
    cur_len = torch.full((B,), P, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    acc, row_steps, drafted, acc_valid = (zeros.clone() for _ in range(4))
    steps = 0
    while steps < max_new_tokens and not bool(torch.all(done)):
        draft, vlen = _ngram_draft(ctx[:, :L], cur_len, K, ngram)
        last = torch.gather(ctx, 1, cur_len.long()[:, None] - 1)
        inputs = torch.cat([last, draft], dim=1)                # (B, K+1)
        pos = (cur_len - 1)[:, None] + ar
        # a done row writes its (ignored) K/V from position 0: its context
        # may have run past the cache, where the reference drops the write
        ci = torch.where(done, 0, cur_len - 1)
        logits, cache = model(inputs, positions=pos, cache=cache,
                              cache_index=ci)
        g = torch.argmax(logits, dim=-1).to(torch.int32)        # (B, K+1)
        match = draft == g[:, :K]
        a = torch.where(torch.all(match, dim=1), K,
                        torch.argmin(match.to(torch.int32), dim=1))
        n_new = a + 1                                           # g[:, 0..a]
        if eos_id is not None:
            is_eos = g == eos_id
            eos_pos = torch.where(torch.any(is_eos, dim=1),
                                  torch.argmax(is_eos.to(torch.int32), dim=1),
                                  K + 1)
            n_new = torch.minimum(n_new, eos_pos + 1)
        n_new = torch.where(done, 0, n_new).to(torch.int32)
        # write the accepted tokens g[:, i], i < n_new, at cur_len + i
        tpos = (cur_len[:, None] + ar).long()
        take = ar < n_new[:, None]
        ctx.scatter_(1, tpos, torch.where(take, g, torch.gather(ctx, 1,
                                                                tpos)))
        if eos_id is not None:
            done = done | torch.any((g == eos_id) & take, dim=1)
        acc += n_new
        live = (n_new > 0).to(torch.int32)
        row_steps += live
        # only real draft positions count as drafted, and an accepted
        # prefix counts only up to them
        drafted += vlen * live
        acc_valid += torch.minimum(a.to(torch.int32), vlen) * live
        cur_len = cur_len + n_new
        done = done | (cur_len >= P + max_new_tokens)
        steps += 1
    out = ctx[:, P:P + max_new_tokens]
    keep = (torch.arange(max_new_tokens, device=dev)[None, :]
            < (cur_len - P)[:, None])
    out = torch.where(keep, out, pad_id)
    return torch.cat([out, acc[:, None], row_steps[:, None],
                      torch.full((B, 1), steps, dtype=torch.int32,
                                 device=dev),
                      drafted[:, None], acc_valid[:, None]],
                     dim=1).to(torch.int32)


def spec_unpack(packed, max_new_tokens: int, draft_len: int = 0):
    """Host unpack of a ``block=False`` speculative result → (tokens (B,
    max_new_tokens), stats dict), the stats of the blocking call, and
    publishes them (:func:`_record_spec_stats`).  ``draft_len`` is unused
    (the acceptance denominator is the drafted count the loop packed).
    ``acceptance_rate`` is accepted over drafted real positions."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    out = packed[:, :max_new_tokens]
    acc = packed[:, max_new_tokens].astype(np.float64)
    row_steps = np.maximum(packed[:, max_new_tokens + 1].astype(np.float64),
                           1.0)
    drafted = packed[:, max_new_tokens + 3].astype(np.float64)
    acc_valid = packed[:, max_new_tokens + 4].astype(np.float64)
    tps = float(np.mean(acc / row_steps))
    stats = {"steps": int(packed[0, max_new_tokens + 2]),
             "accepted": int(acc.sum()),
             "drafted": int(drafted.sum()),
             "tokens_per_step": tps,
             "acceptance_rate": float(acc_valid.sum())
             / max(float(drafted.sum()), 1.0)}
    _record_spec_stats(stats)
    return out, stats


def _record_spec_stats(stats: dict) -> None:
    """Export speculative-decode acceptance as process metrics (the
    reference's names)."""
    from ...telemetry import get_registry
    reg = get_registry()
    reg.counter("llm_spec_accepted_tokens_total",
                "draft tokens accepted by speculative verification").inc(
        stats["accepted"])
    reg.counter("llm_spec_verify_steps_total",
                "speculative verify forwards executed").inc(stats["steps"])
    reg.gauge("llm_spec_tokens_per_step",
              "accepted tokens per verify step (last call)").set(
        stats["tokens_per_step"])
    reg.gauge("llm_spec_acceptance_rate",
              "fraction of drafted tokens accepted (last call)").set(
        stats["acceptance_rate"])


def generate_speculative(model: LlamaModel, prompt_ids,
                         max_new_tokens: int = 32, draft_len: int = 7,
                         ngram: int = 2, eos_id: Optional[int] = None,
                         pad_id: int = 0, block: bool = True):
    """Greedy decode with self-speculative (prompt-lookup) drafting, on the
    model's device: each step verifies ``draft_len`` n-gram-drafted tokens
    in one forward of length ``draft_len + 1``.  The output is exactly
    greedy :func:`generate`'s (a draft token is accepted only when it
    equals the model's argmax).

    → (tokens (B, max_new_tokens) int32, stats with ``steps`` /
    ``accepted`` / ``drafted`` / ``tokens_per_step`` /
    ``acceptance_rate``); ``block=False`` returns the packed (B,
    max_new_tokens + 5) device tensor instead, for :func:`spec_unpack`."""
    ids = torch.as_tensor(np.asarray(prompt_ids, np.int32),
                          device=model.device)
    if ids.shape[1] < max(ngram, 2):
        raise ValueError("prompt must be at least ngram tokens long")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    packed = _generate_spec(model, ids, int(max_new_tokens), int(draft_len),
                            int(ngram), eos_id, int(pad_id))
    if not block:
        return packed
    return spec_unpack(packed, int(max_new_tokens), int(draft_len))
