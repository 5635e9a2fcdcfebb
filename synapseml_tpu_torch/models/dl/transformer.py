"""BERT-style transformer encoder as ``nn.Module``s.

The PyTorch port of the JAX package's ``models/dl/transformer.py`` on one
card.  Parameters keep the flax tree's names and layouts (``Dense``
kernels ``(in, out)``, embeddings ``(vocab, d_model)``,
``layer_{i}.attention.query.kernel``, ...), so a flax tree converts by
renaming alone (:mod:`.convert`).

The dtypes follow the reference step by step, as explicit casts (autocast
would keep the LayerNorm and softmax outputs in f32 and round other
tensors):

- each ``Dense`` casts its input, kernel and bias to ``cfg.dtype`` and
  outputs ``cfg.dtype``; the classifier ``Dense`` is f32;
- both embeddings are gathered, cast to ``cfg.dtype`` and added there;
- LayerNorm (epsilon 1e-6) takes its statistics in f32 (E[x²] − E[x]²)
  and outputs ``cfg.dtype``;
- ``q·k`` stays in ``cfg.dtype`` and is scaled there; the key mask fills
  with f32's finite minimum, which promotes the logits to f32, so a fully
  masked row gets uniform probabilities, not NaN; the softmax runs in f32
  and the probabilities go back to ``cfg.dtype``;
- GELU is the tanh approximation (flax's ``nn.gelu`` default).

Dropout (four sites: the probabilities, the attention output, the FFN
output and the embedding LayerNorm) draws each site's mask from its own
``torch.Generator`` on the activations' device, seeded from the step's
seed and the site, so a step's masks depend on (seed, step) alone and a
rematerialized block draws the same masks again.  The stream differs from
the reference's rbg keys by design, as a change of seed would.  In a
training step over a mesh (``rows=(lo, total)``: this rank holds rows
``[lo, lo+B)`` of a ``total``-row batch) each site draws the mask of the
whole batch in one call and keeps this rank's rows, so a fit over any
number of ranks draws the one-rank fit's masks.  A rank's draw is the
one-rank fit's, never more.  Drawing only a rank's rows would take row
blocks, each from its own generator (a generator's stream cannot be
entered at a row), and every fit would pay a generator and a launch a
block at every site: on an H100, 16 blocks of BERT-base's (128, 12, 128,
128) bf16 probabilities took 0.704 ms against 0.205 for the whole draw,
a rank of two 0.356 ms for its 8 blocks against 0.130 for the whole
draw, and the one-card BERT-base MoE step 120-124 ms against 113-116.

Attention runs as two einsums and a softmax (``attention_impl="einsum"``,
and ``"auto"`` below 1024 tokens) or as the blockwise online-softmax scan
(``"blockwise"``, and ``"auto"`` from 1024 tokens).  With ``num_experts >
0`` every ``moe_layer_freq``-th block's FFN is the MoE FFN
(:mod:`.moe`, ``layer_{i}.moe_ffn``), as in the reference; its
load-balance losses are :meth:`TextEncoder.aux_losses`.  Built with a
``mesh`` that has an ``expert`` axis, each MoE layer holds this rank's
experts (:mod:`.moe`); :meth:`TextEncoder.full_state_dict` gathers the
whole model and :meth:`TextEncoder.load_full_state_dict` takes this
rank's slice of one.  Ring attention over a mesh (ROADMAP A3: ring
attention and pipeline) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, resolve_device
from .precision import run_block

#: sequence length from which "auto" switches to blockwise attention
BLOCKWISE_MIN_SEQ = 1024
#: K/V block width for the blockwise scan
BLOCK_K = 512
#: flax ``nn.LayerNorm``'s default epsilon
LN_EPS = 1e-6
#: the key mask's fill: f32's finite minimum
BIG_NEG = float(np.finfo(np.float32).min)


@dataclasses.dataclass(unsafe_hash=True)
class TransformerConfig:
    vocab_size: int = 30522
    max_len: int = 512
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dropout_rate: float = 0.1
    num_classes: int = 2
    dtype: Any = torch.bfloat16
    #: "auto" | "einsum" | "blockwise" (see the module docstring)
    attention_impl: str = "auto"
    #: rematerialize each encoder block in the backward pass: False/True
    #: or a ``rematPolicy`` name (see :func:`.precision.remat_policy`)
    remat: Any = False
    num_experts: int = 0    # >0: MoE FFN on every moe_layer_freq-th block
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_layer_freq: int = 2

    def uses_moe(self, layer: int) -> bool:
        """Whether block ``layer`` takes the MoE FFN (the reference's
        ``i % moe_layer_freq == moe_layer_freq - 1``)."""
        return (self.num_experts > 0
                and layer % self.moe_layer_freq == self.moe_layer_freq - 1)

    @staticmethod
    def bert_base(num_classes: int = 2, **kw) -> "TransformerConfig":
        return TransformerConfig(num_classes=num_classes, **kw)

    @staticmethod
    def tiny(num_classes: int = 2, **kw) -> "TransformerConfig":
        """Small config for tests."""
        return TransformerConfig(vocab_size=1024, max_len=128, num_layers=2,
                                 num_heads=4, d_model=64, d_ff=128,
                                 num_classes=num_classes, **kw)


# -- initialization and dropout ---------------------------------------------

def trunc_normal(shape, generator: torch.Generator,
                 stddev: float) -> torch.Tensor:
    """flax ``initializers.truncated_normal(stddev)``: a normal of std
    ``stddev`` cut at ±2 std, drawn in f32 on the CPU."""
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=stddev, a=-2 * stddev, b=2 * stddev,
                          generator=generator)
    return w


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device))


def init_weights(model: nn.Module, seed: int) -> None:
    """Redraw every parameter (and reset every batch statistic) of
    ``model`` from ``seed``: each layer's ``reset_parameters(generator)``
    in module order, drawn on the CPU and copied to the parameters'
    device, so one seed gives the same weights on every device."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if mod is not model and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)


def mix_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed from ``seed`` and integer parts (a step, a site, a
    block): distinct parts give distinct generator seeds."""
    h = int(seed) & 0x7FFFFFFFFFFFFFFF
    for p in parts:
        h = (h * 1_000_003 + int(p) + 1) & 0x7FFFFFFFFFFFFFFF
    return h


def dropout(x: torch.Tensor, rate: float, seed: Optional[int],
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    kept values by ``1 / (1 - rate)``; the mask comes from a generator on
    ``x``'s device seeded with ``seed`` (``None``: no dropout).  With
    ``rows=(lo, total)`` the mask is drawn for ``total`` leading rows and
    rows ``[lo, lo + x.shape[0])`` of it are used."""
    if seed is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    if rows is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) \
            < 1.0 - rate
    else:
        lo, total = rows
        keep = torch.rand((total,) + tuple(x.shape[1:]), generator=gen,
                          device=x.device)[lo:lo + x.shape[0]] < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


# -- layers ---------------------------------------------------------------------

class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` is ``(in, out)``; the input, kernel
    and bias are cast to ``dtype``, multiplied and added there.  The
    kernel draws from a truncated normal of std ``stddev``."""

    def __init__(self, in_features: int, features: int, dtype, device,
                 stddev: float = 0.02):
        super().__init__()
        self.dtype = dtype
        self.stddev = stddev
        self.kernel = _param((in_features, features), device)
        self.bias = _param((features,), device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.kernel.copy_(trunc_normal(self.kernel.shape, gen, self.stddev))
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype)) \
            + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``'s table ``(num, features)``, truncated normal
    std 0.02; the caller gathers rows and casts them."""

    def __init__(self, num: int, features: int, device):
        super().__init__()
        self.embedding = _param((num, features), device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.embedding.copy_(trunc_normal(self.embedding.shape, gen, 0.02))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics by the fast
    variance E[x²] − E[x]², output in ``dtype``."""

    def __init__(self, features: int, dtype, device, eps: float = LN_EPS):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = _param((features,), device)
        self.bias = _param((features,), device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def block_attn(q, k, v, key_mask, m, l, o, scale: float,
               p_for_values=None):
    """One K/V block's contribution with an online softmax (the port of
    ``ring_attention._block_attn``).

    q: (B, Sq, H, D); k/v: (B, Sk, H, D); key_mask: (B, Sk) bool or None;
    m/l: (B, H, Sq) f32 running max / normalizer; o: (B, Sq, H, D) f32.
    ``p_for_values`` transforms the unnormalized probabilities on the
    value path only (probabilities dropout)."""
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


def blockwise_attention(q, k, v, mask, scale: float, dropout_rate: float,
                        seed: Optional[int], block_k: int = BLOCK_K,
                        rows: Optional[Tuple[int, int]] = None):
    """Exact attention as an online-softmax scan over K/V blocks: the
    logits never materialize at O(S²).  Probabilities dropout hits the
    value path of each block with its own mask (``seed`` mixed with the
    block index); the normalizer stays dropout-free.

    q/k/v: (B, S, H, D); mask: (B, S) key mask or None."""
    B, S, H, D = q.shape
    nb = -(-S // block_k)
    pad = nb * block_k - S
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        mask = F.pad(mask, (0, pad), value=False)
    m = torch.full((B, H, S), -math.inf, device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    o = torch.zeros((B, S, H, D), device=q.device)
    for i in range(nb):
        blk = slice(i * block_k, (i + 1) * block_k)
        thin = None
        if seed is not None and dropout_rate > 0.0:
            def thin(p, i=i):
                return dropout(p, dropout_rate, mix_seed(seed, i), rows)
        m, l, o = block_attn(q, k[:, blk], v[:, blk], mask[:, blk], m, l, o,
                             scale, p_for_values=thin)
    out = o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


#: dropout sites within an encoder block
_SITE_PROBS, _SITE_ATTN, _SITE_FFN = 0, 1, 2


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.query = Dense(d, d, cfg.dtype, device)
        self.key = Dense(d, d, cfg.dtype, device)
        self.value = Dense(d, d, cfg.dtype, device)
        self.out = Dense(d, d, cfg.dtype, device)

    def forward(self, x, mask, seed: Optional[int],
                rows: Optional[Tuple[int, int]] = None):
        cfg = self.cfg
        B, S, _ = x.shape
        d_head = cfg.d_model // cfg.num_heads
        shape = (B, S, cfg.num_heads, d_head)
        q = self.query(x).reshape(shape)
        k = self.key(x).reshape(shape)
        v = self.value(x).reshape(shape)
        p_seed = None if seed is None else mix_seed(seed, _SITE_PROBS)
        if cfg.attention_impl not in ("auto", "einsum", "blockwise"):
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r}: expected 'auto', "
                "'einsum', or 'blockwise'")
        if (cfg.attention_impl == "blockwise"
                or (cfg.attention_impl == "auto" and S >= BLOCKWISE_MIN_SEQ)):
            out = blockwise_attention(q, k, v, mask, 1.0 / math.sqrt(d_head),
                                      cfg.dropout_rate, p_seed, rows=rows)
        else:
            # 1 / sqrt(d_head) rounded to the compute dtype, as the
            # reference's ``1.0 / jnp.sqrt(d_head).astype(dtype)``
            scale = float(1.0 / torch.tensor(float(d_head)).sqrt()
                          .to(cfg.dtype))
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            if mask is not None:
                logits = torch.where(
                    mask[:, None, None, :], logits.float(),
                    torch.full((), BIG_NEG, device=logits.device))
            probs = torch.softmax(logits.float(), dim=-1).to(cfg.dtype)
            probs = dropout(probs, cfg.dropout_rate, p_seed, rows)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out.reshape(B, S, cfg.d_model))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, use_moe: bool = False,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        self.attention = SelfAttention(cfg, device)
        self.ln_att = LayerNorm(cfg.d_model, cfg.dtype, device)
        if use_moe:
            from .moe import MoEFFN
            self.moe_ffn = MoEFFN(cfg.num_experts, cfg.d_model, cfg.d_ff,
                                  top_k=cfg.moe_top_k,
                                  capacity_factor=cfg.moe_capacity_factor,
                                  dtype=cfg.dtype, device=device, mesh=mesh)
        else:
            self.ffn_up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, device)
            self.ffn_down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, device)
        self.ln_ffn = LayerNorm(cfg.d_model, cfg.dtype, device)

    def forward(self, x, mask, seed: Optional[int],
                rows: Optional[Tuple[int, int]] = None):
        rate = self.cfg.dropout_rate
        a = self.attention(x, mask, seed, rows)
        a = dropout(a, rate, None if seed is None
                    else mix_seed(seed, _SITE_ATTN), rows)
        x = self.ln_att(x + a)
        if self.use_moe:
            h = self.moe_ffn(x, rows=rows)
        else:
            h = self.ffn_down(F.gelu(self.ffn_up(x), approximate="tanh"))
        h = dropout(h, rate, None if seed is None
                    else mix_seed(seed, _SITE_FFN), rows)
        return self.ln_ffn(x + h)


class TextEncoder(nn.Module):
    """BERT-style encoder + [CLS] pooler + classification head.

    Parameters are drawn as the reference draws them (truncated normal,
    std 0.02, for every ``Dense`` kernel and both embeddings; LayerNorm
    scales 1, biases 0) from ``seed`` by :func:`init_weights`; with
    ``seed=None`` they stay unset until the trainer's ``init_state``
    draws them.  ``mesh`` (a ProcessMesh) shards the MoE layers' experts
    over its ``expert`` axis, if it has one."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = "cuda",
                 seed: Optional[int] = 0, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dev)
        self.pos_embed = Embed(cfg.max_len, cfg.d_model, dev)
        self.ln_embed = LayerNorm(cfg.d_model, cfg.dtype, dev)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}",
                    EncoderBlock(cfg, dev, use_moe=cfg.uses_moe(i),
                                 mesh=mesh))
        self.pooler = Dense(cfg.d_model, cfg.d_model, cfg.dtype, dev)
        self.classifier = Dense(cfg.d_model, cfg.num_classes, torch.float32,
                                dev)
        if seed is not None:
            self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        init_weights(self, seed)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.embedding.device

    def aux_losses(self):
        """The last forward's MoE load-balance losses, in the order of the
        reference's ``losses`` collection (layer names sorted as
        strings); empty without MoE blocks."""
        names = sorted(f"layer_{i}" for i in range(self.cfg.num_layers)
                       if self.cfg.uses_moe(i))
        return [getattr(self, n).moe_ffn.aux_loss for n in names]

    def expert_keys(self):
        """State-dict keys held per rank on an ``expert`` axis (empty
        when the experts are whole)."""
        return [k for k, m in self.named_modules() if hasattr(m, "ep")
                and m.ep > 1 for k in (f"{k}.w_up", f"{k}.w_down")]

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict on every rank: each expert leaf
        all-gathered over the ``expert`` axis (collective on an expert
        mesh; the plain ``state_dict`` otherwise)."""
        from ...parallel.collectives import all_gather
        from ...parallel.mesh import EXPERT_AXIS
        sd = self.state_dict()
        for k in self.expert_keys():
            sd[k] = all_gather(sd[k], self.mesh, EXPERT_AXIS, tiled=True,
                               op="gather_experts")
        return sd

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a whole model's state dict: each expert leaf contributes
        this rank's experts."""
        sd = dict(sd)
        for k in self.expert_keys():
            ffn = self.get_submodule(k.rsplit(".", 1)[0])
            lo = ffn.expert_lo
            sd[k] = sd[k][lo:lo + ffn.local_experts]
        self.load_state_dict(sd)

    def forward(self, input_ids, attention_mask=None, deterministic=True,
                return_embeddings=False, dropout_seed: Optional[int] = None,
                rows: Optional[Tuple[int, int]] = None):
        """``input_ids`` (B, S) int, ``attention_mask`` (B, S) → logits
        (B, num_classes) f32, or with ``return_embeddings`` the (B, S,
        d_model) sequence in ``cfg.dtype``.  ``deterministic=False`` with
        ``dropout_rate > 0`` needs ``dropout_seed`` (the step's seed).
        ``rows=(lo, total)``: the batch is rows ``[lo, lo+B)`` of a
        ``total``-row batch sharded over the mesh's ``data`` axis (a
        training step over a mesh sets it)."""
        cfg = self.cfg
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.bool,
                                        device=input_ids.device)
        else:
            attention_mask = attention_mask.to(torch.bool)
        seed = None
        if not deterministic and cfg.dropout_rate > 0.0:
            if dropout_seed is None:
                raise ValueError("deterministic=False with dropout needs "
                                 "a dropout_seed")
            seed = int(dropout_seed)
        tok = F.embedding(input_ids, self.tok_embed.embedding).to(cfg.dtype)
        pos = self.pos_embed.embedding[:S].to(cfg.dtype)
        x = self.ln_embed(tok + pos[None])
        x = dropout(x, cfg.dropout_rate,
                    None if seed is None else mix_seed(seed, 0), rows)
        for i in range(cfg.num_layers):
            x = run_block(getattr(self, f"layer_{i}"), cfg.remat, x,
                          attention_mask,
                          None if seed is None else mix_seed(seed, 1 + i),
                          rows)
        if return_embeddings:
            return x
        pooled = torch.tanh(self.pooler(x[:, 0, :]))
        return self.classifier(pooled)

    @torch.no_grad()
    def features(self, input_ids, attention_mask=None):
        """Headless (B, S, d_model) sequence embeddings for
        featurization."""
        return self(input_ids, attention_mask, deterministic=True,
                    return_embeddings=True)
