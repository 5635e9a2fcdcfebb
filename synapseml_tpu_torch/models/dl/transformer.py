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
rank's slice of one.

Tensor parallelism (a ``mesh`` with a ``model`` axis of size tp > 1) is
the reference's ``LOGICAL_RULES`` (Megatron's layout), one shard a rank:

- ``tok_embed`` is vocab-parallel: a rank holds ``vocab / tp`` rows,
  looks up the ids in its range (zeros for the others) and the f32 rows
  meet in one all-reduce over ``model``;
- ``query``/``key``/``value`` and ``ffn_up`` are column-parallel (the
  heads and the ``d_ff`` columns split, the bias sliced alike); each
  one's input gradient is its ranks' f32 partial products summed over
  ``model`` and rounded once, where one card rounds (Megatron's "f",
  taken a layer at a time so the gradient is one card's);
- ``out`` and ``ffn_down`` are row-parallel: the partial product runs in
  f32 (the inputs rounded to ``cfg.dtype`` as one card rounds them), one
  all-reduce sums it (Megatron's "g"), the sum is rounded to
  ``cfg.dtype`` where one card's product is, and the bias is added once
  after it;
- ``pos_embed``, the LayerNorms, ``pooler`` and ``classifier`` stay
  replicated; the MoE FFN splits ``d_ff`` of every expert (:mod:`.moe`).

Every shard is drawn whole from the one-card stream and sliced, so one
seed gives the one-card model's weights at any tp.  The replicated
parameters' gradients are equal on every ``model`` rank.  Dropout keeps
the rule above: the probabilities' site draws the whole batch's and all
heads' mask and keeps this rank's rows and heads; the sites after a
row-parallel sum draw the same mask on every ``model`` rank.

``use_ring_attention`` (on a mesh with a ``seq`` axis) runs
:func:`.ring_attention.ring_attention_inner` over it: each rank holds a
contiguous block of every sequence (``input_ids`` (B, S / sp)), its
positions are the block's global positions, the dropout sites draw the
whole sequence's mask and keep the block, the [CLS] row reaches the
head from the first block (one all-reduce over ``seq``), and the
probabilities are not dropped, as in the reference's ring.  Outside such
a mesh it raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, resolve_device
from ...parallel.mesh import MODEL_AXIS, axis_index, axis_size
from .precision import run_block
from .ring_attention import BIG_NEG, _block_attn, ring_attention_inner

#: sequence length from which "auto" switches to blockwise attention
BLOCKWISE_MIN_SEQ = 1024
#: K/V block width for the blockwise scan
BLOCK_K = 512
#: flax ``nn.LayerNorm``'s default epsilon
LN_EPS = 1e-6


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
    #: attention as a ring over the mesh's ``seq_axis`` (module docstring)
    use_ring_attention: bool = False
    seq_axis: str = "seq"

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
            rows: Optional[Tuple[int, int]] = None,
            part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    kept values by ``1 / (1 - rate)``; the mask comes from a generator on
    ``x``'s device seeded with ``seed`` (``None``: no dropout).  With
    ``rows=(lo, total)`` the mask is drawn for ``total`` leading rows and
    rows ``[lo, lo + x.shape[0])`` of it are used; ``part=(dim, lo,
    total)`` does the same along ``dim`` (this rank's heads or sequence
    block)."""
    if seed is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    if rows is None and part is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) \
            < 1.0 - rate
    else:
        shape, index = list(x.shape), [slice(None)] * x.dim()
        for dim, lo, total in ([(0,) + tuple(rows)] if rows else []) + \
                ([tuple(part)] if part else []):
            shape[dim] = total
            index[dim] = slice(lo, lo + x.shape[dim])
        keep = torch.rand(shape, generator=gen,
                          device=x.device)[tuple(index)] < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


# -- layers ---------------------------------------------------------------------

def model_shards(mesh, n: int, what: str) -> Tuple[int, int]:
    """``(tp, index)`` of ``mesh``'s ``model`` axis for a dimension of
    ``n`` that splits over it; raises ``ValueError`` when it does not."""
    tp = axis_size(mesh, MODEL_AXIS)
    if n % tp:
        raise ValueError(f"{what}={n} does not split over a model axis of "
                         f"{tp}")
    return tp, axis_index(mesh, MODEL_AXIS)


class _ColumnMatmul(torch.autograd.Function):
    """``x @ w`` of a column-parallel layer (Megatron's "f" folded in):
    the forward is one card's product of this rank's columns; the input's
    gradient is each rank's partial product ``g @ wᵀ`` in f32, summed over
    ``model`` and rounded to ``x``'s dtype once, where one card rounds
    its whole product (so the layer's input gradient is one card's)."""

    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        from ...parallel.collectives import psum
        x, w = ctx.saved_tensors
        gx = psum(torch.matmul(g.float(), w.float().t()), ctx.mesh,
                  MODEL_AXIS, op="tp_input_grad").to(x.dtype)
        gw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          g.reshape(-1, g.shape[-1]))
        return gx, gw, None


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` is ``(in, out)``; the input, kernel
    and bias are cast to ``dtype``, multiplied and added there.  The
    kernel draws from a truncated normal of std ``stddev``.

    ``parallel`` (with a ``mesh`` whose ``model`` axis has tp > 1):
    ``"column"`` holds output columns ``[i·out/tp, (i+1)·out/tp)`` of the
    kernel and the bias, and its input's gradient sums over ``model``
    (:class:`_ColumnMatmul`); ``"row"`` holds input rows ``[i·in/tp,
    (i+1)·in/tp)`` of the kernel and the whole bias, sums the f32 partial
    products over ``model`` and adds the bias once (module docstring)."""

    def __init__(self, in_features: int, features: int, dtype, device,
                 stddev: float = 0.02, mesh=None,
                 parallel: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.stddev = stddev
        self.mesh = mesh
        self.full_shape = (in_features, features)
        tp, idx = 1, 0
        if parallel == "column":
            tp, idx = model_shards(mesh, features, "features")
        elif parallel == "row":
            tp, idx = model_shards(mesh, in_features, "in_features")
        elif parallel is not None:
            raise ValueError(f"parallel={parallel!r}: 'column' or 'row'")
        self.parallel = parallel if tp > 1 else None
        self.tp, self.tp_index = tp, idx
        cols = features // tp if self.parallel == "column" else features
        rows = in_features // tp if self.parallel == "row" else in_features
        self.kernel = _param((rows, cols), device)
        self.bias = _param((cols,), device)

    def shard_dims(self) -> Dict[str, list]:
        """Parameter name → the ``(axis, dim)`` splits of its shard."""
        if self.parallel == "column":
            return {"kernel": [(MODEL_AXIS, 1)], "bias": [(MODEL_AXIS, 0)]}
        if self.parallel == "row":
            return {"kernel": [(MODEL_AXIS, 0)]}
        return {}

    def reset_parameters(self, gen: torch.Generator) -> None:
        full = trunc_normal(self.full_shape, gen, self.stddev)
        if self.parallel is not None:
            dim = 1 if self.parallel == "column" else 0
            n = self.kernel.shape[dim]
            full = full.narrow(dim, self.tp_index * n, n)
        self.kernel.copy_(full)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.parallel == "row":
            from ...parallel.collectives import reduce_forward
            part = torch.matmul(x.to(self.dtype).float(),
                                self.kernel.to(self.dtype).float())
            y = reduce_forward(part, self.mesh, MODEL_AXIS, op="tp_row_sum")
            return y.to(self.dtype) + self.bias.to(self.dtype)
        if self.parallel == "column" and torch.is_grad_enabled():
            return _ColumnMatmul.apply(x.to(self.dtype),
                                       self.kernel.to(self.dtype),
                                       self.mesh) + self.bias.to(self.dtype)
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype)) \
            + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``'s table ``(num, features)``, truncated normal
    std 0.02; the caller gathers rows (:meth:`lookup`) and casts them.
    With ``vocab_parallel`` on a ``model`` axis of size tp a rank holds
    rows ``[i·num/tp, (i+1)·num/tp)``."""

    def __init__(self, num: int, features: int, device, mesh=None,
                 vocab_parallel: bool = False):
        super().__init__()
        self.mesh = mesh
        self.full_shape = (num, features)
        tp, idx = (model_shards(mesh, num, "vocab_size") if vocab_parallel
                   else (1, 0))
        self.tp, self.lo = tp, idx * (num // tp)
        self.embedding = _param((num // tp, features), device)

    def shard_dims(self) -> Dict[str, list]:
        return {"embedding": [(MODEL_AXIS, 0)]} if self.tp > 1 else {}

    def reset_parameters(self, gen: torch.Generator) -> None:
        full = trunc_normal(self.full_shape, gen, 0.02)
        self.embedding.copy_(full[self.lo:self.lo + self.embedding.shape[0]])

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The f32 rows of ``ids``; vocab-parallel, each rank's rows of its
        range (zeros elsewhere) summed over ``model``."""
        if self.tp == 1:
            return F.embedding(ids, self.embedding)
        from ...parallel.collectives import reduce_forward
        n = self.embedding.shape[0]
        local = ids.long() - self.lo
        mine = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), self.embedding)
        rows = rows * mine[..., None].to(rows.dtype)
        return reduce_forward(rows, self.mesh, MODEL_AXIS, op="tp_embed_sum")


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


#: one K/V block's online-softmax update, shared with the ring
block_attn = _block_attn


def blockwise_attention(q, k, v, mask, scale: float, dropout_rate: float,
                        seed: Optional[int], block_k: int = BLOCK_K,
                        rows: Optional[Tuple[int, int]] = None,
                        heads: Optional[Tuple[int, int]] = None):
    """Exact attention as an online-softmax scan over K/V blocks: the
    logits never materialize at O(S²).  Probabilities dropout hits the
    value path of each block with its own mask (``seed`` mixed with the
    block index); the normalizer stays dropout-free.  ``heads=(lo,
    total)``: ``q`` holds heads ``[lo, lo+H)`` of ``total`` (tensor
    parallelism), and the masks are those heads' of the whole draw.

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
                return dropout(p, dropout_rate, mix_seed(seed, i), rows,
                               None if heads is None else (1,) + heads)
        m, l, o = block_attn(q, k[:, blk], v[:, blk], mask[:, blk], m, l, o,
                             scale, p_for_values=thin)
    out = o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


#: dropout sites within an encoder block
_SITE_PROBS, _SITE_ATTN, _SITE_FFN = 0, 1, 2


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        d = cfg.d_model
        tp, idx = model_shards(mesh, cfg.num_heads, "num_heads")
        #: this rank's heads ``[head_lo, head_lo + local_heads)``
        self.local_heads = cfg.num_heads // tp
        self.head_lo = idx * self.local_heads
        self.query = Dense(d, d, cfg.dtype, device, mesh=mesh,
                           parallel="column")
        self.key = Dense(d, d, cfg.dtype, device, mesh=mesh,
                         parallel="column")
        self.value = Dense(d, d, cfg.dtype, device, mesh=mesh,
                           parallel="column")
        self.out = Dense(d, d, cfg.dtype, device, mesh=mesh, parallel="row")

    def forward(self, x, mask, seed: Optional[int],
                rows: Optional[Tuple[int, int]] = None):
        cfg = self.cfg
        B, S, _ = x.shape
        d_head = cfg.d_model // cfg.num_heads
        H = self.local_heads
        heads = (None if H == cfg.num_heads
                 else (self.head_lo, cfg.num_heads))
        shape = (B, S, H, d_head)
        q = self.query(x).reshape(shape)
        k = self.key(x).reshape(shape)
        v = self.value(x).reshape(shape)
        p_seed = None if seed is None else mix_seed(seed, _SITE_PROBS)
        if cfg.attention_impl not in ("auto", "einsum", "blockwise"):
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r}: expected 'auto', "
                "'einsum', or 'blockwise'")
        if cfg.use_ring_attention:
            out = ring_attention_inner(q, k, v, mask, self.mesh,
                                       cfg.seq_axis)
        elif (cfg.attention_impl == "blockwise"
                or (cfg.attention_impl == "auto" and S >= BLOCKWISE_MIN_SEQ)):
            out = blockwise_attention(q, k, v, mask, 1.0 / math.sqrt(d_head),
                                      cfg.dropout_rate, p_seed, rows=rows,
                                      heads=heads)
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
            probs = dropout(probs, cfg.dropout_rate, p_seed, rows,
                            None if heads is None else (1,) + heads)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out.reshape(B, S, H * d_head))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, use_moe: bool = False,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        self.attention = SelfAttention(cfg, device, mesh)
        self.ln_att = LayerNorm(cfg.d_model, cfg.dtype, device)
        if use_moe:
            from .moe import MoEFFN
            self.moe_ffn = MoEFFN(cfg.num_experts, cfg.d_model, cfg.d_ff,
                                  top_k=cfg.moe_top_k,
                                  capacity_factor=cfg.moe_capacity_factor,
                                  dtype=cfg.dtype, device=device, mesh=mesh)
        else:
            self.ffn_up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, device,
                                mesh=mesh, parallel="column")
            self.ffn_down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, device,
                                  mesh=mesh, parallel="row")
        self.ln_ffn = LayerNorm(cfg.d_model, cfg.dtype, device)

    def forward(self, x, mask, seed: Optional[int],
                rows: Optional[Tuple[int, int]] = None,
                part: Optional[Tuple[int, int, int]] = None):
        """``part``: this rank's sequence block ``(1, lo, total)`` for the
        activation dropout sites (ring attention)."""
        rate = self.cfg.dropout_rate
        a = self.attention(x, mask, seed, rows)
        a = dropout(a, rate, None if seed is None
                    else mix_seed(seed, _SITE_ATTN), rows, part)
        x = self.ln_att(x + a)
        if self.use_moe:
            h = self.moe_ffn(x, rows=rows)
        else:
            h = self.ffn_down(F.gelu(self.ffn_up(x), approximate="tanh"))
        h = dropout(h, rate, None if seed is None
                    else mix_seed(seed, _SITE_FFN), rows, part)
        return self.ln_ffn(x + h)


class TextEncoder(nn.Module):
    """BERT-style encoder + [CLS] pooler + classification head.

    Parameters are drawn as the reference draws them (truncated normal,
    std 0.02, for every ``Dense`` kernel and both embeddings; LayerNorm
    scales 1, biases 0) from ``seed`` by :func:`init_weights`; with
    ``seed=None`` they stay unset until the trainer's ``init_state``
    draws them.  ``mesh`` (a ProcessMesh) shards the MoE layers' experts
    over its ``expert`` axis and the weights over its ``model`` axis, if
    it has them, and carries the ring of ``cfg.use_ring_attention`` over
    its ``seq`` axis (module docstring)."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = "cuda",
                 seed: Optional[int] = 0, mesh=None):
        super().__init__()
        if cfg.use_ring_attention and \
                cfg.seq_axis not in getattr(mesh, "shape", {}):
            raise ValueError(
                "use_ring_attention=True runs the attention as a ring over "
                f"the mesh's {cfg.seq_axis!r} axis: build the TextEncoder "
                "with a ProcessMesh that has one (parallel.mesh."
                "dp_sp_tp_mesh), or leave the flag off")
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dev, mesh=mesh,
                               vocab_parallel=True)
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

    def shard_specs(self) -> Dict[str, list]:
        """State-dict key → the ``(axis, dim)`` splits of the leaves a
        rank holds a block of (``expert`` and ``model`` axes; empty for a
        model whose every leaf is whole)."""
        return shard_specs(self)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict on every rank: each sharded leaf
        all-gathered over its axes (collective over a mesh; the plain
        ``state_dict`` otherwise)."""
        return gather_full(self.state_dict(), self.shard_specs(), self.mesh)

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a whole model's state dict: each sharded leaf contributes
        this rank's block."""
        self.load_state_dict(slice_full(sd, self.shard_specs(), self.mesh))

    def forward(self, input_ids, attention_mask=None, deterministic=True,
                return_embeddings=False, dropout_seed: Optional[int] = None,
                rows: Optional[Tuple[int, int]] = None):
        """``input_ids`` (B, S) int, ``attention_mask`` (B, S) → logits
        (B, num_classes) f32, or with ``return_embeddings`` the (B, S,
        d_model) sequence in ``cfg.dtype``.  ``deterministic=False`` with
        ``dropout_rate > 0`` needs ``dropout_seed`` (the step's seed).
        ``rows=(lo, total)``: the batch is rows ``[lo, lo+B)`` of a
        ``total``-row batch sharded over the mesh's ``data`` axis (a
        training step over a mesh sets it).  Under ring attention the
        inputs are this rank's sequence block and so are the embeddings;
        the logits are every block's."""
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
        part, s_index = None, 0
        if cfg.use_ring_attention:
            s_index = self.mesh.axis_index(cfg.seq_axis)
            sp = self.mesh.axis_size(cfg.seq_axis)
            part = (1, s_index * S, sp * S)
        tok = self.tok_embed.lookup(input_ids).to(cfg.dtype)
        lo = s_index * S
        pos = self.pos_embed.embedding[lo:lo + S].to(cfg.dtype)
        x = self.ln_embed(tok + pos[None])
        x = dropout(x, cfg.dropout_rate,
                    None if seed is None else mix_seed(seed, 0), rows, part)
        for i in range(cfg.num_layers):
            x = run_block(getattr(self, f"layer_{i}"), cfg.remat, x,
                          attention_mask,
                          None if seed is None else mix_seed(seed, 1 + i),
                          rows, part)
        if return_embeddings:
            return x
        cls = x[:, 0, :]
        if part is not None:
            # the [CLS] row lives in the first block: one all-reduce over
            # seq hands it to every rank (exact: the others add zeros)
            from ...parallel.collectives import reduce_forward
            cls = cls.float() if s_index == 0 else \
                torch.zeros_like(cls, dtype=torch.float32)
            cls = reduce_forward(cls, self.mesh, cfg.seq_axis,
                                 op="ring_cls").to(cfg.dtype)
        pooled = torch.tanh(self.pooler(cls))
        return self.classifier(pooled)

    @torch.no_grad()
    def features(self, input_ids, attention_mask=None):
        """Headless (B, S, d_model) sequence embeddings for
        featurization."""
        return self(input_ids, attention_mask, deterministic=True,
                    return_embeddings=True)


def shard_specs(model: nn.Module) -> Dict[str, list]:
    """State-dict key → ``(axis, dim)`` splits, from every submodule's
    ``shard_dims()``."""
    out = {}
    for name, mod in model.named_modules():
        dims = getattr(mod, "shard_dims", None)
        if dims is None:
            continue
        for p, splits in dims().items():
            if splits:
                out[f"{name}.{p}" if name else p] = list(splits)
    return out


def gather_full(sd: Dict[str, torch.Tensor], specs: Dict[str, list],
                mesh) -> Dict[str, torch.Tensor]:
    """``sd`` with each leaf of ``specs`` all-gathered over its axes along
    its dims (collective over ``mesh``)."""
    from ...parallel.collectives import all_gather
    sd = dict(sd)
    for k, splits in specs.items():
        t = sd[k]
        for axis, dim in splits:
            parts = all_gather(t.contiguous(), mesh, axis, op="gather_shards")
            t = torch.cat(list(parts.unbind(0)), dim=dim)
        sd[k] = t
    return sd


def slice_full(sd: Dict[str, torch.Tensor], specs: Dict[str, list],
               mesh) -> Dict[str, torch.Tensor]:
    """``sd`` (whole leaves) with each leaf of ``specs`` cut to this
    rank's block (``mesh`` None: nothing is cut)."""
    sd = dict(sd)
    for k, splits in specs.items():
        t = sd[k]
        for axis, dim in splits:
            n = axis_size(mesh, axis)
            per = t.shape[dim] // n
            t = t.narrow(dim, axis_index(mesh, axis) * per, per)
        sd[k] = t.contiguous()
    return sd
