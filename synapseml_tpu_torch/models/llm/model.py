"""Decoder-only causal LLM (Llama-3 family architecture) as ``nn.Module``s.

The PyTorch port of the JAX package's ``models/llm/model.py``: RMSNorm,
rotary embeddings, grouped-query attention and a SwiGLU MLP, with the KV
cache as explicit state — a list of per-layer ``{"k", "v"}`` tensors
shaped ``(batch, max_len, kv_heads, d_head)`` that the attention updates
IN PLACE (the reference threads an immutable pytree through ``apply``
and donates it; here the write lands in the caller's tensors and the
same list comes back).

Parameters keep the reference's layouts and names, so a flax parameter
tree converts by renaming alone (:mod:`.convert`): projection kernels
are ``(in, out)``, the embedding table ``(vocab, d_model)``.  The
precision rules are the reference's: projections compute in
``cfg.dtype``, RMSNorm in f32 then ``(normed * scale).to(dtype)``,
attention scores and softmax in f32 with the probabilities cast to
``cfg.dtype`` before the PV product, and the tied head promotes both the
hidden state and the table to ``cfg.dtype`` (flax ``nn.Embed.attend``)
before its logits go to f32.  The projections are plain ``torch.matmul``
as the reference leaves them to XLA; the paged decode read is the K3
kernel (:mod:`.paged_attn`).

``weight_quant="int8"`` (weight-only int8, the reference's
:class:`QuantDense` / :class:`QuantEmbed`): every projection holds an int8
kernel and an f32 scale per output channel, and computes ``(x @
kq.to(dtype)) * scale.to(dtype)``; a tied embedding holds an int8 table
with an f32 scale per vocabulary row, and its head runs the product in
f32 before multiplying by the scale.  The int8 tensors stay int8 on the
device; each use casts them (no dequantized copy is kept).
:func:`~.generate.quantize_int8` makes such a model from a float one.

Tensor parallelism (``mesh`` with a ``model`` axis of size tp > 1) is the
reference's ``LLM_LOGICAL_RULES`` (Megatron's layout), one shard a rank:
``q_proj``/``k_proj``/``v_proj``/``gate_proj``/``up_proj`` are
column-parallel (a rank holds ``heads / tp`` query heads, ``kv / tp``
key-value heads and ``d_ff / tp`` hidden units; an int8 kernel's
``scale`` splits with its columns); ``o_proj`` and ``down_proj`` are
row-parallel (the f32 partial products meet in one all-reduce over
``model``, rounded to the compute type where one card's product is; an
int8 row's ``scale`` stays whole and multiplies the sum); the embedding
(``embedding`` or ``embedding_q`` and its row ``scale``) is
vocab-parallel: a lookup sums each rank's rows of its range over
``model``, and the head's logits (tied or ``lm_head``, split over the
vocabulary) are all-gathered over ``model`` before anyone samples, so
every rank holds the whole ``(B, S, vocab)`` logits.  The KV cache holds
``kv / tp`` heads (:func:`init_cache` with ``tp``).  Every shard is drawn
whole from the one-card stream and sliced, so one seed gives the
one-card model's weights at any tp.  The dense ``generate`` runs such a
model; the continuous-batching engine does not (:mod:`.slots` refuses
it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...parallel.mesh import MODEL_AXIS, axis_index, axis_size
from .paged_attn import paged_decode_attention

#: flax ``truncated_normal(stddev)`` draws from a standard normal cut at
#: ±2 and rescales by this constant, so the kept values have std ``stddev``
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(unsafe_hash=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    d_ff: int = 14_336
    max_len: int = 8192
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    #: "int8": projections (and a tied embedding) hold int8 weights with
    #: f32 scales (:class:`QuantDense`, :class:`QuantEmbed`)
    weight_quant: str = "none"

    @property
    def d_head(self) -> int:
        return self.d_model // self.num_heads

    @staticmethod
    def llama3_1b(**kw) -> "LlamaConfig":
        """Llama-3.2-1B's published shapes; ``kw`` overrides any field
        (a cut depth: ``num_layers=2``)."""
        shapes = dict(d_model=2048, num_layers=16, num_heads=32,
                      num_kv_heads=8, d_ff=8192, tie_embeddings=True)
        return LlamaConfig(**{**shapes, **kw})

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test config: byte vocab, 4 layers."""
        kw.setdefault("vocab_size", 512)
        kw.setdefault("d_model", 128)
        kw.setdefault("num_layers", 4)
        kw.setdefault("num_heads", 8)
        kw.setdefault("num_kv_heads", 4)
        kw.setdefault("d_ff", 256)
        kw.setdefault("max_len", 256)
        return LlamaConfig(**kw)


def _trunc_normal(shape, device, generator, stddev: float = 0.02,
                  block=None):
    """A truncated-normal parameter drawn whole at ``shape``; ``block=
    (dim, lo, n)`` keeps ``n`` entries from ``lo`` along ``dim`` (a
    tensor-parallel shard of the one-card draw)."""
    s = stddev / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, std=s, a=-2 * s, b=2 * s, generator=generator)
    if block is not None:
        w = w.narrow(*block).contiguous()
    return nn.Parameter(w)


def _shards(mesh, parallel: Optional[str], in_features: int,
            features: int):
    """``(tp, index, rows, cols)`` of a projection's kernel shard."""
    tp = axis_size(mesh, MODEL_AXIS) if parallel else 1
    n = features if parallel == "column" else in_features
    if n % tp:
        raise ValueError(f"{n} does not split over a model axis of {tp}")
    idx = axis_index(mesh, MODEL_AXIS) if tp > 1 else 0
    rows = in_features // tp if parallel == "row" else in_features
    cols = features // tp if parallel == "column" else features
    return tp, idx, rows, cols


def _row_sum(part: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel layer's f32 partial products summed over
    ``model``."""
    from ...parallel.collectives import reduce_forward
    return reduce_forward(part, mesh, MODEL_AXIS, op="tp_row_sum")


class Dense(nn.Module):
    """flax ``nn.Dense`` without bias: ``kernel`` is ``(in, out)``; the
    input and kernel are cast to ``dtype`` and multiplied there.
    ``parallel`` ("column" | "row", with a ``model`` axis on ``mesh``)
    holds this rank's columns or rows (module docstring)."""

    def __init__(self, in_features: int, features: int, dtype,
                 device: torch.device, generator: torch.Generator,
                 mesh=None, parallel: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.mesh = mesh
        tp, idx, rows, cols = _shards(mesh, parallel, in_features, features)
        self.parallel = parallel if tp > 1 else None
        block = None
        if self.parallel == "column":
            block = (1, idx * cols, cols)
        elif self.parallel == "row":
            block = (0, idx * rows, rows)
        self.kernel = _trunc_normal((in_features, features), device,
                                    generator, block=block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.parallel == "row":
            part = torch.matmul(x.to(self.dtype).float(),
                                self.kernel.to(self.dtype).float())
            return _row_sum(part, self.mesh).to(self.dtype)
        if self.parallel == "column" and torch.is_grad_enabled():
            # the input's gradient sums over model (the DL encoder's)
            from ..dl.transformer import _ColumnMatmul
            return _ColumnMatmul.apply(x.to(self.dtype),
                                       self.kernel.to(self.dtype), self.mesh)
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))


class QuantDense(nn.Module):
    """int8 weight-only Dense: ``kernel_q`` (in, out) int8 and ``scale``
    (out,) f32; the scale is applied after the product (a per-column
    scale commutes with the contraction).  The product runs in the
    promotion of the input's type and ``dtype``, as the reference's
    ``dot_general``.  ``parallel`` as :class:`Dense`'s: a column shard
    splits ``scale`` with its columns, a row shard sums the f32 partial
    products over ``model`` before the whole ``scale``."""

    def __init__(self, in_features: int, features: int, dtype,
                 device: torch.device, mesh=None,
                 parallel: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.mesh = mesh
        tp, _, rows, cols = _shards(mesh, parallel, in_features, features)
        self.parallel = parallel if tp > 1 else None
        self.kernel_q = nn.Parameter(
            torch.zeros((rows, cols), dtype=torch.int8,
                        device=device), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cols, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, self.dtype)
        if self.parallel == "row":
            part = torch.matmul(x.to(ct).float(), self.kernel_q.float())
            y = _row_sum(part, self.mesh).to(ct)
        else:
            y = torch.matmul(x.to(ct), self.kernel_q.to(ct))
        return y * self.scale.to(self.dtype)


class _VocabParallel:
    """The vocab-parallel lookup and head of the embeddings: a rank holds
    rows ``[lo, lo + n)`` of the table."""

    def _vocab_split(self, vocab: int, mesh) -> int:
        self.mesh = mesh
        self.tp = axis_size(mesh, MODEL_AXIS)
        if vocab % self.tp:
            raise ValueError(f"vocab_size={vocab} does not split over a "
                             f"model axis of {self.tp}")
        n = vocab // self.tp
        self.lo = (axis_index(mesh, MODEL_AXIS) if self.tp > 1 else 0) * n
        return n

    def _lookup(self, ids: torch.Tensor, rows_of) -> torch.Tensor:
        """``rows_of(local ids)`` for this rank's range, zeros elsewhere,
        summed over ``model`` (exact: one rank adds a nonzero row)."""
        if self.tp == 1:
            return rows_of(ids.long())
        n = self.n_local
        local = ids.long() - self.lo
        mine = (local >= 0) & (local < n)
        rows = rows_of(local.clamp(0, n - 1))
        rows = rows.float() * mine[..., None].float()
        from ...parallel.collectives import reduce_forward
        return reduce_forward(rows, self.mesh, MODEL_AXIS,
                              op="tp_embed_sum")

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Each rank's vocabulary columns → the whole logits on every
        rank (one all-gather over ``model``)."""
        if self.tp == 1:
            return logits
        from ...parallel.collectives import all_gather
        parts = all_gather(logits.contiguous(), self.mesh, MODEL_AXIS,
                           op="tp_logits_gather")
        return torch.cat(list(parts.unbind(0)), dim=-1)


class QuantEmbed(nn.Module, _VocabParallel):
    """int8 tied embedding: one (vocab, features) int8 table with an f32
    scale per vocabulary row serves the lookup (exact per-row dequant)
    and the :meth:`attend` head (the row scale commutes out of the
    contraction over features and multiplies the logits columnwise)."""

    def __init__(self, vocab: int, features: int, dtype,
                 device: torch.device, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.n_local = self._vocab_split(vocab, mesh)
        self.embedding_q = nn.Parameter(
            torch.zeros((self.n_local, features), dtype=torch.int8,
                        device=device), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(self.n_local,
                                             dtype=torch.float32,
                                             device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._lookup(ids, lambda i: (
            self.embedding_q[i].to(self.dtype)
            * self.scale[i].to(self.dtype)[..., None])).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (..., vocab) f32: the product of ``x`` and the int8 table
        in f32 (the reference's ``preferred_element_type``), times the
        row scales."""
        return self._gather_vocab(
            torch.matmul(x.float(), self.embedding_q.float().T) * self.scale)


def _dense(in_features: int, features: int, dtype, device, generator,
           quant: str = "none", mesh=None,
           parallel: Optional[str] = None) -> nn.Module:
    if quant == "int8":
        return QuantDense(in_features, features, dtype, device, mesh,
                          parallel)
    return Dense(in_features, features, dtype, device, generator, mesh,
                 parallel)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float, dtype,
                 device: torch.device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        normed = xf * torch.rsqrt(var + self.eps)
        return (normed * self.scale).to(self.dtype)


def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, np.float32) / d_head))


@functools.lru_cache(maxsize=None)
def _inv_freq(d_head: int, theta: float, device: torch.device):
    """The device copy of :func:`rope_frequencies`, made once per
    ``(d_head, theta, device)``: a host-to-device copy from pageable
    memory is illegal while a CUDA graph captures the forward."""
    return torch.from_numpy(rope_frequencies(d_head, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute token positions."""
    inv = _inv_freq(x.shape[-1], float(theta), x.device)       # (D/2,)
    ang = positions[..., None].float() * inv                   # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda",
               tp: int = 1) -> List[Dict[str, torch.Tensor]]:
    """Per-layer KV cache: ``batch`` rows of ``(max_len, kv_heads / tp,
    d_head)`` zeros in ``cfg.dtype`` (``tp``: the model's ``model``-axis
    size; a rank caches its own key-value heads).  ``batch`` doubles as
    the slot axis of the continuous-batching engine (:mod:`.slots`)."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads // tp, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.num_layers)]


class CausalAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device,
                 generator: torch.Generator, mesh=None):
        super().__init__()
        self.cfg = cfg
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
        tp = axis_size(mesh, MODEL_AXIS)
        if H % tp or KV % tp:
            raise ValueError(f"{H} heads and {KV} key-value heads must split "
                             f"over a model axis of {tp}")
        #: this rank's query and key-value heads
        self.heads, self.kv_heads = H // tp, KV // tp
        q = cfg.weight_quant
        self.q_proj = _dense(cfg.d_model, H * D, cfg.dtype, device,
                             generator, q, mesh, "column")
        self.k_proj = _dense(cfg.d_model, KV * D, cfg.dtype, device,
                             generator, q, mesh, "column")
        self.v_proj = _dense(cfg.d_model, KV * D, cfg.dtype, device,
                             generator, q, mesh, "column")
        self.o_proj = _dense(H * D, cfg.d_model, cfg.dtype, device,
                             generator, q, mesh, "row")

    def forward(self, x, positions, cache: Optional[Dict],
                cache_index=None, slot_mask: Optional[torch.Tensor] = None,
                attention_backend: str = "dense",
                paged_variant: Optional[str] = None):
        """→ ``(out, cache)``.  ``cache_index`` is an int (prefill: write
        the S new K/V rows at that offset of every batch row) or a ``(B,)``
        tensor (decode / verify: row b writes its S rows at its own
        offset).  ``slot_mask`` gates the vector write: an inactive row
        rewrites the values it holds, so its K/V is bitwise unchanged
        (the reference's payload masking).  Every written position must
        lie inside the cache: the engine guarantees it.  ``paged_variant``
        picks the paged read's kernel (``paged_attn.PAGED_VARIANTS``;
        None: its dtype's default)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, cfg.d_head
        q = apply_rope(self.q_proj(x).reshape(B, S, H, D), positions,
                       cfg.rope_theta)
        k = apply_rope(self.k_proj(x).reshape(B, S, KV, D), positions,
                       cfg.rope_theta)
        v = self.v_proj(x).reshape(B, S, KV, D)

        vector = cache is not None and torch.is_tensor(cache_index) \
            and cache_index.dim() > 0
        if cache is not None:
            k_all, v_all = cache["k"], cache["v"]
            T = k_all.shape[1]
            if not vector:
                ci = int(cache_index)
                if ci < 0 or ci + S > T:
                    raise ValueError(f"cache_index {ci} + {S} new rows "
                                     f"overrun the cache's {T} positions")
                k_all[:, ci:ci + S] = k
                v_all[:, ci:ci + S] = v
            else:
                wpos = (cache_index.long()[:, None]
                        + torch.arange(S, device=x.device)[None, :])
                bidx = torch.arange(B, device=x.device)[:, None]
                k_w, v_w = k, v
                if slot_mask is not None:
                    m = slot_mask.to(torch.bool).reshape(B, 1, 1, 1)
                    k_w = torch.where(m, k, k_all[bidx, wpos])
                    v_w = torch.where(m, v, v_all[bidx, wpos])
                k_all.index_put_((bidx, wpos), k_w)
                v_all.index_put_((bidx, wpos), v_w)
        else:
            k_all, v_all = k, v

        if attention_backend in ("paged", "interpret") and vector:
            # the paged decode read (K3): each slot attends only its live
            # span; spans count the LAST query's keys.  'interpret' is the
            # reference's CPU spelling of the same read
            spans = (positions[:, -1].to(torch.int32) + 1).contiguous()
            out = paged_decode_attention(q, k_all, v_all, spans,
                                         variant=paged_variant)
            out = out.reshape(B, S, H * D)
        else:
            if cache is not None:
                key_pos = torch.arange(k_all.shape[1], device=x.device)
                causal = key_pos[None, None, :] <= positions[:, :, None]
            else:
                causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                               device=x.device))[None]
            group = H // KV
            qg = q.reshape(B, S, KV, group, D)
            logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                                  k_all.float())
            logits = logits / float(np.sqrt(D))
            logits = logits.masked_fill(~causal[:, None, None],
                                        torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
            out = torch.einsum("bkgst,btkd->bskgd", probs, v_all)
            out = out.reshape(B, S, H * D)
        return self.o_proj(out), cache


class DecoderBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device,
                 generator: torch.Generator, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = RMSNorm(cfg.d_model, cfg.rms_norm_eps, cfg.dtype,
                               device)
        self.attn = CausalAttention(cfg, device, generator, mesh)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.rms_norm_eps, cfg.dtype,
                              device)
        q = cfg.weight_quant
        self.gate_proj = _dense(cfg.d_model, cfg.d_ff, cfg.dtype, device,
                                generator, q, mesh, "column")
        self.up_proj = _dense(cfg.d_model, cfg.d_ff, cfg.dtype, device,
                              generator, q, mesh, "column")
        self.down_proj = _dense(cfg.d_ff, cfg.d_model, cfg.dtype, device,
                                generator, q, mesh, "row")

    def forward(self, x, positions, cache, cache_index, slot_mask=None,
                attention_backend: str = "dense",
                paged_variant: Optional[str] = None):
        a, cache = self.attn(self.ln_attn(x), positions, cache, cache_index,
                             slot_mask, attention_backend, paged_variant)
        x = x + a
        h = self.ln_mlp(x)
        h = nn.functional.silu(self.gate_proj(h)) * self.up_proj(h)  # SwiGLU
        return x + self.down_proj(h), cache


class Embed(nn.Module, _VocabParallel):
    """flax ``nn.Embed``: ``embedding`` is ``(vocab, features)``; lookups
    and :meth:`attend` compute in ``dtype`` (vocab-parallel over a
    ``model`` axis: module docstring)."""

    def __init__(self, vocab: int, features: int, dtype,
                 device: torch.device, generator: torch.Generator,
                 mesh=None):
        super().__init__()
        self.dtype = dtype
        self.n_local = self._vocab_split(vocab, mesh)
        self.embedding = _trunc_normal(
            (vocab, features), device, generator,
            block=(0, self.lo, self.n_local) if self.tp > 1 else None)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._lookup(ids, lambda i: nn.functional.embedding(
            i, self.embedding)).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather_vocab(torch.matmul(
            x.to(self.dtype), self.embedding.to(self.dtype).T))


class LlamaModel(nn.Module):
    """Causal LM: ``forward`` returns logits (B, S, vocab) f32; pass a
    cache (:func:`init_cache`) and ``cache_index`` for incremental decode,
    and ``(logits, cache)`` comes back.

    Parameters are created on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``) in f32, drawn from ``seed`` as
    the reference initializes them (truncated normal, std 0.02; RMSNorm
    scales 1); :func:`~.generate.cast_params` casts them to the serving
    type.  ``cfg.weight_quant="int8"`` builds the int8 modules (zero
    kernels, unit scales, as the reference initializes them): load a
    quantized state dict into them (:func:`~.generate.quantize_int8`).
    ``mesh`` (a ProcessMesh with a ``model`` axis) shards the model
    over it (module docstring); :meth:`load_full_state_dict` takes this
    rank's shard of a whole state dict and :meth:`full_state_dict`
    gathers one."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda",
                 seed: int = 0, mesh=None):
        super().__init__()
        if cfg.weight_quant not in ("none", "int8"):
            raise ValueError(f"weight_quant={cfg.weight_quant!r}: must be "
                             "'none' or 'int8'")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.cfg = cfg
        self.mesh = mesh
        #: the ``model`` axis size (1: the whole model on this rank)
        self.tp = axis_size(mesh, MODEL_AXIS)
        if self.tp > 1 and cfg.d_ff % self.tp:
            raise ValueError(f"d_ff={cfg.d_ff} does not split over a model "
                             f"axis of {self.tp}")
        if cfg.tie_embeddings and cfg.weight_quant == "int8":
            self.tok_embed = QuantEmbed(cfg.vocab_size, cfg.d_model,
                                        cfg.dtype, dev, mesh)
        else:
            self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype,
                                   dev, gen, mesh)
        self.layers = nn.ModuleList(DecoderBlock(cfg, dev, gen, mesh)
                                    for _ in range(cfg.num_layers))
        self.ln_final = RMSNorm(cfg.d_model, cfg.rms_norm_eps, cfg.dtype,
                                dev)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg.d_model, cfg.vocab_size, torch.float32,
                                  dev, gen, cfg.weight_quant, mesh, "column")

    @property
    def device(self) -> torch.device:
        return self.ln_final.scale.device

    def shard_specs(self) -> Dict[str, list]:
        """State-dict key → the ``(axis, dim)`` split of the leaves a rank
        holds a block of (empty without a ``model`` axis)."""
        return tp_shard_specs(self.state_dict().keys()) if self.tp > 1 \
            else {}

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict on every rank (collective over a
        ``model`` axis)."""
        from ..dl.transformer import gather_full
        return gather_full(self.state_dict(), self.shard_specs(), self.mesh)

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a whole model's state dict: each sharded leaf contributes
        this rank's block."""
        from ..dl.transformer import slice_full
        self.load_state_dict(slice_full(sd, self.shard_specs(), self.mesh))

    def forward(self, input_ids, positions=None, cache=None,
                cache_index=None, slot_mask: Optional[torch.Tensor] = None,
                attention_backend: str = "dense",
                paged_variant: Optional[str] = None):
        cfg = self.cfg
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=input_ids.device)[None].expand(
                                         B, S)
        x = self.tok_embed(input_ids)
        for i, layer in enumerate(self.layers):
            x, _ = layer(x, positions, cache[i] if cache is not None
                         else None, cache_index, slot_mask,
                         attention_backend, paged_variant)
        x = self.ln_final(x)
        if isinstance(self.tok_embed, QuantEmbed):
            logits = self.tok_embed.attend(x)   # f32 product inside
        elif cfg.tie_embeddings:
            logits = self.tok_embed.attend(x.float())
        else:
            logits = self.lm_head(x)
            if self.tp > 1:
                logits = self.tok_embed._gather_vocab(logits)
        logits = logits.float()
        if cache is not None:
            return logits, cache
        return logits


#: projections split over the ``model`` axis by their key's suffix:
#: column-parallel (dim 1 of the kernel, the scale with it) or
#: row-parallel (dim 0 of the kernel; the scale stays whole)
_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
_ROW = ("o_proj", "down_proj")


def tp_shard_specs(keys) -> Dict[str, list]:
    """The Megatron layout of a :class:`LlamaModel` state dict's ``keys``:
    key → ``[(MODEL_AXIS, dim)]`` for every leaf a rank holds a block of
    (``LLM_LOGICAL_RULES``: heads, kv, mlp and vocab on ``model``)."""
    out = {}
    for k in keys:
        parts = k.split(".")
        leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
        if owner == "tok_embed":
            out[k] = [(MODEL_AXIS, 0)]
        elif owner in _COLUMN:
            out[k] = [(MODEL_AXIS, 1 if leaf.startswith("kernel") else 0)]
        elif owner in _ROW and leaf.startswith("kernel"):
            out[k] = [(MODEL_AXIS, 0)]
    return out


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy over shifted targets (f32): the mean over
    every position, or over the positions whose next token ``mask``
    keeps."""
    targets = input_ids[:, 1:].long()
    pred = logits[:, :-1].float()
    losses = torch.nn.functional.cross_entropy(
        pred.reshape(-1, pred.shape[-1]), targets.reshape(-1),
        reduction="none").reshape(targets.shape)
    if mask is not None:
        m = mask[:, 1:].float()
        return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)
    return losses.mean()


def llama_from_pretrained(path: str, dtype: Any = torch.bfloat16,
                          max_len: Optional[int] = None,
                          config: Optional[LlamaConfig] = None,
                          seed: int = 0,
                          device: DeviceLike = "cuda") -> LlamaModel:
    """A :class:`LlamaModel` on ``device`` from an HF-format checkpoint.

    ``path``: an HF model directory (``config.json`` beside safetensors,
    a torch pickle or ``flax_model.msgpack``, possibly sharded) or a bare
    weights file (then ``config`` is required unless a ``config.json``
    lies beside it).  ``config.json`` is read as the reference reads it:
    ``rope_theta`` defaults to 10,000 and ``rms_norm_eps`` to 1e-5 when
    absent, ``tie_word_embeddings`` to False, ``num_key_value_heads`` to
    the head count, and ``max_len`` overrides
    ``max_position_embeddings`` (default 8192); other keys
    (``rope_scaling`` among them) are ignored, as there.  ``dtype`` is the
    compute type; the parameters stay f32 as loaded
    (:func:`~.generate.cast_params` casts them).  The weights go through
    the HF name mapping of
    :func:`synapseml_tpu_torch.models.dl.checkpoints.import_llama`."""
    import json
    import os

    from ..dl.checkpoints import import_llama, read_checkpoint

    dev = resolve_device(device)
    if config is None:
        cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) \
            else os.path.join(os.path.dirname(path), "config.json")
        if not os.path.exists(cfg_path):
            raise ValueError(
                f"no config.json beside {path!r}; pass config= explicitly")
        with open(cfg_path) as f:
            hc = json.load(f)
        config = LlamaConfig(
            vocab_size=hc["vocab_size"],
            d_model=hc["hidden_size"],
            num_layers=hc["num_hidden_layers"],
            num_heads=hc["num_attention_heads"],
            num_kv_heads=hc.get("num_key_value_heads",
                                hc["num_attention_heads"]),
            d_ff=hc["intermediate_size"],
            max_len=max_len or int(hc.get("max_position_embeddings", 8192)),
            # HF's default when config.json omits it (Llama-1/2 era)
            rope_theta=float(hc.get("rope_theta", 10_000.0)),
            rms_norm_eps=float(hc.get("rms_norm_eps", 1e-5)),
            tie_embeddings=bool(hc.get("tie_word_embeddings", False)),
            dtype=dtype)
    model = LlamaModel(config, device=dev, seed=seed)
    hf = read_checkpoint(path)
    model.load_state_dict(import_llama(
        model.state_dict(), hf, num_layers=config.num_layers,
        tie_embeddings=config.tie_embeddings))
    return model
