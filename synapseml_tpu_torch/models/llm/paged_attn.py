"""Paged decode attention (K3): the continuous-batching engine's decode read.

The PyTorch port of the JAX package's ``models/llm/pallas_attn.py``.  The
dense decode path (:class:`~synapseml_tpu_torch.models.llm.model
.CausalAttention`, vector ``cache_index`` branch) attends every step over
the whole ``(n_slots, max_len)`` KV cache with a mask; this kernel reads
only each slot's live span, so decode-attention bytes scale with live
tokens instead of cache capacity.

:func:`paged_decode_attention` is the wrapper: for CUDA tensors it
launches the hand-written Hopper kernels in
``synapseml_tpu_torch/csrc/paged_attn.cu`` (bf16 and f16: the split
kernel, one block per chunk of :data:`SPLIT_KEYS` keys of a slot's span
on ``mma.sync`` tensor cores with a ``cp.async`` tile ring, then a
combine, with the probabilities rounded to the compute type before P V;
f32: the f32 split kernel, one block per chunk of
:func:`f32_chunk_keys` keys in full f32 FMAs with a ``cp.async`` ring,
the chunks combined by the last block to arrive, in one launch); for
CPU tensors it takes the plain PyTorch version
:func:`paged_decode_attention_plain`.  There is no fallback between the
two: a CUDA input the kernels cannot take raises.
:func:`paged_decode_attention_previous` launches the previous kernel
(one block per (kv head, slot) walking the whole span) at any type, as
a same-run yardstick of the split kernels.

The geometry, span buckets and byte ledger (:func:`paged_geometry`,
:func:`span_bucket_tiles`, :func:`paged_read_bytes`,
:func:`dense_read_bytes`) are copies of the JAX package's, so the
engine's byte ledger prices the same tile as the reference's.  The CUDA
kernel does not use the tile: its own loop stops at each slot's span.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...kernels import launches
from ...kernels._build import DEFINES, load_library, loaded_once

#: VMEM budget of the reference's TPU kernel working set; the geometry
#: gate below is kept identical so the byte ledger prices the same tile
_VMEM_BUDGET = 13 * 1024 * 1024

#: key-tile candidates, largest first (the reference's ladder)
_TILE_CANDIDATES = (256, 128, 64, 32, 16, 8)

#: the attention_backend switch values: 'auto' resolves to 'paged' when a
#: geometry fits; 'interpret' is the reference's CPU-correctness spelling
#: of 'paged'
ATTENTION_BACKENDS = ("auto", "dense", "paged", "interpret")

#: the CUDA kernel's compile-time limits (csrc/paged_attn.cu): query rows
#: one block keeps (a wider verify span x GQA group spreads over more
#: blocks) and the largest head width
_MAX_ROWS = DEFINES["paged_attn"]["SML_PA_MAX_ROWS"]
_MAX_D = DEFINES["paged_attn"]["SML_PA_MAX_D"]
#: keys of a slot's span one block of the split kernel takes (and the
#: most the f32 split kernel's chunk takes)
SPLIT_KEYS = DEFINES["paged_attn"]["SML_PA_SPLIT"]
#: the kernels' key tile (``kTile`` in csrc/paged_attn.cu)
_TILE = 64
#: the grid the f32 split kernel's chunk length aims at, and the query
#: rows x head width one of its blocks keeps
_F32_BLOCKS = DEFINES["paged_attn"]["SML_PA_F32_BLOCKS"]
_F32_ACC = DEFINES["paged_attn"]["SML_PA_F32_ACC"]
#: the fewest chunks it cuts a cache row into, unless the row is one chunk
_F32_MIN_CHUNKS = DEFINES["paged_attn"]["SML_PA_F32_MIN_CHUNKS"]
#: head widths the kernel is instantiated for
_HEAD_DIMS = tuple(d for d in (16, 32, 64, 128) if d <= _MAX_D)
#: dtype codes of the kernel's C interface, and their names in launch keys
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}


#: the tuning-table space of the kernel choice (its own name: the JAX
#: package's ``paged_attn_tile`` tunes a TPU key tile, another knob)
VARIANT_SPACE = "paged_attn_variant"
#: the kernels a CUDA call can take: ``split`` (per-chunk blocks: for
#: bf16/f16 the tensor-core kernel and a combine, for f32 the f32 split
#: kernel with its combine in the last block; launch key
#: ``variant=split``) and ``single`` (one block per (kv head, slot) over
#: the whole span, every type; the previous kernel, launch key
#: ``variant=previous``)
PAGED_VARIANTS = ("split", "single")


def default_variant(dtype) -> str:
    """The kernel a call takes without a tuned choice: split, at every
    type (a type no kernel takes is refused by the launch)."""
    return "split"


def variant_ok(variant: Any, dtype) -> bool:
    """Can ``variant`` run at ``dtype``?  Both kernels are built for
    f32, bf16 and f16."""
    return variant in PAGED_VARIANTS


def f32_rows_per_block(d_head: int) -> int:
    """Query rows one block of the f32 split kernel keeps at ``d_head``:
    rows x d_head at most ``SML_PA_F32_ACC`` (each of its warps holds at
    most half of them), and never more than the other kernels' rows."""
    return min(_MAX_ROWS, _F32_ACC // int(d_head))


def f32_chunk_keys(n_slots: int, num_kv_heads: int, max_len: int,
                   rows: int, d_head: int) -> int:
    """The f32 split kernel's chunk: the keys of a slot's span one block
    takes, chosen from the shapes alone (never the spans, which live on
    the device).  It is the fewest keys, a multiple of the 64-key tile in
    ``[64, SPLIT_KEYS]``, at which ``n_slots * num_kv_heads * row chunks
    * ceil(max_len / C)`` blocks are at most ``SML_PA_F32_BLOCKS`` (about
    two on each of the H100's 132 SMs); ``rows`` is ``S * num_heads /
    num_kv_heads``.  A cache row that C would cut into fewer than
    :data:`_F32_MIN_CHUNKS` chunks and that one chunk can take is one
    chunk: there the combine's serial tail costs more than the split
    saves.  The kernel's entry point refuses any other C."""
    T = int(max_len)
    row_chunks = -(-int(rows) // f32_rows_per_block(d_head))
    per_chunk = int(n_slots) * int(num_kv_heads) * row_chunks
    c = _TILE
    while c < SPLIT_KEYS and per_chunk * -(-T // c) > _F32_BLOCKS:
        c += _TILE
    whole = -(-T // _TILE) * _TILE
    if -(-T // c) < _F32_MIN_CHUNKS and whole <= SPLIT_KEYS:
        return whole
    return c


def paged_geometry_key(max_len: int, num_kv_heads: int, d_head: int,
                       dtype: Any, max_query_span: int = 1) -> str:
    """The tuning-table geometry of a paged cache: the autotuner records
    the ``paged_attn_variant`` winner under it and ``SlotEngine``
    consults with it (``dtype`` by its name, ``bfloat16``)."""
    from ...telemetry.tunetable import geometry_key
    return geometry_key(max_len=int(max_len), kv_heads=int(num_kv_heads),
                        d_head=int(d_head),
                        dtype=str(dtype).replace("torch.", ""),
                        span=max(1, int(max_query_span)))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _sublane(dtype) -> int:
    """Minimum sublane multiple for ``dtype`` (f32 8, bf16 16, int8 32)."""
    return max(8, 32 // _itemsize(dtype))


@dataclasses.dataclass(frozen=True)
class PagedGeometry:
    """Resolved geometry for one cache shape: the K/V key tile the byte
    ledger prices, the total tile count (``max_len // tile``) and the
    working-set estimate the gate admitted."""
    tile: int
    total_tiles: int
    vmem_bytes: int


def paged_geometry(max_len: int, num_heads: int, num_kv_heads: int,
                   d_head: int, dtype: Any = torch.bfloat16,
                   max_query_span: int = 1,
                   tile: Optional[int] = None) -> Optional[PagedGeometry]:
    """The reference's geometry gate: the key tile for a ``(max_len,
    num_kv_heads, d_head)`` cache row, or None when none fits ('auto' then
    stays dense).  The tile divides ``max_len``, is a sublane multiple for
    the cache dtype, leaves at least two tiles, and its working set
    (double-buffered K and V tiles, q/out blocks and f32 scratch, the
    latter scaled by the widest verify span) fits the budget.  ``tile``
    pins one candidate through the same gate."""
    itemsize = _itemsize(dtype)
    sub = _sublane(dtype)
    s = max(1, int(max_query_span))
    candidates = _TILE_CANDIDATES if tile is None else (int(tile),)
    for cand in candidates:
        if cand <= 0 or cand % sub or max_len % cand \
                or cand > max_len // 2:
            continue
        need = (2 * 2 * cand * num_kv_heads * d_head * itemsize  # K+V x2 buf
                + s * 2 * num_heads * d_head * itemsize          # q + out
                + s * num_heads * d_head * 4                     # f32 acc
                + s * 2 * num_heads * 128 * 4)                   # m + l
        if need <= _VMEM_BUDGET:
            return PagedGeometry(cand, max_len // cand, need)
    return None


def resolve_attention_backend(backend: str, *, max_len: int,
                              num_heads: int, num_kv_heads: int,
                              d_head: int, dtype: Any = torch.bfloat16,
                              max_query_span: int = 1) -> str:
    """The one parser for ``attention_backend``: returns the resolved
    backend (``'dense'`` | ``'paged'``) or raises ``ValueError``.  It
    gates on the geometry alone, as the reference does:

    - ``'auto'`` — ``'paged'`` whenever a geometry fits, ``'dense'``
      otherwise (never raises);
    - ``'dense'`` — the full-row masked softmax;
    - ``'paged'`` — the K3 wrapper: the CUDA kernel for CUDA tensors, the
      plain version for CPU tensors; raises when no geometry fits;
    - ``'interpret'`` — the reference's CPU-correctness spelling, taken
      as ``'paged'`` (on the CPU the wrapper already runs the plain
      version).

    Whether the CUDA kernel takes the head layout is
    :func:`check_kernel_layout`'s question, asked by the engine for a
    cache on the card: a layout it cannot take raises there, it never
    turns 'auto' into 'dense'."""
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(
            f"attention_backend={backend!r}: must be one of "
            f"{ATTENTION_BACKENDS}")
    if backend == "dense":
        return "dense"
    geo = paged_geometry(max_len, num_heads, num_kv_heads, d_head, dtype,
                         max_query_span=max_query_span)
    if backend == "auto":
        return "paged" if geo is not None else "dense"
    if geo is None:
        raise ValueError(
            f"attention_backend={backend!r}: no paged geometry fits "
            f"(max_len={max_len}, kv_heads={num_kv_heads}, "
            f"d_head={d_head}, dtype={dtype}) — max_len must be divisible "
            "by a sublane-aligned tile <= max_len//2; use "
            "attention_backend='dense' (or 'auto', which falls back)")
    return "paged"


def span_bucket_tiles(max_span: int, geo: PagedGeometry) -> int:
    """The reference's bucketed grid length: the next power of two >= the
    longest live span's tile count, clamped to the cache's total tiles."""
    nt = -(-max(1, int(max_span)) // geo.tile)
    b = 1
    while b < nt:
        b *= 2
    return min(b, geo.total_tiles)


# ---------------------------------------------------------------------------
# the byte ledger (the reference's DMA accounting, shared with its tests)
# ---------------------------------------------------------------------------

def paged_read_bytes(spans, tile: int, num_kv_heads: int, d_head: int,
                     itemsize: int, num_layers: int = 1) -> int:
    """K/V bytes one paged decode step reads for ``spans`` in the
    reference's accounting: each slot reads ``ceil(span / tile)`` tiles
    of K and of V per layer; ``spans`` covers every slot, inactive ones
    at span 1."""
    tiles = np.ceil(np.maximum(np.asarray(spans, np.float64), 1.0)
                    / tile).astype(np.int64)
    return int(num_layers * 2 * tiles.sum() * tile
               * num_kv_heads * d_head * itemsize)


def dense_read_bytes(n_slots: int, max_len: int, num_kv_heads: int,
                     d_head: int, itemsize: int,
                     num_layers: int = 1) -> int:
    """K/V bytes the dense decode attention reads per step: the full
    ``(n_slots, max_len)`` K and V rows per layer."""
    return int(num_layers * 2 * n_slots * max_len
               * num_kv_heads * d_head * itemsize)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 spans: torch.Tensor) -> torch.Tensor:
    """What K3 computes, in plain PyTorch: f32 scores ``q . k / sqrt(D)``
    over the keys ``kpos < spans[b] - (S-1) + j`` of query j (masked keys
    at ``finfo(f32).min``), f32 softmax and PV, cast to ``q.dtype``.
    Keys past the longest span are not read.  ``q`` is ``(B, H, D)`` or
    ``(B, S, H, D)``; ``k``, ``v`` ``(B, max_len, KV, D)``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV
    spans = spans.to(device=q.device, dtype=torch.int64)
    n = int(spans.max().clamp(1, T))
    qf = q.float().reshape(B, S, KV, group, D)
    kf = k[:, :n].float()
    vf = v[:, :n].float()
    logits = torch.einsum("bskgd,btkd->bkgst", qf, kf) / float(np.sqrt(D))
    kpos = torch.arange(n, device=q.device)
    lim = spans[:, None] - (S - 1) + torch.arange(S, device=q.device)
    valid = kpos[None, None, :] < lim[:, :, None]              # (B, S, n)
    logits = logits.masked_fill(~valid[:, None, None],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
    out = out.reshape(B, S, H, D).to(q.dtype)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@loaded_once
def _kernels() -> ctypes.CDLL:
    lib = load_library("paged_attn")
    lib.sml_paged_decode_attention.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _I, ctypes.c_float, _P]
    lib.sml_paged_decode_attention.restype = _I
    lib.sml_paged_decode_attention_split.argtypes = [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _I, _I,
        ctypes.c_float, _P]
    lib.sml_paged_decode_attention_split.restype = _I
    lib.sml_paged_decode_attention_split_f32.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _I,
        ctypes.c_float, _P]
    lib.sml_paged_decode_attention_split_f32.restype = _I
    lib.sml_pa_error_string.argtypes = [_I]
    lib.sml_pa_error_string.restype = ctypes.c_char_p
    return lib


def split_workspace_shape(B: int, S: int, H: int, KV: int, D: int,
                          T: int) -> tuple:
    """The split kernel's f32 workspace: for each (slot, kv head) and each
    of the ``ceil(T / SPLIT_KEYS)`` chunks of the cache row, the S * group
    query rows' running max, sum and D accumulators.  Only chunks inside a
    slot's span are written and read."""
    return (B, KV, -(-T // SPLIT_KEYS), S * (H // KV), D + 2)


def f32_workspace_shape(B: int, S: int, H: int, KV: int, D: int,
                        T: int) -> tuple:
    """The f32 split kernel's workspace: for each (slot, kv head) and each
    of the ``ceil(T / C)`` chunks (C from :func:`f32_chunk_keys`), the S *
    group query rows' D accumulators, running max and sum, and two floats
    that keep each row 16-byte aligned.  Only a slot whose span takes
    more than one chunk writes and reads its chunks."""
    C = f32_chunk_keys(B, KV, T, S * (H // KV), D)
    return (B, KV, -(-T // C), S * (H // KV), D + 4)


#: the f32 split kernel's arrival counters, (device index, K's address,
#: count) -> int32 zeros; never freed, since a captured graph keeps the
#: address it was recorded with
_COUNTERS: dict = {}


def _split_counters(k: torch.Tensor, n: int) -> torch.Tensor:
    """The arrival counters of the f32 split kernel over the cache ``k``:
    one per (slot, kv head, row chunk), zero before and after every
    launch (the last-arriving block resets its own).  One buffer per
    cache, so two engines on two streams never share a counter; made and
    zeroed at the cache's first call, which the engine makes eagerly
    before it captures a graph (a first call inside a capture records
    the zeroing into the graph, which replays it)."""
    key = (k.device.index, k.data_ptr(), n)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = torch.zeros(n, dtype=torch.int32, device=k.device)
        if not torch.cuda.is_current_stream_capturing():
            torch.cuda.current_stream(k.device).synchronize()
        _COUNTERS[key] = buf
    return buf


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_kernel_layout(num_heads: int, num_kv_heads: int, d_head: int,
                        dtype) -> None:
    """Raise unless the CUDA kernel is built for this head layout and
    type: ``d_head`` in :data:`_HEAD_DIMS`, float32, bfloat16 or float16,
    and whole GQA groups.  Any verify width is taken."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_decode_attention: the CUDA kernel takes "
                        f"{tuple(_DTYPE_CODES)}, got {dtype}")
    if num_kv_heads < 1 or num_heads % num_kv_heads:
        raise ValueError(f"num_heads={num_heads} is not a multiple of "
                         f"num_kv_heads={num_kv_heads}")
    if d_head not in _HEAD_DIMS:
        raise ValueError(f"d_head={d_head}: the CUDA kernel takes "
                         f"{_HEAD_DIMS}; use attention_backend='dense'")


def _paged_decode_attention_cuda(q, k, v, spans, split: bool):
    """Launch K3's ``split`` kernel for q's type, or the previous one."""
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    dev = q4.device
    B, S, H, D = q4.shape
    T, KV = k.shape[1], k.shape[2]
    check_kernel_layout(H, KV, D, q4.dtype)
    _need(q4, "q", q4.dtype, (B, S, H, D), dev)
    _need(k, "k", q4.dtype, (B, T, KV, D), dev)
    _need(v, "v", q4.dtype, (B, T, KV, D), dev)
    _need(spans, "spans", torch.int32, (B,), dev)
    out = torch.empty_like(q4)
    lib = _kernels()
    sqrt_d = float(np.float32(np.sqrt(D)))
    ws = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if split and q4.dtype == torch.float32:
            rows = S * (H // KV)
            chunk = f32_chunk_keys(B, KV, T, rows, D)
            ws = torch.empty(f32_workspace_shape(B, S, H, KV, D, T),
                             dtype=torch.float32, device=dev)
            counters = _split_counters(
                k, B * KV * -(-rows // f32_rows_per_block(D)))
            rc = lib.sml_paged_decode_attention_split_f32(
                q4.data_ptr(), k.data_ptr(), v.data_ptr(), spans.data_ptr(),
                out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, S, H,
                KV, D, T, chunk, sqrt_d, stream)
        elif split:
            ws = torch.empty(split_workspace_shape(B, S, H, KV, D, T),
                             dtype=torch.float32, device=dev)
            rc = lib.sml_paged_decode_attention_split(
                q4.data_ptr(), k.data_ptr(), v.data_ptr(), spans.data_ptr(),
                out.data_ptr(), ws.data_ptr(), B, S, H, KV, D, T,
                ws.shape[2], _DTYPE_CODES[q4.dtype], sqrt_d, stream)
        else:
            rc = lib.sml_paged_decode_attention(
                q4.data_ptr(), k.data_ptr(), v.data_ptr(), spans.data_ptr(),
                out.data_ptr(), B, S, H, KV, D, T, _DTYPE_CODES[q4.dtype],
                sqrt_d, stream)
    if rc != 0:
        msg = lib.sml_pa_error_string(rc).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {rc} ({msg})")
    if launches.wants_bytes():
        # the keys and values of the live spans (a host sync, so only
        # under a cost capture), and the workspace the split kernel
        # writes and reads back
        live = int(spans.clamp(1, T).sum()) * KV * D * k.element_size() * 2
        launches.io_bytes("paged_decode_attention", q4, live, spans, out,
                          None if ws is None else 2 * ws.numel() * 4)
    # launch key: ``T`` the cache's max_len, ``variant`` the kernel
    launches.count("paged_decode_attention", B=B, S=S, H=H, KV=KV, D=D,
                   T=T, dtype=_DTYPE_NAMES[q4.dtype],
                   variant="split" if split else "previous")
    return out[:, 0] if squeeze else out


def paged_decode_attention_previous(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor,
                                    spans: torch.Tensor) -> torch.Tensor:
    """The previous kernel (one block per (kv head, slot), the whole span
    in one block) at any of its types: the yardstick the split kernels
    are timed against (``variant="single"`` takes it too).  CUDA tensors
    only."""
    if q.device.type != "cuda":
        raise ValueError("paged_decode_attention_previous launches a CUDA "
                         f"kernel; q is on {q.device}")
    return _paged_decode_attention_cuda(q, k, v, spans, split=False)


def paged_decode_attention(q: torch.Tensor,      # (B, H, D) | (B, S, H, D)
                           k: torch.Tensor,      # (B, max_len, KV, D)
                           v: torch.Tensor,      # (B, max_len, KV, D)
                           spans: torch.Tensor,  # (B,) int32 live lengths
                           variant: Optional[str] = None,
                           ) -> torch.Tensor:
    """One decode step's attention for every slot, reading only each
    slot's live K/V span: → same shape as ``q``, in ``q.dtype``.

    ``spans[b]`` is slot b's live length including this step's S written
    positions: the last query attends keys ``[0, spans[b])`` and each
    earlier query one key fewer.  The queries' own K/V must already be in
    the cache.  CUDA tensors launch the K3 kernel ``variant`` names
    (:data:`PAGED_VARIANTS`; None: :func:`default_variant`, the split
    kernel); CPU tensors run :func:`paged_decode_attention_plain`."""
    variant = default_variant(q.dtype) if variant is None else variant
    if not variant_ok(variant, q.dtype):
        raise ValueError(f"paged_decode_attention: variant={variant!r} "
                         f"cannot run at {q.dtype} (one of "
                         f"{PAGED_VARIANTS})")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k, v, spans)
    return _paged_decode_attention_cuda(q, k, v, spans,
                                        split=variant == "split")
