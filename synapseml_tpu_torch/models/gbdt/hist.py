"""GBDT histogram ops: int8 limb quantization and the two histogram kernels.

The PyTorch port of the JAX package's ``models/gbdt/pallas_hist.py``.
Gradients and hessians quantize per tree to THREE balanced base-128 int8
limbs each (signed digits in [-64, 63], range ±2^20 on a max-|value|
scale) plus an exact 0/1 count lane, so every histogram is an EXACT int32
sum of limbs; :func:`_reconstruct` turns limb sums into f32
[grad, hess, count].  Lanes per row: ``[g0 g1 g2 h0 h1 h2 count pad]``.

Two kernels, each a hand-written CUDA kernel for Hopper in
``synapseml_tpu_torch/csrc/gbdt_hist.cu`` with a plain PyTorch version
beside it:

- :func:`build_hist_nodes` (K1) — node-batched histograms of rows by
  slot (replaces ``build_hist_nodes_pallas``);
- :func:`route_and_hist` (K2) — one depthwise wave: route the rows of the
  pending leaves and build the left children's histograms in the same
  pass, optionally at coarse ``bin >> hist_shift`` resolution with
  full-resolution histograms of the refined features ``sel_k`` (replaces
  ``route_and_hist_pallas``).

A wrapper takes the plain version for tensors on the CPU and launches the
kernel for tensors on a card; there is no fallback between the two.  The
TPU's ``(G, ft, N)`` feature-tile layout and tuned ``hist_chunk`` are VMEM
artifacts and are not ported: bins are always ``(F, N)`` int32.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from ...kernels import launches
from ...kernels._build import DEFINES

#: value channels per row (and output lanes per slot)
SLOT_LANES = 8
#: live lanes: g0 g1 g2 h0 h1 h2 count
_LIVE = 7
#: largest magnitude representable in 3 balanced base-128 digits
#: (63 + 63·128 + 63·16384)
_Q_MAX = 1_040_447.0
#: the CUDA kernels' compile-time limits (csrc/gbdt_hist.cu)
_MAX_SLOTS = DEFINES["gbdt_hist"]["SML_MAX_SLOTS"]
_MAX_SMEM = DEFINES["gbdt_hist"]["SML_MAX_SMEM"]

# --------------------------------------------------------------------------
# quantization
# --------------------------------------------------------------------------

def _limbs(q: torch.Tensor):
    """int32 quantized value → 3 balanced base-128 int32 digits in [-64, 63]."""
    d0 = ((q + 64) & 127) - 64
    q1 = (q - d0) >> 7                 # exact: (q - d0) divisible by 128
    d1 = ((q1 + 64) & 127) - 64
    d2 = (q1 - d1) >> 7                # in [-64, 63] after the clip in _quant
    return d0, d1, d2


def _quant(v: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(v / scale), -_Q_MAX, _Q_MAX).to(torch.int32)
    return _limbs(q)


def _reconstruct(out: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int32 limb histogram (..., 8) → (..., 3) f32 [grad, hess, count].

    Limb sums can exceed 2^24, so each converts to f32 BEFORE combining,
    in the JAX package's order of operations."""
    o = out.to(torch.float32)
    g = scales[0] * (o[..., 0] + 128.0 * o[..., 1] + 16384.0 * o[..., 2])
    h = scales[1] * (o[..., 3] + 128.0 * o[..., 4] + 16384.0 * o[..., 5])
    return torch.stack([g, h, o[..., 6]], dim=-1)


def prep_hist_vals(grad: torch.Tensor, hess: torch.Tensor,
                   mask: torch.Tensor):
    """Per-row value channels → ((N, 8) int8 limb matrix, (2,) f32 scales).

    g/h quantize on a per-call max-|value| scale; ``grad``/``hess`` may be
    bf16 (the fused ingest) — times the f32 ``mask`` they promote to f32,
    as in JAX."""
    g = grad * mask
    h = hess * mask
    s_g = torch.clamp_min(torch.max(torch.abs(g)), 1e-30) / _Q_MAX
    s_h = torch.clamp_min(torch.max(torch.abs(h)), 1e-30) / _Q_MAX
    g0, g1, g2 = _quant(g, s_g)
    h0, h1, h2 = _quant(h, s_h)
    count = (mask > 0).to(torch.int32)
    z = torch.zeros_like(count)
    vals = torch.stack([g0, g1, g2, h0, h1, h2, count, z],
                       dim=-1).to(torch.int8)
    return vals, torch.stack([s_g, s_h])


def coarse_bins(total_bins: int, shift: int) -> int:
    """Histogram width of the coarse (``bin >> shift``) level, padded to a
    multiple of 8 as in the JAX package (the trees depend on the width
    only through empty trailing bins, but the shapes stay comparable)."""
    bc = -(-total_bins // (1 << shift))
    return -(-bc // 8) * 8


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def hist_limbs_plain(bins_t: torch.Tensor, slot: torch.Tensor,
                     vals: torch.Tensor, n_slots: int, width: int,
                     shift: int = 0) -> torch.Tensor:
    """(F, N) bins, (N,) slots in [-1, S), (N, 8) int8 limbs → (F, width,
    S, 8) int32 limb sums over rows with a slot, at ``bin >> shift``.
    Bins outside [0, width) add nothing (they match no one-hot row of the
    TPU kernel).  ``index_add_`` into int64, one feature at a time."""
    F, N = bins_t.shape
    S = n_slots
    v64 = vals.to(torch.int64)
    has = (slot >= 0) & (slot < S)
    dump = width * S                   # rows without a cell land here
    out = torch.empty((F, width, S, SLOT_LANES), dtype=torch.int32,
                      device=bins_t.device)
    for f in range(F):
        b = bins_t[f] >> shift if shift else bins_t[f]
        ok = has & (b >= 0) & (b < width)
        idx = torch.where(ok, b.to(torch.int64) * S + slot, dump)
        acc = torch.zeros((dump + 1, SLOT_LANES), dtype=torch.int64,
                          device=bins_t.device)
        acc.index_add_(0, idx, v64)
        out[f] = acc[:dump].view(width, S, SLOT_LANES).to(torch.int32)
    return out


def route_plain(node_id, leaf, sel, t1, rlo, rhi, dflt, l_id, r_id):
    """The fused kernel's routing: → (new node id (N,), left-child slot
    (N,), -1 for rows that are not routed left).  Later slots win, as in
    the Pallas kernel's slot loop."""
    new = node_id
    bslot = torch.full_like(node_id, -1)
    for j in range(sel.shape[0]):
        inleaf = node_id == leaf[j]
        xb = sel[j]
        in_range = (xb > rlo[j]) & (xb <= rhi[j])
        gl = torch.where(in_range, xb <= t1[j], dflt[j] != 0)
        new = torch.where(inleaf, torch.where(gl, l_id[j], r_id[j]), new)
        bslot = torch.where(inleaf & gl, j, bslot)
    return new.to(torch.int32), bslot.to(torch.int32)


def build_hist_nodes_plain(bins_t, slot, vals, n_slots: int,
                           total_bins: int, hist_shift: int = 0):
    """K1's plain version → (F, Bh, S, 8) int32 limb sums."""
    Bh = coarse_bins(total_bins, hist_shift) if hist_shift else total_bins
    return hist_limbs_plain(bins_t, slot, vals, n_slots, Bh, hist_shift)


def route_and_hist_plain(bins_t, node_id, leaf, sel, t1, rlo, rhi, dflt,
                         l_id, r_id, vals, n_slots: int, total_bins: int,
                         hist_shift: int = 0, sel_k=None):
    """K2's plain version → (new_id (N,), (F, Bh, S, 8) int32,
    (K, B, S, 8) int32 or None)."""
    B = total_bins
    Bh = coarse_bins(B, hist_shift) if hist_shift else B
    new_id, bslot = route_plain(node_id, leaf, sel, t1, rlo, rhi, dflt,
                                l_id, r_id)
    out = hist_limbs_plain(bins_t, bslot, vals, n_slots, Bh, hist_shift)
    outf = (None if sel_k is None
            else hist_limbs_plain(sel_k, bslot, vals, n_slots, B, 0))
    return new_id, out, outf


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    from ...kernels._build import load_library
    lib = load_library("gbdt_hist")
    lib.sml_hist_nodes.argtypes = [_P, _I, _LL, _P, _P, _I, _I, _I, _P, _P]
    lib.sml_hist_nodes.restype = _I
    lib.sml_route_and_hist.argtypes = [_P, _I, _LL, _P, _P, _I, _P, _P, _P,
                                       _I, _I, _I, _I, _P, _P, _P, _P]
    lib.sml_route_and_hist.restype = _I
    lib.sml_cuda_error_string.argtypes = [_I]
    lib.sml_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    if t.data_ptr() % 8:
        raise ValueError(f"{name} must be 8-byte aligned")


def _check_smem(width: int, n_slots: int) -> None:
    if not 1 <= n_slots <= _MAX_SLOTS:
        raise ValueError(f"n_slots={n_slots}: the CUDA kernels take 1.."
                         f"{_MAX_SLOTS}")
    if width * n_slots * _LIVE * 4 > _MAX_SMEM:
        raise ValueError(f"one feature's histogram ({width} bins x "
                         f"{n_slots} slots) exceeds a block's shared memory")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().sml_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _build_hist_nodes_cuda(bins_t, slot, vals, n_slots, total_bins,
                           hist_shift):
    dev = bins_t.device
    F, N = bins_t.shape
    Bh = coarse_bins(total_bins, hist_shift) if hist_shift else total_bins
    _need(bins_t, "bins_t", torch.int32, (F, N), dev)
    _need(slot, "slot", torch.int32, (N,), dev)
    _need(vals, "vals", torch.int8, (N, SLOT_LANES), dev)
    _check_smem(Bh, n_slots)
    out = torch.zeros((F, Bh, n_slots, SLOT_LANES), dtype=torch.int32,
                      device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.sml_hist_nodes(
            bins_t.data_ptr(), F, N, slot.data_ptr(), vals.data_ptr(),
            n_slots, Bh, hist_shift, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "build_hist_nodes")
    # launch keys: K1 ``F, B, shift, S`` and K2 ``F, B, shift, K, S``, with
    # ``B`` the full bin count
    launches.count("build_hist_nodes", F=F, B=total_bins, shift=hist_shift,
                   S=n_slots)
    return out


def _route_and_hist_cuda(bins_t, node_id, leaf, sel, t1, rlo, rhi, dflt,
                         l_id, r_id, vals, n_slots, total_bins, hist_shift,
                         sel_k):
    dev = bins_t.device
    F, N = bins_t.shape
    S = n_slots
    B = total_bins
    Bh = coarse_bins(B, hist_shift) if hist_shift else B
    params = torch.stack([leaf, t1, rlo, rhi, dflt, l_id, r_id]).to(
        device=dev, dtype=torch.int32).contiguous()
    _need(bins_t, "bins_t", torch.int32, (F, N), dev)
    _need(node_id, "node_id", torch.int32, (N,), dev)
    _need(params, "leaf/t1/rlo/rhi/dflt/l_id/r_id", torch.int32, (7, S), dev)
    _need(sel, "sel", torch.int32, (S, N), dev)
    _need(vals, "vals", torch.int8, (N, SLOT_LANES), dev)
    _check_smem(Bh, S)
    K = 0
    if sel_k is not None:
        K = sel_k.shape[0]
        _need(sel_k, "sel_k", torch.int32, (K, N), dev)
        _check_smem(B, S)
    new_id = torch.empty(N, dtype=torch.int32, device=dev)
    out = torch.zeros((F, Bh, S, SLOT_LANES), dtype=torch.int32, device=dev)
    outf = (torch.zeros((K, B, S, SLOT_LANES), dtype=torch.int32, device=dev)
            if K else None)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.sml_route_and_hist(
            bins_t.data_ptr(), F, N, node_id.data_ptr(), params.data_ptr(),
            S, sel.data_ptr(), vals.data_ptr(),
            sel_k.data_ptr() if K else None, K, B, Bh, hist_shift,
            new_id.data_ptr(), out.data_ptr(),
            outf.data_ptr() if K else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "route_and_hist")
    launches.count("route_and_hist", F=F, B=B, shift=hist_shift, K=K, S=S)
    return new_id, out, outf


# --------------------------------------------------------------------------
# entry points (signatures and returns of the JAX package's functions)
# --------------------------------------------------------------------------

def build_hist_nodes_limbs(bins_t, slot, vals, n_slots: int,
                           total_bins: int, hist_shift: int = 0):
    """K1 → (F, Bh, S, 8) int32 limb sums: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if bins_t.is_cuda:
        return _build_hist_nodes_cuda(bins_t, slot, vals, n_slots,
                                      total_bins, hist_shift)
    return build_hist_nodes_plain(bins_t, slot, vals, n_slots, total_bins,
                                  hist_shift)


def build_hist_nodes(bins_t, slot, vals, scales, n_slots: int,
                     total_bins: int, hist_shift: int = 0) -> torch.Tensor:
    """→ (n_slots, F, Bh, 3) float32 [grad, hess, count] histograms
    (Bh = :func:`coarse_bins` when ``hist_shift`` > 0)."""
    out = build_hist_nodes_limbs(bins_t, slot, vals, n_slots, total_bins,
                                 hist_shift)
    return _reconstruct(out.permute(2, 0, 1, 3), scales)


def route_and_hist_limbs(bins_t, node_id, leaf, sel, t1, rlo, rhi, dflt,
                         l_id, r_id, vals, n_slots: int, total_bins: int,
                         hist_shift: int = 0, sel_k=None):
    """K2 → (new_id, (F, Bh, S, 8) int32, (K, B, S, 8) int32 or None): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if bins_t.is_cuda:
        return _route_and_hist_cuda(bins_t, node_id, leaf, sel, t1, rlo,
                                    rhi, dflt, l_id, r_id, vals, n_slots,
                                    total_bins, hist_shift, sel_k)
    return route_and_hist_plain(bins_t, node_id, leaf, sel, t1, rlo, rhi,
                                dflt, l_id, r_id, vals, n_slots, total_bins,
                                hist_shift, sel_k)


def route_and_hist(bins_t, node_id, leaf, sel, t1, rlo, rhi, dflt, l_id,
                   r_id, vals, scales, n_slots: int, total_bins: int,
                   hist_shift: int = 0, sel_k=None):
    """One pass: → (new_node_id (N,), hists (n_slots, F, Bh, 3)[,
    fine_hists (n_slots, K, B, 3) when ``sel_k`` is given]).

    Rows of ``leaf[j]`` go left iff ``x in (rlo, rhi] ? x <= t1 : dflt``
    with x from ``sel[j]`` (the split column's bin row, gathered by the
    caller); left rows get ``l_id[j]``, right rows ``r_id[j]``, and the
    histograms are of the left rows by slot."""
    new_id, out, outf = route_and_hist_limbs(
        bins_t, node_id, leaf, sel, t1, rlo, rhi, dflt, l_id, r_id, vals,
        n_slots, total_bins, hist_shift, sel_k)
    hists = _reconstruct(out.permute(2, 0, 1, 3), scales)
    if outf is None:
        return new_id, hists
    return new_id, hists, _reconstruct(outf.permute(2, 0, 1, 3), scales)
