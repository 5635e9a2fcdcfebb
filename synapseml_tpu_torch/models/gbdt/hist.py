"""GBDT histogram ops: int8 limb quantization and the two histogram kernels.

The PyTorch port of the JAX package's ``models/gbdt/pallas_hist.py``.
Gradients and hessians quantize per tree to THREE balanced base-128 int8
limbs each (signed digits in [-64, 63], range ±2^20 on a max-|value|
scale) plus an exact 0/1 count lane, so every histogram is an EXACT int32
sum of limbs; :func:`_reconstruct` turns limb sums into f32
[grad, hess, count].  Lanes per row: ``[g0 g1 g2 h0 h1 h2 count pad]``.

Two kernels, each hand-written CUDA for Hopper in
``synapseml_tpu_torch/csrc/gbdt_hist.cu`` with a plain PyTorch version
beside it:

- :func:`build_hist_nodes` (K1) — node-batched histograms of rows by
  slot (replaces ``build_hist_nodes_pallas``);
- :func:`route_and_hist_limbs` (K2) — one depthwise wave: route the rows
  of the pending leaves and build the left children's histograms in the
  same pass, optionally at coarse ``bin >> hist_shift`` resolution with
  full-resolution histograms of the refined features ``sel_k`` (replaces
  ``route_and_hist_pallas``).  :func:`route_and_hist_ids_limbs` is the
  same function with the split and refined features given as row ids of
  ``bins_t`` instead of gathered copies of their rows; the grower calls
  it and reconstructs the limb sums (``trainer._node_hists``).

On the card each is two launches: ``route_kernel`` routes every row once
(K2) or reads its slot (K1) and appends the rows that have a slot to a
compacted list, then ``hist_rows_kernel`` builds the histograms of the
listed rows through a ``cp.async`` ring (:func:`rows_geometry` chooses its
features per block and tile).  The previous kernel, which re-routed every
row once per feature group, stays as a same-run yardstick
(``*_previous``); no main path calls it.

A wrapper takes the plain version for tensors on the CPU and launches the
kernel for tensors on a card; there is no fallback between the two.  The
TPU's ``(G, ft, N)`` feature-tile layout and tuned ``hist_chunk`` are VMEM
artifacts and are not ported: bins are always ``(F, N)`` int32.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from ...kernels import launches
from ...kernels._build import DEFINES, load_library, loaded_once

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
#: hist_rows_kernel's geometry limits (kMaxFpb in csrc/gbdt_hist.cu) and
#: the bytes of one tile's gathers a block keeps in flight: ~25 KB per SM
#: covers 3.35 TB/s x ~1 us of latency spread over 132 SMs; a tile may
#: shrink to half that to fit one more feature per block
_MAX_FPB = 64
_TILE_MIN, _TILE_MAX = 128, 2048
_FLIGHT_BYTES = 32 * 1024
#: shared memory of one H100 SM (228 KB)
_SM_SMEM = 233472

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
    # a tensor divisor: CUDA divides by a Python number as a multiply by
    # its reciprocal, which can differ from the CPU's quotient in the last
    # bit and so change every limb of the tree
    q_max = torch.full((), _Q_MAX, dtype=torch.float32, device=g.device)
    s_g = torch.clamp_min(torch.max(torch.abs(g)), 1e-30) / q_max
    s_h = torch.clamp_min(torch.max(torch.abs(h)), 1e-30) / q_max
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
                     shift: int = 0, feat=None) -> torch.Tensor:
    """(R, N) bins, (N,) slots in [-1, S), (N, 8) int8 limbs → (F, width,
    S, 8) int32 limb sums over rows with a slot, at ``bin >> shift``, of
    the rows ``feat`` (F,) of ``bins_t`` (all R rows when None).  Bins
    outside [0, width) add nothing (they match no one-hot row of the TPU
    kernel).  The rows that have a slot are compacted once; then one
    ``index_add_`` into int64 per chunk of features, over a
    feature-offset index (integer sums: the order changes nothing)."""
    dev = bins_t.device
    S = n_slots
    fr = (torch.arange(bins_t.shape[0], device=dev) if feat is None
          else torch.as_tensor(feat, device=dev).to(torch.int64))
    F = int(fr.shape[0])
    cells = width * S
    out = torch.zeros((F, width, S, SLOT_LANES), dtype=torch.int32,
                      device=dev)
    idx = torch.nonzero((slot >= 0) & (slot < S)).squeeze(1)
    n = int(idx.shape[0])
    if n == 0 or F == 0:
        return out
    s64 = slot[idx].to(torch.int64)
    v64 = vals[idx].to(torch.int64)
    step = max(1, (1 << 21) // n)      # ~128 MB of int64 values a chunk
    for f0 in range(0, F, step):
        fc = fr[f0:f0 + step]
        k = int(fc.shape[0])
        b = bins_t[fc[:, None], idx[None, :]].to(torch.int64)
        if shift:
            b = b >> shift
        off = torch.arange(k, device=dev, dtype=torch.int64)[:, None] * cells
        key = torch.where((b >= 0) & (b < width), off + b * S + s64,
                          k * cells)   # rows without a cell land here
        acc = torch.zeros((k * cells + 1, SLOT_LANES), dtype=torch.int64,
                          device=dev)
        acc.index_add_(0, key.reshape(-1),
                       v64.expand(k, n, SLOT_LANES).reshape(k * n,
                                                            SLOT_LANES))
        out[f0:f0 + k] = acc[:-1].view(k, width, S, SLOT_LANES).to(
            torch.int32)
    return out


def route_plain(node_id, leaf, sel, t1, rlo, rhi, dflt, l_id, r_id):
    """The fused kernel's routing: → (new node id (N,), left-child slot
    (N,), -1 for rows that are not routed left).  ``sel[j]`` is split j's
    bin row: an (S, N) tensor or a sequence of S rows.  Later slots win,
    as in the Pallas kernel's slot loop."""
    new = node_id
    bslot = torch.full_like(node_id, -1)
    for j in range(len(sel)):
        inleaf = node_id == leaf[j]
        xb = sel[j]
        in_range = (xb > rlo[j]) & (xb <= rhi[j])
        gl = torch.where(in_range, xb <= t1[j], dflt[j] != 0)
        new = torch.where(inleaf, torch.where(gl, l_id[j], r_id[j]), new)
        bslot = torch.where(inleaf & gl, j, bslot)
    return new.to(torch.int32), bslot.to(torch.int32)


def build_hist_nodes_plain(bins_t, slot, vals, n_slots: int,
                           total_bins: int, hist_shift: int = 0, feat=None):
    """K1's plain version → (F, Bh, S, 8) int32 limb sums."""
    Bh = coarse_bins(total_bins, hist_shift) if hist_shift else total_bins
    return hist_limbs_plain(bins_t, slot, vals, n_slots, Bh, hist_shift,
                            feat)


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


def route_and_hist_ids_plain(bins_t, node_id, leaf, feat, t1, rlo, rhi,
                             dflt, l_id, r_id, vals, n_slots: int,
                             total_bins: int, hist_shift: int = 0,
                             feat_k=None):
    """K2's plain version in the id form: split j's bins are the row
    ``feat[j]`` of ``bins_t`` and the refined features the rows
    ``feat_k``; rows are read in place, nothing is gathered."""
    B = total_bins
    Bh = coarse_bins(B, hist_shift) if hist_shift else B
    rows = [bins_t[f] for f in feat.tolist()]
    new_id, bslot = route_plain(node_id, leaf, rows, t1, rlo, rhi, dflt,
                                l_id, r_id)
    out = hist_limbs_plain(bins_t, bslot, vals, n_slots, Bh, hist_shift)
    outf = (None if feat_k is None
            else hist_limbs_plain(bins_t, bslot, vals, n_slots, B, 0,
                                  feat_k))
    return new_id, out, outf


# --------------------------------------------------------------------------
# the histogram pass's geometry (csrc/gbdt_hist.cu, hist_rows_kernel)
# --------------------------------------------------------------------------

def _hist_bytes(fpb: int, width: int, n_slots: int) -> int:
    """A block's shared histograms: fpb features x width x S x 7 int32,
    rounded up to 16 bytes (the ring after them takes 16-byte copies)."""
    return -(-fpb * width * n_slots * _LIVE * 4 // 16) * 16


def _ring_bytes(fpb: int, tile: int) -> int:
    """The cp.async ring: 3 stages of tile (row, slot) entries, 2 of the
    rows' 8 limbs and 2 of fpb bins per row."""
    return tile * (3 * 8 + 2 * 8 + 2 * 4 * fpb)


def rows_blocks_per_sm(smem: int) -> int:
    """Blocks an H100 SM holds at ``smem`` dynamic shared bytes each (228
    KB a SM, 1 KB reserved a block), at most the 2 the kernel's launch
    bounds promise registers for."""
    return min(2, _SM_SMEM // (smem + 1024))


def _tile_cap(fpb: int) -> int:
    """The largest power-of-two tile whose gathers (8 bytes of limbs plus
    4 per feature and row) stay within ``_FLIGHT_BYTES``."""
    tile = _TILE_MAX
    while tile > _TILE_MIN and tile * (8 + 4 * fpb) > _FLIGHT_BYTES:
        tile //= 2
    return tile


@functools.lru_cache(maxsize=None)
def rows_geometry(nfeat: int, width: int, n_slots: int):
    """→ (features per block, tile, feature groups, dynamic shared bytes)
    of one feature set in ``hist_rows_kernel``.

    The most features per block whose histograms fit beside a ring at
    :func:`_tile_cap`'s tile, spread evenly over the groups that takes;
    a single feature too wide for that takes a smaller tile.  Where a
    block is alone on its SM but two fit at half the tile, half the tile:
    the SM keeps as many bytes in flight, with twice the threads
    scattering.  Raises ``ValueError`` when one feature's histogram does
    not fit."""
    if nfeat <= 0:
        return 0, 0, 0, 0

    def smem(fpb, tile):
        return _hist_bytes(fpb, width, n_slots) + _ring_bytes(fpb, tile)
    nf = next((n for n in range(min(nfeat, _MAX_FPB), 0, -1)
               if smem(n, _tile_cap(n)) <= _MAX_SMEM), 0)
    if nf:
        groups = -(-nfeat // nf)
        fpb = -(-nfeat // groups)
        tile = _tile_cap(fpb)
        if smem(fpb, tile) > _MAX_SMEM:
            tile = _tile_cap(nf)
    else:
        groups, fpb, tile = nfeat, 1, _tile_cap(1)
        while tile > _TILE_MIN and smem(1, tile) > _MAX_SMEM:
            tile //= 2
        if smem(1, tile) > _MAX_SMEM:
            raise ValueError(f"one feature's histogram ({width} bins x "
                             f"{n_slots} slots) exceeds a block's shared "
                             "memory")
    if (tile > _TILE_MIN and rows_blocks_per_sm(smem(fpb, tile)) < 2
            and rows_blocks_per_sm(smem(fpb, tile // 2)) == 2):
        tile //= 2
    return fpb, tile, groups, smem(fpb, tile)


# --------------------------------------------------------------------------
# the tuned geometry (the gbdt_hist_geometry space of telemetry.autotune)
# --------------------------------------------------------------------------

#: the tuning-table space of ``hist_rows_kernel``'s (features per block,
#: tile); its own name, so no table hands the JAX package's row-chunk
#: winner (``gbdt_hist_chunk``) to this knob
HIST_GEOMETRY_SPACE = "gbdt_hist_geometry"

#: the (fpb, tile) of each feature set of the last launch under each launch
#: key (K1: one pair; K2: the coarse pair, then the refined one or zeros)
LAUNCH_GEOMETRY: Dict[str, Tuple[int, ...]] = {}

#: plane -> {(device kind, F, width, S): (fpb, tile)}: one consult per
#: plane, device kind and geometry
_TUNED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def rows_geometry_ok(nfeat: int, width: int, n_slots: int, fpb: int,
                     tile: int) -> bool:
    """Does ``hist_rows_kernel`` take ``(fpb, tile)`` for this feature
    set: ``fpb`` in [1, min(nfeat, 64)], ``tile`` a power of two in
    [``_TILE_MIN``, :func:`_tile_cap` (fpb)] and the block's shared
    histograms and ring within ``_MAX_SMEM``?"""
    if any(isinstance(v, bool) or not isinstance(v, int)
           for v in (fpb, tile)):
        return False
    return (1 <= fpb <= min(nfeat, _MAX_FPB)
            and _TILE_MIN <= tile <= _tile_cap(fpb)
            and tile & (tile - 1) == 0
            and _hist_bytes(fpb, width, n_slots) + _ring_bytes(fpb, tile)
            <= _MAX_SMEM)


def rows_geometry_candidates(nfeat: int, width: int,
                             n_slots: int) -> List[Tuple[int, int]]:
    """The ``(fpb, tile)`` pairs the autotuner tries: ``fpb`` each even
    spread ``ceil(nfeat / g)`` of the features over g groups (an uneven
    spread only leaves a block short), ``tile`` every power of two
    :func:`rows_geometry_ok` admits with it."""
    out = []
    for fpb in sorted({-(-nfeat // g) for g in range(1, nfeat + 1)}):
        tile = _TILE_MIN
        while tile <= _TILE_MAX:
            if rows_geometry_ok(nfeat, width, n_slots, fpb, tile):
                out.append((fpb, tile))
            tile *= 2
    return out


def hist_geometry_key(nfeat: int, width: int, n_slots: int) -> str:
    """The tuning-table geometry of one feature set's histogram pass: its
    features, the bins it histograms (coarse ones under a shift) and its
    slots.  The autotuner records under it and the launches consult it."""
    from ...telemetry.tunetable import geometry_key
    return geometry_key(features=int(nfeat), total_bins=int(width),
                        slots=int(n_slots))


def launch_geometry(nfeat: int, width: int, n_slots: int,
                    device=None) -> Tuple[int, int]:
    """The ``(fpb, tile)`` one feature set launches with: a ``loaded``
    ``gbdt_hist_geometry`` winner for ``device`` and this geometry that
    :func:`rows_geometry_ok` re-admits, else :func:`rows_geometry`'s
    (what a process without a table launches).  The table is consulted
    once per plane, device kind and geometry."""
    from ...telemetry.tunetable import get_tuneplane
    plane = get_tuneplane()
    memo = _TUNED.setdefault(plane, {})
    key = (plane.kind_of(device), nfeat, width, n_slots)
    hit = memo.get(key)
    if hit is None:
        won = plane.consult(
            "hist.launch_geometry", HIST_GEOMETRY_SPACE,
            hist_geometry_key(nfeat, width, n_slots),
            validate=lambda w: rows_geometry_ok(
                nfeat, width, n_slots, w.get("fpb"), w.get("tile")),
            device=device)
        hit = memo[key] = (rows_geometry(nfeat, width, n_slots)[:2]
                           if won is None
                           else (int(won["fpb"]), int(won["tile"])))
    return hit


def _forced_geometry(nfeat, width, n_slots, geometry) -> Tuple[int, int]:
    fpb, tile = (int(v) for v in geometry)
    if not rows_geometry_ok(nfeat, width, n_slots, fpb, tile):
        raise ValueError(f"geometry (fpb={fpb}, tile={tile}) does not fit "
                         f"hist_rows_kernel at F={nfeat}, width={width}, "
                         f"S={n_slots}")
    return fpb, tile


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@loaded_once
def _kernels() -> ctypes.CDLL:
    lib = load_library("gbdt_hist")
    lib.sml_route_rows.argtypes = [_LL, _I, _P, _P, _P, _P, _P, _P, _P, _P]
    lib.sml_hist_nodes.argtypes = [_P, _P, _I, _LL, _P, _P, _I, _I, _I, _I,
                                   _I, _P, _P, _P, _P]
    lib.sml_route_and_hist.argtypes = [_P, _I, _LL, _P, _P, _I, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _P, _P, _P, _P, _P, _P]
    lib.sml_hist_nodes_previous.argtypes = [_P, _I, _LL, _P, _P, _I, _I, _I,
                                            _P, _P]
    lib.sml_route_and_hist_previous.argtypes = [
        _P, _I, _LL, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    for fn in (lib.sml_route_rows, lib.sml_hist_nodes,
               lib.sml_route_and_hist, lib.sml_hist_nodes_previous,
               lib.sml_route_and_hist_previous):
        fn.restype = _I
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
    """One feature's histogram at (width, S) must fit a block beside the
    smallest ring (and so fits the previous kernel too)."""
    if not 1 <= n_slots <= _MAX_SLOTS:
        raise ValueError(f"n_slots={n_slots}: the CUDA kernels take 1.."
                         f"{_MAX_SLOTS}")
    rows_geometry(1, width, n_slots)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().sml_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _row_list(N: int, dev: torch.device):
    """Scratch of the compacted rows: N + 2 (row, slot) pairs (the hist
    pass copies pairs, so one past the last never reads past the end) and
    the zeroed count."""
    if N >= 2 ** 31:
        raise ValueError(f"N={N}: the row list holds int32 row indices")
    return (torch.empty((N + 2, 2), dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _need_rows(base, rows, name: str, N: int, dev) -> None:
    """``rows`` (n,) int32 ids of rows of ``base`` (R, N); the ids must lie
    in [0, R) (the kernel reads them unchecked)."""
    _need(base, name, torch.int32, (base.shape[0], N), dev)
    _need(rows, f"{name} row ids", torch.int32, (rows.shape[0],), dev)


def _build_hist_nodes_cuda(bins_t, slot, vals, n_slots, total_bins,
                           hist_shift, feat, geometry=None):
    dev = bins_t.device
    R, N = bins_t.shape
    F = R if feat is None else feat.shape[0]
    Bh = coarse_bins(total_bins, hist_shift) if hist_shift else total_bins
    _need(bins_t, "bins_t", torch.int32, (R, N), dev)
    if feat is not None:
        _need(feat, "feat", torch.int32, (F,), dev)
    _need(slot, "slot", torch.int32, (N,), dev)
    _need(vals, "vals", torch.int8, (N, SLOT_LANES), dev)
    _check_smem(Bh, n_slots)
    fpb, tile = (launch_geometry(F, Bh, n_slots, dev) if geometry is None
                 else _forced_geometry(F, Bh, n_slots, geometry))
    out = torch.zeros((F, Bh, n_slots, SLOT_LANES), dtype=torch.int32,
                      device=dev)
    lst, cnt = _row_list(N, dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.sml_hist_nodes(
            bins_t.data_ptr(), _ptr(feat), F, N, slot.data_ptr(),
            vals.data_ptr(), n_slots, Bh, hist_shift, fpb, tile,
            lst.data_ptr(), cnt.data_ptr(), out.data_ptr(), _stream(dev))
    _raise_on(rc, "build_hist_nodes")
    launches.io_bytes("build_hist_nodes", 4 * F * N, slot, vals, out)
    # launch keys: K1 ``F, B, shift, S`` and K2 ``F, B, shift, K, S``, with
    # ``B`` the full bin count, then the kernel variant
    key = launches.launch_key("build_hist_nodes", F=F, B=total_bins,
                              shift=hist_shift, S=n_slots, variant="rows")
    LAUNCH_GEOMETRY[key] = (fpb, tile)
    launches.count("build_hist_nodes", F=F, B=total_bins, shift=hist_shift,
                   S=n_slots, variant="rows")
    return out


def _route_and_hist_cuda(bins_t, node_id, leaf, base, rows, t1, rlo, rhi,
                         dflt, l_id, r_id, vals, n_slots, total_bins,
                         hist_shift, kbase, krows):
    """K2 on the card: split j's bins are row ``rows[j]`` of ``base`` and
    the refined features rows ``krows`` of ``kbase`` (None: no refine)."""
    dev = bins_t.device
    F, N = bins_t.shape
    S = n_slots
    B = total_bins
    Bh = coarse_bins(B, hist_shift) if hist_shift else B
    params = torch.stack([leaf, t1, rlo, rhi, dflt, l_id, r_id, rows]).to(
        device=dev, dtype=torch.int32).contiguous()
    _need(bins_t, "bins_t", torch.int32, (F, N), dev)
    _need(node_id, "node_id", torch.int32, (N,), dev)
    _need(params, "leaf/t1/rlo/rhi/dflt/l_id/r_id/rows", torch.int32, (8, S),
          dev)
    _need_rows(base, rows, "split bins", N, dev)
    _need(vals, "vals", torch.int8, (N, SLOT_LANES), dev)
    _check_smem(Bh, S)
    fpb0, tile0 = launch_geometry(F, Bh, S, dev)
    K = fpb1 = tile1 = 0
    if krows is not None:
        K = krows.shape[0]
        _need_rows(kbase, krows, "refined bins", N, dev)
        _check_smem(B, S)
        if K:
            fpb1, tile1 = launch_geometry(K, B, S, dev)
    new_id = torch.empty(N, dtype=torch.int32, device=dev)
    out = torch.zeros((F, Bh, S, SLOT_LANES), dtype=torch.int32, device=dev)
    outf = (torch.zeros((K, B, S, SLOT_LANES), dtype=torch.int32, device=dev)
            if krows is not None else None)
    lst, cnt = _row_list(N, dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.sml_route_and_hist(
            bins_t.data_ptr(), F, N, node_id.data_ptr(), params.data_ptr(),
            S, base.data_ptr(), vals.data_ptr(),
            _ptr(kbase) if K else None, _ptr(krows) if K else None, K, B,
            Bh, hist_shift, fpb0, tile0, fpb1, tile1, new_id.data_ptr(),
            lst.data_ptr(), cnt.data_ptr(), out.data_ptr(), _ptr(outf),
            _stream(dev))
    _raise_on(rc, "route_and_hist")
    launches.io_bytes("route_and_hist", bins_t, node_id, params,
                      4 * (S + K) * N, vals, new_id, out, outf)
    key = launches.launch_key("route_and_hist", F=F, B=B, shift=hist_shift,
                              K=K, S=S, variant="rows")
    LAUNCH_GEOMETRY[key] = (fpb0, tile0, fpb1, tile1)
    launches.count("route_and_hist", F=F, B=B, shift=hist_shift, K=K, S=S,
                   variant="rows")
    return new_id, out, outf


def route_rows(node_id, leaf, base, rows, t1, rlo, rhi, dflt, l_id, r_id,
               n_slots: int):
    """K2's first launch alone, on the card: → (new_id (N,), the
    compacted (row, slot) list (N + 2, 2) int32, its length (1,) int32).
    Each block's rows are in ascending order.  For timing the routing
    apart from the histograms; no main path calls it."""
    dev = node_id.device
    if dev.type != "cuda":
        raise ValueError(f"route_rows launches a CUDA kernel; node_id is on "
                         f"{dev}")
    N = node_id.shape[0]
    S = n_slots
    params = torch.stack([leaf, t1, rlo, rhi, dflt, l_id, r_id, rows]).to(
        device=dev, dtype=torch.int32).contiguous()
    _need(node_id, "node_id", torch.int32, (N,), dev)
    _need(params, "leaf/t1/rlo/rhi/dflt/l_id/r_id/rows", torch.int32, (8, S),
          dev)
    _need_rows(base, rows, "split bins", N, dev)
    _check_smem(1, S)
    new_id = torch.empty(N, dtype=torch.int32, device=dev)
    lst, cnt = _row_list(N, dev)
    with torch.cuda.device(dev):
        rc = _kernels().sml_route_rows(
            N, S, node_id.data_ptr(), params.data_ptr(), base.data_ptr(),
            None, new_id.data_ptr(), lst.data_ptr(), cnt.data_ptr(),
            _stream(dev))
    _raise_on(rc, "route_rows")
    launches.io_bytes("route_rows", node_id, params, 4 * S * N, new_id, lst,
                      cnt)
    launches.count("route_rows", S=S)
    return new_id, lst, cnt


# --------------------------------------------------------------------------
# entry points (signatures and returns of the JAX package's functions)
# --------------------------------------------------------------------------

def build_hist_nodes_limbs(bins_t, slot, vals, n_slots: int,
                           total_bins: int, hist_shift: int = 0, feat=None,
                           geometry: Optional[Tuple[int, int]] = None):
    """K1 → (F, Bh, S, 8) int32 limb sums of the rows ``feat`` (F,) int32
    of ``bins_t`` (all its rows when None): the kernel for CUDA tensors,
    the plain version for CPU tensors.  ``geometry`` forces the kernel's
    ``(fpb, tile)`` (the autotuner's candidates; None:
    :func:`launch_geometry`); the histogram does not depend on it."""
    if bins_t.is_cuda:
        return _build_hist_nodes_cuda(bins_t, slot, vals, n_slots,
                                      total_bins, hist_shift, feat, geometry)
    return build_hist_nodes_plain(bins_t, slot, vals, n_slots, total_bins,
                                  hist_shift, feat)


def build_hist_nodes(bins_t, slot, vals, scales, n_slots: int,
                     total_bins: int, hist_shift: int = 0,
                     feat=None) -> torch.Tensor:
    """→ (n_slots, F, Bh, 3) float32 [grad, hess, count] histograms
    (Bh = :func:`coarse_bins` when ``hist_shift`` > 0) of the rows
    ``feat`` of ``bins_t`` (all when None)."""
    out = build_hist_nodes_limbs(bins_t, slot, vals, n_slots, total_bins,
                                 hist_shift, feat)
    return _reconstruct(out.permute(2, 0, 1, 3), scales)


def route_and_hist_limbs(bins_t, node_id, leaf, sel, t1, rlo, rhi, dflt,
                         l_id, r_id, vals, n_slots: int, total_bins: int,
                         hist_shift: int = 0, sel_k=None):
    """K2 → (new_id, (F, Bh, S, 8) int32, (K, B, S, 8) int32 or None): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if bins_t.is_cuda:
        def ids(t):
            return torch.arange(t.shape[0], dtype=torch.int32,
                                device=t.device)
        return _route_and_hist_cuda(
            bins_t, node_id, leaf, sel, ids(sel), t1, rlo, rhi, dflt, l_id,
            r_id, vals, n_slots, total_bins, hist_shift, sel_k,
            None if sel_k is None else ids(sel_k))
    return route_and_hist_plain(bins_t, node_id, leaf, sel, t1, rlo, rhi,
                                dflt, l_id, r_id, vals, n_slots, total_bins,
                                hist_shift, sel_k)


def route_and_hist_ids_limbs(bins_t, node_id, leaf, feat, t1, rlo, rhi,
                             dflt, l_id, r_id, vals, n_slots: int,
                             total_bins: int, hist_shift: int = 0,
                             feat_k=None):
    """:func:`route_and_hist_limbs` with split j's bins the row
    ``feat[j]`` of ``bins_t`` and the refined features its rows
    ``feat_k`` ((S,) and (K,) int32 ids in [0, F)): nothing is gathered."""
    if bins_t.is_cuda:
        return _route_and_hist_cuda(
            bins_t, node_id, leaf, bins_t, feat, t1, rlo, rhi, dflt, l_id,
            r_id, vals, n_slots, total_bins, hist_shift,
            None if feat_k is None else bins_t, feat_k)
    return route_and_hist_ids_plain(bins_t, node_id, leaf, feat, t1, rlo,
                                    rhi, dflt, l_id, r_id, vals, n_slots,
                                    total_bins, hist_shift, feat_k)


# --------------------------------------------------------------------------
# the previous kernel: a same-run yardstick, CUDA tensors only
# --------------------------------------------------------------------------

def _need_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; its input is on "
                         f"{t.device}")


def build_hist_nodes_limbs_previous(bins_t, slot, vals, n_slots: int,
                                    total_bins: int, hist_shift: int = 0):
    """K1 through the previous kernel (grid of row blocks x feature
    groups, each group reading every row's slot): the same output as
    :func:`build_hist_nodes_limbs`."""
    _need_card(bins_t, "build_hist_nodes_limbs_previous")
    dev = bins_t.device
    F, N = bins_t.shape
    Bh = coarse_bins(total_bins, hist_shift) if hist_shift else total_bins
    _need(bins_t, "bins_t", torch.int32, (F, N), dev)
    _need(slot, "slot", torch.int32, (N,), dev)
    _need(vals, "vals", torch.int8, (N, SLOT_LANES), dev)
    _check_smem(Bh, n_slots)
    out = torch.zeros((F, Bh, n_slots, SLOT_LANES), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = _kernels().sml_hist_nodes_previous(
            bins_t.data_ptr(), F, N, slot.data_ptr(), vals.data_ptr(),
            n_slots, Bh, hist_shift, out.data_ptr(), _stream(dev))
    _raise_on(rc, "build_hist_nodes_previous")
    launches.io_bytes("build_hist_nodes", bins_t, slot, vals, out)
    launches.count("build_hist_nodes", F=F, B=total_bins, shift=hist_shift,
                   S=n_slots, variant="previous")
    return out


def route_and_hist_limbs_previous(bins_t, node_id, leaf, sel, t1, rlo, rhi,
                                  dflt, l_id, r_id, vals, n_slots: int,
                                  total_bins: int, hist_shift: int = 0,
                                  sel_k=None):
    """K2 through the previous kernel (grid of row blocks x feature
    groups, each group routing every row again, split rows gathered by
    the caller): the same output as :func:`route_and_hist_limbs`."""
    _need_card(bins_t, "route_and_hist_limbs_previous")
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
    with torch.cuda.device(dev):
        rc = _kernels().sml_route_and_hist_previous(
            bins_t.data_ptr(), F, N, node_id.data_ptr(), params.data_ptr(),
            S, sel.data_ptr(), vals.data_ptr(), _ptr(sel_k), K, B, Bh,
            hist_shift, new_id.data_ptr(), out.data_ptr(), _ptr(outf),
            _stream(dev))
    _raise_on(rc, "route_and_hist_previous")
    launches.io_bytes("route_and_hist", bins_t, node_id, params, sel, vals,
                      sel_k, new_id, out, outf)
    launches.count("route_and_hist", F=F, B=B, shift=hist_shift, K=K, S=S,
                   variant="previous")
    return new_id, out, outf
