"""Compressed collectives: quantized all-reduce with error feedback.

The PyTorch port of the JAX package's ``parallel/compression.py``.  Two
levers cut the bytes a reduction moves:

- **Quantized all-reduce codecs** (EQuARX, arXiv:2506.17615): ``bf16``
  (cast, reduce in bf16, cast back: 2x less wire) and ``int8`` (chunked
  symmetric quantization, one f32 scale per ``chunk`` values: ~3.9x at
  chunk=256).  int8 reduces as a reduce-scatter plus an all-gather of
  QUANTIZED shards: an all-to-all ships each rank its shard's quantized
  copies, the shard sums in f32 locally in rank order, and the
  re-quantized sum all-gathers back; both wire legs carry int8.
- **Error feedback** (the 1-bit SGD lineage): the quantization error is
  carried in a residual and added to the next step's gradient (DL mesh
  training's manual step, ``models.dl.training``).

The codecs are bit-exact against the reference's functions: the same
f32 operations in the same order, round half to even, and every divide
by a device tensor (a card multiplies by the reciprocal when it divides
by a Python number).  Non-finite policy: an int8 chunk holding a NaN or
Inf decodes to all-NaN on every rank; bf16 casts them through.

Determinism: every rank decodes the same gathered bytes in the same
order, so a compressed reduction is replicated exactly like ``psum``,
which the data-parallel GBDT's identical trees on every rank rely on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..telemetry import get_registry
from .mesh import DATA_AXIS

#: codecs understood by :class:`CollectiveConfig.compression`
CODECS = ("none", "bf16", "int8")

#: the tuning-table space of the int8 codec's chunk (the JAX package's
#: ``int8_chunk``, under the port's own name)
INT8_CHUNK_SPACE = "int8_codec_chunk"
#: the geometry the codec shorthand consults with
INT8_CHUNK_NUMEL = 1 << 18


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    """Per-estimator collective compression and routing policy (the
    reference's fields; frozen and hashable)."""
    #: "none" | "bf16" | "int8" — wire codec for eligible reductions
    compression: str = "none"
    #: reduce-scatter gradients, update the local shard, all-gather
    #: params back (DL only)
    sharded_update: bool = False
    #: carry quantization error into the next step's gradient (DL only)
    error_feedback: bool = False
    #: payloads with fewer elements stay f32
    min_size: int = 2048
    #: values sharing one f32 scale in the int8 codec
    chunk: int = 256
    #: force the manual data-parallel step (a measurement pin)
    manual: bool = False
    #: reduction route (:mod:`.planner`): auto | flat | ring | tree |
    #: hierarchical
    strategy: str = "auto"

    def __post_init__(self):
        if self.compression not in CODECS:
            raise ValueError(
                f"compression={self.compression!r}: must be one of {CODECS}")
        if self.chunk < 8:
            raise ValueError(f"chunk={self.chunk}: must be >= 8")
        from .planner import STRATEGIES
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"strategy={self.strategy!r}: must be one of {STRATEGIES}")

    @property
    def enabled(self) -> bool:
        return (self.compression != "none" or self.sharded_update
                or self.manual or self.routes)

    @property
    def routes(self) -> bool:
        """An explicit routing request ('auto' alone enables nothing)."""
        return self.strategy in ("ring", "tree", "hierarchical")

    @property
    def compresses(self) -> bool:
        return self.compression != "none"


def resolve_collective_config(value: Any) -> Optional[CollectiveConfig]:
    """The one parser for ``collectiveCompression`` params: ``None`` /
    ``"none"`` (off), a codec shorthand (``"bf16"`` / ``"int8"``, error
    feedback on; the int8 chunk from the tuning table when it holds one
    for this device), a :class:`CollectiveConfig`, or its
    ``dataclasses.asdict`` form."""
    if value is None:
        return None
    if isinstance(value, CollectiveConfig):
        return value if value.enabled else None
    if isinstance(value, dict):
        fields = {f.name for f in dataclasses.fields(CollectiveConfig)}
        return resolve_collective_config(CollectiveConfig(
            **{k: v for k, v in value.items() if k in fields}))
    if isinstance(value, str):
        if value in ("none", ""):
            return None
        if value not in CODECS:
            raise ValueError(
                f"collectiveCompression={value!r}: must be one of {CODECS} "
                "or a CollectiveConfig")
        cfg = CollectiveConfig(compression=value, error_feedback=True)
        if value == "int8":
            tuned = _tuned_int8_chunk()
            if tuned is not None:
                cfg = dataclasses.replace(cfg, chunk=tuned)
        return cfg
    raise TypeError(
        f"collectiveCompression accepts a str codec or CollectiveConfig, "
        f"got {type(value).__name__}")


def _tuned_int8_chunk(device=None) -> Optional[int]:
    """The ``int8_codec_chunk`` tuning-table winner for this device, or
    None (keep the 256 default).  Only the codec shorthand consults."""
    from ..telemetry.tunetable import geometry_key, get_tuneplane
    winner = get_tuneplane().consult(
        "resolve_collective_config", INT8_CHUNK_SPACE,
        geometry_key(numel=INT8_CHUNK_NUMEL),
        validate=lambda w: (isinstance(w.get("chunk"), int)
                            and not isinstance(w["chunk"], bool)
                            and w["chunk"] >= 8),
        device=device)
    return int(winner["chunk"]) if winner is not None else None


def stream_eligible(shape, dtype: torch.dtype,
                    config: Optional[CollectiveConfig]) -> bool:
    """Does a payload of this shape and dtype belong to the big flat
    stream (float, ``min_size`` or more elements)?"""
    return (config is not None and int(np.prod(shape)) >= config.min_size
            and dtype.is_floating_point)


def codec_eligible(shape, dtype, config: Optional[CollectiveConfig]) -> bool:
    """THE eligibility predicate: does the codec engage on this payload?
    The reductions, the wire accounting and the labels all ask it."""
    return (config is not None and config.compresses
            and stream_eligible(shape, dtype, config))


# -- wire accounting ---------------------------------------------------------

def logical_nbytes(x) -> int:
    """Bytes the values of a tensor (or a tree of them) occupy at their
    logical dtype."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in pytree.tree_leaves(x))


def wire_nbytes(x, config: Optional[CollectiveConfig],
                channel_major: bool = False) -> int:
    """Bytes the codec puts on the wire for ``x`` (the reference's
    model): bf16 halves every eligible float; int8 ships 1 byte a value
    plus one f32 scale per ``chunk``, the layout's pad values included
    (``channel_major``: each trailing channel pads to a chunk multiple).
    ``config=None`` / "none": logical bytes."""
    if config is None or not config.compresses:
        return logical_nbytes(x)
    total = 0
    int8_vals = 0
    for leaf in pytree.tree_leaves(x):
        size, shape = leaf.numel(), tuple(leaf.shape)
        if not codec_eligible((size,), leaf.dtype, config):
            total += size * leaf.element_size()
        elif config.compression == "bf16":
            total += size * 2
        elif channel_major and len(shape) >= 2:
            C = shape[-1]
            per = size // C
            int8_vals += C * (-(-per // config.chunk) * config.chunk)
        else:
            int8_vals += size
    if int8_vals:
        int8_vals = -(-int8_vals // config.chunk) * config.chunk
        total += int8_vals + (int8_vals // config.chunk) * 4
    return total


def record_compressed(op: str, axis, x, config: Optional[CollectiveConfig],
                      channel_major: bool = False, strategy: str = "flat",
                      codec: Optional[str] = None,
                      wire: Optional[int] = None) -> int:
    """Wire/logical accounting of a compressed collective →
    the wire bytes it recorded."""
    if codec is None:
        codec = config.compression if config is not None else "none"
    logical = logical_nbytes(x)
    if wire is None:
        wire = wire_nbytes(x, config, channel_major=channel_major)
    reg = get_registry()
    labels = dict(op=op, axis=str(axis), codec=codec, strategy=strategy)
    reg.counter(
        "collective_wire_bytes_total",
        "per-rank bytes collectives actually put on the wire, by op, mesh "
        "axis, codec and routing strategy",
        ("op", "axis", "codec", "strategy")).inc(wire, **labels)
    reg.gauge(
        "collective_compression_ratio",
        "logical / wire bytes of the last collective, by op, mesh axis, "
        "codec and routing strategy",
        ("op", "axis", "codec", "strategy")).set(
            (logical / wire) if wire else 1.0, **labels)
    return wire


# -- codecs ------------------------------------------------------------------

def bf16_encode(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def bf16_decode(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32)


def int8_encode(flat: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked symmetric int8 quantization of a flat f32 vector whose
    length is a multiple of ``chunk`` → ``(q int8 (n_chunks, chunk),
    scales f32 (n_chunks,))`` with ``scale = max|finite x| / 127`` per
    chunk; a chunk holding a non-finite value gets a NaN scale."""
    xc = flat.reshape(-1, chunk)
    finite = torch.isfinite(xc)
    amax = torch.where(finite, xc.abs(), torch.zeros_like(xc)).amax(dim=1)
    scale = amax / torch.tensor(127.0, dtype=amax.dtype, device=amax.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xc / safe[:, None]), -127, 127).to(
        torch.int8)
    scale = torch.where(finite.all(dim=1), scale,
                        torch.full_like(scale, float("nan")))
    return q, scale.to(torch.float32)


def int8_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`int8_encode` → flat f32."""
    return (q.to(torch.float32) * scales[:, None]).reshape(-1)


def int8_roundtrip(flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """Encode → decode round trip of a flat f32 vector: the int8 codec's
    standalone entry point, which the ``int8_codec_chunk`` space times."""
    return int8_decode(*int8_encode(flat, chunk))


def _channel_major_padded(x: torch.Tensor, chunk: int):
    """Channel-major flatten with each trailing channel zero-padded to a
    ``chunk`` multiple → ``(flat, per, per_padded)``, so no int8 chunk
    spans two channels (GBDT's grad/hess/count differ by ~1e3)."""
    if x.dim() >= 2:
        C = x.shape[-1]
        moved = torch.movedim(x, -1, 0).reshape(C, -1)
        per = moved.shape[1]
        per_p = -(-per // chunk) * chunk
        if per_p != per:
            moved = torch.nn.functional.pad(moved, (0, per_p - per))
        return moved.reshape(-1), per, per_p
    return x.reshape(-1), None, None


def _channel_major_padded_inv(flat, shape, per, per_p):
    if len(shape) >= 2:
        C = shape[-1]
        out = flat.reshape(C, per_p)[:, :per]
        return torch.movedim(out.reshape((C,) + tuple(shape[:-1])), 0, -1)
    return flat.reshape(shape)


def _pad_to(flat: torch.Tensor, unit: int) -> torch.Tensor:
    n = flat.shape[0]
    padded = -(-n // unit) * unit
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    return flat


def _sum_in_rank_order(vals: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (rank) axis in order 0..n-1, the same f32
    adds on every rank and device."""
    acc = vals[0]
    for j in range(1, vals.shape[0]):
        acc = acc + vals[j]
    return acc


def int8_reduce_scatter(flat: torch.Tensor, mesh, axis: str, chunk: int,
                        timeout_s: Optional[float] = None) -> torch.Tensor:
    """Quantized reduce-scatter of a flat f32 vector whose length is a
    multiple of ``n_ranks * chunk`` → this rank's f32 shard of the SUM.
    Each rank quantizes its vector per chunk, an all-to-all ships shard
    ``r``'s quantized copies to rank ``r``, and the shard sums in f32."""
    from .collectives import all_to_all
    n = mesh.axis_size(axis)
    q, s = int8_encode(flat, chunk)
    if n == 1:
        return int8_decode(q, s)
    shard = flat.shape[0] // n
    q = q.reshape(n, shard // chunk, chunk)
    s = s.reshape(n, shard // chunk)
    q_x = all_to_all(q, mesh, axis, op="int8_reduce_scatter",
                     timeout_s=timeout_s)
    s_x = all_to_all(s, mesh, axis, op="int8_reduce_scatter",
                     timeout_s=timeout_s)
    vals = q_x.to(torch.float32) * s_x[..., None]
    return _sum_in_rank_order(vals).reshape(-1)


def int8_all_gather(shard: torch.Tensor, mesh, axis: str, chunk: int,
                    timeout_s: Optional[float] = None) -> torch.Tensor:
    """Quantized all-gather of equal f32 shards → the concatenated f32
    vector, identical on every rank."""
    from .collectives import all_gather
    n = mesh.axis_size(axis)
    q, s = int8_encode(shard, chunk)
    if n == 1:
        return int8_decode(q, s)
    qg = all_gather(q, mesh, axis, op="int8_all_gather",
                    timeout_s=timeout_s)                   # (n, C, chunk)
    sg = all_gather(s, mesh, axis, op="int8_all_gather",
                    timeout_s=timeout_s)                   # (n, C)
    return (qg.to(torch.float32) * sg[..., None]).reshape(-1)


# -- compressed reductions ----------------------------------------------------

def compressed_psum(x: torch.Tensor, mesh, axis: Optional[str] = DATA_AXIS,
                    config: Optional[CollectiveConfig] = None,
                    op: str = "compressed_psum", record: bool = True,
                    timeout_s: Optional[float] = None) -> torch.Tensor:
    """``psum`` with the config's codec on the wire: stateless, sum
    semantics, the same result on every rank.  Trailing-channel arrays
    lay out channel-major before chunking.  ``config=None`` / "none" /
    small or non-float payloads take the plain f32 ``psum``."""
    from .collectives import _record, psum
    if axis is None or mesh is None:
        return x
    if not codec_eligible(x.shape, x.dtype, config):
        return psum(x, mesh, axis, op=op, record=record,
                    timeout_s=timeout_s)
    if record:
        _record(op, axis, x, config=config, channel_major=True)
    shape, orig_dtype = tuple(x.shape), x.dtype
    if config.compression == "bf16":
        out = psum(bf16_encode(x), mesh, axis, op=op, record=False,
                   timeout_s=timeout_s)
        return bf16_decode(out).to(orig_dtype)
    flat, per, per_p = _channel_major_padded(x.to(torch.float32),
                                             config.chunk)
    size = flat.shape[0]
    flat = _pad_to(flat, mesh.axis_size(axis) * config.chunk)
    shard = int8_reduce_scatter(flat, mesh, axis, config.chunk, timeout_s)
    total = int8_all_gather(shard, mesh, axis, config.chunk, timeout_s)
    return _channel_major_padded_inv(total[:size], shape, per,
                                     per_p).to(orig_dtype)


def flatten_with_residuals(leaves: Sequence[torch.Tensor], big: Sequence[int],
                           res_leaves, padded: int) -> torch.Tensor:
    """Concatenate the ``big`` leaves (f32, plus their residuals when
    carried) into one zero-padded flat stream of length ``padded``."""
    eff = []
    for i in big:
        g = leaves[i].to(torch.float32)
        if res_leaves is not None:
            g = g + res_leaves[i].reshape(g.shape)
        eff.append(g.reshape(-1))
    dev = leaves[big[0]].device if big else None
    flat = (torch.cat(eff) if eff
            else torch.zeros(0, dtype=torch.float32, device=dev))
    return torch.nn.functional.pad(flat, (0, padded - flat.shape[0]))


def unpack_residuals(err: torch.Tensor, big: Sequence[int],
                     leaves: Sequence[torch.Tensor], res_leaves) -> list:
    """Scatter the flat quantization error back into the residual
    leaves (``e' = (g+e) - Q(g+e)``), inverting the packing order."""
    new_res = list(res_leaves)
    offset = 0
    for i in big:
        sz = leaves[i].numel()
        new_res[i] = err[offset:offset + sz].reshape(new_res[i].shape)
        offset += sz
    return new_res


# -- world-size-independent re-sharding (elastic resize) ---------------------

def canonical_residuals(stacked) -> np.ndarray:
    """Stacked per-rank residuals ``(n, *shape)`` → the total carried
    error ``(*shape,)``, summed in rank order."""
    return np.asarray(stacked, dtype=np.float32).sum(axis=0)


def reshard_residuals(canonical, n: int) -> np.ndarray:
    """Canonical total error → ``(n, *shape)`` residuals: rank 0 carries
    it all, the others zeros (exact; keeps ``sum_r e_r``)."""
    canonical = np.asarray(canonical, dtype=np.float32)
    out = np.zeros((int(n),) + canonical.shape, dtype=np.float32)
    out[0] = canonical
    return out


def reshard_flat_stream(buf, total: int, new_padded: int) -> np.ndarray:
    """A flat padded stream laid out for one world size → re-padded for
    another, keeping its ``total`` real values."""
    buf = np.asarray(buf)
    if total > buf.shape[0] or new_padded < total:
        raise ValueError(
            f"cannot re-lay stream of {buf.shape[0]} values to "
            f"{new_padded} keeping {total} real values")
    out = np.zeros((int(new_padded),), dtype=buf.dtype)
    out[:total] = buf[:total]
    return out


def compressed_tree_sync(tree, mesh, axis: Optional[str],
                         config: CollectiveConfig, residuals=None,
                         mean: bool = True, op: str = "grad_sync"):
    """Gradient-tree all-reduce with compression and error feedback →
    ``(reduced_tree, new_residuals)``.  Large float leaves concatenate
    into one flat stream that rides the codec (or, under an explicit
    route, the planner's plan); small or non-float leaves ride a plain
    bucketed psum.  With ``residuals`` (a tree like ``tree``), each rank
    sends ``Q(g + e)`` and keeps ``e' = (g + e) - Q(g + e)``, in SUM
    units (``mean`` divides the reduced total only)."""
    from .collectives import _record, psum, tree_psum_bucketed
    leaves, spec = pytree.tree_flatten(tree)
    n = mesh.axis_size(axis) if (axis is not None and mesh is not None) \
        else 1
    live = axis is not None and mesh is not None
    big = [i for i, lf in enumerate(leaves)
           if stream_eligible(lf.shape, lf.dtype, config)
           and (config.compresses or config.routes)]
    small = [i for i in range(len(leaves)) if i not in big]
    out = list(leaves)
    new_res = None
    if residuals is not None:
        new_res = list(pytree.tree_leaves(residuals))
    if small and live:
        summed = tree_psum_bucketed([leaves[i] for i in small], mesh,
                                    axis=axis)
        for j, i in enumerate(small):
            out[i] = _mean(summed[j], n) if mean else summed[j]
    if big:
        plan = None
        size = int(sum(leaves[i].numel() for i in big))
        if live and config.strategy != "flat":
            from .planner import get_planner
            plan = get_planner().plan(size * 4, n, config, axis=str(axis),
                                      op=op)
        routed = plan is not None and plan.strategy != "flat"
        big_leaves = [leaves[i] for i in big]
        codec = (plan.wire_codec((size,), torch.float32) if routed
                 else None)
        if live:
            if routed:
                _record(op, axis, big_leaves)
                record_compressed(op, axis, big_leaves,
                                  config if codec != "none" else None,
                                  strategy=plan.strategy, codec=codec,
                                  wire=plan.wire_nbytes(big_leaves, codec))
            else:
                _record(op, axis, big_leaves, config=config)
        flat = flatten_with_residuals(leaves, big, new_res, size)
        want_err = new_res is not None and config.error_feedback
        if routed:
            flat_p = _pad_to(flat, plan.pad_unit(codec))
            total_p, err_p = plan.reduce_flat(flat_p, mesh, axis, codec,
                                              want_err=want_err)
            total = total_p[:size]
            if want_err:
                new_res = unpack_residuals(err_p[:size], big, leaves,
                                           new_res)
        elif not config.compresses:
            total = psum(flat, mesh, axis, op=op, record=False) if live \
                else flat
        elif config.compression == "bf16":
            sent = bf16_decode(bf16_encode(flat))
            total = (bf16_decode(psum(bf16_encode(flat), mesh, axis, op=op,
                                      record=False)) if live else sent)
            if want_err:
                new_res = unpack_residuals(flat - sent[:size], big, leaves,
                                           new_res)
        else:
            flat_p = _pad_to(flat, n * config.chunk)
            sent = int8_roundtrip(flat_p, config.chunk)[:size]
            if live and n > 1:
                shard = int8_reduce_scatter(flat_p, mesh, axis, config.chunk)
                total = int8_all_gather(shard, mesh, axis,
                                        config.chunk)[:size]
            else:
                total = sent
            if want_err:
                new_res = unpack_residuals(flat - sent[:size], big, leaves,
                                           new_res)
        offset = 0
        for i in big:
            sz = leaves[i].numel()
            red = total[offset:offset + sz].reshape(leaves[i].shape)
            out[i] = (_mean(red, n) if mean else red).to(leaves[i].dtype)
            offset += sz
    reduced = pytree.tree_unflatten(out, spec)
    if residuals is not None:
        new_res = pytree.tree_unflatten(
            new_res, pytree.tree_structure(residuals))
    return reduced, new_res


def _mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` dividing by a device tensor (a card would multiply
    by the reciprocal of a Python number)."""
    return total / torch.tensor(float(n), dtype=total.dtype,
                                device=total.device)
