"""Topology-aware collective planner: per-payload reduction routing.

The PyTorch port of the JAX package's ``parallel/planner.py``.  A
:class:`ReductionPlan` names the route a reduction takes — **flat**
(``all_reduce``, whatever the backend runs), **ring** (reduce-scatter +
all-gather around the axis), **tree** (recursive doubling, ``log2(n)``
exchanges; latency-optimal for small payloads) or **hierarchical**
(intra-host reduce-scatter in f32, inter-host all-reduce through the
int8/bf16 codec, intra-host all-gather) — chosen by :func:`_decide` from
payload bytes × world size × link class, behind
:class:`~.compression.CollectiveConfig` (``strategy``).

Honesty contract: ``auto`` routes away from ``flat`` only when the
topology is KNOWN — an injected :class:`TopologySpec`.  This stack never
discovers an interconnect layout (no backend exposes one), so a
discovered spec is untrusted and ``auto`` plans ``flat``.  Plans are
cached by ``(payload bucket, world, config, spec, epoch)``; every gang
relaunch or resize bumps the epoch.  A fitted
:class:`~synapseml_tpu_torch.telemetry.autotune.CollectiveCostModel` in
the tuning table (``COST_MODEL_SPACE``) prices the tree-vs-ring cutoff;
without one the spec constant ``TREE_CUTOFF_BYTES`` does.

Telemetry: ``collective_plans_total{strategy,reason,model}``,
``plan_decide`` / ``plan_invalidate`` flight events, the
``strategy`` label of ``collective_wire_bytes_total`` and the step
profiler's collective segment.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..resilience.faults import get_faults
from ..telemetry import get_registry
from ..telemetry.flight import record as flight_record

__all__ = ["TopologySpec", "ReductionPlan", "CollectivePlanner",
           "STRATEGIES", "TREE_CUTOFF_BYTES", "get_planner", "set_planner",
           "planned_psum", "PLANNER_METRICS"]

#: strategies a CollectiveConfig may request ('auto' resolves per payload)
STRATEGIES = ("auto", "flat", "ring", "tree", "hierarchical")

#: payloads at or below this ride the tree under 'auto' (spec constant)
TREE_CUTOFF_BYTES = 256 << 10

PLANNER_METRICS = frozenset({"collective_plans_total"})


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The link structure plans route by (hashable: a cache-key part).
    ``source='injected'`` specs are explicit overrides and trusted;
    ``'discovered'`` ones only when real link coordinates were seen."""
    n_hosts: int = 1
    devices_per_host: int = 1
    coords_known: bool = False
    source: str = "injected"

    def __post_init__(self):
        if self.n_hosts < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"TopologySpec needs n_hosts >= 1 and devices_per_host "
                f">= 1, got {self.n_hosts}x{self.devices_per_host}")
        if self.source not in ("injected", "discovered"):
            raise ValueError(f"source={self.source!r}")

    @property
    def world(self) -> int:
        return self.n_hosts * self.devices_per_host

    @property
    def multi_host(self) -> bool:
        return self.n_hosts > 1

    @property
    def trusted(self) -> bool:
        return self.source == "injected" or self.coords_known


def discover_spec() -> TopologySpec:
    """An untrusted ``discovered`` spec from the process group: world
    size and the launcher's ``LOCAL_WORLD_SIZE`` (no collective; no link
    coordinates exist on this stack, so it never routes ``auto``)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
    local = max(1, min(local, world))
    return TopologySpec(n_hosts=max(1, world // local),
                        devices_per_host=local, coords_known=False,
                        source="discovered")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _bucket(nbytes: int) -> int:
    """Next power of two: the plan cache's size bucket."""
    nbytes = max(1, int(nbytes))
    return 1 << (nbytes - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ReductionPlan:
    """One resolved route for one (payload bucket, world, config).
    :meth:`execute` has ``psum`` semantics; :meth:`reduce_flat` is the
    gradient-stream form (padded flat f32 in, ``(total, this rank's
    quantization error)`` out)."""
    strategy: str                 # flat | ring | tree | hierarchical
    reason: str
    world: int
    inner: int                    # intra-host group size (hierarchical)
    payload_bucket: int
    config: Any = None

    @property
    def outer(self) -> int:
        return self.world // max(1, self.inner)

    def wire_codec(self, shape, dtype) -> str:
        """The codec this plan's quantized leg uses: 'none' when the
        config does not compress the payload, and for a ``tree`` route
        under int8 (latency-bound payloads ride the logical dtype)."""
        from .compression import codec_eligible
        cfg = self.config
        if cfg is None or not codec_eligible(shape, dtype, cfg):
            return "none"
        if self.strategy == "tree" and cfg.compression == "int8":
            return "none"
        return cfg.compression

    def pad_unit(self, codec: str) -> int:
        """Flat-stream padding multiple the route needs."""
        if self.strategy == "ring":
            return (self.world * self.config.chunk if codec == "int8"
                    else self.world)
        if self.strategy == "hierarchical":
            return (self.inner * self.config.chunk if codec == "int8"
                    else self.inner)
        if self.strategy == "flat" and codec == "int8":
            return self.world * self.config.chunk
        return 1

    def wire_nbytes(self, x, codec: str, channel_major: bool = False) -> int:
        """Per-rank bytes this route puts on the wire for ``x``;
        hierarchical counts its two intra-host f32 legs plus the 1/inner
        inter-host shard at codec width."""
        from .compression import logical_nbytes, wire_nbytes
        live = self.config if codec != "none" else None
        if self.strategy != "hierarchical":
            return wire_nbytes(x, live, channel_major=channel_major)
        logical = logical_nbytes(x)
        intra = 2 * (self.inner - 1) * logical // self.inner
        inter = wire_nbytes(x, live,
                            channel_major=channel_major) // self.inner
        return intra + inter

    def phases(self, codec: str = "none") -> Tuple[str, ...]:
        """The wire legs of a dispatch under this plan."""
        w = codec if codec != "none" else "f32"
        if self.strategy == "hierarchical":
            return ("intra_reduce_scatter@f32", f"inter_allreduce@{codec}",
                    "intra_all_gather@f32")
        if self.strategy == "ring":
            return (f"ring_reduce_scatter@{w}", f"ring_all_gather@{w}")
        if self.strategy == "tree":
            return (f"tree_exchange@{w}",)
        if codec == "int8":
            return ("reduce_scatter@int8", "all_gather@int8")
        return (f"psum@{w}",)

    # -- execution ----------------------------------------------------------

    def execute(self, x: torch.Tensor, mesh, axis, op: str = "planned_psum",
                record: bool = True, timeout_s: Optional[float] = None):
        """``psum`` semantics under this route; ``flat`` is
        :func:`~.compression.compressed_psum` verbatim."""
        from .compression import (_channel_major_padded,
                                  _channel_major_padded_inv, _pad_to,
                                  compressed_psum)
        if self.strategy == "flat":
            return compressed_psum(x, mesh, axis, self.config, op=op,
                                   record=record, timeout_s=timeout_s)
        codec = self.wire_codec(x.shape, x.dtype)
        if record:
            _record_routed(op, axis, x, self, codec)
        shape, orig_dtype = tuple(x.shape), x.dtype
        if codec == "none":
            # route at the input dtype (ints stay ints)
            flat = x.reshape(-1)
            size = flat.shape[0]
            flat = _pad_to(flat, self.pad_unit(codec))
            total, _ = self.reduce_flat(flat, mesh, axis, codec,
                                        timeout_s=timeout_s)
            return total[:size].reshape(shape)
        cm = codec == "int8"
        if cm:
            flat, per, per_p = _channel_major_padded(
                x.to(torch.float32), self.config.chunk)
        else:
            flat, per, per_p = x.to(torch.float32).reshape(-1), None, None
        size = flat.shape[0]
        flat = _pad_to(flat, self.pad_unit(codec))
        total, _ = self.reduce_flat(flat, mesh, axis, codec,
                                    timeout_s=timeout_s)
        total = total[:size]
        if cm:
            return _channel_major_padded_inv(total, shape, per,
                                             per_p).to(orig_dtype)
        return total.reshape(shape).to(orig_dtype)

    def reduce_flat(self, flat: torch.Tensor, mesh, axis, codec: str,
                    want_err: bool = False,
                    timeout_s: Optional[float] = None):
        """Sum a padded flat stream over ``axis`` along this route →
        ``(total, err)``; ``err`` (with ``want_err``) is this rank's
        share of the wire quantization error, whose sum over ranks is
        the total error."""
        from .collectives import _ring_core, psum
        from .compression import (bf16_decode, bf16_encode, int8_all_gather,
                                  int8_reduce_scatter, int8_roundtrip)
        cfg = self.config
        if self.strategy == "hierarchical":
            return self._hier_reduce_flat(flat, mesh, axis, codec, want_err,
                                          timeout_s)
        zeros = torch.zeros_like(flat) if want_err else None
        if codec == "int8":
            # flat and ring: the chunked int8 reduce-scatter + all-gather
            # IS the ring schedule
            total = int8_all_gather(
                int8_reduce_scatter(flat, mesh, axis, cfg.chunk,
                                    timeout_s=timeout_s),
                mesh, axis, cfg.chunk, timeout_s=timeout_s)
            err = (flat - int8_roundtrip(flat, cfg.chunk) if want_err
                   else None)
            return total, err
        if codec == "bf16":
            enc = bf16_encode(flat)
            if self.strategy == "ring":
                total = bf16_decode(_ring_core(enc, mesh, axis,
                                               timeout_s=timeout_s))
            elif self.strategy == "tree":
                total = bf16_decode(self._tree_core(enc, mesh, axis,
                                                    timeout_s))
            else:
                total = bf16_decode(psum(enc, mesh, axis, record=False,
                                         timeout_s=timeout_s))
            return total, (flat - bf16_decode(enc) if want_err else None)
        if self.strategy == "ring":
            return _ring_core(flat, mesh, axis, timeout_s=timeout_s), zeros
        if self.strategy == "tree":
            return self._tree_core(flat, mesh, axis, timeout_s), zeros
        return psum(flat, mesh, axis, record=False,
                    timeout_s=timeout_s), zeros

    def _tree_core(self, v: torch.Tensor, mesh, axis,
                   timeout_s: Optional[float] = None) -> torch.Tensor:
        """Recursive doubling: log2(world) exchange-and-add rounds with
        partner ``rank XOR 2^k`` (the same sums on every rank, operand
        order aside, so the result is replicated bit for bit)."""
        from .collectives import ppermute
        n = self.world
        k = 1
        while k < n:
            v = v + ppermute(v, mesh, [(i, i ^ k) for i in range(n)], axis,
                             op="tree_exchange", record=False,
                             timeout_s=timeout_s)
            k <<= 1
        return v

    def _groups(self):
        """Intra-host index blocks and the transposed inter-host groups,
        carved by :func:`~.placement.partition_assignment`."""
        from .placement import partition_assignment
        pm = partition_assignment(self.world, self.outer, strategy="block")
        intra = [pm.rank_to_partitions[h] for h in range(self.outer)]
        inter = [[intra[h][i] for h in range(self.outer)]
                 for i in range(self.inner)]
        return intra, inter

    def _hier_reduce_flat(self, flat, mesh, axis, codec: str,
                          want_err: bool, timeout_s=None):
        from .collectives import all_gather, psum, reduce_scatter
        from .compression import (bf16_decode, bf16_encode, int8_decode,
                                  int8_encode, _sum_in_rank_order)
        intra_idx, inter_idx = self._groups()
        intra = mesh.sub(axis, intra_idx)
        inter = mesh.sub(axis, inter_idx)
        shard = reduce_scatter(flat, intra, axis, record=False,
                               timeout_s=timeout_s)
        err_shard = None
        if codec == "int8":
            q, s = int8_encode(shard, self.config.chunk)
            qg = all_gather(q, inter, axis, record=False,
                            timeout_s=timeout_s)
            sg = all_gather(s, inter, axis, record=False,
                            timeout_s=timeout_s)
            total_shard = _sum_in_rank_order(
                qg.to(torch.float32) * sg[..., None]).reshape(-1)
            if want_err:
                err_shard = shard - int8_decode(q, s)
        elif codec == "bf16":
            enc = bf16_encode(shard)
            total_shard = bf16_decode(psum(enc, inter, axis, record=False,
                                           timeout_s=timeout_s))
            if want_err:
                err_shard = shard - bf16_decode(enc)
        else:
            total_shard = psum(shard, inter, axis, record=False,
                               timeout_s=timeout_s)
        out = all_gather(total_shard, intra, axis, tiled=True, record=False,
                         timeout_s=timeout_s)
        if not want_err:
            return out, None
        err = torch.zeros_like(flat)
        if err_shard is not None:
            # this rank owned shard (me % inner) of its host's sum on the
            # quantized leg: keep exactly that error, zero elsewhere
            me = mesh.axis_index(axis)
            n = flat.shape[0] // self.inner
            lo = (me % self.inner) * n
            err[lo:lo + n] = err_shard
        return out, err


def _record_routed(op: str, axis, x, plan: ReductionPlan,
                   codec: str) -> None:
    """Accounting of a routed dispatch: calls and logical bytes, then
    the strategy-labelled wire bytes the route really ships."""
    from .collectives import _record
    from .compression import record_compressed
    _record(op, axis, x)
    cm = codec == "int8"
    record_compressed(op, axis, x, plan.config if codec != "none" else None,
                      channel_major=cm, strategy=plan.strategy, codec=codec,
                      wire=plan.wire_nbytes(x, codec, channel_major=cm))


class CollectivePlanner:
    """Process-wide plan synthesizer with a size-bucketed cache keyed by
    ``(payload bucket, world, config, spec, epoch)``.  Thread-safe."""

    def __init__(self, spec: Optional[TopologySpec] = None):
        self._lock = threading.RLock()
        self._injected = spec
        self._discovered: Optional[TopologySpec] = None
        self._epoch = 0
        self._plans: Dict[Tuple, ReductionPlan] = {}
        self._c_plans = get_registry().counter(
            "collective_plans_total",
            "reduction plans synthesized, by resolved strategy, decision "
            "reason and the cost model that priced the auto decision "
            "(fitted|spec|fallback)", ("strategy", "reason", "model"))
        self._cost_model: Optional[Any] = None

    def spec(self) -> Optional[TopologySpec]:
        """The injected spec, else a discovered (untrusted) snapshot."""
        with self._lock:
            if self._injected is not None:
                return self._injected
            if self._discovered is None:
                self._discovered = discover_spec()
            return self._discovered

    def set_spec(self, spec: Optional[TopologySpec],
                 reason: str = "injected") -> None:
        with self._lock:
            self._injected = spec
            self._invalidate(reason)

    def refresh(self, reason: str, world_size: Optional[int] = None) -> None:
        """The relaunch/resize hook: drop the discovered snapshot and
        every cached plan (an injected spec survives)."""
        with self._lock:
            self._discovered = None
            self._invalidate(reason, world_size=world_size)

    def _invalidate(self, reason: str,
                    world_size: Optional[int] = None) -> None:
        dropped = len(self._plans)
        self._plans.clear()
        self._cost_model = None
        self._epoch += 1
        get_faults().note("plan.refresh", reason=reason,
                          world_size=world_size, dropped_plans=dropped,
                          epoch=self._epoch)
        flight_record("plan_invalidate", reason=reason,
                      world_size=world_size, dropped_plans=dropped,
                      epoch=self._epoch)

    def cache_size(self) -> int:
        with self._lock:
            return len(self._plans)

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def plan(self, payload_bytes: int, world: int, config,
             axis: str = "data", op: Optional[str] = None) -> ReductionPlan:
        """Resolve (and cache) the route for one payload class."""
        world = int(world)
        bucket = _bucket(payload_bytes)
        with self._lock:
            spec = None
            if config is not None and getattr(config, "strategy",
                                              "flat") != "flat":
                spec = self.spec()
            key = (bucket, world, config, spec, self._epoch)
            plan = self._plans.get(key)
            if plan is not None:
                return plan
            if self._cost_model is None:
                self._cost_model = _resolve_cost_model()
            strategy, reason, inner, model = _decide(
                payload_bytes, world, spec, config,
                cost_model=self._cost_model)
            plan = ReductionPlan(strategy=strategy, reason=reason,
                                 world=world, inner=inner,
                                 payload_bucket=bucket, config=config)
            self._plans[key] = plan
            self._c_plans.inc(1, strategy=strategy, reason=reason,
                              model=model)
        flight_record("plan_decide", strategy=strategy, reason=reason,
                      world=world, inner=inner, payload_bucket=bucket, op=op,
                      model=model,
                      codec=(config.compression if config is not None
                             else "none"))
        return plan

    def resolved_routing(self, config, world: Optional[int] = None) -> str:
        """'flat' when every plan under ``config`` is the flat dispatch,
        else the config's strategy (the checkpoint stamp's rule)."""
        if config is None:
            return "flat"
        s = getattr(config, "strategy", "flat")
        if s == "flat" or (world is not None and int(world) <= 1):
            return "flat"
        if s in ("auto", "hierarchical"):
            spec = self.spec()
            if spec is None or not spec.trusted:
                return "flat"
            if s == "hierarchical":
                inner = spec.devices_per_host
                w = int(world) if world is not None else spec.world
                if not (spec.multi_host and 1 <= inner < w
                        and w % inner == 0):
                    return "flat"
        if s == "tree" and world is not None and not _is_pow2(int(world)):
            return "flat"
        return s


def _resolve_cost_model():
    """A fitted α-β model from the tuning table for this device, else
    the spec-constant model whose cutoff is ``TREE_CUTOFF_BYTES``."""
    from ..telemetry.autotune import (COST_MODEL_GEOMETRY, COST_MODEL_SPACE,
                                      CollectiveCostModel)
    from ..telemetry.tunetable import get_tuneplane

    def _gate(w):
        a, b = w.get("alpha_s"), w.get("beta_s_per_byte")

        def num(v):
            return (isinstance(v, (int, float)) and not isinstance(v, bool)
                    and math.isfinite(v))

        return num(a) and num(b) and a >= 0.0 and b > 0.0

    won = get_tuneplane().consult("CollectivePlanner", COST_MODEL_SPACE,
                                  COST_MODEL_GEOMETRY, validate=_gate)
    if won is not None:
        return CollectiveCostModel(alpha_s=float(won["alpha_s"]),
                                   beta_s_per_byte=float(
                                       won["beta_s_per_byte"]),
                                   source="fitted")
    return CollectiveCostModel.spec(TREE_CUTOFF_BYTES)


def _decide(payload_bytes: int, world: int, spec: Optional[TopologySpec],
            config, cost_model=None):
    """The decision table → ``(strategy, reason, inner, model)`` (the
    reference's rules, its one numeric threshold priced by
    ``cost_model.tree_cutoff_bytes``)."""
    requested = (getattr(config, "strategy", "flat") if config is not None
                 else "flat")
    if requested == "flat":
        return "flat", "forced", world, "fallback"
    if world <= 1:
        return "flat", "single_rank", world, "fallback"
    known = spec is not None and spec.trusted
    inner = spec.devices_per_host if known else world
    hier_ok = (known and spec.multi_host and 1 <= inner < world
               and world % inner == 0)
    if requested == "ring":
        return "ring", "forced", world, "fallback"
    if requested == "tree":
        if _is_pow2(world):
            return "tree", "forced", world, "fallback"
        return "flat", "non_pow2_world", world, "fallback"
    if requested == "hierarchical":
        if hier_ok:
            return "hierarchical", "forced", inner, "fallback"
        return "flat", ("no_topology" if not known
                        else "indivisible_world"), world, "fallback"
    if requested != "auto":
        raise ValueError(f"strategy={requested!r}: must be one of "
                         f"{STRATEGIES}")
    if not known:
        return "flat", "unknown_topology", world, "fallback"
    cutoff, mlabel = TREE_CUTOFF_BYTES, "spec"
    if cost_model is not None:
        cutoff = cost_model.tree_cutoff_bytes(world)
        mlabel = cost_model.source
    if payload_bytes <= cutoff:
        if _is_pow2(world):
            return "tree", "latency_bound", world, mlabel
        return "flat", "non_pow2_world", world, mlabel
    compresses_here = (config is not None and config.compresses
                       and payload_bytes >= config.min_size * 4)
    if hier_ok and compresses_here:
        return "hierarchical", "multi_host_codec", inner, mlabel
    if hier_ok:
        return "hierarchical", "multi_host", inner, mlabel
    return "ring", "bandwidth_bound", world, mlabel


_default_planner: Optional[CollectivePlanner] = None
_planner_lock = threading.Lock()


def get_planner() -> CollectivePlanner:
    """The process-wide planner every dispatch plans through."""
    global _default_planner
    with _planner_lock:
        if _default_planner is None:
            _default_planner = CollectivePlanner()
        return _default_planner


def set_planner(planner: CollectivePlanner) -> CollectivePlanner:
    """Swap the process planner (tests) → the previous one."""
    global _default_planner
    with _planner_lock:
        prev = _default_planner
        _default_planner = planner
        return prev


def planned_psum(x: torch.Tensor, mesh, axis: Optional[str], config,
                 op: str = "compressed_psum", record: bool = True,
                 timeout_s: Optional[float] = None) -> torch.Tensor:
    """The planner-routed ``psum``: ``config=None`` and strategy-flat
    configs take :func:`~.compression.compressed_psum` directly; others
    resolve a :class:`ReductionPlan` for this payload and execute it."""
    from .compression import compressed_psum
    if axis is None or mesh is None:
        return x
    if config is None or getattr(config, "strategy", "flat") == "flat":
        return compressed_psum(x, mesh, axis, config, op=op, record=record,
                               timeout_s=timeout_s)
    nbytes = int(np.prod(tuple(x.shape))) * x.element_size()
    plan = get_planner().plan(nbytes, mesh.axis_size(axis), config,
                              axis=str(axis), op=op)
    return plan.execute(x, mesh, axis, op=op, record=record,
                        timeout_s=timeout_s)
