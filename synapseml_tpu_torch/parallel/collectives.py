"""Collectives over a :class:`~.mesh.ProcessMesh`.

The PyTorch port of the JAX package's ``parallel/collectives.py``: the
one all-reduce stack that replaces LightGBM's socket ring, VW's
spanning tree and Horovod's NCCL/Gloo.  The JAX package's wrappers run
inside ``shard_map`` and name a mesh axis; here each is a plain function
on this rank's tensor that takes the mesh and the axis name and
dispatches ``torch.distributed`` on that axis's process group:

- ``psum`` → ``all_reduce(SUM)``; ``pmean``, ``pmax``, ``pmin``
- ``all_gather`` (stacked, or ``tiled`` along dim 0),
  ``reduce_scatter`` (tiled), ``all_to_all`` (``all_to_all_single``)
- ``ppermute`` / ``ring_shift`` (``batch_isend_irecv``; differentiable:
  the gradient goes back along the inverse permutation), ``axis_index``,
  ``barrier``
- ``ring_allreduce``: a real ring of 2(n-1) send/recv steps
  (reduce-scatter, then all-gather), the schedule LightGBM's socket ring
  runs; ``hierarchical_psum`` (inner reduce-scatter, outer psum, inner
  all-gather); ``tree_psum_bucketed`` (Horovod's tensor fusion);
  ``allreduce_fn`` (the host-dispatched histogram all-reduce);
  ``reduce_forward`` / ``reduce_backward``, the differentiable pair a
  model sharded over an axis is built from.

Every op runs through :func:`dispatch_watchdog`: the
``collective.dispatch`` fault site, ``collective.begin``/``end`` flight
events, the open step's collective segment (:func:`~synapseml_tpu_torch.
telemetry.gangplane.observe_collective`) and, with a timeout (per call
or the mesh's ``timeout_s``), a :class:`CollectiveTimeout` instead of a
frozen rank.  ``collective_calls_total`` / ``collective_bytes_total``
count executions (the JAX package counts traced programs).

On a gloo group over CUDA tensors the point-to-point ops (``ppermute``,
``ring_shift``, ``ring_allreduce``, the planner's ring and tree routes)
stage through pinned host memory: gloo's ``isend``/``irecv`` fail on
device pointers (measured on an H100 with torch 2.11).  Everything else
runs on the device tensors.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..resilience.faults import get_faults
from ..telemetry import get_registry
from ..telemetry.flight import record as flight_record
from ..telemetry.gangplane import observe_collective
from .mesh import DATA_AXIS


class CollectiveTimeout(RuntimeError):
    """A collective (or the rendezvous) blocked past its deadline.

    Carries the op, the mesh axis, the payload and the deadline.  The
    blocked native call cannot be cancelled: the raising process exits
    and the gang supervisor relaunches the gang."""

    def __init__(self, op: str, axis, timeout_s: float,
                 payload_bytes: Optional[int] = None):
        extra = (f", {payload_bytes} payload bytes"
                 if payload_bytes is not None else "")
        super().__init__(
            f"collective {op!r} over axis {axis!r} still blocked after "
            f"{timeout_s:.3f}s{extra}")
        self.op = op
        self.axis = str(axis)
        self.timeout_s = float(timeout_s)
        self.payload_bytes = payload_bytes


def dispatch_watchdog(fn: Callable, *args, op: str, axis=DATA_AXIS,
                      deadline=None, timeout_s: Optional[float] = None,
                      payload_bytes: Optional[int] = None,
                      device: Optional[torch.device] = None, **kw):
    """Run a blocking dispatch under a host-side watchdog.

    ``deadline`` (a :class:`~synapseml_tpu_torch.resilience.Deadline`)
    and/or ``timeout_s`` bound the wait; with neither the call runs
    inline.  On expiry the caller gets a :class:`CollectiveTimeout` and
    ``collective_timeouts_total{op,axis}`` ticks; the worker thread stays
    parked on the native call (a daemon: it dies with the process).  The
    ``collective.dispatch`` fault site fires inside the watched thread,
    so an armed ``hang`` wedges the dispatch where a lost peer would.
    ``device``: the CUDA device the watched thread works on (the current
    device is per thread)."""
    if deadline is not None:
        timeout_s = deadline.limit(timeout_s)
    if timeout_s is None:
        flight_record("collective.begin", op=op, axis=str(axis),
                      nbytes=payload_bytes)
        get_faults().raise_point("collective.dispatch", op=op,
                                 axis=str(axis))
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        flight_record("collective.end", op=op, axis=str(axis),
                      nbytes=payload_bytes, seconds=round(dt, 6))
        observe_collective(dt, payload_bytes or 0)
        return out
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            get_faults().raise_point("collective.dispatch", op=op,
                                     axis=str(axis))
            box["value"] = fn(*args, **kw)
        except BaseException as e:      # surfaced on the caller's thread
            box["error"] = e
        finally:
            done.set()

    flight_record("collective.begin", op=op, axis=str(axis),
                  nbytes=payload_bytes, timeout_s=float(timeout_s))
    t0 = time.perf_counter()
    t = threading.Thread(target=_run, daemon=True, name=f"collective-{op}")
    t.start()
    if not done.wait(timeout=max(0.0, float(timeout_s))):
        get_registry().counter(
            "collective_timeouts_total",
            "collectives that blocked past their deadline",
            ("op", "axis")).inc(1, op=op, axis=str(axis))
        flight_record("collective.timeout", op=op, axis=str(axis),
                      nbytes=payload_bytes, timeout_s=float(timeout_s))
        raise CollectiveTimeout(op, axis, float(timeout_s),
                                payload_bytes=payload_bytes)
    dt = time.perf_counter() - t0
    if "error" in box:
        raise box["error"]
    flight_record("collective.end", op=op, axis=str(axis),
                  nbytes=payload_bytes, seconds=round(dt, 6))
    observe_collective(dt, payload_bytes or 0)
    return box["value"]


def _record(op: str, axis, x, config=None, channel_major: bool = False,
            strategy: str = "flat") -> None:
    """Per-collective accounting (EQuARX, arXiv:2506.17615): calls and
    LOGICAL payload bytes per (op, axis); compressed ops add their wire
    bytes through :func:`~.compression.record_compressed`."""
    from .compression import logical_nbytes, record_compressed
    reg = get_registry()
    labels = dict(op=op, axis=str(axis))
    reg.counter("collective_calls_total",
                "collective ops dispatched, by op and mesh axis",
                ("op", "axis")).inc(1, **labels)
    reg.counter("collective_bytes_total",
                "per-rank LOGICAL payload bytes handed to collectives, by "
                "op and mesh axis", ("op", "axis")).inc(
                    logical_nbytes(x), **labels)
    if config is not None and config.compresses:
        record_compressed(op, axis, x, config, channel_major=channel_major,
                          strategy=strategy)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _run(mesh, op: str, axis, fn, x, timeout_s=None):
    """Dispatch ``fn()`` for a collective on ``mesh``'s ``axis``."""
    if timeout_s is None:
        timeout_s = mesh.timeout_s
    return dispatch_watchdog(fn, op=op, axis=axis, timeout_s=timeout_s,
                             payload_bytes=_nbytes(x), device=mesh.device)


def _stage(mesh, op: str, axis, x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``x`` (point-to-point on gloo over CUDA)."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    _count_staged(mesh, op, axis, _nbytes(x))
    return host


def _count_staged(mesh, op: str, axis, nbytes: int) -> None:
    mesh.staged_bytes += nbytes
    get_registry().counter(
        "collective_staged_bytes_total",
        "bytes copied between the card and pinned host memory for "
        "collectives gloo cannot run on CUDA tensors", ("op", "axis")).inc(
            nbytes, op=op, axis=str(axis))


def _unstage(mesh, op: str, axis, host: torch.Tensor,
             like: torch.Tensor) -> torch.Tensor:
    _count_staged(mesh, op, axis, _nbytes(host))
    return host.to(like.device)


def psum(x: torch.Tensor, mesh, axis: str = DATA_AXIS, *,
         op: str = "psum", record: bool = True,
         timeout_s: Optional[float] = None, reduce_op=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, on every rank (a new
    tensor; ``x`` is unchanged)."""
    import torch.distributed as dist
    if record:
        _record(op, axis, x)
    out = x.contiguous().clone()
    g = mesh.group(axis)
    _run(mesh, op, axis,
         lambda: dist.all_reduce(out, op=reduce_op or dist.ReduceOp.SUM,
                                 group=g), x, timeout_s)
    return out


def pmean(x, mesh, axis: str = DATA_AXIS, **kw):
    n = torch.tensor(float(mesh.axis_size(axis)), dtype=x.dtype,
                     device=x.device)
    return psum(x, mesh, axis, op="pmean", **kw) / n


def pmax(x, mesh, axis: str = DATA_AXIS, **kw):
    import torch.distributed as dist
    return psum(x, mesh, axis, op="pmax", reduce_op=dist.ReduceOp.MAX, **kw)


def pmin(x, mesh, axis: str = DATA_AXIS, **kw):
    import torch.distributed as dist
    return psum(x, mesh, axis, op="pmin", reduce_op=dist.ReduceOp.MIN, **kw)


def all_gather(x: torch.Tensor, mesh, axis: str = DATA_AXIS, *,
               tiled: bool = False, op: str = "all_gather",
               record: bool = True,
               timeout_s: Optional[float] = None) -> torch.Tensor:
    """Every rank's ``x`` in axis order: stacked ``(n, *x.shape)``, or
    with ``tiled`` concatenated along dim 0."""
    import torch.distributed as dist
    if record:
        _record(op, axis, x)
    xc = x.contiguous()
    outs = [torch.empty_like(xc) for _ in range(mesh.axis_size(axis))]
    g = mesh.group(axis)
    _run(mesh, op, axis, lambda: dist.all_gather(outs, xc, group=g), x,
         timeout_s)
    return torch.cat(outs) if tiled else torch.stack(outs)


def reduce_scatter(x: torch.Tensor, mesh, axis: str = DATA_AXIS, *,
                   scatter_dimension: int = 0, op: str = "reduce_scatter",
                   record: bool = True,
                   timeout_s: Optional[float] = None) -> torch.Tensor:
    """This rank's block (axis index ``i`` gets block ``i``) of the sum
    over ranks, ``x`` split evenly along ``scatter_dimension`` (tiled)."""
    import torch.distributed as dist
    if record:
        _record(op, axis, x)
    n = mesh.axis_size(axis)
    if x.shape[scatter_dimension] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dimension} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    parts = [p.contiguous() for p in x.chunk(n, dim=scatter_dimension)]
    out = torch.empty_like(parts[0])
    g = mesh.group(axis)
    _run(mesh, op, axis, lambda: dist.reduce_scatter(out, parts, group=g),
         x, timeout_s)
    return out


def all_to_all(x: torch.Tensor, mesh, axis: str = DATA_AXIS, *,
               op: str = "all_to_all", record: bool = True,
               timeout_s: Optional[float] = None) -> torch.Tensor:
    """``x`` (n, ...): block ``j`` goes to axis index ``j``; → (n, ...)
    whose block ``j`` came from axis index ``j`` (``lax.all_to_all``
    with split and concat axis 0, untiled)."""
    import torch.distributed as dist
    if record:
        _record(op, axis, x)
    if x.shape[0] != mesh.axis_size(axis):
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} != axis "
                         f"size {mesh.axis_size(axis)}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    g = mesh.group(axis)
    _run(mesh, op, axis, lambda: dist.all_to_all_single(out, xc, group=g),
         x, timeout_s)
    return out


def _exchange(x: torch.Tensor, mesh, axis: str, send_to: Optional[int],
              recv_from: Optional[int], op: str) -> torch.Tensor:
    """One point-to-point step on ``axis``: send ``x`` to axis index
    ``send_to`` and receive a tensor like it from ``recv_from`` (either
    may be None) → the received tensor (zeros when none)."""
    import torch.distributed as dist
    ranks = mesh.axis_ranks(axis)
    g = mesh.group(axis)
    staged = mesh.stages_p2p
    src = _stage(mesh, op, axis, x) if staged else x.contiguous()
    buf = torch.zeros_like(src)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, src, ranks[send_to], g))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, buf, ranks[recv_from], g))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if staged:
        return _unstage(mesh, op, axis, buf, x)
    return buf


def _ppermute(x: torch.Tensor, mesh, perm: Sequence[tuple], axis: str,
              op: str, record: bool,
              timeout_s: Optional[float]) -> torch.Tensor:
    """The exchange of :func:`ppermute`, outside autograd."""
    if record:
        _record(op, axis, x)
    me = mesh.axis_index(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if dst and src and dst[0] == me and src[0] == me:
        return x.clone()
    send_to, recv_from = (dst[0] if dst else None), (src[0] if src else
                                                     None)
    return _run(mesh, op, axis,
                lambda: _exchange(x, mesh, axis, send_to, recv_from, op), x,
                timeout_s)


class _PPermute(torch.autograd.Function):
    """:func:`ppermute` whose backward sends the cotangent along the
    inverse permutation (the transpose of ``lax.ppermute``): what a rank
    received, its gradient goes back to the sender, and a rank that sent
    nothing gets a zero gradient."""

    @staticmethod
    def forward(ctx, x, mesh, perm, axis, op, record, timeout_s):
        ctx.mesh, ctx.axis, ctx.op = mesh, axis, op
        ctx.inverse = [(d, s) for s, d in perm]
        ctx.record, ctx.timeout_s = record, timeout_s
        return _ppermute(x, mesh, perm, axis, op, record, timeout_s)

    @staticmethod
    def backward(ctx, g):
        back = _ppermute(g.contiguous(), ctx.mesh, ctx.inverse, ctx.axis,
                         ctx.op + "_grad", ctx.record, ctx.timeout_s)
        return back, None, None, None, None, None, None


def ppermute(x: torch.Tensor, mesh, perm: Sequence[tuple],
             axis: str = DATA_AXIS, *, op: str = "ppermute",
             record: bool = True,
             timeout_s: Optional[float] = None) -> torch.Tensor:
    """Send ``x`` along ``perm`` ((source, destination) axis indices):
    → what this rank receives, zeros if no pair names it (the
    ``lax.ppermute`` contract).  Differentiable: the gradient goes back
    along the inverse permutation (``op`` + ``"_grad"`` in the counters),
    so every rank of the axis must run the backward too, in the same
    order as the forward's sends.  On gloo over CUDA tensors both
    directions stage through pinned host memory and count their
    bytes."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, mesh, list(perm), axis, op, record,
                               timeout_s)
    return _ppermute(x, mesh, perm, axis, op, record, timeout_s)


def ring_shift(x: torch.Tensor, mesh, axis: str = DATA_AXIS, *,
               reverse: bool = False, op: str = "ring_shift",
               **kw) -> torch.Tensor:
    """Send to the next rank on the ring (the previous with
    ``reverse``); differentiable as :func:`ppermute` (its gradient shifts
    the other way)."""
    n = mesh.axis_size(axis)
    step = -1 if reverse else 1
    return ppermute(x, mesh, [(i, (i + step) % n) for i in range(n)], axis,
                    op=op, **kw)


def axis_index(mesh, axis: str = DATA_AXIS) -> int:
    return mesh.axis_index(axis)


def barrier(x, mesh, axis: str = DATA_AXIS):
    """Gang sync (``BarrierTaskContext.barrier()``): a psum of ones over
    ``axis`` that must count every rank; returns ``x``."""
    token = psum(torch.ones((), dtype=torch.int32, device=mesh.device),
                 mesh, axis, op="barrier")
    if int(token) != mesh.axis_size(axis):
        raise RuntimeError(f"barrier over {axis!r} counted {int(token)} of "
                           f"{mesh.axis_size(axis)} ranks")
    return x


def ring_allreduce(x: torch.Tensor, mesh, axis: str = DATA_AXIS,
                   **kw) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce: n-1 reduce-scatter steps then
    n-1 all-gather steps, each sending 1/n of the payload to the next
    rank (the algorithm of LightGBM's socket ring).  ``x``'s leading dim
    must divide by the axis size; → the SUM over ranks on every rank
    (== :func:`psum`)."""
    _record("ring_allreduce", axis, x)
    return _ring_core(x, mesh, axis, op="ring_allreduce", **kw)


def _ring_core(x: torch.Tensor, mesh, axis: str, op: str = "ring",
               timeout_s: Optional[float] = None) -> torch.Tensor:
    """The unrecorded ring schedule, shared with the planner's ``ring``
    route.  After the reduce-scatter, axis index r owns the sum of part
    (r+1) mod n; the all-gather circulates the finished parts."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x.clone()
    if x.shape[0] % n:
        raise ValueError(f"ring_allreduce: leading dim {x.shape[0]} does "
                         f"not split over {n} ranks")
    me = mesh.axis_index(axis)
    nxt, prv = (me + 1) % n, (me - 1) % n
    acc = list(x.chunk(n, dim=0))
    acc = [a.clone() for a in acc]

    def step(t):
        return _run(mesh, op, axis,
                    lambda: _exchange(t, mesh, axis, nxt, prv, op), t,
                    timeout_s)

    for s in range(n - 1):
        received = step(acc[(me - s) % n])
        i = (me - s - 1) % n
        acc[i] = acc[i] + received
    own = (me + 1) % n
    moving = acc[own]
    for s in range(n - 1):
        moving = step(moving)
        acc[(own - s - 1) % n] = moving
    return torch.cat(acc, dim=0)


def hierarchical_psum(x: torch.Tensor, mesh, inner_axis: str,
                      outer_axis: str) -> torch.Tensor:
    """Two-level all-reduce: reduce-scatter over ``inner_axis``, psum the
    1/n shard over ``outer_axis``, all-gather back over ``inner_axis``;
    the outer traffic shrinks by the inner size against a flat psum.
    Leading dim must divide by the inner axis size."""
    _record("hierarchical_psum", f"{inner_axis}+{outer_axis}", x)
    shard = reduce_scatter(x, mesh, inner_axis, record=False)
    shard = psum(shard, mesh, outer_axis, record=False)
    return all_gather(shard, mesh, inner_axis, tiled=True, record=False)


class _ReduceForward(torch.autograd.Function):
    """Sum over ``axis`` in the forward; the backward passes the
    (replicated) cotangent through unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axis, op):
        return psum(x, mesh, axis, op=op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _ReduceBackward(torch.autograd.Function):
    """The identity in the forward; the backward sums the cotangent over
    ``axis``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, op):
        ctx.mesh, ctx.axis, ctx.op = mesh, axis, op
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis, op=ctx.op), None, None, None


def reduce_forward(x: torch.Tensor, mesh, axis: str = DATA_AXIS,
                   op: str = "reduce_forward") -> torch.Tensor:
    """Differentiable sum over ``axis`` whose result every rank then uses
    alike: the gradient of a replicated consumer reaches each rank's
    ``x`` unchanged (Megatron-LM's "g").  Pairs with
    :func:`reduce_backward`: partial sums meet here, and an input that
    feeds partial computations passes through there."""
    return _ReduceForward.apply(x, mesh, axis, op)


def reduce_backward(x: torch.Tensor, mesh, axis: str = DATA_AXIS,
                    op: str = "reduce_backward") -> torch.Tensor:
    """``x`` unchanged, its gradient summed over ``axis``: the input of a
    computation each rank does only part of (Megatron-LM's "f")."""
    return _ReduceBackward.apply(x, mesh, axis, op)


def tree_psum_bucketed(tree, mesh, axis: str = DATA_AXIS,
                       bucket_bytes: int = 4 << 20):
    """psum a tree of tensors in size-bucketed fusion groups: leaves pack
    into ~``bucket_bytes`` flat buffers of one dtype (Horovod's tensor
    fusion), so small tensors share one collective at their own
    precision."""
    _record("tree_psum_bucketed", axis, tree)
    leaves, spec = pytree.tree_flatten(tree)
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes, cur_dtype = 0, None
    for i, leaf in enumerate(leaves):
        nbytes = _nbytes(leaf)
        if cur and (cur_bytes + nbytes > bucket_bytes
                    or leaf.dtype != cur_dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = leaf.dtype
    if cur:
        buckets.append(cur)
    out = list(leaves)
    for bucket in buckets:
        if len(bucket) == 1:
            i = bucket[0]
            out[i] = psum(leaves[i], mesh, axis, record=False)
            continue
        flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
        summed = psum(flat, mesh, axis, record=False)
        offset = 0
        for i in bucket:
            size = leaves[i].numel()
            out[i] = summed[offset:offset + size].reshape(leaves[i].shape)
            offset += size
    return pytree.tree_unflatten(out, spec)


def allreduce_fn(mesh, axis: str = DATA_AXIS, config=None) -> Callable:
    """The host-dispatched histogram all-reduce: the returned callable
    takes this rank's values stacked on dim 0, ``(S, *H)``, and returns
    the sum over the stack and over the ranks, ``(*H)`` (the LightGBM
    histogram-allreduce replacement).  ``config`` (a
    :class:`~.compression.CollectiveConfig`) routes the reduce through
    the planner and its codec.  Each call lands one sample in
    ``collective_latency_seconds{op,axis}``; ``deadline=`` /
    ``timeout_s=`` bound it (:class:`CollectiveTimeout`)."""
    from .planner import planned_psum
    latency = get_registry().histogram(
        "collective_latency_seconds",
        "host-observed latency of host-dispatched collectives",
        ("op", "axis"))

    def call(x: torch.Tensor, *, deadline=None, timeout_s=None):
        t0 = time.perf_counter()
        if deadline is not None:
            timeout_s = deadline.limit(timeout_s)
        out = planned_psum(x.sum(0), mesh, axis, config, op="allreduce_fn",
                           timeout_s=timeout_s)
        latency.observe(time.perf_counter() - t0, op="allreduce_fn",
                        axis=str(axis))
        return out

    return call
