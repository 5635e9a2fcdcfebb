"""The process mesh: named axes over the ranks of a process group.

The PyTorch port of the JAX package's ``parallel/mesh.py``.  A JAX
``Mesh`` lays local devices out on named axes, and collectives name an
axis inside ``shard_map``.  Here one process is one rank and owns one
device, so the mesh is a :class:`ProcessMesh`: the world size, this
rank, and named axis sizes whose product is the world.  Ranks lie on the
axes in row-major order (the reference's ``np.array(devs).reshape``):
the last axis varies fastest.  Each axis that is not the whole world is
a set of ``dist.new_group`` sub-groups, one per slice; collectives take
the mesh and an axis name where the JAX code takes an axis name.

Axis conventions (the reference's):

- ``data``   — batch/row sharding (DP); every trainer uses it
- ``model``  — tensor-parallel weight sharding (TP)
- ``seq``    — sequence/context parallelism
- ``expert`` — expert parallelism (MoE)
- ``pipe``   — pipeline stages

The rows a rank holds are the JAX package's ``batch_sharding`` blocks:
rows pad with zeros to a multiple of the axis size, and axis index ``i``
holds the contiguous block ``[i*per, (i+1)*per)`` (:func:`shard_batch`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _resolve_sizes(axis_sizes: Optional[Dict[str, int]],
                   world: int) -> Dict[str, int]:
    """Named axis sizes with at most one ``-1`` ("the rest of the
    ranks"); their product must be the world size (every rank of the
    group is on the mesh)."""
    if not axis_sizes:
        return {DATA_AXIS: world}
    names, sizes = list(axis_sizes), list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        fixed = math.prod(s for s in sizes if s != -1)
        if world % fixed:
            raise ValueError(f"{world} ranks not divisible by fixed axes "
                             f"{fixed}")
        sizes[sizes.index(-1)] = world // fixed
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, the group has {world}")
    return dict(zip(names, (int(s) for s in sizes)))


class ProcessMesh:
    """Named axes over the initialized default process group.

    Construct it on every rank, in the same order as any other group
    creation (``dist.new_group`` is collective).  ``device`` is this
    rank's device (default ``"cuda"``: the device
    :func:`~.distributed.initialize_cluster` bound, ``cuda:LOCAL_RANK``
    under NCCL).  The backend is the group's own; nothing is switched:

    - ``nccl``: every collective runs on this rank's card.
    - ``gloo`` on ``device="cpu"``: CPU tensors, the tests' layout.
    - ``gloo`` on a CUDA device (several ranks sharing one card, only
      when the caller chose ``backend="gloo"``): all-reduce, broadcast,
      all-gather, reduce-scatter and ``all_to_all_single`` run on the
      CUDA tensors (gloo copies through the host itself), while the
      point-to-point sends that gloo refuses on CUDA tensors
      (``isend``/``irecv``: ``ppermute``, ``ring_shift``,
      ``ring_allreduce``, the planner's ring and tree routes) STAGE
      through pinned host memory (:attr:`stages_p2p`); the bytes copied
      each way count in :attr:`staged_bytes` and in
      ``collective_staged_bytes_total{op,axis}``.

    ``timeout_s`` (optional) bounds every collective dispatched on this
    mesh with :func:`~.collectives.dispatch_watchdog`.
    """

    def __init__(self, axis_sizes: Optional[Dict[str, int]] = None, *,
                 device="cuda", timeout_s: Optional[float] = None):
        import torch.distributed as dist
        from ..device import resolve_device
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ProcessMesh needs an initialized process group "
                "(parallel.distributed.initialize_cluster)")
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        if device == "cuda":
            from .distributed import cluster_device
            bound = cluster_device()
            device = bound if bound is not None else device
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("a nccl group moves CUDA tensors; pass a CUDA "
                             "device or initialize a gloo group")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {self.backend!r}: the port runs "
                             "'gloo' or 'nccl'")
        self.shape = _resolve_sizes(axis_sizes, self.world_size)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.timeout_s = timeout_s
        self.staged_bytes = 0
        sizes = tuple(self.shape.values())
        grid = np.arange(self.world_size).reshape(sizes)
        self._coords = tuple(int(c) for c in
                             np.unravel_index(self.rank, sizes))
        self._ranks: Dict[str, List[int]] = {}
        self._groups: Dict[str, object] = {}
        #: every slice of each axis (global ranks in axis order)
        self._slices: Dict[str, List[List[int]]] = {}
        self._subs: Dict[tuple, "_SubMesh"] = {}
        for ax_i, name in enumerate(self.axis_names):
            moved = np.moveaxis(grid, ax_i, -1).reshape(-1, sizes[ax_i])
            self._slices[name] = moved.tolist()
            if sizes[ax_i] == self.world_size:
                # the whole world: the default group (its rank order is
                # the axis order, since the other axes have size 1)
                self._ranks[name] = list(range(self.world_size))
                self._groups[name] = None
                continue
            for slice_ranks in moved.tolist():
                # every rank creates every group, in one order
                g = dist.new_group(slice_ranks)
                if self.rank in slice_ranks:
                    self._ranks[name] = slice_ranks
                    self._groups[name] = g

    @property
    def stages_p2p(self) -> bool:
        """True where point-to-point sends copy through pinned host
        memory: a gloo group moving CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def axis_size(self, axis: str = DATA_AXIS) -> int:
        return int(self.shape[axis])

    def axis_index(self, axis: str = DATA_AXIS) -> int:
        return self._coords[self.axis_names.index(axis)]

    def axis_ranks(self, axis: str = DATA_AXIS) -> List[int]:
        """Global ranks of this rank's group on ``axis``, in axis order."""
        return list(self._ranks[axis])

    def group(self, axis: str = DATA_AXIS):
        """The process group of ``axis`` (``None``: the default group)."""
        if axis not in self.shape:
            raise ValueError(f"axis {axis!r} is not on this mesh "
                             f"{self.shape}")
        return self._groups[axis]

    def sub(self, axis: str, index_groups: List[List[int]]) -> "_SubMesh":
        """A one-axis view of ``axis`` restricted to the index group that
        holds this rank (``index_groups``: lists of axis indices, the
        same on every slice; ``lax``'s ``axis_index_groups``).  The
        groups of every slice are created on first use, on every rank in
        one order, so call it collectively."""
        key = (axis, tuple(tuple(g) for g in index_groups))
        if key not in self._subs:
            import torch.distributed as dist
            me = self.axis_index(axis)
            mine = None
            for slice_ranks in self._slices[axis]:
                for idx in index_groups:
                    ranks = [slice_ranks[i] for i in idx]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = (g, ranks, list(idx).index(me))
            self._subs[key] = _SubMesh(self, axis, *mine)
        return self._subs[key]

    def __deepcopy__(self, memo) -> "ProcessMesh":
        # the mesh names the process group's ranks and sub-groups: a deep
        # copy of a model or a train state that holds it shares it
        return self

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")


class _SubMesh:
    """One axis of a :class:`ProcessMesh` restricted to a sub-group: the
    mesh interface the collectives read (the planner's hierarchical
    legs run on these)."""

    def __init__(self, parent: ProcessMesh, axis: str, group, ranks, index):
        self.parent, self.axis = parent, axis
        self._group, self._ranks, self._index = group, list(ranks), index
        self.device, self.timeout_s = parent.device, parent.timeout_s

    @property
    def stages_p2p(self) -> bool:
        return self.parent.stages_p2p

    @property
    def staged_bytes(self) -> int:
        return self.parent.staged_bytes

    @staged_bytes.setter
    def staged_bytes(self, v: int) -> None:
        self.parent.staged_bytes = v

    def __deepcopy__(self, memo) -> "_SubMesh":
        return self

    def _check(self, axis):
        if axis != self.axis:
            raise ValueError(f"sub-mesh of axis {self.axis!r}, asked {axis!r}")

    def axis_size(self, axis: str = DATA_AXIS) -> int:
        self._check(axis)
        return len(self._ranks)

    def axis_index(self, axis: str = DATA_AXIS) -> int:
        self._check(axis)
        return self._index

    def axis_ranks(self, axis: str = DATA_AXIS) -> List[int]:
        self._check(axis)
        return list(self._ranks)

    def group(self, axis: str = DATA_AXIS):
        self._check(axis)
        return self._group


def data_parallel_mesh(device="cuda",
                       timeout_s: Optional[float] = None) -> ProcessMesh:
    """Every rank of the group on the ``data`` axis."""
    return ProcessMesh(None, device=device, timeout_s=timeout_s)


def dp_ep_mesh(ep: int, device="cuda",
               timeout_s: Optional[float] = None) -> ProcessMesh:
    """The ``(data, expert)`` mesh of an expert-parallel MoE fit:
    ``{data: world / ep, expert: ep}``, expert innermost (the JAX
    package's ``dp_ep_mesh``).  The ranks of one ``data`` slice hold the
    same rows and different experts."""
    if ep < 1:
        raise ValueError(f"expert parallelism {ep} must be >= 1")
    return ProcessMesh({DATA_AXIS: -1, EXPERT_AXIS: int(ep)}, device=device,
                       timeout_s=timeout_s)


def dp_tp_mesh(tp: int, device="cuda",
               timeout_s: Optional[float] = None) -> ProcessMesh:
    """The ``(data, model)`` mesh of a tensor-parallel fit: ``{data:
    world / tp, model: tp}``, model innermost (the JAX package's
    ``dp_tp_mesh``): the ranks of one ``data`` slice hold the same rows
    and different shards of the weights."""
    if tp < 1:
        raise ValueError(f"tensor parallelism {tp} must be >= 1")
    return ProcessMesh({DATA_AXIS: -1, MODEL_AXIS: int(tp)}, device=device,
                       timeout_s=timeout_s)


def dp_sp_tp_mesh(sp: int, tp: int, device="cuda",
                  timeout_s: Optional[float] = None) -> ProcessMesh:
    """The ``(data, seq, model)`` mesh for long-context training: ``{data:
    world / (sp·tp), seq: sp, model: tp}`` (the JAX package's
    ``dp_sp_tp_mesh``)."""
    if sp < 1 or tp < 1:
        raise ValueError(f"seq {sp} and model {tp} sizes must be >= 1")
    return ProcessMesh({DATA_AXIS: -1, SEQ_AXIS: int(sp),
                        MODEL_AXIS: int(tp)}, device=device,
                       timeout_s=timeout_s)


def axis_size(mesh, axis: str = DATA_AXIS) -> int:
    """The size of ``axis`` on ``mesh``: 1 without a mesh or where the
    mesh has no such axis (one rank holds the whole axis)."""
    if mesh is None or axis not in getattr(mesh, "shape", {}):
        return 1
    return mesh.axis_size(axis)


def axis_index(mesh, axis: str = DATA_AXIS) -> int:
    """This rank's index on ``axis``; 0 where :func:`axis_size` is 1."""
    return mesh.axis_index(axis) if axis_size(mesh, axis) > 1 else 0


def block_bounds(n: int, size: int, index: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of the padded ``pad_to_multiple(n, size)`` rows
    that axis index ``index`` holds (rows at ``>= n`` are pad rows)."""
    per = pad_to_multiple(n, size) // size
    return index * per, (index + 1) * per


def shard_batch(mesh: ProcessMesh, x, axis: str = DATA_AXIS):
    """This rank's contiguous block of ``x``'s rows, padded with zero
    rows to a multiple of the axis size, on the mesh's device →
    ``(block, n)`` with ``n`` the unpadded row count (the JAX package's
    ``device_put`` under ``batch_sharding``, one shard)."""
    x = np.asarray(x)
    n = x.shape[0]
    lo, hi = block_bounds(n, mesh.axis_size(axis), mesh.axis_index(axis))
    block = x[lo:min(hi, n)]
    if hi > n:
        pad = hi - max(lo, n)
        block = np.concatenate(
            [block, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return torch.as_tensor(np.ascontiguousarray(block),
                           device=mesh.device), n
