"""The DL training loop on one card: optimizer, train state and steps.

The PyTorch port of the JAX package's ``models/dl/training.py`` for one
device.  The step is eager PyTorch: forward in the model's compute dtype
(explicit casts in the models), softmax cross-entropy on f32 logits,
backward, gradients f32 (cast to bf16 under ``bf16_grad``), then
:class:`OptaxOptimizer`: the global-norm clip and the update as optax
computes them, dtype by dtype (torch's optimizers want gradients of the
parameters' dtype and update by other formulas):

- a schedule is read at the count of updates already made (the first
  update uses lr(0), which is 0 under the warmup-cosine schedule);
- ``clip_by_global_norm`` scales by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm``, with no epsilon;
- adamw is b1 0.9, b2 0.999, eps 1e-8 with decay on every parameter,
  biases and norms included; sgd's momentum is optax's ``trace``.

Step metrics stay on the device; the caller reads them when it needs them
(the estimators once an epoch).

Over a gang of ranks (``mesh=``, a :class:`~synapseml_tpu_torch.parallel.
mesh.ProcessMesh` whose ``data`` axis shards the batch; an ``expert`` axis
shards the MoE experts, :mod:`.moe`; a ``model`` axis shards the weights
in the Megatron layout, :mod:`.transformer`) the step computes what the
reference's GSPMD step computes over the global batch:

- each rank takes its block of each batch's rows
  (:func:`~synapseml_tpu_torch.parallel.mesh.block_bounds`), computes the
  loss and gradients of its rows, and the gradients are mean-reduced over
  ``data`` (one bucketed all-reduce); BatchNorm statistics, MoE capacity,
  slot positions and the Switch loss are the global batch's
  (:mod:`.resnet`, :mod:`.moe`).  The Switch loss is the same value on
  every rank and its gradient reaches each rank's tokens unreduced, so
  the objective a rank differentiates is ``ce_local + D · aux``: after
  the mean over ``data`` that is the gradient of ``ce + aux``;
- the gradients are reduced over ``data`` only: a leaf sharded over
  ``model`` or ``expert`` holds its own block's gradient, and a
  replicated leaf's gradient is the same on every rank of those axes
  (the layers' ``reduce_backward`` / ``reduce_forward`` pairs make it
  so).  The clip's global norm sums each sharded leaf's squares over its
  axes once and counts each replicated leaf once;
- the reported loss and accuracy are the global batch's (one all-reduce
  of two scalars);
- dropout: a D-rank fit draws the 1-rank fit's masks.  Each dropout site
  draws the mask of the whole batch from its ``mix_seed`` generator in
  one call and keeps this rank's rows (``rows=(lo, total)`` down the text
  encoder), so the masks depend on (seed, step, site) alone at any world
  size and a resize stays deterministic; a rank's draw is the one-rank
  fit's (:mod:`.transformer` says why it is not split by rows);
- ``zero1`` (the reference's GSPMD weight-update sharding, over any
  mesh): every float parameter this rank holds (its ``model`` /
  ``expert`` blocks) rides one flat f32 stream padded to a multiple of
  D; a reduce-scatter over ``data`` gives each rank the mean gradient of
  its 1/D slice, the global-norm clip takes its norm from a psum of the
  slices' squares (the sharded leaves' parts also summed over their
  axes), :class:`ShardedOptimizer` updates the slice with optax's
  formulas and an all-gather returns the parameters.  A rank holds 1/D
  of its blocks' moment bytes, the split the reference's
  ``_zero1_shardings`` gives each moment leaf (the model or expert split
  kept, a data split added);
- a :class:`~synapseml_tpu_torch.parallel.compression.CollectiveConfig`
  (``collective=``) runs the reference's manual data-parallel step:
  ``replicated_update`` syncs through ``compressed_tree_sync`` (bf16 or
  int8 on the wire, per-rank error-feedback residuals in
  :attr:`TrainState.residuals`); ``sharded_update`` packs the leaves of
  ``min_size`` or more elements into one flat stream, reduce-scatters it
  in the codec, updates this rank's slice (no optax clip: the step takes
  the true global norm across slices, as the reference), all-gathers the
  parameters, and psums the small leaves (``tree_psum_bucketed``).
  ``bf16_grad`` rounds the gradients through bf16 before the sync; the
  residuals stay f32.  It needs a pure data mesh, and excludes ``zero1``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, resolve_device
from ...parallel.mesh import (DATA_AXIS, EXPERT_AXIS, axis_index, axis_size,
                              block_bounds)
from .precision import PrecisionPolicy, resolve_precision
from .transformer import mix_seed


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule(init, end, steps)``."""
    def lr(count: int) -> float:
        if steps <= 0:
            return init
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end
    return lr


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule(init, steps, alpha)``."""
    def lr(count: int) -> float:
        c = min(count, steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / steps))
        return init * ((1.0 - alpha) * decay + alpha)
    return lr


def warmup_cosine(init: float, peak: float, warmup: int, decay_steps: int,
                  end: float = 0.0) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule``: linear warmup joined to a
    cosine decay over ``decay_steps - warmup`` steps."""
    alpha = 0.0 if peak == 0.0 else end / peak
    up = _linear(init, peak, warmup)
    down = _cosine(peak, decay_steps - warmup, alpha)
    return lambda count: up(count) if count < warmup else down(count - warmup)


@dataclasses.dataclass
class OptimizerConfig:
    """Loss/optimizer-by-name (LitDeepVisionModel.py loss/opt by name)."""
    name: str = "adamw"                   # adamw | adam | sgd
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    momentum: float = 0.9
    schedule: str = "constant"            # constant | cosine | linear
    warmup_steps: int = 0
    total_steps: int = 10_000
    grad_clip_norm: float = 0.0

    def schedule_fn(self) -> Callable[[int], float]:
        """Update count → learning rate, as the reference's optax
        schedule."""
        if self.schedule == "cosine":
            # decay_steps counts warmup + cosine, clamped against the
            # clamped warmup so a 1-step fit still gets a cosine step
            warm = max(self.warmup_steps, 1)
            return warmup_cosine(0.0, self.learning_rate, warm,
                                 max(self.total_steps, warm + 1))
        if self.schedule == "linear":
            return _linear(self.learning_rate, 0.0, max(self.total_steps, 1))
        return lambda count: self.learning_rate

    def build(self, params: Sequence[nn.Parameter]) -> "OptaxOptimizer":
        """The optimizer over ``params``; the trainer passes it the
        learning rate from :meth:`schedule_fn` at every update."""
        if self.name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {self.name!r}")
        return OptaxOptimizer(self, params)


def _bf16_scalar(x: float, dtype) -> float:
    """A Python scalar as JAX sees it beside an array of ``dtype``: a
    weak-typed scalar is rounded to the array's type first."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


class OptaxOptimizer:
    """optax's ``clip_by_global_norm`` chained with ``adamw`` / ``adam`` /
    ``sgd(momentum)``, with optax's per-operation dtype rules.

    Gradients arrive in their own dtype (f32, or bf16 under
    ``bf16_grad``); parameters and moments are f32.  As in optax:

    - the global norm squares and sums each leaf in the gradients' dtype
      (a leaf's sum accumulates in f32 and rounds to that dtype), adds the
      leaf sums one by one in that dtype and takes the square root there;
      the clip is ``(g / norm) * max_norm`` in that dtype, applied only
      when ``norm >= max_norm``;
    - ``(1 - b1) * g`` and ``(1 - b2) * g * g`` are computed in the
      gradients' dtype (the Python factor rounded to it first, as a
      weak-typed scalar is) and promoted to f32 where they meet the f32
      moments; sgd's trace ``g + momentum * trace`` promotes at the add;
    - the bias correction, ``mu_hat / (sqrt(nu_hat) + eps)``, adamw's
      ``+ weight_decay * p`` and ``p + (-lr) * update`` run in f32.
    """

    def __init__(self, cfg: "OptimizerConfig", params: Sequence[nn.Parameter]):
        self.cfg = cfg
        self.params = list(params)
        self.count = 0
        #: optional ``sums → sums`` hook of the clip: each leaf's sum of
        #: squares, completed where a leaf is sharded across ranks
        self.leaf_sums: Optional[Callable] = None
        if cfg.name in ("adamw", "adam"):
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        else:
            self.trace = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _clip(self, grads):
        max_norm = self.cfg.grad_clip_norm
        if max_norm <= 0 or not grads:
            return grads
        dtype = grads[0].dtype
        sums = torch._foreach_norm(torch._foreach_mul(grads, grads), 1)
        if self.leaf_sums is not None:
            sums = self.leaf_sums(list(sums))
        if dtype == torch.float32:
            total = torch.stack(sums).sum()
        else:
            # optax's Python ``sum`` rounds after every leaf
            total = sums[0]
            for s_ in sums[1:]:
                total = total + s_
        norm = torch.sqrt(total)
        limit = torch.full((), _bf16_scalar(max_norm, dtype), dtype=dtype,
                           device=norm.device)
        keep = norm < limit
        # (g / 1) * 1 is g exactly, so one pass serves both branches
        one = torch.ones_like(norm)
        return torch._foreach_mul(
            torch._foreach_div(grads, torch.where(keep, one, norm)),
            torch.where(keep, one, limit))

    def moment_bytes(self) -> int:
        """Bytes of the optimizer's moments on this rank."""
        moments = (self.mu + self.nu if hasattr(self, "mu")
                   else self.trace)
        return sum(m.numel() * m.element_size() for m in moments)

    def moments(self) -> Dict[str, list]:
        return ({"mu": self.mu, "nu": self.nu} if hasattr(self, "mu")
                else {"trace": self.trace})

    @torch.no_grad()
    def step(self, grads, lr: float, params=None) -> None:
        """One update of every parameter from ``grads`` (one per
        parameter, in order) at learning rate ``lr``; ``params`` updates
        other tensors of the same shapes in place (a flat slice)."""
        if params is not None:
            self.params = list(params)
        cfg = self.cfg
        grads = self._clip(grads)
        dtype = grads[0].dtype
        if cfg.name == "sgd":
            torch._foreach_mul_(self.trace, cfg.momentum)
            torch._foreach_add_(self.trace, grads)
            updates = self.trace
        else:
            b1, b2, eps = 0.9, 0.999, 1e-8
            self.count += 1
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, torch._foreach_mul(
                grads, _bf16_scalar(1 - b1, dtype)))
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_add_(self.nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads),
                _bf16_scalar(1 - b2, dtype)))
            c = np.float32(self.count)
            bc1 = float(np.float32(1) - np.float32(b1) ** c)
            bc2 = float(np.float32(1) - np.float32(b2) ** c)
            denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(torch._foreach_div(self.mu, bc1),
                                         denom)
            if cfg.name == "adamw":
                torch._foreach_add_(updates, torch._foreach_mul(
                    self.params, cfg.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(updates, -lr))


class ShardedOptimizer:
    """ZeRO-1's and the sharded update's optimizer: the ``big``
    parameters ride one flat f32 stream padded to ``padded`` values, and
    this rank holds the moments of its slice ``[i·shard, (i+1)·shard)``
    only (``i`` its ``data`` index); the other (``small``) parameters keep
    replicated moments.  With ``clip`` (zero1: every parameter rides the
    stream) the slice's optimizer clips as optax does, by the global norm
    (its leaf sum is the psum of the slices' sums of squares, the pad
    being zero, and the parts of the leaves that ``leaf_axes`` names
    sharded over ``model``/``expert`` are also summed over those axes);
    otherwise neither part clips and the step scales the gradients by the
    global norm first."""

    def __init__(self, cfg: "OptimizerConfig", params: Sequence[nn.Parameter],
                 big: Sequence[int], padded: int, mesh, clip: bool = False,
                 leaf_axes: Optional[Dict[int, Tuple[str, ...]]] = None):
        self.cfg = cfg
        self.params = list(params)
        self.big = list(big)
        self.small = [i for i in range(len(self.params))
                      if i not in set(self.big)]
        self.mesh = mesh
        self.n = axis_size(mesh, DATA_AXIS)
        self.index = axis_index(mesh, DATA_AXIS)
        self.total = sum(self.params[i].numel() for i in self.big)
        self.padded = int(padded)
        self.shard = self.padded // self.n
        dev = self.params[0].device
        plain = dataclasses.replace(cfg, grad_clip_norm=0.0)
        self.flat = OptaxOptimizer(cfg if clip else plain, [torch.zeros(
            self.shard, dtype=torch.float32, device=dev)])
        self._groups = self._slice_groups(leaf_axes or {})
        if clip and (self.n > 1 or self._groups):
            self.flat.leaf_sums = self._sum_over_slices
        self._g_shard = None
        self.rest = OptaxOptimizer(plain, [self.params[i]
                                           for i in self.small])

    def _slice_groups(self, leaf_axes) -> List[Tuple[Tuple[str, ...], list]]:
        """This rank's slice as ranges grouped by the axes their leaves
        are sharded over: ``[(axes, [(lo, hi), ...]), ...]`` (empty when
        no big leaf is sharded)."""
        if not any(leaf_axes.get(i) for i in self.big):
            return []
        lo, hi = self.index * self.shard, (self.index + 1) * self.shard
        groups: Dict[Tuple[str, ...], list] = {}
        offset = 0
        for i in self.big:
            n = self.params[i].numel()
            a, b = max(offset, lo), min(offset + n, hi)
            axes = tuple(leaf_axes.get(i, ()))
            groups.setdefault(axes, [])
            if a < b:
                groups[axes].append((a - lo, b - lo))
            offset += n
        return sorted(groups.items())

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _sum_over_slices(self, sums):
        from ...parallel.collectives import psum
        if not self._groups:
            return [psum(s_.float(), self.mesh, DATA_AXIS, op="grad_norm")
                    .to(s_.dtype) for s_ in sums]
        g = self._g_shard
        parts = torch.stack([
            sum(((g[a:b].float() ** 2).sum() for a, b in ranges),
                torch.zeros((), device=g.device))
            for _, ranges in self._groups])
        if self.n > 1:
            parts = psum(parts, self.mesh, DATA_AXIS, op="grad_norm")
        for axis in sorted({a for axes, _ in self._groups for a in axes}):
            rows = [j for j, (axes, _) in enumerate(self._groups)
                    if axis in axes]
            done = psum(parts[rows], self.mesh, axis, op="grad_norm")
            parts = parts.index_copy(0, torch.tensor(rows,
                                                     device=g.device), done)
        return [parts.sum().to(sums[0].dtype)]

    def moment_bytes(self) -> int:
        return self.flat.moment_bytes() + self.rest.moment_bytes()

    def flat_stream(self, leaves) -> torch.Tensor:
        """The ``big`` leaves of ``leaves`` as one zero-padded f32
        stream of ``padded`` values."""
        flat = torch.cat([leaves[i].detach().float().reshape(-1)
                          for i in self.big]) if self.big else \
            torch.zeros(0, device=self.params[0].device)
        return F.pad(flat, (0, self.padded - flat.shape[0]))

    def my_slice(self, flat: torch.Tensor) -> torch.Tensor:
        lo = self.index * self.shard
        return flat[lo:lo + self.shard]

    @torch.no_grad()
    def step(self, g_shard: torch.Tensor, small_grads, lr: float) -> None:
        """Update this rank's slice from its mean gradient ``g_shard``,
        all-gather the slices into the parameters, and update the small
        parameters from ``small_grads``."""
        from ...parallel.collectives import all_gather
        p_shard = self.my_slice(self.flat_stream(self.params)).clone()
        self._g_shard = g_shard
        self.flat.step([g_shard], lr, params=[p_shard])
        self._g_shard = None
        full = p_shard if self.n == 1 else all_gather(
            p_shard, self.mesh, DATA_AXIS, tiled=True,
            op="param_all_gather")
        offset = 0
        for i in self.big:
            p = self.params[i]
            p.copy_(full[offset:offset + p.numel()].reshape(p.shape))
            offset += p.numel()
        if self.small:
            self.rest.step(list(small_grads), lr)


@dataclasses.dataclass
class TrainState:
    """The step count (updates made, on the host), the model (its
    parameters, and its buffers as the extra state: batch statistics),
    the optimizer (its moments) and, under a compressing collective with
    error feedback, this rank's residuals (one f32 tensor a parameter)."""
    step: int
    model: nn.Module
    opt: "OptaxOptimizer | ShardedOptimizer"
    residuals: Optional[List[torch.Tensor]] = None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """optax ``softmax_cross_entropy_with_integer_labels(...).mean()`` on
    f32 logits."""
    return F.cross_entropy(logits.float(), labels.long())


def make_dl_mesh(tp: int = 1, num_devices: int = 0, ep: int = 1,
                 device: DeviceLike = "cuda", owner: str = "make_dl_mesh"):
    """The DL fit's mesh over the ranks of the initialized process group
    (the reference's ``make_dl_mesh`` / ``dp_ep_mesh``, whose shards are
    local devices): None for a fit on this device alone
    (``num_devices`` 1, or a world of one rank, with ``tp`` and ``ep``
    1), else a ProcessMesh ``{data: world}``, ``{data: world / ep,
    expert: ep}`` with ``ep > 1``, or ``{data: world / tp, model: tp}``
    with ``tp > 1`` (``dp_tp_mesh``; the caller picks one of ``ep`` and
    ``tp``, as the reference's estimator does).  ``num_devices`` 0 means
    every rank; any other value must be the group's size.  Raises
    ``ValueError`` before any work."""
    from ...parallel.mesh import MODEL_AXIS, ProcessMesh
    import torch.distributed as dist
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    nd = int(num_devices)
    tp, ep = int(tp), int(ep)
    if nd < 0 or (nd not in (0, 1) and nd != world):
        raise ValueError(
            f"{owner}: numDevices={nd} must be 0 (every rank), 1 (this "
            f"device) or the process group's size; the group has "
            f"{world} rank(s)")
    if tp < 1 or ep < 1 or (tp > 1 and ep > 1):
        raise ValueError(f"{owner}: modelParallelism={tp} and "
                         f"expertParallelism={ep}: each >= 1, at most one "
                         "> 1")
    ranks = 1 if nd == 1 else world
    if ranks % tp:
        raise ValueError(
            f"{owner}: modelParallelism={tp} does not divide the group's "
            f"{ranks} rank(s) (numDevices={nd}; the group has {world} "
            f"rank(s))")
    if ranks == 1:
        if ep > 1:
            raise ValueError(
                f"{owner}: expertParallelism={ep} needs a gang of ranks "
                f"it divides (numDevices={nd}, {world} rank(s))")
        return None
    if world % ep:
        raise ValueError(f"{owner}: expertParallelism={ep} does not "
                         f"divide the group's {world} ranks")
    if tp > 1:
        return ProcessMesh({DATA_AXIS: -1, MODEL_AXIS: tp}, device=device)
    return ProcessMesh({DATA_AXIS: -1, EXPERT_AXIS: ep} if ep > 1 else None,
                       device=device)


#: gradient all-reduce bucket of the data-mesh step (one collective a
#: bucket: few large transfers over gloo)
GRAD_BUCKET_BYTES = 32 << 20


def _mean(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n``, dividing by a device tensor (a card multiplies by the
    reciprocal of a Python number)."""
    return t / torch.tensor(float(n), dtype=t.dtype, device=t.device)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class DLTrainer:
    """Train and eval steps for a model whose forward takes the batch
    inputs plus ``deterministic=`` (text) or ``train=`` (vision) and
    returns logits.

    ``model`` must already sit on ``device``; its parameters are the f32
    master weights.  ``mesh`` (a ProcessMesh on ``device``; every rank
    builds the trainer alike, the model built with the same mesh) trains
    over the gang's ranks, ``zero1`` shards the optimizer moments over its
    ``data`` axis and ``collective`` (a CollectiveConfig) runs the manual
    data-parallel step (module docstring)."""

    def __init__(self, model: nn.Module, optimizer: OptimizerConfig,
                 device: DeviceLike = "cuda",
                 loss_fn: Optional[Callable] = None,
                 has_batch_stats: bool = False,
                 train_kwarg: str = "deterministic",
                 precision: Optional[PrecisionPolicy] = None,
                 mesh=None, zero1: bool = False, collective=None):
        self.device = resolve_device(device)
        self.model = model
        self.precision = resolve_precision(precision)
        self._opt_cfg = optimizer
        self.lr = optimizer.schedule_fn()
        self.has_batch_stats = has_batch_stats
        self.train_kwarg = train_kwarg
        self.loss_fn = loss_fn or softmax_cross_entropy
        self.mesh = mesh
        self.data_size = axis_size(mesh, DATA_AXIS)
        self.data_index = axis_index(mesh, DATA_AXIS)
        self.zero1 = bool(zero1)
        self.collective = (collective if collective is not None
                           and collective.enabled else None)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not "
                             f"device={self.device}")
        if self.collective is not None:
            if self.zero1:
                raise ValueError(
                    "zero1 (weight-update sharding) and a CollectiveConfig "
                    "are mutually exclusive: sharded_update=True is the "
                    "explicit form of zero1 and composes with compression")
            bad = {a: s_ for a, s_ in (mesh.shape if mesh else {}).items()
                   if a != DATA_AXIS and s_ > 1}
            if bad:
                raise ValueError(
                    f"collective compression/sharded update runs the "
                    f"manual data-parallel step and supports pure data "
                    f"meshes only; this mesh also has {bad}: drop "
                    "tensor/expert parallelism or collectiveCompression")

    @property
    def is_writer(self) -> bool:
        """The rank that writes the fit's step checkpoints."""
        return self.mesh is None or self.mesh.rank == 0

    def _flag(self, train: bool) -> Dict[str, bool]:
        if self.train_kwarg == "train":
            return {"train": train}
        return {self.train_kwarg: not train}

    # -- init ----------------------------------------------------------------
    def init_state(self, seed: int) -> TrainState:
        """A fresh state: the model's parameters drawn from ``seed`` (its
        ``init_weights``; batch statistics reset), step 0, empty optimizer
        moments and, under error feedback, zero residuals."""
        self.model.init_weights(seed)
        params = list(self.model.parameters())
        cc = self.collective
        if cc is not None and cc.sharded_update:
            big = [i for i, p in enumerate(params)
                   if p.numel() >= cc.min_size]
            opt = self._sharded(params, big, cc.chunk
                                if cc.compression == "int8" else 1)
        elif self.zero1:
            opt = self._sharded(params, range(len(params)), 1, clip=True,
                                leaf_axes={i: tuple(a for a, _ in splits)
                                           for i, splits in
                                           self._shard_params().items()})
        else:
            opt = self._opt_cfg.build(params)
            sharded = self._shard_params()
            if sharded:
                opt.leaf_sums = self._sharded_sums(sharded)
        residuals = None
        if cc is not None and cc.compresses and cc.error_feedback:
            residuals = [torch.zeros_like(p, dtype=torch.float32)
                         for p in params]
        return TrainState(step=0, model=self.model, opt=opt,
                          residuals=residuals)

    def _sharded_sums(self, sharded: Dict[int, list]) -> Callable:
        """The clip's hook over a mesh that shards leaves: each sharded
        leaf's sum of squares is summed over each of its axes (one
        all-reduce an axis), so the global norm counts every block once,
        as the reference's does; a replicated leaf counts once."""
        from ...parallel.collectives import psum
        mesh = self.mesh
        by_axis: Dict[str, List[int]] = {}
        for i, splits in sharded.items():
            for axis, _ in splits:
                by_axis.setdefault(axis, []).append(i)

        def complete(sums):
            for axis in sorted(by_axis):
                idx = by_axis[axis]
                total = psum(torch.stack([sums[i] for i in idx]), mesh,
                             axis, op="grad_norm")
                for j, i in enumerate(idx):
                    sums[i] = total[j]
            return sums

        return complete

    def _sharded(self, params, big, chunk: int, clip: bool = False,
                 leaf_axes=None) -> ShardedOptimizer:
        if self._opt_cfg.name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {self._opt_cfg.name!r}")
        big = list(big)
        total = sum(params[i].numel() for i in big)
        unit = self.data_size * chunk
        padded = -(-max(total, 1) // unit) * unit
        return ShardedOptimizer(self._opt_cfg, params, big, padded,
                                self.mesh, clip, leaf_axes)

    # -- steps ---------------------------------------------------------------
    def train_step(self) -> Callable:
        """``step(state, inputs, labels, dropout_seed) -> (state,
        metrics)``: one update in place; ``metrics`` holds the loss and
        the batch accuracy as device scalars (the global batch's over a
        mesh).  Dropout masks come from ``(dropout_seed, state.step)``.
        Over a mesh, ``inputs``/``labels`` are this rank's rows of the
        batch (:meth:`local_rows`)."""
        from ...parallel.collectives import psum
        flag = self._flag(True)
        takes_seed = self.train_kwarg == "deterministic"
        D, d, mesh = self.data_size, self.data_index, self.mesh
        sync = self._sync_fn()

        def step(state: TrainState, inputs: Tuple, labels: torch.Tensor,
                 dropout_seed: int):
            model = state.model
            kw = dict(flag)
            if takes_seed:
                kw["dropout_seed"] = mix_seed(dropout_seed, state.step)
                if D > 1:
                    B = labels.shape[0]
                    kw["rows"] = (d * B, D * B)
            logits = model(*inputs, **kw)
            ce = self.loss_fn(logits, labels)
            terms = model.aux_losses() if hasattr(model, "aux_losses") \
                else []
            # the layers' auxiliary objectives (the MoE load-balance
            # losses), summed from 0 as the reference sums its ``losses``
            aux = (sum(terms, torch.zeros((), device=ce.device)) if terms
                   else None)
            objective = ce
            if aux is not None:
                # the Switch loss is the global batch's on every rank and
                # its gradient reaches each rank's tokens unreduced: the
                # mean over data must not divide it
                objective = ce + (aux * D if D > 1 else aux)
            state.opt.zero_grad()
            objective.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in state.opt.params]
            sync(state, grads, self.lr(state.step))
            if self.has_batch_stats:
                model.commit_batch_stats()
            state.step += 1
            with torch.no_grad():
                acc = (logits.argmax(-1) == labels).float().mean()
                ce = ce.detach().float()
                if D > 1:
                    both = _mean(psum(torch.stack([ce, acc]), mesh,
                                      DATA_AXIS, op="step_metrics"), D)
                    ce, acc = both[0], both[1]
                loss = ce if aux is None else ce + aux.detach()
            return state, {"loss": loss, "accuracy": acc}

        return step

    def _clip(self, g_shard, small):
        """The reference's sharded update's clip, ``g · (max / norm)``
        when ``norm > max``, by the TRUE global norm: the slices
        partition the flat stream (its pad is zero), the small leaves are
        whole on every rank."""
        from ...parallel.collectives import psum
        max_norm = self._opt_cfg.grad_clip_norm
        if max_norm <= 0:
            return g_shard, small
        sq = (g_shard.float() * g_shard.float()).sum()
        if self.data_size > 1:
            sq = psum(sq, self.mesh, DATA_AXIS, op="grad_norm")
        for g in small:
            sq = sq + (g.float() * g.float()).sum()
        norm = torch.sqrt(sq)
        limit = torch.full((), float(max_norm), device=norm.device)
        scale = torch.where(norm > limit, limit / norm,
                            torch.ones_like(norm))
        return g_shard * scale, [g * scale for g in small]

    def _sync_fn(self) -> Callable:
        """``sync(state, grads, lr)``: reduce this rank's gradients over
        ``data`` and update the state in place, by the trainer's mode."""
        from ...parallel import compression as Z
        from ...parallel.collectives import (_record, reduce_scatter,
                                             tree_psum_bucketed)
        D, mesh, cc = self.data_size, self.mesh, self.collective
        grad_dtype = (self.precision.grad_dtype
                      if self.precision.casts_grads else None)

        def mean_over_data(leaves, bucket=GRAD_BUCKET_BYTES):
            if D == 1 or not leaves:
                return list(leaves)
            return [_mean(g, D) for g in tree_psum_bucketed(
                list(leaves), mesh, DATA_AXIS, bucket_bytes=bucket)]

        def scatter_mean(flat):
            if D == 1:
                return flat
            return _mean(reduce_scatter(flat, mesh, DATA_AXIS,
                                        op="grad_reduce_scatter"), D)

        if cc is None and not self.zero1:
            def sync(state, grads, lr):
                grads = mean_over_data(grads)
                if grad_dtype is not None:
                    grads = [g.to(grad_dtype) for g in grads]
                state.opt.step(grads, lr)
            return sync

        if cc is None:                                    # zero1
            def sync(state, grads, lr):
                g_shard = scatter_mean(state.opt.flat_stream(grads))
                if grad_dtype is not None:
                    g_shard = g_shard.to(grad_dtype)
                state.opt.step(g_shard, [], lr)
            return sync

        def rounded(grads):
            if grad_dtype is None:
                return grads
            # round THROUGH bf16, keep f32: the codec owns the wire dtype
            # and the residual math stays f32
            return [g.to(grad_dtype).to(g.dtype) for g in grads]

        if not cc.sharded_update:                         # replicated
            def sync(state, grads, lr):
                live = mesh if D > 1 else None
                grads, res = Z.compressed_tree_sync(
                    rounded(grads), live, DATA_AXIS if live else None, cc,
                    residuals=state.residuals, mean=True)
                if res is not None:
                    state.residuals = list(res)
                state.opt.step(list(grads), lr)
            return sync

        def sync(state, grads, lr):                       # sharded update
            opt = state.opt
            grads = rounded(grads)
            flat = Z.flatten_with_residuals(grads, opt.big, state.residuals,
                                            opt.padded)
            if D > 1:
                _record("grad_reduce_scatter", DATA_AXIS,
                        [grads[i] for i in opt.big], config=cc)
            if cc.compression == "int8":
                sent = Z.int8_roundtrip(flat, cc.chunk)
                shard_sum = (Z.int8_reduce_scatter(flat, mesh, DATA_AXIS,
                                                   cc.chunk)
                             if D > 1 else sent)
            elif cc.compression == "bf16":
                sent = Z.bf16_decode(Z.bf16_encode(flat))
                shard_sum = (Z.bf16_decode(reduce_scatter(
                    Z.bf16_encode(flat), mesh, DATA_AXIS, record=False,
                    op="grad_reduce_scatter")) if D > 1 else sent)
            else:
                sent = flat
                shard_sum = (reduce_scatter(flat, mesh, DATA_AXIS,
                                            record=False,
                                            op="grad_reduce_scatter")
                             if D > 1 else flat)
            g_shard = _mean(shard_sum, D)
            small_g = mean_over_data([grads[i] for i in opt.small],
                                     bucket=4 << 20)
            g_shard, small_g = self._clip(g_shard, small_g)
            opt.step(g_shard, small_g, lr)
            if state.residuals is not None:
                state.residuals = Z.unpack_residuals(
                    flat - sent, opt.big, grads, state.residuals)

        return sync

    def eval_step(self) -> Callable:
        """``ev(state, inputs) -> logits`` without gradients, dropout or
        batch-statistic updates (over an expert mesh every rank scores the
        same rows together)."""
        flag = self._flag(False)

        def ev(state: TrainState, inputs: Tuple) -> torch.Tensor:
            with torch.no_grad():
                return state.model(*inputs, **flag)

        return ev

    # -- data ----------------------------------------------------------------
    def local_rows(self, idx: np.ndarray) -> np.ndarray:
        """This rank's block of a batch's row indices (the whole batch on
        one rank; a batch from :func:`iterate_minibatches` at ``shards``
        = the data size always splits evenly)."""
        if self.data_size == 1:
            return idx
        lo, hi = block_bounds(len(idx), self.data_size, self.data_index)
        return idx[lo:hi]

    def shard_batch(self, arrays: Sequence[np.ndarray]
                    ) -> Tuple[torch.Tensor, ...]:
        """Host arrays → tensors on the trainer's device
        (:func:`to_device`)."""
        return to_device(arrays, self.device)

    # -- checkpoints -----------------------------------------------------------
    def _gather(self, t: torch.Tensor, axis: str, tiled: bool,
                op: str) -> torch.Tensor:
        from ...parallel.collectives import all_gather
        if axis_size(self.mesh, axis) == 1:
            return t if tiled else t[None]
        return all_gather(t, self.mesh, axis, tiled=tiled, op=op)

    def _shard_params(self) -> Dict[int, list]:
        """Parameter index → the ``(axis, dim)`` splits of the parameters
        this rank holds a block of (the model's ``shard_specs``)."""
        specs = self.model.shard_specs() \
            if hasattr(self.model, "shard_specs") else {}
        return {i: specs[k] for i, (k, _) in
                enumerate(self.model.named_parameters()) if k in specs}

    def _full_leaf(self, t: torch.Tensor, splits) -> torch.Tensor:
        from .transformer import gather_full
        return gather_full({"t": t}, {"t": splits}, self.mesh)["t"] \
            if splits else t

    def _own_block(self, t: torch.Tensor, splits) -> torch.Tensor:
        from .transformer import slice_full
        return slice_full({"t": t}, {"t": splits}, self.mesh)["t"] \
            if splits else t

    def _canonical_stream(self, opt: ShardedOptimizer,
                          local: torch.Tensor) -> torch.Tensor:
        """A sharded optimizer's padded local stream (this rank's blocks)
        → the whole model's stream: each sharded leaf gathered over its
        axes, in parameter order (what a one-rank fit holds)."""
        sharded = self._shard_params()
        if not sharded:
            return local
        leaves, offset = [], 0
        for i in opt.big:
            p = opt.params[i]
            leaf = local[offset:offset + p.numel()].reshape(p.shape)
            leaves.append(self._full_leaf(leaf, sharded.get(i)).reshape(-1))
            offset += p.numel()
        return torch.cat(leaves)

    def _local_stream(self, opt: ShardedOptimizer,
                      full: np.ndarray) -> np.ndarray:
        """The inverse of :meth:`_canonical_stream`: the whole model's
        stream → this rank's blocks' stream padded to ``opt.padded``."""
        sharded = self._shard_params()
        if not sharded:
            if full.shape[0] != opt.padded:
                from ...parallel import compression as Z
                full = Z.reshard_flat_stream(full, opt.total, opt.padded)
            return full
        parts, offset = [], 0
        for i in opt.big:
            p = opt.params[i]
            shape = list(p.shape)
            for axis, dim in sharded.get(i, ()):
                shape[dim] *= axis_size(self.mesh, axis)
            n = int(np.prod(shape))
            leaf = torch.from_numpy(np.ascontiguousarray(
                full[offset:offset + n])).reshape(shape)
            parts.append(self._own_block(leaf, sharded.get(i)).reshape(-1))
            offset += n
        out = np.zeros((opt.padded,), np.float32)
        flat = torch.cat(parts).numpy()
        out[:flat.shape[0]] = flat
        return out

    def checkpoint_tree(self, state: TrainState) -> dict:
        """The step checkpoint's tree, free of the world size and of the
        mesh's shape, as host arrays: the whole model's state dict, the
        step, the optimizer (moments in parameter order, sharded leaves
        gathered, and its count; a sharded optimizer's flat moments as
        the whole model's stream) and the residuals stacked ``(ranks,
        *shape)``.  Collective over a mesh: every rank calls it."""
        model = state.model
        sd = (model.full_state_dict() if hasattr(model, "full_state_dict")
              else model.state_dict())
        tree = {"model": {k: _host(v) for k, v in sd.items()},
                "step": np.asarray(state.step, np.int64)}
        opt = state.opt
        if isinstance(opt, ShardedOptimizer):
            tree["opt"] = {
                "count": np.asarray(opt.flat.count, np.int64),
                "flat": {k: [_host(self._canonical_stream(
                    opt, self._gather(v[0], DATA_AXIS, True,
                                      "gather_moments")))]
                         for k, v in opt.flat.moments().items()},
                "small": {"count": np.asarray(opt.rest.count, np.int64),
                          **{k: [_host(m) for m in v]
                             for k, v in opt.rest.moments().items()}}}
        else:
            sharded = self._shard_params()
            tree["opt"] = {"count": np.asarray(opt.count, np.int64)}
            for k, v in opt.moments().items():
                tree["opt"][k] = [_host(self._full_leaf(m, sharded.get(i)))
                                  for i, m in enumerate(v)]
        if state.residuals is not None:
            tree["residuals"] = [_host(self._gather(r, DATA_AXIS, False,
                                                    "gather_residuals"))
                                 for r in state.residuals]
        return tree

    @torch.no_grad()
    def load_checkpoint_tree(self, state: TrainState, tree: dict,
                             saved_shards: int) -> None:
        """Load a :meth:`checkpoint_tree` written at ``saved_shards`` data
        shards (and any ``model``/``expert`` shape) into ``state``,
        re-laid for this trainer's mesh where they differ (the
        reference's ``reshard_restored``: the residuals collapse to their
        total and restack with rank 0 carrying it, the flat moment stream
        re-pads, every sharded leaf gives this rank its block).
        Deterministic: the same checkpoint gives the same state at the
        same size, whatever size wrote it."""
        from ...parallel import compression as Z
        model = state.model
        sd = {k: torch.as_tensor(_host(v)) for k, v in tree["model"].items()}
        if hasattr(model, "load_full_state_dict"):
            model.load_full_state_dict(sd)
        else:
            model.load_state_dict(sd)
        opt, saved = state.opt, tree["opt"]
        dev = self.device
        if isinstance(opt, ShardedOptimizer):
            for k, (full,) in saved["flat"].items():
                full = self._local_stream(opt, _host(full))
                getattr(opt.flat, k)[0].copy_(torch.from_numpy(
                    np.ascontiguousarray(opt.my_slice(full))).to(dev))
            opt.flat.count = int(_host(saved["count"]))
            for k, v in opt.rest.moments().items():
                for dst, src in zip(v, saved["small"][k]):
                    dst.copy_(torch.as_tensor(_host(src)).to(dev))
            opt.rest.count = int(_host(saved["small"]["count"]))
        else:
            sharded = self._shard_params()
            for k, v in opt.moments().items():
                for i, (dst, src) in enumerate(zip(v, saved[k])):
                    src = self._own_block(torch.as_tensor(_host(src)),
                                          sharded.get(i))
                    dst.copy_(src.to(dev))
            opt.count = int(_host(saved["count"]))
        if state.residuals is not None:
            rows = []
            for r in saved_residuals(tree, saved_shards):
                if r.shape[0] != self.data_size:
                    r = Z.reshard_residuals(Z.canonical_residuals(r),
                                            self.data_size)
                rows.append(torch.from_numpy(
                    np.ascontiguousarray(r[self.data_index])).to(dev))
            state.residuals = rows
        state.step = int(_host(tree["step"]))


def saved_residuals(tree: dict, saved_shards: int) -> List[np.ndarray]:
    """A checkpoint's residual leaves, each stacked ``(saved_shards,
    *shape)``; raises when a leaf does not carry that stacking."""
    out = []
    for r in tree.get("residuals", []):
        r = _host(r)
        if r.ndim < 1 or r.shape[0] != int(saved_shards):
            raise ValueError(f"residual leaf {r.shape} does not carry the "
                             f"saved {saved_shards}-rank stacking")
        out.append(r)
    return out


def to_device(arrays: Sequence[np.ndarray],
              device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Host arrays → device tensors: on a card each goes through pinned
    memory as a non-blocking copy."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def effective_batch_size(batch_size: int, shards: int) -> int:
    return max(batch_size - batch_size % max(shards, 1), shards)


def num_minibatches(n: int, batch_size: int, shards: int) -> int:
    """Exact step count iterate_minibatches will yield — keeps lr schedules
    aligned with the actual number of optimizer steps."""
    bs = effective_batch_size(batch_size, shards)
    if n < bs:
        return 1
    return n // bs + (1 if n % bs else 0)


def iterate_minibatches(n: int, batch_size: int, shards: int,
                        rng: np.random.Generator, shuffle: bool = True):
    """Yield index arrays padded/truncated to full batches divisible by
    ``shards`` (the reference's order: the same generator gives the same
    batches)."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    bs = effective_batch_size(batch_size, shards)
    for start in range(0, n - bs + 1, bs):
        yield order[start:start + bs]
    rem = n % bs
    if rem and n >= bs:
        # wrap-around final batch keeps shapes static
        yield np.concatenate([order[n - rem:], order[:bs - rem]])
    elif n < bs:
        reps = int(np.ceil(bs / n))
        yield np.tile(order, reps)[:bs]
