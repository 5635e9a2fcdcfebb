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
(the estimators once an epoch).  The mesh, tensor/ZeRO-1 sharding and the
compressed collectives are not ported (ROADMAP A5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, resolve_device
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

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        """One update of every parameter from ``grads`` (one per
        parameter, in order) at learning rate ``lr``."""
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


@dataclasses.dataclass
class TrainState:
    """The step count (updates made, on the host), the model (its
    parameters, and its buffers as the extra state: batch statistics) and
    the optimizer (its moments)."""
    step: int
    model: nn.Module
    opt: OptaxOptimizer


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """optax ``softmax_cross_entropy_with_integer_labels(...).mean()`` on
    f32 logits."""
    return F.cross_entropy(logits.float(), labels.long())


class DLTrainer:
    """Train and eval steps for a model whose forward takes the batch
    inputs plus ``deterministic=`` (text) or ``train=`` (vision) and
    returns logits.

    ``model`` must already sit on ``device``; its parameters are the f32
    master weights."""

    def __init__(self, model: nn.Module, optimizer: OptimizerConfig,
                 device: DeviceLike = "cuda",
                 loss_fn: Optional[Callable] = None,
                 has_batch_stats: bool = False,
                 train_kwarg: str = "deterministic",
                 precision: Optional[PrecisionPolicy] = None):
        self.device = resolve_device(device)
        self.model = model
        self.precision = resolve_precision(precision)
        self._opt_cfg = optimizer
        self.lr = optimizer.schedule_fn()
        self.has_batch_stats = has_batch_stats
        self.train_kwarg = train_kwarg
        self.loss_fn = loss_fn or softmax_cross_entropy

    def _flag(self, train: bool) -> Dict[str, bool]:
        if self.train_kwarg == "train":
            return {"train": train}
        return {self.train_kwarg: not train}

    # -- init ----------------------------------------------------------------
    def init_state(self, seed: int) -> TrainState:
        """A fresh state: the model's parameters drawn from ``seed`` (its
        ``init_weights``; batch statistics reset), step 0 and empty
        optimizer moments."""
        self.model.init_weights(seed)
        return TrainState(step=0, model=self.model,
                          opt=self._opt_cfg.build(self.model.parameters()))

    # -- steps ---------------------------------------------------------------
    def train_step(self) -> Callable:
        """``step(state, inputs, labels, dropout_seed) -> (state,
        metrics)``: one update in place; ``metrics`` holds the loss and
        the batch accuracy as device scalars.  Dropout masks come from
        ``(dropout_seed, state.step)``."""
        flag = self._flag(True)
        takes_seed = self.train_kwarg == "deterministic"
        grad_dtype = (self.precision.grad_dtype
                      if self.precision.casts_grads else None)

        def step(state: TrainState, inputs: Tuple, labels: torch.Tensor,
                 dropout_seed: int):
            model = state.model
            kw = dict(flag)
            if takes_seed:
                kw["dropout_seed"] = mix_seed(dropout_seed, state.step)
            logits = model(*inputs, **kw)
            loss = self.loss_fn(logits, labels)
            aux = model.aux_losses() if hasattr(model, "aux_losses") else []
            if aux:
                # the layers' auxiliary objectives (the MoE load-balance
                # losses), summed from 0 as the reference sums its
                # ``losses`` collection
                loss = loss + sum(aux, torch.zeros((), device=loss.device))
            state.opt.zero_grad()
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in state.opt.params]
            if grad_dtype is not None:
                grads = [g.to(grad_dtype) for g in grads]
            state.opt.step(grads, self.lr(state.step))
            if self.has_batch_stats:
                model.commit_batch_stats()
            state.step += 1
            with torch.no_grad():
                acc = (logits.argmax(-1) == labels).float().mean()
            return state, {"loss": loss.detach(), "accuracy": acc}

        return step

    def eval_step(self) -> Callable:
        """``ev(state, inputs) -> logits`` without gradients, dropout or
        batch-statistic updates."""
        flag = self._flag(False)

        def ev(state: TrainState, inputs: Tuple) -> torch.Tensor:
            with torch.no_grad():
                return state.model(*inputs, **flag)

        return ev

    # -- data ----------------------------------------------------------------
    def shard_batch(self, arrays: Sequence[np.ndarray]
                    ) -> Tuple[torch.Tensor, ...]:
        """Host arrays → tensors on the trainer's device
        (:func:`to_device`)."""
        return to_device(arrays, self.device)


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
