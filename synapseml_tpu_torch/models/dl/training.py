"""The DL training loop on one card: optimizer, train state and steps.

The PyTorch port of the JAX package's ``models/dl/training.py`` for one
device.  The step is eager PyTorch: forward in the model's compute dtype
(explicit casts in the models), softmax cross-entropy on f32 logits,
backward, gradients f32 (rounded through bf16 under ``bf16_grad``), the
global-norm clip, then the optimizer.  The update matches optax, not
torch's defaults:

- a schedule is read at the count of updates already made (the first
  update uses lr(0), which is 0 under the warmup-cosine schedule);
- ``clip_by_global_norm`` scales by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm``, with no epsilon (``clip_grad_norm_`` adds 1e-6,
  so it is not used);
- adamw is b1 0.9, b2 0.999, eps 1e-8 with decay on every parameter,
  biases and norms included; sgd's momentum is optax's ``trace``
  (``SGD(momentum, dampening=0)``).

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

    def build(self, params: Sequence[nn.Parameter]) -> torch.optim.Optimizer:
        """The optimizer over ``params``; the trainer sets its learning
        rate from :meth:`schedule_fn` before every update."""
        params = list(params)
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8,
                                     weight_decay=self.weight_decay,
                                     foreach=True)
        if self.name == "adam":
            return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999),
                                    eps=1e-8, foreach=True)
        if self.name == "sgd":
            return torch.optim.SGD(params, lr=0.0, momentum=self.momentum,
                                   dampening=0.0, foreach=True)
        raise ValueError(f"unknown optimizer {self.name!r}")


@dataclasses.dataclass
class TrainState:
    """The step count (updates made, on the host), the model (its
    parameters, and its buffers as the extra state: batch statistics) and
    the optimizer (its moments)."""
    step: int
    model: nn.Module
    opt: torch.optim.Optimizer


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
    def _clip(self, grads) -> None:
        max_norm = self._opt_cfg.grad_clip_norm
        if max_norm <= 0 or not grads:
            return
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        torch._foreach_mul_(grads, scale)

    def train_step(self) -> Callable:
        """``step(state, inputs, labels, dropout_seed) -> (state,
        metrics)``: one update in place; ``metrics`` holds the loss and
        the batch accuracy as device scalars.  Dropout masks come from
        ``(dropout_seed, state.step)``."""
        flag = self._flag(True)
        takes_seed = self.train_kwarg == "deterministic"
        bf16_round = (self.precision.grad_dtype
                      if self.precision.casts_grads else None)

        def step(state: TrainState, inputs: Tuple, labels: torch.Tensor,
                 dropout_seed: int):
            model = state.model
            kw = dict(flag)
            if takes_seed:
                kw["dropout_seed"] = mix_seed(dropout_seed, state.step)
            logits = model(*inputs, **kw)
            loss = self.loss_fn(logits, labels)
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            if bf16_round is not None:
                for g in grads:
                    g.copy_(g.to(bf16_round))
            self._clip(grads)
            for group in state.opt.param_groups:
                group["lr"] = self.lr(state.step)
            state.opt.step()
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
