"""Minimal causal-LM fine-tuning for :class:`~.model.LlamaModel`.

The PyTorch port of the JAX package's ``models/llm/finetune.py``.  The
serving side (speculative decoding) needs models whose greedy
continuations are predictable; random-init weights emit chaos, so
prompt-lookup acceptance stays near zero.  This trainer is the in-repo
path to that regime: next-token cross-entropy with adamw on generated
token streams (:func:`templated_log_corpus`; nothing is downloaded).

The step is the model's full-sequence forward (no cache), the f32
shifted cross-entropy of :func:`~.model.causal_lm_loss` and a backward;
the update is optax's ``adamw(lr, weight_decay=0.01)`` through
:class:`~synapseml_tpu_torch.models.dl.training.OptaxOptimizer`, with
optax's per-operation dtypes (f32 parameters and moments).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ..dl.training import OptaxOptimizer, OptimizerConfig
from .model import LlamaModel, causal_lm_loss

__all__ = ["lm_loss_fn", "make_lm_train_step", "finetune_lm",
           "templated_log_corpus"]

#: default record template for :func:`templated_log_corpus` — 16 tokens,
#: two random field slots (-1), the rest fixed
_LOG_TEMPLATE = np.array([17, 18, 19, -1, 21, 22, 23, 24, 25, -1, 27, 28,
                          29, 30, 31, 32])


def templated_log_corpus(rng: np.random.Generator, n: int, n_rec: int,
                         template: Optional[np.ndarray] = None,
                         field_range: Tuple[int, int] = (64, 512)
                         ) -> np.ndarray:
    """(n, n_rec·len(template)) int32 sequences of templated "log
    records": fixed template tokens with random field tokens in the -1
    slots — the predictable-text corpus of speculative decoding's target
    regime.  The same generator gives the reference's array."""
    tpl = _LOG_TEMPLATE if template is None else np.asarray(template)
    rec_len = len(tpl)
    out = np.zeros((n, n_rec * rec_len), np.int32)
    n_fields = int((tpl == -1).sum())
    for i in range(n):
        for r in range(n_rec):
            rec = tpl.copy()
            rec[rec == -1] = rng.integers(*field_range, size=n_fields)
            out[i, r * rec_len:(r + 1) * rec_len] = rec
    return out


def lm_loss_fn(model: LlamaModel) -> Callable[[torch.Tensor], torch.Tensor]:
    """tokens (B, S) int → mean next-token cross-entropy (f32) of the
    model's full-sequence forward."""

    def loss(tokens: torch.Tensor) -> torch.Tensor:
        return causal_lm_loss(model(tokens).float(), tokens)
    return loss


def make_lm_train_step(model: LlamaModel, learning_rate: float = 3e-4,
                       weight_decay: float = 0.01):
    """→ (init_opt() → optimizer, step(opt, tokens) → loss): one adamw
    update of every parameter in place; the loss stays on the device."""
    cfg = OptimizerConfig(name="adamw", learning_rate=learning_rate,
                          weight_decay=weight_decay)
    loss = lm_loss_fn(model)
    params = list(model.parameters())

    def init_opt() -> OptaxOptimizer:
        return cfg.build(params)

    def step(opt: OptaxOptimizer, tokens: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        value = loss(tokens)
        value.backward()
        opt.step([p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in params], learning_rate)
        return value.detach()

    return init_opt, step


def finetune_lm(model: LlamaModel, batches: Iterable[np.ndarray],
                learning_rate: float = 3e-4, log_every: int = 0,
                variables: Optional[Dict[str, torch.Tensor]] = None,
                device: DeviceLike = "cuda"
                ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Run the cross-entropy step over ``batches`` of (B, S) int32 tokens
    on ``device`` (the model's; default ``"cuda"``, which raises without a
    card unless ``device="cpu"``), starting from ``variables`` (a state
    dict) when given, else from the model's parameters.  Returns (the
    trained state dict, the final loss); the loss is read once, at the
    end (and every ``log_every`` steps when set)."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model is on {model.device} but "
                         f"device={str(device)!r}")
    if variables is not None:
        model.load_state_dict(variables)
    init_opt, step = make_lm_train_step(model, learning_rate)
    opt = init_opt()
    last = None
    for i, toks in enumerate(batches):
        last = step(opt, torch.as_tensor(np.asarray(toks, np.int32),
                                         device=dev))
        if log_every and (i + 1) % log_every == 0:
            print(f"  lm step {i + 1}: loss {float(last):.4f}")
    final = float(last) if last is not None else float("nan")
    return {k: v.detach() for k, v in model.state_dict().items()}, final
