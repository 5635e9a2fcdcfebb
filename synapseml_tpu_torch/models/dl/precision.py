"""Mixed-precision and rematerialization policies for DL training.

The PyTorch port of the JAX package's ``models/dl/precision.py``:

- :class:`PrecisionPolicy` — the dtype the forward/backward computes in
  (``compute_dtype``), the dtype gradients are rounded through before the
  update (``grad_dtype``) and the master dtype of parameters, optimizer
  moments and batch statistics (``param_dtype``, always float32: bf16
  activations and f32 master weights, Micikevicius et al.,
  arXiv:1710.03740).
- :func:`remat_policy` — the ``rematPolicy`` knob mapped onto
  ``torch.utils.checkpoint`` with ``use_reentrant=False``; the models
  wrap each block in :func:`run_block`.

``"bf16_grad"`` casts every gradient to bf16 (:func:`cast_floating`'s
rule) and the trainer's optimizer computes the clip and the moment
products in bf16, promoting to the f32 moments as optax does
(``training.OptaxOptimizer``).  :func:`round_to` (round through a dtype,
keep f32) is the reference's rule for the manual data-parallel path.
Rematerialization re-runs the same ops on the same values in the
backward pass, so gradients equal the no-remat step's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: accepted ``rematPolicy`` values (estimator param + model configs)
REMAT_POLICIES = ("none", "dots_saveable", "full", "blocks")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype contract of one train step.  ``param_dtype`` is the master
    dtype: parameters, optimizer moments and batch statistics never leave
    it."""
    name: str = "bf16"
    compute_dtype: Any = torch.bfloat16
    grad_dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def casts_grads(self) -> bool:
        return self.grad_dtype != self.param_dtype


_POLICIES = {
    "bf16": PrecisionPolicy("bf16", torch.bfloat16, torch.float32),
    "f32": PrecisionPolicy("f32", torch.float32, torch.float32),
    "bf16_grad": PrecisionPolicy("bf16_grad", torch.bfloat16,
                                 torch.bfloat16),
}

#: checkpoint config-guard code per policy, as in the JAX package
PRECISION_CODE = {"bf16": 0.0, "f32": 1.0, "bf16_grad": 2.0}


def resolve_precision(spec) -> PrecisionPolicy:
    """``None``/name/:class:`PrecisionPolicy` → policy (default bf16)."""
    if spec is None:
        return _POLICIES["bf16"]
    if isinstance(spec, PrecisionPolicy):
        return spec
    if isinstance(spec, str):
        if spec not in _POLICIES:
            raise ValueError(f"precision={spec!r}: expected one of "
                             f"{sorted(_POLICIES)}")
        return _POLICIES[spec]
    raise ValueError(f"precision must be a name or PrecisionPolicy, got "
                     f"{type(spec).__name__}")


def cast_floating(state: Dict[str, torch.Tensor],
                  dtype) -> Dict[str, torch.Tensor]:
    """Cast every floating tensor of a state dict to ``dtype`` (integer
    and bool tensors pass through)."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in state.items()}


def round_to(state: Dict[str, torch.Tensor],
             dtype) -> Dict[str, torch.Tensor]:
    """Round floating tensors THROUGH ``dtype`` and keep their own dtype
    (f32 in, f32 out)."""
    return {k: v.to(dtype).to(v.dtype) if v.is_floating_point() else v
            for k, v in state.items()}


#: the ops whose outputs ``dots_saveable`` keeps: matmuls and
#: convolutions (jax's ``dots_saveable`` keeps every dot_general and
#: convolution result); everything else recomputes
_DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "addmm", "bmm", "baddbmm", "convolution"))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_saveable)


def remat_policy(name) -> Tuple[bool, Optional[Callable]]:
    """``rematPolicy`` knob → ``(enabled, context_fn)``.

    - ``"none"``/None/False: no rematerialization.
    - ``"dots_saveable"``: checkpoint each block, saving the outputs of
      its matmuls and convolutions (a selective checkpoint); the cheap
      elementwise and norm chains recompute.
    - ``"full"`` / ``"blocks"`` (and ``True``): checkpoint each block
      saving only its inputs.
    """
    if name in (None, False, "none"):
        return False, None
    if name is True:
        name = "full"
    if name not in REMAT_POLICIES:
        raise ValueError(f"rematPolicy={name!r}: expected one of "
                         f"{REMAT_POLICIES}")
    if name == "dots_saveable":
        return True, _dots_context
    return True, None


def run_block(block: Callable, remat, *args):
    """``block(*args)``, checkpointed under the ``remat`` policy when
    gradients flow (an inference call keeps nothing either way)."""
    enabled, context_fn = remat_policy(remat)
    if not enabled or not torch.is_grad_enabled():
        return block(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(block, *args, use_reentrant=False, **kw)
