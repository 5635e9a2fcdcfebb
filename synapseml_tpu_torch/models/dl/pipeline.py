"""Pipeline-parallel training for the BERT-style :class:`~.transformer.
TextEncoder`.

The PyTorch port of the JAX package's ``models/dl/pipeline.py``: the
encoder's block stack splits into S stages of ``num_layers / S`` blocks,
activations (and the attention mask riding beside them, as a float leaf)
move one hop a tick under the GPipe schedule of
:mod:`synapseml_tpu_torch.parallel.pipeline`, and the embeddings and the
pooler/classifier head stay replicated on every stage.

Parameters are the port's state-dict keys: :func:`split_encoder_stages`
takes a TextEncoder's (whole) state dict and returns ``(outer,
stacked)``, ``outer`` the non-block leaves and ``stacked`` the block
leaves as ``"b{j}.<rest>"`` with a leading stage dim; each rank of the
``pipe`` axis trains its slice (:func:`~synapseml_tpu_torch.parallel.
pipeline.local_stage`).  Dropout is off (the reference's supported PP
mode), so the pipelined forward and backward are the sequential
model's: microbatching is exact for per-sample ops and the schedule is a
schedule.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ...parallel.mesh import DATA_AXIS, PIPE_AXIS, axis_size
from ...parallel.pipeline import pipeline_apply, stack_stage_params
from .precision import run_block
from .transformer import Dense, EncoderBlock, LayerNorm, TransformerConfig

__all__ = ["split_encoder_stages", "merge_encoder_stages",
           "encoder_stage_fn", "pp_logits_fn", "pp_train_loss"]

_HEAD_KEYS = ("pooler", "classifier")


def _layer(key: str):
    """``"layer_{i}.<rest>"`` → ``(i, rest)``; None for other keys."""
    if not key.startswith("layer_"):
        return None
    head, rest = key.split(".", 1)
    return int(head.split("_")[1]), rest


def split_encoder_stages(state: Dict[str, torch.Tensor], n_stages: int
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """A TextEncoder state dict → ``(outer, stacked)``: ``outer`` keeps
    every leaf outside the ``layer_{i}`` blocks; ``stacked`` holds
    ``"b{j}.<rest>"`` = the stages' block ``j`` leaves stacked on a
    leading stage dim.  Requires ``num_layers % n_stages == 0``."""
    layers = {}
    outer = {}
    for k, v in state.items():
        hit = _layer(k)
        if hit is None:
            outer[k] = v
        else:
            layers.setdefault(hit[0], {})[hit[1]] = v
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"num_layers={L} not divisible by "
                         f"n_stages={n_stages}")
    per = L // n_stages
    stages = [{f"b{j}.{rest}": v for j in range(per)
               for rest, v in layers[s * per + j].items()}
              for s in range(n_stages)]
    return outer, stack_stage_params(stages)


def merge_encoder_stages(outer: Dict[str, torch.Tensor],
                         stacked: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_encoder_stages` (a PP-trained model back
    into the TextEncoder's layout)."""
    out = dict(outer)
    n_stages = next(iter(stacked.values())).shape[0]
    per = len({k.split(".", 1)[0] for k in stacked})
    for k, v in stacked.items():
        j, rest = k.split(".", 1)
        j = int(j[1:])
        for s in range(n_stages):
            out[f"layer_{s * per + j}.{rest}"] = v[s]
    return out


def encoder_stage_fn(cfg: TransformerConfig):
    """The stage function for :func:`~synapseml_tpu_torch.parallel.
    pipeline.pipeline_apply`: this stage's EncoderBlocks over the
    activation ``{"x", "mask"}`` (the mask a float leaf), dropout off.
    ``cfg.remat`` rematerializes each block in the backward pass, as
    the TextEncoder's own stack does."""
    if cfg.num_experts > 0:
        # TextEncoder builds MoE blocks at cfg-dependent positions; a
        # plain EncoderBlock here would train a different (non-MoE) model
        raise NotImplementedError(
            "pipeline parallelism over MoE TextEncoders is not supported "
            "(num_experts > 0): shard experts over the 'expert' mesh "
            "axis instead")
    block = EncoderBlock(cfg, torch.device("cpu"))
    names = [k for k, _ in block.named_parameters()]

    def one_block(params, x, bmask):
        return functional_call(block, params, (x, bmask, None))

    def fn(stage_params, state):
        x, mask = state["x"], state["mask"]
        bmask = mask > 0.5
        per = len({k.split(".", 1)[0] for k in stage_params})
        for j in range(per):
            p = {n: stage_params[f"b{j}.{n}"] for n in names}
            x = run_block(lambda xx, mm, p=p: one_block(p, xx, mm),
                          cfg.remat, x, bmask)
        return {"x": x, "mask": mask}

    return fn


class _Front(torch.nn.Module):
    """TextEncoder's pre-block section (token + position embedding, the
    embedding LayerNorm) under the same parameter names."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_embed = LayerNorm(cfg.d_model, cfg.dtype, torch.device("cpu"))

    def forward(self, tok_table, pos_table, input_ids):
        S = input_ids.shape[1]
        tok = F.embedding(input_ids, tok_table).to(self.cfg.dtype)
        pos = pos_table[:S].to(self.cfg.dtype)
        return self.ln_embed(tok + pos[None])


class _Head(torch.nn.Module):
    """TextEncoder's post-block section ([CLS] pooler + classifier)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        dev = torch.device("cpu")
        self.pooler = Dense(cfg.d_model, cfg.d_model, cfg.dtype, dev)
        self.classifier = Dense(cfg.d_model, cfg.num_classes, torch.float32,
                                dev)

    def forward(self, x):
        return self.classifier(torch.tanh(self.pooler(x[:, 0, :])))


def pp_logits_fn(cfg: TransformerConfig, num_microbatches: int, mesh,
                 axis: str = PIPE_AXIS):
    """``fn(outer, stacked, input_ids, attention_mask)`` → this rank's
    logits: the replicated front, the pipelined block stack over
    ``mesh``'s ``axis`` (``stacked`` this rank's stage, leading dim 1),
    the replicated head.  The batch is this rank's rows."""
    stage_fn = encoder_stage_fn(cfg)
    front, head = _Front(cfg), _Head(cfg)

    def fn(outer, stacked, input_ids, attention_mask):
        B = input_ids.shape[0]
        M = num_microbatches
        if B % M:
            raise ValueError(f"per-rank batch {B} not divisible by "
                             f"num_microbatches={M}")
        x = functional_call(front, {"ln_embed.scale": outer["ln_embed.scale"],
                                    "ln_embed.bias": outer["ln_embed.bias"]},
                            (outer["tok_embed.embedding"],
                             outer["pos_embed.embedding"], input_ids.long()))
        mb = B // M
        mbs = {"x": x.reshape(M, mb, *x.shape[1:]),
               "mask": attention_mask.float().reshape(M, mb, -1)}
        # the mask rides the pipeline but is never an output
        out = pipeline_apply(stage_fn, stacked, mbs, mesh, axis,
                             collect=lambda s: s["x"])
        y = out.reshape(B, *x.shape[1:])
        return functional_call(head, {k: v for k, v in outer.items()
                                      if k.split(".", 1)[0] in _HEAD_KEYS},
                               (y,))

    return fn


def pp_train_loss(cfg: TransformerConfig, mesh, num_microbatches: int = 4):
    """``loss(outer, stacked, ids, mask, labels)`` → the mean softmax-CE
    over the global batch under a ``(pipe[, data])`` mesh: ``stacked`` is
    this rank's stage (leading dim 1), the batch this rank's rows of the
    ``data`` axis.  Each rank's backward of it gives the sequential
    full-batch model's gradients: the whole outer tree's on every rank
    and its own stage's block leaves (the parameters' gradients are
    summed over ``data``, ``reduce_backward``), when dropout is off."""
    from ...parallel.collectives import psum, reduce_backward, reduce_forward
    logits_fn = pp_logits_fn(cfg, num_microbatches, mesh)
    data = axis_size(mesh, DATA_AXIS)

    def loss(outer, stacked, ids, mask, labels):
        if data > 1:
            outer = {k: reduce_backward(v, mesh, DATA_AXIS, op="pp_grad")
                     for k, v in outer.items()}
            stacked = {k: reduce_backward(v, mesh, DATA_AXIS, op="pp_grad")
                       for k, v in stacked.items()}
        logits = logits_fn(outer, stacked, ids, mask)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
        total, count = nll.sum(), torch.tensor(
            float(nll.shape[0]), device=nll.device)
        if data > 1:
            total = reduce_forward(total, mesh, DATA_AXIS, op="pp_loss")
            count = psum(count, mesh, DATA_AXIS, op="pp_count")
        return total / count

    return loss
