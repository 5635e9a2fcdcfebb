"""GPipe pipeline parallelism over a ``pipe`` mesh axis.

The PyTorch port of the JAX package's ``parallel/pipeline.py``.  Every
rank of the ``pipe`` axis runs the same schedule over its own stage's
parameters (its slice of a stage-stacked tree, leading dim 1): at tick
``t`` stage 0 takes microbatch ``t``, every stage applies ``stage_fn`` to
the activation it holds, and the activations move one hop to the next
stage (:func:`~.collectives.ppermute`).  With S stages and M
microbatches the schedule takes ``T = M + S - 1`` ticks; the last stage
retires microbatch ``t - (S - 1)`` at tick ``t``, and one all-reduce over
``pipe`` hands the outputs to every stage.  As in the reference, every
stage computes at every tick (the bubble's inputs are zeros or a
repeated microbatch whose outputs never retire).

The backward is the GPipe backward written out: the ticks run in
reverse, each stage back-propagates the cotangent of its tick's output
through the tick's graph, and the gradient of the tick's input goes back
to the previous stage along the inverse permutation.  The semantics are
those of ``jax.grad`` outside the reference's ``shard_map``: the
broadcast outputs are one replicated value, so the last stage seeds
their cotangent once (every rank computes the same loss from them); the
microbatches are a replicated input, so their gradient (stage 0's) is
summed over ``pipe`` and every rank gets it.  A stage's parameter
gradients are its own.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from .mesh import PIPE_AXIS

__all__ = ["pipeline_apply", "pipeline_loss", "stack_stage_params",
           "local_stage", "PIPE_AXIS"]


def stack_stage_params(per_stage_params: Sequence[Any]):
    """Stack S per-stage pytrees into one pytree with a leading stage dim
    (each rank of the ``pipe`` axis then takes its slice,
    :func:`local_stage`)."""
    flats = [pytree.tree_flatten(p) for p in per_stage_params]
    spec = flats[0][1]
    leaves = [torch.stack([f[0][i] for f in flats])
              for i in range(len(flats[0][0]))]
    return pytree.tree_unflatten(leaves, spec)


def local_stage(stacked: Any, mesh, axis: str = PIPE_AXIS):
    """This rank's slice of a stage-stacked tree, leading dim 1 (the
    reference's ``P(pipe)`` placement, one shard)."""
    i = mesh.axis_index(axis)
    return pytree.tree_map(lambda a: a[i:i + 1], stacked)


def _grad_leaf(t: torch.Tensor) -> torch.Tensor:
    """A fresh graph leaf holding ``t``'s values; it takes gradients when
    ``t`` is floating."""
    t = t.detach()
    return t.requires_grad_(True) if t.is_floating_point() else t


class _Schedule(torch.autograd.Function):
    """The tick loop as one autograd node (module docstring).  ``run``
    holds the static inputs: the stage function, the mesh and axis, the
    trees' specs and ``collect``."""

    @staticmethod
    def forward(ctx, run, *leaves):
        from .collectives import _ppermute, psum
        mesh, axis = run["mesh"], run["axis"]
        n_p = run["n_params"]
        p_leaves = [_grad_leaf(t) for t in leaves[:n_p]]
        mb_leaves = [t.detach() for t in leaves[n_p:]]
        with torch.enable_grad():
            # views taken with gradients on, so the stage graph reaches
            # the parameter leaves
            params = pytree.tree_unflatten([p[0] for p in p_leaves],
                                           run["p_spec"])
        M = mb_leaves[0].shape[0]
        S, stage = mesh.axis_size(axis), mesh.axis_index(axis)
        T = M + S - 1
        perm = [(i, (i + 1) % S) for i in range(S)]
        state = [torch.zeros_like(t[0]) for t in mb_leaves]
        outputs, ticks = None, []
        for t in range(T):
            if stage == 0:
                state = [mb[min(t, M - 1)] for mb in mb_leaves]
            state_in = [_grad_leaf(x) for x in state]
            with torch.enable_grad():
                out = run["stage_fn"](
                    params, pytree.tree_unflatten(state_in, run["mb_spec"]))
                out_leaves = pytree.tree_flatten(out)[0]
                kept = pytree.tree_flatten(run["collect"](out))[0]
            retire = t - (S - 1)
            if outputs is None:
                outputs = [torch.zeros((M,) + tuple(k.shape), dtype=k.dtype,
                                       device=k.device) for k in kept]
            if stage == S - 1 and retire >= 0:
                for buf, k in zip(outputs, kept):
                    buf[retire] = k.detach()
            ticks.append((state_in, out_leaves, kept))
            if t + 1 < T:
                # the last tick's send would feed nothing
                state = [_ppermute(o.detach().contiguous(), mesh, perm, axis,
                                   "pipeline", True, None)
                         for o in out_leaves]
        if S > 1:
            outputs = [psum(o, mesh, axis, op="pipeline_outputs")
                       for o in outputs]
        ctx.run, ctx.ticks, ctx.p_leaves = run, ticks, p_leaves
        ctx.M, ctx.S, ctx.stage = M, S, stage
        ctx.mb_meta = [(t.shape, t.dtype, t.device) for t in mb_leaves]
        return tuple(outputs)

    @staticmethod
    def backward(ctx, *grad_outs):
        from .collectives import _ppermute, psum
        run, ticks, M, S, stage = ctx.run, ctx.ticks, ctx.M, ctx.S, ctx.stage
        mesh, axis = run["mesh"], run["axis"]
        inverse = [((i + 1) % S, i) for i in range(S)]
        p_leaves = ctx.p_leaves
        p_grads = [torch.zeros_like(p) if p.requires_grad else None
                   for p in p_leaves]
        mb_grads = [torch.zeros(shape, dtype=dtype, device=device)
                    if dtype.is_floating_point else None
                    for shape, dtype, device in ctx.mb_meta]
        recv = None
        for t in reversed(range(len(ticks))):
            state_in, out_leaves, kept = ticks[t]
            outs, cots = [], []
            if recv is not None:
                for o, c in zip(out_leaves, recv):
                    if o.requires_grad:
                        outs.append(o)
                        cots.append(c)
            retire = t - (S - 1)
            if stage == S - 1 and retire >= 0:
                for k, g in zip(kept, grad_outs):
                    if k.requires_grad and g is not None:
                        outs.append(k)
                        cots.append(g[retire])
            wrt = [x for x in state_in if x.requires_grad] + \
                [p for p in p_leaves if p.requires_grad]
            got = [None] * len(wrt)
            if outs:
                # the vector-Jacobian product as the gradient of the scalar
                # Σ <out, cotangent> (the same cotangents bit for bit):
                # autograd's check of explicit grad_outputs imports sympy
                # on first use, ~4 s a process on the H100's host
                with torch.enable_grad():
                    vjp = sum((o * c).sum() for o, c in zip(outs, cots))
                got = torch.autograd.grad(vjp, wrt, allow_unused=True)
            it = iter(got)
            g_in = [next(it) if x.requires_grad else None for x in state_in]
            for j, p in enumerate(p_leaves):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        p_grads[j] += g
            if stage == 0 and t < M:
                for j, g in enumerate(g_in):
                    if g is not None and mb_grads[j] is not None:
                        mb_grads[j][t] += g
            if t > 0:
                # the input's cotangent goes back to the stage that sent it
                # (stage 0 took a microbatch: it sends zeros)
                back = [torch.zeros_like(x) if g is None or stage == 0
                        else g for x, g in zip(state_in, g_in)]
                recv = [_ppermute(b.contiguous(), mesh, inverse, axis,
                                  "pipeline_grad", True, None)
                        for b in back]
        if S > 1:
            mb_grads = [None if g is None else
                        psum(g, mesh, axis, op="pipeline_input_grad")
                        for g in mb_grads]
        ctx.ticks = None
        return (None, *p_grads, *mb_grads)


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stacked_params: Any,
                   microbatches: Any, mesh, axis: str = PIPE_AXIS,
                   collect: Callable[[Any], Any] = None) -> Any:
    """Run microbatches through the S-stage pipeline over ``mesh``'s
    ``axis``.

    ``stage_fn``: (params of one stage, activation pytree) → activation
    pytree.  ``stacked_params``: this rank's stage's tree, leading dim 1
    (:func:`local_stage`).  ``microbatches``: a tensor (M, mb, ...) or a
    pytree of them (an attention mask can ride beside the activations),
    the same on every stage (stage 0 is its only consumer).  ``collect``
    (state pytree → output pytree, default identity) picks the leaves to
    retire and broadcast.  → the (M, ...) outputs, the same on every
    stage.  Differentiable (module docstring); every rank of the axis
    must call it, and run its backward, together."""
    collect = collect if collect is not None else (lambda s: s)
    p_leaves, p_spec = pytree.tree_flatten(stacked_params)
    mb_leaves, mb_spec = pytree.tree_flatten(microbatches)
    # the collected tree's structure, from a stage-free probe of collect
    out_spec = pytree.tree_flatten(collect(microbatches))[1]
    run = dict(stage_fn=stage_fn, mesh=mesh, axis=axis, collect=collect,
               n_params=len(p_leaves), p_spec=p_spec, mb_spec=mb_spec)
    outs = _Schedule.apply(run, *p_leaves, *mb_leaves)
    return pytree.tree_unflatten(list(outs), out_spec)


def pipeline_loss(stage_fn: Callable[[Any, Any], Any], stacked_params: Any,
                  microbatches: Any, loss_fn: Callable[[Any], torch.Tensor],
                  mesh, axis: str = PIPE_AXIS) -> torch.Tensor:
    """Pipeline forward + scalar loss: ``loss_fn`` (outputs (M, ...) →
    scalar) runs on the broadcast outputs, the same on every rank.  Its
    gradient (each rank's backward of its copy) is the gradient of the
    one loss: the last stage seeds the outputs' cotangent once."""
    return loss_fn(pipeline_apply(stage_fn, stacked_params, microbatches,
                                  mesh, axis))
