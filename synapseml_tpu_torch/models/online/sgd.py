"""Online SGD on one card: VW's learn loop as minibatch steps in PyTorch.

The PyTorch port of the JAX package's ``models/online/sgd.py``.  One
step consumes a (B, D) dense block, computes margins with a matvec and
applies an AdaGrad-normalized update — VW's ``--adaptive --normalized
--invariant`` default triple, restated for batched hardware:

- *adaptive*: per-coordinate learning rate eta / (sum g^2)^power_t
- *normalized*: gradients scaled by the running max |x_d| so feature
  scales don't skew the step size
- the per-example t-schedule ``eta * (t0 / (t0 + t))^power_t``

The reference runs a pass as a ``lax.scan`` over ``(n_blocks, B, D)``
blocks that all sit on the device.  Here the blocked matrix is uploaded
once per fit and a pass walks it block by block: every step reads its
block through a device-side index (``index_select`` at a device counter
the step advances), updates the state tensors in place and adds to the
device loss and weight sums, so a pass makes no host sync; the sums and
``t`` are read once at the end of the fit.  On the card a chunk of
:data:`GRAPH_CHUNK` steps is captured once as a CUDA graph and replayed
(the counterpart of the compiled scan); the rest of the pass, and every
pass on the CPU, runs the same step eagerly.  Graph and eager run the same
kernels on the same buffers, so their states are bit-identical.

The state is f32, ``t`` included, as the reference keeps it.  The
reference has no Pallas kernel here, so the step is plain torch ops.

Over a :class:`~synapseml_tpu_torch.parallel.mesh.ProcessMesh`
(``train_sgd(mesh=...)``) the rows shard over the ``data`` axis as the
JAX package shards them (padded to whole blocks, with a mid-pass
schedule to whole chunks of k blocks; rank i holds the i-th contiguous
part), and ``sync_every_batches`` picks the schedule:

- 0: each rank walks its blocks, then the states are averaged, weighted
  by each rank's ``t``, with ``x_max`` the max over the ranks (one psum
  and one pmax at the end of each pass; ``t`` becomes the examples seen,
  where the JAX package doubles it, :func:`sync_state`);
- k > 1: the same average after every chunk of k blocks;
- 1: every step's gradient is averaged over the ranks inside the step,
  plus the pass-end average.

A collective cannot be captured in a CUDA graph, so on the card the
graphs replay between the syncs (the chunk captured is ``min(k,
GRAPH_CHUNK)`` steps under k > 1) and the all-reduces run outside them;
under schedule 1 every step runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device

#: steps captured in one CUDA graph (a pass replays it n_blocks // chunk
#: times and runs the remainder eagerly)
GRAPH_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    """VW arg-surface analogue (reference: VowpalWabbitBase.scala params
    learningRate/powerT/l1/l2/numPasses + passThroughArgs)."""
    loss: str = "squared"          # squared | logistic | hinge | quantile | poisson
    learning_rate: float = 0.5
    power_t: float = 0.5
    initial_t: float = 1.0
    l1: float = 0.0
    l2: float = 0.0
    num_passes: int = 1
    batch_size: int = 32
    adaptive: bool = True
    normalized: bool = True
    quantile_tau: float = 0.5
    link: str = "identity"         # identity | logistic
    #: average weights across shards every k batches (0 = only at pass
    #: end, 1 = the gradient of every batch); used only with a mesh
    sync_every_batches: int = 0


class SGDState(NamedTuple):
    w: torch.Tensor          # (D,) weights
    bias: torch.Tensor       # () bias
    g2: torch.Tensor         # (D,) adagrad accumulator
    g2_bias: torch.Tensor    # ()
    x_max: torch.Tensor      # (D,) running max |x| for normalization
    t: torch.Tensor          # () example counter, f32


def init_state(dim: int, device: DeviceLike = "cuda") -> SGDState:
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return SGDState(
        w=torch.zeros(dim, **f32), bias=torch.zeros((), **f32),
        g2=torch.full((dim,), 1e-6, **f32),
        g2_bias=torch.full((), 1e-6, **f32),
        x_max=torch.full((dim,), 1e-6, **f32), t=torch.zeros((), **f32))


def state_from_numpy(arrays, device: DeviceLike = "cuda") -> SGDState:
    """``{field: array}`` (or any object with the fields as attributes,
    such as the JAX package's ``SGDState``) → a state on ``device``."""
    dev = resolve_device(device)
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda f: getattr(arrays, f))
    return SGDState(**{f: torch.from_numpy(
        np.array(get(f), dtype=np.float32)).to(dev)
        for f in SGDState._fields})


def state_from_jax(jstate, device: DeviceLike = "cuda") -> SGDState:
    """The JAX package's ``SGDState`` (its arrays read as numpy) → the
    port's state on ``device``: how weights are carried across."""
    return state_from_numpy(jstate, device)


def state_to_numpy(state: SGDState) -> Dict[str, np.ndarray]:
    """The state as ``{field: f32 numpy array}``: ``SGDState(**{k:
    jnp.asarray(v)})`` gives the JAX package's state back."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in SGDState._fields}


def state_to(state: SGDState, device: torch.device) -> SGDState:
    return SGDState(*(t.to(device) for t in state))


def _loss_grad(loss: str, margin, y, tau: float):
    """d loss / d margin, elementwise.  Labels: logistic/hinge use ±1."""
    if loss == "squared":
        return margin - y
    if loss == "logistic":
        return -y / (1.0 + torch.exp(y * margin))
    if loss == "hinge":
        return torch.where(y * margin < 1.0, -y, torch.zeros_like(y))
    if loss == "quantile":
        return torch.where(margin > y, torch.full_like(y, 1.0 - tau),
                           torch.full_like(y, -tau))
    if loss == "poisson":
        return torch.exp(margin) - y
    raise ValueError(f"unknown loss {loss!r}")


def _loss_value(loss: str, margin, y, tau: float):
    if loss == "squared":
        return 0.5 * (margin - y) ** 2
    if loss == "logistic":
        return torch.log1p(torch.exp(-y * margin))
    if loss == "hinge":
        return torch.clamp(1.0 - y * margin, min=0.0)
    if loss == "quantile":
        e = y - margin
        return torch.where(e >= 0, tau * e, (tau - 1.0) * e)
    if loss == "poisson":
        return torch.exp(margin) - y * margin
    raise ValueError(f"unknown loss {loss!r}")


def make_scan_step(cfg: SGDConfig, grad_mean=None):
    """One minibatch update: ``step(state, block) -> (state, loss, wsum)``
    with ``block = (x (B, D), y (B,), sample_weight (B,), valid-mask
    (B,))``; ``loss`` and ``wsum`` are this block's weighted loss sum and
    weight sum (device scalars).  Functional: the inputs are not
    modified.  ``grad_mean`` (the mesh's schedule 1) averages the
    (D + 1,) weight and bias gradient across the ranks."""
    if cfg.loss not in ("squared", "logistic", "hinge", "quantile",
                        "poisson"):
        raise ValueError(f"unknown loss {cfg.loss!r}")

    def step(state: SGDState, block):
        x, y, sw, mask = block
        eff_w = sw * mask
        margin = torch.mv(x, state.w) + state.bias
        g_m = _loss_grad(cfg.loss, margin, y, cfg.quantile_tau) * eff_w
        w_sum = eff_w.sum()
        denom = torch.clamp(w_sum, min=1.0)
        grad_w = (x * g_m[:, None]).sum(0) / denom + cfg.l2 * state.w
        grad_b = g_m.sum() / denom
        if grad_mean is not None:
            both = grad_mean(torch.cat([grad_w, grad_b[None]]))
            grad_w, grad_b = both[:-1], both[-1]
        x_max = torch.maximum(state.x_max, x.abs().amax(0))
        if cfg.normalized:
            grad_w = grad_w / x_max
        g2 = state.g2 + grad_w ** 2
        g2_b = state.g2_bias + grad_b ** 2
        t = state.t + w_sum
        if cfg.adaptive:
            # VW --adaptive: the accumulator IS the schedule
            denom_w = g2 ** cfg.power_t
            denom_b = g2_b ** cfg.power_t
            step_w = cfg.learning_rate * grad_w / denom_w
            step_b = cfg.learning_rate * grad_b / denom_b
            shrink = (cfg.learning_rate * cfg.l1
                      / torch.clamp(denom_w, min=1e-12))
        else:
            eta = cfg.learning_rate * (cfg.initial_t
                                       / (cfg.initial_t + t)) ** cfg.power_t
            step_w = eta * grad_w
            step_b = eta * grad_b
            shrink = eta * cfg.l1
        w = state.w - step_w
        if cfg.l1 > 0:
            # truncated-gradient L1 (VW --l1): shrink toward zero
            w = torch.sign(w) * torch.clamp(w.abs() - shrink, min=0.0)
        loss = (_loss_value(cfg.loss, margin, y, cfg.quantile_tau)
                * eff_w).sum()
        return (SGDState(w=w, bias=state.bias - step_b, g2=g2, g2_bias=g2_b,
                         x_max=x_max, t=t), loss, w_sum)

    return step


def _pad_blocks(x: np.ndarray, y: np.ndarray, sw: np.ndarray,
                batch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    n, d = x.shape
    n_blocks = max(1, -(-n // batch))
    pad = n_blocks * batch - n
    if pad:
        x = np.concatenate([x, np.zeros((pad, d), x.dtype)])
        y = np.concatenate([y, np.zeros(pad, y.dtype)])
        sw = np.concatenate([sw, np.zeros(pad, sw.dtype)])
    mask = np.ones(n_blocks * batch, np.float32)
    if pad:
        mask[-pad:] = 0.0
    return (x.reshape(n_blocks, batch, d), y.reshape(n_blocks, batch),
            sw.reshape(n_blocks, batch), mask.reshape(n_blocks, batch))


class BlockPass:
    """One fit's device buffers and its pass: the blocked matrix, labels,
    weights and mask on the device, the state and the loss/weight sums
    as tensors updated in place, and the device block counter.

    :meth:`run_pass` walks every block once (``graph=True``: through the
    captured chunk on the card); :attr:`steps` counts the steps run."""

    def __init__(self, cfg: SGDConfig, state: SGDState, blocks,
                 device: torch.device, grad_mean=None,
                 chunk: int = GRAPH_CHUNK):
        self.cfg = cfg
        self.chunk = chunk
        self.device = device
        self.blocks = tuple(torch.from_numpy(np.ascontiguousarray(b))
                            .to(device) for b in blocks)
        self.n_blocks = int(self.blocks[0].shape[0])
        self.state = SGDState(*(t.detach().clone() for t in state))
        z = dict(dtype=torch.float32, device=device)
        self.loss_sum = torch.zeros((), **z)
        self.w_sum = torch.zeros((), **z)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self._step = make_scan_step(cfg, grad_mean)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.steps = 0

    def reset(self, state: SGDState) -> None:
        """Start over from ``state`` on the same buffers (a captured graph
        stays valid): copy it in and zero the sums and the step count."""
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        self.loss_sum.zero_()
        self.w_sum.zero_()
        self.steps = 0

    def _one(self) -> None:
        """One step in place: read block ``cursor``, update, advance."""
        x, y, sw, mask = (b.index_select(0, self.cursor)[0]
                          for b in self.blocks)
        new, loss, w_sum = self._step(self.state, (x, y, sw, mask))
        for dst, src in zip(self.state, new):
            dst.copy_(src)
        self.loss_sum.add_(loss)
        self.w_sum.add_(w_sum)
        self.cursor.add_(1)

    def _capture(self) -> None:
        """Capture ``chunk`` steps (:data:`GRAPH_CHUNK` by default).  The
        warm-up step runs on copies (it must not move the state), and a
        capture executes nothing, so the state and the sums are
        untouched."""
        saved = [t.clone() for t in (*self.state, self.loss_sum,
                                     self.w_sum, self.cursor)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._one()
        torch.cuda.current_stream(self.device).wait_stream(side)
        for dst, src in zip((*self.state, self.loss_sum, self.w_sum,
                             self.cursor), saved):
            dst.copy_(src)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(self.chunk):
                self._one()
        self.graph = graph

    def run_steps(self, count: int, graph: bool) -> None:
        """The next ``count`` blocks from the cursor: whole chunks through
        the captured graph on the card (``graph=True``), the rest
        eagerly."""
        n_graph = 0
        if graph and self.device.type == "cuda" and count >= self.chunk:
            if self.graph is None:
                self._capture()
            n_graph = count // self.chunk
            for _ in range(n_graph):
                self.graph.replay()
        for _ in range(count - n_graph * self.chunk):
            self._one()
        self.steps += count

    def run_pass(self, graph: bool) -> None:
        self.cursor.zero_()
        self.run_steps(self.n_blocks, graph)


def _check_mesh(mesh, device=None) -> None:
    """A mesh must be a ProcessMesh on the fit's device; checked before
    any work."""
    if mesh is None:
        return
    from ...parallel.mesh import ProcessMesh
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"mesh must be a ProcessMesh, got "
                        f"{type(mesh).__name__}")
    if device is not None and mesh.device != resolve_device(device):
        raise ValueError(f"the mesh's device {mesh.device} is not "
                         f"device={resolve_device(device)}")


def _shard_blocks(x, y, sw, cfg: SGDConfig, shards: int, rank: int):
    """This rank's blocks under the mesh: rows pad at the end (weight 0,
    mask 0) so each of the ``shards`` parts holds whole blocks and, under
    a mid-pass schedule k > 1, whole chunks of k blocks; rank i holds the
    i-th contiguous part (the JAX package's layout)."""
    n, d = x.shape
    unit = cfg.batch_size * max(1, cfg.sync_every_batches)
    per = -(-n // shards)
    per = -(-per // unit) * unit
    lo, hi = rank * per, (rank + 1) * per
    keep = slice(lo, min(hi, n))
    pad = hi - max(lo, min(hi, n))
    xs, ys, ws = x[keep], y[keep], sw[keep]
    mask = np.ones(len(ys), np.float32)
    if pad:
        xs = np.concatenate([xs, np.zeros((pad, d), np.float32)])
        ys = np.concatenate([ys, np.zeros(pad, np.float32)])
        ws = np.concatenate([ws, np.zeros(pad, np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, np.float32)])
    b = per // cfg.batch_size
    return (xs.reshape(b, cfg.batch_size, d), ys.reshape(b, cfg.batch_size),
            ws.reshape(b, cfg.batch_size), mask.reshape(b, cfg.batch_size))


def sync_state(state: SGDState, mesh, base_t: torch.Tensor) -> SGDState:
    """Cross-rank parameter averaging weighted by the examples each rank
    has seen (the JAX package's ``_sync_state``, mergeModels'
    analogue): one psum of the weighted w, g2, bias, g2_bias, the
    weights and the examples since the last sync, one pmax of ``x_max``;
    every rank gets the same state.  ``base_t``: ``t`` at the last sync
    (the same on every rank).

    Each rank weighs in with its ``t`` (``base_t`` plus its own examples
    since), as in the JAX package; the new ``t`` is ``base_t`` plus every
    rank's examples since, the examples seen.  The JAX package sets it
    to the sum of the ranks' ``t``, which counts ``base_t`` once a rank:
    it doubles at every sync on two ranks, reaches inf after ~128 syncs
    and then makes the averaged state NaN (ROADMAP queue C)."""
    from ...parallel.collectives import pmax, psum
    seen = torch.clamp_min(state.t, 1e-6)
    D = state.w.shape[0]
    packed = torch.cat([state.w * seen, state.g2 * seen,
                        torch.stack([state.bias * seen,
                                     state.g2_bias * seen, seen,
                                     state.t - base_t])])
    tot = psum(packed, mesh, op="sgd_sync_psum")
    total = tot[-2]
    return SGDState(w=tot[:D] / total, bias=tot[2 * D] / total,
                    g2=tot[D:2 * D] / total, g2_bias=tot[2 * D + 1] / total,
                    x_max=pmax(state.x_max, mesh),
                    t=base_t + tot[-1])


def train_sgd(x: np.ndarray, y: np.ndarray, cfg: SGDConfig,
              sample_weight: Optional[np.ndarray] = None,
              mesh=None, init: Optional[SGDState] = None,
              device: DeviceLike = "cuda", graph: bool = True):
    """Run ``cfg.num_passes`` passes on ``device``; returns ``(state,
    stats)`` with ``stats = {"average_loss", "examples"}``, read from the
    device once at the end.  ``graph=False`` keeps every step eager on the
    card.  ``mesh`` (a ProcessMesh on ``device``; every rank passes the
    full data) shards the rows over its ``data`` axis and syncs by
    ``cfg.sync_every_batches`` (the module docstring); every rank
    returns the same state, and the stats sum over the ranks."""
    _check_mesh(mesh, device)
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, np.float32)
    y = np.asarray(y, np.float32)
    sw = (np.asarray(sample_weight, np.float32) if sample_weight is not None
          else np.ones(len(y), np.float32))
    state = (state_to(init, dev) if init is not None
             else init_state(x.shape[1], dev))
    if mesh is None:
        run = BlockPass(cfg, state, _pad_blocks(x, y, sw, cfg.batch_size),
                        dev)
        for _ in range(cfg.num_passes):
            run.run_pass(graph)
        loss_sum, w_sum, t = torch.stack(
            [run.loss_sum, run.w_sum, run.state.t]).tolist()
        return run.state, {"average_loss": loss_sum / max(w_sum, 1e-12),
                           "examples": t}
    from ...parallel.collectives import pmean, psum
    from ...parallel.mesh import DATA_AXIS
    k = cfg.sync_every_batches
    blocks = _shard_blocks(x, y, sw, cfg, mesh.axis_size(DATA_AXIS),
                           mesh.axis_index(DATA_AXIS))
    run = BlockPass(cfg, state, blocks, dev, grad_mean=(
        (lambda g: pmean(g, mesh)) if k == 1
        else None), chunk=min(k, GRAPH_CHUNK) if k > 1 else GRAPH_CHUNK)

    def load(new: SGDState) -> None:
        for dst, src in zip(run.state, new):
            dst.copy_(src)

    for _ in range(cfg.num_passes):
        run.cursor.zero_()
        for count in ([k] * (run.n_blocks // k) if k > 1
                      else [run.n_blocks]):
            base_t = run.state.t.clone()
            run.run_steps(count, graph and k != 1)
            load(sync_state(run.state, mesh, base_t))
    sums = psum(torch.stack([run.loss_sum, run.w_sum]), mesh,
                op="sgd_loss_psum")
    loss_sum, w_sum, t = torch.cat([sums, run.state.t[None]]).tolist()
    return run.state, {"average_loss": loss_sum / max(w_sum, 1e-12),
                       "examples": t}


def predict_margin(state: SGDState, x: np.ndarray) -> np.ndarray:
    """``x @ w + bias`` on the state's device → numpy f32."""
    dev = state.w.device
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    return (torch.mv(xt, state.w) + state.bias).cpu().numpy()


def merge_states(states, weights=None) -> SGDState:
    """Parameter-average independently trained states
    (VowpalWabbitNative.mergeModels analogue), on the first state's
    device."""
    arrs = [state_to_numpy(s) for s in states]
    ws = np.asarray(weights if weights is not None
                    else [float(a["t"]) for a in arrs], np.float64)
    ws = ws / max(ws.sum(), 1e-12)

    def avg(field):
        return np.asarray(sum(a[field] * wi for a, wi in zip(arrs, ws)),
                          np.float32)
    merged = {f: avg(f) for f in ("w", "bias", "g2", "g2_bias")}
    merged["x_max"] = np.max([a["x_max"] for a in arrs], 0)
    merged["t"] = np.asarray(sum(float(a["t"]) for a in arrs), np.float32)
    return state_from_numpy(merged, states[0].w.device)
