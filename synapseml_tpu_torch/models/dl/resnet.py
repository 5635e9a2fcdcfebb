"""ResNet backbones for the vision classifier as ``nn.Module``s.

The PyTorch port of the JAX package's ``models/dl/resnet.py`` on one card.
The parameter and batch-statistic names are the flax trees'
(``conv_init.kernel``, ``bn_init.scale``, ``ResNetBlock_3.Conv_1.kernel``,
``BottleneckResNetBlock_0.norm_proj.mean``, ...) and so are the layouts:
a convolution kernel is ``(kh, kw, in, out)``, the head's ``(in, out)``.
Rematerialization renames nothing.

The input is NHWC, as in the reference; the model views it as NCHW in the
``channels_last`` memory format (the same bytes), so the convolutions run
channels-last.  The reference's conventions kept here:

- flax ``"SAME"`` padding: a stride-2 3×3 convolution or max-pool over an
  even input pads (0, 1), not torch's symmetric 1 (the pool pads with
  −∞); ``conv_init`` pads (3, 3) explicitly;
- BatchNorm with flax's ``momentum=0.9, epsilon=1e-5``: running = 0.9 ·
  running + 0.1 · batch, where the batch variance is flax's biased fast
  variance E[x²] − E[x]² in f32 (torch would fold in the unbiased
  variance).  A training forward computes the
  new statistics but leaves the buffers alone until
  :meth:`ResNet.commit_batch_stats`, so a rematerialized block that runs
  twice updates them once, as the reference's functional ``batch_stats``;
- the last norm of each block starts at scale 0;
- convolutions compute in ``dtype`` (bf16 by default) with f32 master
  weights; the head averages over H and W and applies an f32 ``Dense``.

On a card, a float32 convolution follows PyTorch's cuDNN setting
(``torch.backends.cudnn.allow_tf32``, on by default: TF32 products); set
it to False for IEEE f32.

Over a data mesh (``mesh=``, a training step's batch sharded over
``data``), BatchNorm takes the reference's GSPMD statistics: E[x] and
E[x²] over the GLOBAL batch.  :class:`_SyncBatchNormTrain` all-reduces
the per-channel f32 sums in the forward, and in the backward the sums of
``dy`` and ``dy·x̂`` that the input gradient needs (the parameters'
gradients stay this rank's sums, reduced with every other gradient by
the trainer).  The running statistics follow the global ones, so they
are the same on every rank.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, resolve_device
from ...parallel.mesh import DATA_AXIS, axis_size
from .precision import run_block
from .transformer import Dense, _param, init_weights, trunc_normal

#: flax's variance_scaling "truncated_normal" divides the std by this, so
#: the truncated draws keep the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_std(fan_in: int) -> float:
    """The truncated normal's std of flax ``lecun_normal()`` (variance
    1 / fan_in after truncation)."""
    return (1.0 / fan_in) ** 0.5 / _TRUNC_STD


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME" or explicit)``:
    ``kernel`` is ``(kh, kw, in, out)``; input and kernel are cast to
    ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int], dtype, device,
                 padding: Optional[Sequence[Tuple[int, int]]] = None):
        super().__init__()
        kh, kw = kernel
        self.kernel = _param((kh, kw, in_ch, out_ch), device)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        self.kernel.copy_(trunc_normal(self.kernel.shape, gen,
                                       lecun_std(kh * kw * cin)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        if self.padding is None:
            (ht, hb), (wl, wr) = (same_pads(x.shape[2], kh, self.strides[0]),
                                  same_pads(x.shape[3], kw, self.strides[1]))
        else:
            (ht, hb), (wl, wr) = self.padding
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        x = x.to(self.dtype)
        # a strided convolution pads its input explicitly: PyTorch's CPU
        # bf16 convolution leaves the weight gradient of a tap that only
        # ever reads implicit padding unwritten (a stride-2 3x3 over a
        # 1x1 map returns uninitialized memory there)
        if ht == hb and wl == wr and (self.strides == (1, 1)
                                      or ht == wl == 0):
            return F.conv2d(x, w, None, self.strides, (ht, wl))
        x = F.pad(x, (wl, wr, ht, hb)).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x, w, None, self.strides)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over NCHW with flax's statistics: the batch
    mean and the fast variance E[x²] − E[x]² (clipped at 0), both reduced
    in f32.  PyTorch's kernels normalize with those statistics and take
    the backward from the saved mean and 1 / sqrt(var + eps), so only the
    input is kept for the backward pass.  Returns (y, mean, var); the
    statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        del xf
        y = torch.ops.aten.native_batch_norm(x, scale, bias, mean, var,
                                             False, 0.0, eps)[0]
        ctx.save_for_backward(x, scale, mean, torch.rsqrt(var + eps))
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = torch.ops.aten.native_batch_norm_backward(
            dy, x, scale, None, None, mean, rstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return dx, dscale, dbias, None


class _SyncBatchNormTrain(torch.autograd.Function):
    """:class:`_BatchNormTrain` over a batch sharded on the mesh's
    ``data`` axis: the statistics are the global batch's.  Forward: one
    all-reduce of the per-channel ``[Σx, Σx²]`` (f32).  Backward: one
    all-reduce of ``[Σdy, Σdy·x̂]`` and ``dx = scale·rstd·(dy − Σdy/M −
    x̂·Σdy·x̂/M)`` over the global count M; ``dscale``/``dbias`` are this
    rank's sums."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, mesh):
        from ...parallel.collectives import psum
        xf = x.float()
        dims = (0, 2, 3)
        sums = psum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), mesh,
                    DATA_AXIS, op="bn_stats")
        del xf
        count = torch.tensor(float(x.numel() // x.shape[1]
                                   * mesh.axis_size(DATA_AXIS)),
                             device=x.device)
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        y = torch.ops.aten.native_batch_norm(x, scale, bias, mean, var,
                                             False, 0.0, eps)[0]
        ctx.save_for_backward(x, scale, mean, torch.rsqrt(var + eps), count)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        from ...parallel.collectives import psum
        x, scale, mean, rstd, count = ctx.saved_tensors
        dims = (0, 2, 3)

        def per_channel(v):
            return v[None, :, None, None]

        xhat = (x.float() - per_channel(mean)) * per_channel(rstd)
        dyf = dy.float()
        local = torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])
        total = psum(local, ctx.mesh, DATA_AXIS, op="bn_grad")
        dx = per_channel(scale * rstd) * (
            dyf - per_channel(total[0] / count)
            - xhat * per_channel(total[1] / count))
        return dx.to(x.dtype), local[1], local[0], None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=...)`` over
    NCHW: parameters ``scale``/``bias``, batch statistics ``mean``/``var``
    (buffers, f32).  In training the batch's statistics (flax's: f32
    reductions, the biased fast variance) normalize, and the running
    update waits in ``pending`` for :meth:`commit`.  With a :attr:`mesh`
    whose ``data`` axis is larger than 1, training statistics are the
    global batch's (:class:`_SyncBatchNormTrain`)."""

    def __init__(self, features: int, dtype, device,
                 zero_scale: bool = False, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.momentum = momentum
        self.eps = eps
        self.scale = _param((features,), device)
        self.bias = _param((features,), device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.pending: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.mesh = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)
        self.pending = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps
                                ).to(self.dtype)
        if axis_size(self.mesh, DATA_AXIS) > 1:
            y, mean, var = _SyncBatchNormTrain.apply(
                x, self.scale, self.bias, self.eps, self.mesh)
        else:
            y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                                 self.eps)
        m = self.momentum
        with torch.no_grad():
            self.pending = (m * self.mean + (1 - m) * mean,
                            m * self.var + (1 - m) * var)
        return y.to(self.dtype)

    @torch.no_grad()
    def commit(self) -> None:
        if self.pending is not None:
            self.mean.copy_(self.pending[0])
            self.var.copy_(self.pending[1])
            self.pending = None


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides, dtype, device):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, (3, 3), strides, dtype, device)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, (3, 3), (1, 1), dtype, device)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device, zero_scale=True)
        if in_ch != filters or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_ch, filters, (1, 1), strides, dtype,
                                  device)
            self.norm_proj = BatchNorm(filters, dtype, device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides, dtype, device):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_ch, filters, (1, 1), (1, 1), dtype, device)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, dtype, device)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device)
        self.Conv_2 = Conv(filters, out, (1, 1), (1, 1), dtype, device)
        self.BatchNorm_2 = BatchNorm(out, dtype, device, zero_scale=True)
        if in_ch != out or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_ch, out, (1, 1), strides, dtype,
                                  device)
            self.norm_proj = BatchNorm(out, dtype, device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(x NHWC, train)`` → logits (B, num_classes) f32.

    Weights are drawn as the reference draws them (lecun-normal kernels,
    BatchNorm scale 1 but 0 on each block's last norm, zero biases) from
    ``seed`` by :func:`~.transformer.init_weights`; with ``seed=None``
    they stay unset until the trainer's ``init_state`` draws them.
    ``mesh`` (a ProcessMesh) makes a training forward's BatchNorm
    statistics those of the batch sharded over its ``data`` axis."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int, num_filters: int = 64,
                 dtype: Any = torch.bfloat16, remat: Any = "none",
                 device: DeviceLike = "cuda", seed: Optional[int] = 0,
                 mesh=None):
        super().__init__()
        dev = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.dtype = dtype
        self.remat = remat
        self.conv_init = Conv(3, num_filters, (7, 7), (2, 2), dtype, dev,
                              padding=((3, 3), (3, 3)))
        self.bn_init = BatchNorm(num_filters, dtype, dev)
        self.block_names = []
        in_ch = num_filters
        k = 0
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                name = f"{block_cls.__name__}_{k}"
                setattr(self, name, block_cls(in_ch, filters, strides, dtype,
                                              dev))
                self.block_names.append(name)
                in_ch = filters * block_cls.expansion
                k += 1
        self.head = Dense(in_ch, num_classes, torch.float32, dev,
                          stddev=lecun_std(in_ch))
        self.mesh = mesh
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.mesh = mesh
        if seed is not None:
            self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        init_weights(self, seed)

    @property
    def device(self) -> torch.device:
        return self.head.kernel.device

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)           # NHWC bytes as channels_last
        x = F.relu(self.bn_init(self.conv_init(x), train))
        pt, pb = same_pads(x.shape[2], 3, 2)
        pl_, pr = same_pads(x.shape[3], 3, 2)
        x = F.pad(x, (pl_, pr, pt, pb), value=-float("inf"))
        x = F.max_pool2d(x.contiguous(memory_format=torch.channels_last), 3, 2)
        for name in self.block_names:
            x = run_block(getattr(self, name), self.remat, x, train)
        pooled = x.mean((2, 3))
        return self.head(pooled)

    def commit_batch_stats(self) -> None:
        """Write the running statistics the last training forward
        computed (the step's new ``batch_stats``)."""
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.commit()


BACKBONES = {
    "resnet18": functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                                  block_cls=ResNetBlock),
    "resnet34": functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                                  block_cls=ResNetBlock),
    "resnet50": functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                                  block_cls=BottleneckResNetBlock),
    "resnet101": functools.partial(ResNet, stage_sizes=(3, 4, 23, 3),
                                   block_cls=BottleneckResNetBlock),
    "resnet152": functools.partial(ResNet, stage_sizes=(3, 8, 36, 3),
                                   block_cls=BottleneckResNetBlock),
}


def make_backbone(name: str, num_classes: int, **kw) -> ResNet:
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; have {sorted(BACKBONES)}")
    return BACKBONES[name](num_classes=num_classes, **kw)
