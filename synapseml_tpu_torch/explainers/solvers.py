"""Weighted linear solvers used by LIME / Kernel SHAP, batched on a device.

Re-designs the reference's internal regression solvers (reference:
explainers/LassoRegression.scala, explainers/LeastSquaresRegression.scala —
private breeze-based solvers used by LIMEBase.scala:137 and
KernelSHAPBase.scala).  Here every problem of a transform is one slice of
a batch: ``x (B, S, D)``, ``y (B, S)`` and ``w (B, S)`` go to the device
once, weighted least squares is one batched ``torch.linalg.solve`` over
the ``(B, D, D)`` Grams, and lasso runs its ISTA steps as batched
``bmm``s with no host read inside the loop.

The sums, the Grams and the solves run in float64 and the results return
in float32.  Kernel SHAP pins its empty and full coalitions with weight
1e6 beside unit-weight rows: a float32 Gram's sums round the unit rows'
terms against the pinned rows', so float32 solves (the JAX package's,
on LAPACK; cuSOLVER's on a card) land 1-5% of scale from the exact
solution, each in its own direction.  In float64 the card and the CPU
agree to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import DeviceLike, resolve_device


class RegressionResult(NamedTuple):
    coefficients: torch.Tensor   # (B, D) float32
    intercept: torch.Tensor      # (B,)
    r_squared: torch.Tensor      # (B,)
    loss: torch.Tensor           # (B,)


def _centered(x, y, w):
    """Normalized weights, weighted means and the centered problem."""
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    xm = (w[..., None] * x).sum(1)                      # (B, D)
    ym = (w * y).sum(1)                                 # (B,)
    xc = x - xm[:, None, :]
    yc = y - ym[:, None]
    xw = (xc * w[..., None]).transpose(1, 2)            # (B, D, S)
    g = torch.bmm(xw, xc)                               # (B, D, D)
    b = torch.bmm(xw, yc[..., None])[..., 0]            # (B, D)
    return w, xm, ym, yc, g, b


def _fit_stats(x, y, w, yc, xm, ym, coef):
    intercept = ym - (xm * coef).sum(-1)
    pred = torch.bmm(x, coef[..., None])[..., 0] + intercept[:, None]
    ss_res = (w * (y - pred) ** 2).sum(1)
    ss_tot = (w * yc ** 2).sum(1)
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)
    return intercept, r2, ss_res


def _batch(x, y, sample_weight, device):
    """The problems as float64 tensors on the device."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev).to(torch.float64)
    y = torch.as_tensor(y, device=dev).to(torch.float64)
    w = (torch.ones_like(y) if sample_weight is None else
         torch.as_tensor(sample_weight, device=dev).to(torch.float64))
    return x, y, w


def _f32(*ts) -> RegressionResult:
    return RegressionResult(*(t.to(torch.float32) for t in ts))


def least_squares_batched(x, y, sample_weight=None, l2: float = 1e-6,
                          device: DeviceLike = "cuda") -> RegressionResult:
    """Weighted ridge-stabilized least squares with intercept for each of
    B problems: ``x (B, S, D)``, ``y (B, S)``, ``w (B, S)``."""
    x, y, w = _batch(x, y, sample_weight, device)
    w, xm, ym, yc, g, b = _centered(x, y, w)
    eye = torch.eye(x.shape[2], dtype=g.dtype, device=x.device)
    coef = torch.linalg.solve(g + l2 * eye, b)
    intercept, r2, ss_res = _fit_stats(x, y, w, yc, xm, ym, coef)
    return _f32(coef, intercept, r2, ss_res)


def lasso_batched(x, y, alpha: float, sample_weight=None, max_iter: int = 200,
                  device: DeviceLike = "cuda") -> RegressionResult:
    """Weighted lasso for each of B problems via proximal gradient (ISTA)
    with the fixed step ``1 / trace(G)`` of each problem's Gram."""
    x, y, w = _batch(x, y, sample_weight, device)
    w, xm, ym, yc, g, b = _centered(x, y, w)
    step = 1.0 / torch.clamp(
        torch.diagonal(g, dim1=1, dim2=2).sum(-1), min=1e-8)[:, None]
    coef = torch.zeros_like(b)
    for _ in range(int(max_iter)):
        grad = torch.bmm(g, coef[..., None])[..., 0] - b
        z = coef - step * grad
        coef = torch.sign(z) * torch.clamp(z.abs() - step * alpha, min=0.0)
    intercept, r2, ss_res = _fit_stats(x, y, w, yc, xm, ym, coef)
    return _f32(coef, intercept, r2, ss_res + alpha * coef.abs().sum(-1))


def _one(res: RegressionResult) -> RegressionResult:
    return RegressionResult(*(t[0] for t in res))


def _unsqueeze(v):
    return None if v is None else torch.as_tensor(v)[None]


def least_squares_regression(x, y, sample_weight=None, l2: float = 1e-6,
                             device: DeviceLike = "cuda") -> RegressionResult:
    """One problem: ``x (S, D)``, ``y (S,)`` → ``(D,)`` coefficients and
    scalar intercept, r² and loss."""
    return _one(least_squares_batched(_unsqueeze(x), _unsqueeze(y),
                                      _unsqueeze(sample_weight), l2, device))


def lasso_regression(x, y, alpha: float, sample_weight=None,
                     max_iter: int = 200,
                     device: DeviceLike = "cuda") -> RegressionResult:
    """One lasso problem: ``x (S, D)``, ``y (S,)``."""
    return _one(lasso_batched(_unsqueeze(x), _unsqueeze(y), alpha,
                              _unsqueeze(sample_weight), max_iter, device))
