"""Boosting objectives: ``(scores, labels, weights) -> (grad, hess)``.

The PyTorch port of the JAX package's ``models/gbdt/objectives.py``:
``binary`` (logistic), the regression objectives (L2, L1, huber, fair,
poisson, quantile, mape, gamma, tweedie), the multiclass softmax and the
multiclassova per-class sigmoid, plus the ``boost_from_average`` initial
score.  Each is elementwise torch on the scores' device.  lambdarank
needs the query groups: :func:`.ranking.make_lambdarank_objective`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

ObjectiveFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def binary(scores, labels, weights):
    p = torch.sigmoid(scores)
    grad = (p - labels) * weights
    hess = torch.clamp_min(p * (1.0 - p), 1e-16) * weights
    return grad, hess


def regression(scores, labels, weights):
    return (scores - labels) * weights, weights


def regression_l1(scores, labels, weights):
    # LightGBM's constant hessian for L1
    return torch.sign(scores - labels) * weights, weights


def huber(scores, labels, weights, alpha=0.9):
    diff = scores - labels
    small = torch.abs(diff) <= alpha
    grad = torch.where(small, diff, alpha * torch.sign(diff)) * weights
    hess = torch.where(small, 1.0, 1e-2) * weights
    return grad, hess


def fair(scores, labels, weights, c=1.0):
    diff = scores - labels
    grad = c * diff / (torch.abs(diff) + c) * weights
    hess = c * c / (torch.abs(diff) + c) ** 2 * weights
    return grad, hess


def poisson(scores, labels, weights):
    exp_s = torch.exp(scores)
    return (exp_s - labels) * weights, exp_s * weights


def quantile(scores, labels, weights, alpha=0.5):
    diff = scores - labels
    grad = torch.where(diff >= 0, 1.0 - alpha, -alpha) * weights
    return grad, weights


def mape(scores, labels, weights):
    safe = torch.clamp_min(torch.abs(labels), 1.0)
    grad = torch.sign(scores - labels) / safe * weights
    return grad, weights / safe


def gamma(scores, labels, weights):
    exp_s = torch.exp(-scores)
    grad = (1.0 - labels * exp_s) * weights
    hess = labels * exp_s * weights
    return grad, torch.clamp_min(hess, 1e-16)


def tweedie(scores, labels, weights, rho=1.5):
    exp1 = torch.exp((1.0 - rho) * scores)
    exp2 = torch.exp((2.0 - rho) * scores)
    grad = (-labels * exp1 + exp2) * weights
    hess = (-labels * (1.0 - rho) * exp1 + (2.0 - rho) * exp2) * weights
    return grad, torch.clamp_min(hess, 1e-16)


OBJECTIVES: Dict[str, ObjectiveFn] = {
    "binary": binary,
    "regression": regression,
    "regression_l2": regression,
    "mean_squared_error": regression,
    "mse": regression,
    "regression_l1": regression_l1,
    "mae": regression_l1,
    "huber": huber,
    "fair": fair,
    "poisson": poisson,
    "quantile": quantile,
    "mape": mape,
    "gamma": gamma,
    "tweedie": tweedie,
}


def softmax_grad_hess(scores, labels_onehot, weights):
    """Multiclass softmax: scores (n, K) → grad/hess (n, K) (LightGBM's
    'multiclass')."""
    p = torch.softmax(scores, dim=-1)
    grad = (p - labels_onehot) * weights[:, None]
    hess = torch.clamp_min(2.0 * p * (1.0 - p), 1e-16) * weights[:, None]
    return grad, hess


def ova_grad_hess(scores, labels_onehot, weights):
    """multiclassova: an independent sigmoid loss per class, (n, K)."""
    pk = torch.sigmoid(scores)
    grad = (pk - labels_onehot) * weights[:, None]
    hess = torch.clamp_min(pk * (1.0 - pk), 1e-16) * weights[:, None]
    return grad, hess


def get_objective(name: str) -> ObjectiveFn:
    if name in OBJECTIVES:
        return OBJECTIVES[name]
    if name == "lambdarank":
        raise ValueError("lambdarank needs the query groups: build it with "
                         "ranking.make_lambdarank_objective")
    raise NotImplementedError(
        f"objective {name!r} is not one this package trains; known: "
        f"{sorted(OBJECTIVES) + ['lambdarank']}")


def objective_kwargs(objective: str, config) -> Dict[str, float]:
    """The config values an objective takes (the JAX package's
    ``_step_factory_args``)."""
    if objective in ("huber", "quantile"):
        return {"alpha": config.alpha}
    if objective == "fair":
        return {"c": config.fair_c}
    if objective == "tweedie":
        return {"rho": config.tweedie_variance_power}
    return {}


def initial_score(objective: str, labels, weights) -> float:
    """``boost_from_average`` init margin (host-side float64).
    ``weights=None`` means unit weights, with the same result as a vector
    of ones (x * 1.0 and a sum of ones are exact) and no such vector."""
    labels = np.asarray(labels, np.float64)
    if weights is None:
        mean = float(labels.sum() / max(float(len(labels)), 1e-12))
    else:
        weights = np.asarray(weights, np.float64)
        mean = float((labels * weights).sum() / max(weights.sum(), 1e-12))
    if objective == "binary":
        mean = min(max(mean, 1e-6), 1 - 1e-6)
        return float(np.log(mean / (1 - mean)))
    if objective in ("poisson", "gamma", "tweedie"):
        return float(np.log(max(mean, 1e-12)))
    if objective in ("regression_l1", "mae", "quantile"):
        return float(np.median(labels))
    return mean
