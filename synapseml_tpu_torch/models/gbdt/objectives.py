"""Boosting objectives: ``(scores, labels, weights) -> (grad, hess)``.

The PyTorch port of the JAX package's ``models/gbdt/objectives.py`` for
the objectives this slice trains: ``binary`` (logistic) and
``regression`` (L2), plus the ``boost_from_average`` initial score.  The
other regression objectives and multiclass softmax are not ported yet.
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


OBJECTIVES: Dict[str, ObjectiveFn] = {
    "binary": binary,
    "regression": regression,
    "regression_l2": regression,
    "mean_squared_error": regression,
    "mse": regression,
}


def get_objective(name: str) -> ObjectiveFn:
    if name in OBJECTIVES:
        return OBJECTIVES[name]
    raise NotImplementedError(
        f"objective {name!r} is not ported yet (ROADMAP queue A, GBDT "
        f"breadth); ported: {sorted(OBJECTIVES)}")


def initial_score(objective: str, labels, weights) -> float:
    """``boost_from_average`` init margin (host-side float64)."""
    labels = np.asarray(labels, np.float64)
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
