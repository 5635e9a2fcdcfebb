"""Evaluation metrics for boosting.

The PyTorch port of the JAX package's ``models/gbdt/metrics.py``: AUC,
binary and multiclass log loss and error, L2/RMSE, L1, MAPE, NDCG@k
and the default metric of each objective.  Each is one float64 torch
function on the tensors' device (:data:`DEVICE_METRICS`), which a fit's
validation evaluates without copying the margins to the host (AUC and
NDCG included: no shape depends on the data, so nothing syncs).
:data:`METRICS` and the names :func:`auc`, :func:`l2`, ... call the same
functions on numpy arrays, on the CPU; :func:`ndcg_at` takes either.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def default_metric(objective: str, num_class: int) -> str:
    if objective == "binary":
        return "binary_logloss"
    if objective in ("multiclass", "multiclassova"):
        return "multi_logloss"
    if objective in ("regression_l1", "mae"):
        return "l1"
    if objective == "lambdarank":
        return "ndcg"
    return "l2"


# -- the metrics, on the tensors' device --------------------------------------

def _wmean_t(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        return x.mean()
    w = w.double()
    return (x * w).sum() / torch.clamp_min(w.sum(), 1e-12)


def auc_t(labels, margin, weights=None) -> torch.Tensor:
    """The rank-sum AUC, ties at their average rank.  A row ends its tie
    group where the next sorted margin differs; each group's sums are
    read from running sums at its end and at the previous group's end
    (a running max of end indices), so every shape is N and nothing
    waits on the data.  Scans and reductions of fixed order: a run
    repeats exactly."""
    m = margin.double()
    order = torch.argsort(m, stable=True)
    m = m[order]
    y = labels.double()[order] > 0
    w = (torch.ones_like(m) if weights is None
         else weights.double()[order])
    pos, neg = y * w, (~y) * w
    total_pos, total_neg = pos.sum(), neg.sum()
    idx = torch.arange(m.shape[0], device=m.device)
    is_end = torch.cat([m[1:] != m[:-1], torch.ones_like(m[:1], dtype=bool)])
    # row i's previous group end, -1 in the first group
    prev = torch.cummax(torch.where(is_end, idx, -1), 0).values
    prev = torch.cat([torch.full_like(prev[:1], -1), prev[:-1]]) + 1
    zero = torch.zeros(1, dtype=m.dtype, device=m.device)
    cpos = torch.cat([zero, torch.cumsum(pos, 0)])   # sums of the first k
    cneg = torch.cat([zero, torch.cumsum(neg, 0)])
    neg_before = cneg[prev]
    tie_pos = cpos[idx + 1] - cpos[prev]
    tie_neg = cneg[idx + 1] - neg_before
    s = torch.where(is_end, tie_pos * (neg_before + tie_neg / 2.0),
                    torch.zeros_like(m)).sum()
    return torch.where((total_pos == 0) | (total_neg == 0),
                       torch.full_like(s, 0.5),
                       s / (total_pos * total_neg))


def binary_logloss_t(labels, margin, weights=None) -> torch.Tensor:
    p = torch.clamp(torch.sigmoid(margin.double()), 1e-15, 1 - 1e-15)
    y = labels.double()
    return _wmean_t(-(y * torch.log(p) + (1 - y) * torch.log(1 - p)),
                    weights)


def binary_error_t(labels, margin, weights=None) -> torch.Tensor:
    return _wmean_t(((margin > 0).double() != labels.double()).double(),
                    weights)


def multi_logloss_t(labels, margin, weights=None) -> torch.Tensor:
    p = torch.softmax(margin.double(), dim=1)
    y = labels.long()
    py = p.gather(1, y[:, None])[:, 0]
    return _wmean_t(-torch.log(torch.clamp_min(py, 1e-15)), weights)


def multi_error_t(labels, margin, weights=None) -> torch.Tensor:
    return _wmean_t((margin.argmax(dim=1) != labels.long()).double(),
                    weights)


def l2_t(labels, pred, weights=None) -> torch.Tensor:
    d = pred.double() - labels.double()
    return _wmean_t(d * d, weights)


def rmse_t(labels, pred, weights=None) -> torch.Tensor:
    return torch.sqrt(l2_t(labels, pred, weights))


def l1_t(labels, pred, weights=None) -> torch.Tensor:
    return _wmean_t((pred.double() - labels.double()).abs(), weights)


def mape_t(labels, pred, weights=None) -> torch.Tensor:
    y = labels.double()
    return _wmean_t((pred.double() - y).abs()
                    / torch.clamp_min(y.abs(), 1.0), weights)


class GroupGrid:
    """Query groups of a flat row order as a padded ``(Q, Dmax)`` grid
    on ``device``: ``idx`` the rows (0 on pads) and ``mask`` the real
    slots.  ``Dmax`` is the largest group: NDCG is never truncated."""

    def __init__(self, groups, device="cpu"):
        sizes = np.asarray(groups, np.int64).reshape(-1)
        sizes = sizes[sizes > 0]            # empty groups are skipped
        D = int(sizes.max()) if len(sizes) else 1
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        pos = np.arange(D)
        mask = pos[None, :] < sizes[:, None]
        dev = torch.device(device)
        self.idx = torch.as_tensor(np.where(mask, starts[:, None] + pos, 0),
                                   device=dev)
        self.mask = torch.as_tensor(mask, device=dev)


def ndcg_t(labels, scores, groups, weights=None, k: int = 10):
    """Mean NDCG@k over the query groups (a :class:`GroupGrid`, or the
    group sizes in row order), the JAX package's ``ndcg_at``: each group
    ranks its rows by descending score (stable: ties in row order), gains
    ``2^y - 1``, discounts ``1 / log2(position + 2)`` over the first k,
    divided by the ideal order's; a group with zero ideal DCG counts as
    1.0.  No group, 1.0.  ``weights`` are ignored, as there."""
    if not isinstance(groups, GroupGrid):
        groups = GroupGrid(groups, scores.device)
    g = groups
    if g.mask.shape[0] == 0:
        return torch.ones((), dtype=torch.float64, device=scores.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64,
                       device=scores.device)
    y = labels.double()[g.idx]
    s = torch.where(g.mask, -scores.double()[g.idx], inf)
    D = g.mask.shape[1]
    pos = torch.arange(D, device=scores.device)
    disc = torch.where((pos[None, :] < k) & g.mask,
                       1.0 / torch.log2(pos.double() + 2.0)[None, :],
                       torch.zeros((), dtype=torch.float64,
                                   device=scores.device))
    gain = torch.pow(2.0, y) - 1.0

    def dcg(order):
        return (gain.gather(1, order) * disc).sum(1)

    got = dcg(torch.argsort(s, dim=1, stable=True))
    ideal = dcg(torch.argsort(torch.where(g.mask, -y, inf), dim=1,
                              stable=True))
    per = torch.where(ideal > 0, got / torch.where(ideal > 0, ideal, 1.0),
                      torch.ones_like(got))
    return per.mean()


def ndcg_at(k: int):
    """``fn(labels, scores, groups, weights=None)`` → mean NDCG@k: a 0-dim
    float64 tensor on the scores' device for tensors, a float for numpy
    arrays (computed on the CPU)."""
    def ndcg(labels, scores, groups, weights=None):
        if torch.is_tensor(scores):
            return ndcg_t(labels, scores, groups, weights, k)
        return float(ndcg_t(torch.as_tensor(np.asarray(labels)),
                            torch.as_tensor(np.asarray(scores)), groups,
                            None, k))
    ndcg.__name__ = f"ndcg_at_{k}"
    return ndcg


#: metric name -> (fn(labels, margin_or_pred, weights) → 0-dim float64
#: tensor, larger_is_better), on the tensors' device; ``ndcg`` also takes
#: the groups: ``fn(labels, scores, groups, weights, k)``
DEVICE_METRICS: Dict[str, tuple] = {
    "auc": (auc_t, True),
    "binary_logloss": (binary_logloss_t, False),
    "binary_error": (binary_error_t, False),
    "multi_logloss": (multi_logloss_t, False),
    "multi_error": (multi_error_t, False),
    "l2": (l2_t, False),
    "mse": (l2_t, False),
    "rmse": (rmse_t, False),
    "l1": (l1_t, False),
    "mae": (l1_t, False),
    "mape": (mape_t, False),
    "ndcg": (ndcg_t, True),
}


def _on_host(fn: Callable) -> Callable:
    """``fn`` over numpy arrays (or lists) on the CPU → a float."""
    def host(labels, margin, weights=None) -> float:
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a))
        return float(fn(t(labels), t(margin),
                        None if weights is None else t(weights)))
    host.__name__ = host.__qualname__ = fn.__name__[:-2]
    host.__doc__ = fn.__doc__
    return host


#: metric name -> (fn(labels, margin_or_pred, weights) → float,
#: larger_is_better), over numpy arrays
METRICS: Dict[str, tuple] = {name: (_on_host(fn), larger)
                             for name, (fn, larger) in DEVICE_METRICS.items()
                             if name != "ndcg"}
auc, binary_logloss, binary_error, multi_logloss, multi_error, l2, rmse, \
    l1, mape = (METRICS[k][0] for k in (
        "auc", "binary_logloss", "binary_error", "multi_logloss",
        "multi_error", "l2", "rmse", "l1", "mape"))
