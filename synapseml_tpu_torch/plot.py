"""Evaluation plots: confusion matrix and ROC curve.

The PyTorch port's copy of the JAX package's ``plot.py``, the
counterpart of the reference's pyspark plotting helpers
(reference: core/src/main/python/synapse/ml/plot/plot.py:18,56).  The
metric computation is pure numpy (no sklearn) and always returned, so the
functions work headless; rendering happens only when matplotlib is
importable and ``show`` is not disabled.

The scalar AUC is the port's ``models.gbdt.metrics.auc``.

Accepts a :class:`synapseml_tpu_torch.core.Dataset`, a pandas DataFrame, or any
mapping of column name → array.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .core.dataset import Dataset

__all__ = ["confusion_matrix", "roc_curve", "confusionMatrix", "roc"]


def _columns(df: Any, *cols: str) -> Tuple[np.ndarray, ...]:
    return tuple(np.asarray(df[c]) for c in cols)


def confusion_matrix(df: Any, y_col: str, y_hat_col: str,
                     labels: Sequence[Any],
                     plot: bool = True) -> Dict[str, Any]:
    """Counts[i, j] = rows with true label ``labels[i]`` predicted ``labels[j]``.

    Returns {"matrix", "normalized", "accuracy"}; additionally renders a
    heatmap if matplotlib is available and ``plot`` is True.
    """
    y, y_hat = _columns(df, y_col, y_hat_col)
    labels = list(labels)
    index = {lab: i for i, lab in enumerate(labels)}
    k = len(labels)
    cm = np.zeros((k, k), dtype=np.int64)
    for t, p in zip(y, y_hat):
        ti, pi = index.get(t), index.get(p)
        if ti is not None and pi is not None:
            cm[ti, pi] += 1
    row_sums = np.maximum(cm.sum(axis=1, keepdims=True), 1)
    cmn = cm.astype(np.float64) / row_sums
    # accuracy over the rows the matrix counts, so trace/sum is consistent
    accuracy = float(np.trace(cm)) / max(int(cm.sum()), 1)
    result = {"matrix": cm, "normalized": cmn, "accuracy": accuracy}
    if plot:
        _render_confusion(cm, cmn, labels, accuracy)
    return result


def _render_confusion(cm, cmn, labels, accuracy) -> None:
    try:
        import matplotlib.pyplot as plt
    except Exception:
        return
    tick_marks = np.arange(len(labels))
    plt.text(-0.3, -0.55, f"Accuracy = {round(accuracy * 100, 1)}%",
             fontsize=18)
    plt.xticks(tick_marks, labels, rotation=0)
    plt.yticks(tick_marks, labels, rotation=90)
    plt.imshow(cmn, interpolation="nearest", cmap="Blues", vmin=0, vmax=1)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            plt.text(j, i, cm[i, j], horizontalalignment="center",
                     fontsize=18,
                     color="white" if cmn[i, j] > 0.1 else "black")
    plt.colorbar()
    plt.xlabel("Predicted Label", fontsize=18)
    plt.ylabel("True Label", fontsize=18)


def roc_curve(df: Any, y_col: str, y_hat_col: str, thresh: float = 0.5,
              plot: bool = True) -> Dict[str, np.ndarray]:
    """ROC of score column ``y_hat_col`` against binarized ``y_col``.

    True labels are binarized at ``thresh`` (mirroring the reference's
    ``f2i``); the score column is swept over every distinct value.
    Returns {"fpr", "tpr", "thresholds", "auc"}.
    """
    y_raw, scores = _columns(df, y_col, y_hat_col)
    y = (np.asarray(y_raw, dtype=np.float64) > thresh).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)

    order = np.argsort(-scores, kind="stable")
    y_sorted, s_sorted = y[order], scores[order]
    # cut only where the score changes so tied scores share one point
    distinct = np.where(np.diff(s_sorted))[0]
    cuts = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y_sorted)[cuts].astype(np.float64)
    fps = (cuts + 1) - tps
    n_pos = max(float(y.sum()), 1.0)
    n_neg = max(float(y.size - y.sum()), 1.0)
    fpr = np.r_[0.0, fps / n_neg]
    tpr = np.r_[0.0, tps / n_pos]
    thresholds = np.r_[np.inf, s_sorted[cuts]]
    # scalar AUC via the shared rank-statistic helper (one implementation
    # package-wide; the curve above is only for rendering)
    from .models.gbdt.metrics import auc as _auc
    auc = _auc(y, scores)
    if plot:
        try:
            import matplotlib.pyplot as plt
            plt.plot(fpr, tpr)
            plt.xlabel("False Positive Rate", fontsize=20)
            plt.ylabel("True Positive Rate", fontsize=20)
        except Exception:
            pass
    return {"fpr": fpr, "tpr": tpr, "thresholds": thresholds, "auc": auc}


#: reference-compatible camelCase aliases (plot.py:18,56)
confusionMatrix = confusion_matrix
roc = roc_curve
