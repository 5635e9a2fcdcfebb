"""Contextual bandit learner.

The PyTorch port of the JAX package's ``models/online/bandit.py``: the
learner is :func:`.sgd.train_sgd` on the ``device`` param, over the
``mesh`` (a ``ProcessMesh``) when one is given.

Re-designs the reference's VW contextual-bandit estimator (reference:
vw/.../VowpalWabbitContextualBandit.scala:1-376: schema = shared context
features + per-action features + chosen action/cost/probability columns).
Learning is IPS-weighted cost regression on the chosen action's feature
vector (VW's ``cb_type ips`` reduction to regression): each logged row
contributes an importance weight 1/p(action), and the policy scores every
action in one batched matmul at decision time.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...core.dataset import Dataset
from ...core.params import (BoolParam, FloatParam, IntParam, PyObjectParam,
                            StringParam)
from ...core.pipeline import Estimator, Model
from .estimators import _SGDModelState
from .sgd import SGDConfig, _check_mesh, predict_margin, train_sgd


class _BanditParams:
    device = StringParam(doc="device to train and score on: 'cuda' "
                             "(raises when no card is present) or 'cpu'",
                         default="cuda")
    sharedCol = StringParam(doc="shared context feature-vector column",
                            default="shared")
    featuresCol = StringParam(doc="list-of-action feature-vector column",
                              default="features")
    chosenActionCol = StringParam(doc="1-based chosen action index column",
                                  default="chosenAction")
    labelCol = StringParam(doc="observed cost column", default="label")
    probabilityCol = StringParam(doc="logged P(chosen action) column",
                                 default="probability")
    predictionCol = StringParam(doc="per-action score output",
                                default="prediction")
    learningRate = FloatParam(doc="base learning rate", default=0.5)
    powerT = FloatParam(doc="t-decay exponent", default=0.5)
    l1 = FloatParam(doc="L1 regularization", default=0.0)
    l2 = FloatParam(doc="L2 regularization", default=0.0)
    numPasses = IntParam(doc="passes over the data", default=1)
    batchSize = IntParam(doc="rows per update step", default=32)
    epsilon = FloatParam(doc="exploration rate for the served policy",
                         default=0.05)
    ipsClip = FloatParam(doc="importance weight cap (0 = uncapped)",
                         default=0.0)
    useInteractions = BoolParam(doc="include shared x action quadratic "
                                "features (VW -q sa)", default=True)
    useBarrierExecutionMode = BoolParam(doc="parity", default=False)
    mesh = PyObjectParam(doc="ProcessMesh for data-parallel training "
                             "over a torch.distributed group")


def _row_features(shared: Optional[np.ndarray], action: np.ndarray,
                  interactions: bool) -> np.ndarray:
    """Chosen-action example = [action ++ shared ++ vec(shared ⊗ action)].
    The quadratic block is VW's ``-q sa`` namespace interaction — without
    it a linear scorer cannot express action-dependent context effects."""
    if shared is None:
        return action
    parts = [action, shared]
    if interactions:
        parts.append(np.outer(shared, action).ravel())
    return np.concatenate(parts)


class ContextualBandit(_BanditParams, Estimator):
    def __init__(self, **kw):
        super().__init__(**kw)

    def _fit(self, ds: Dataset) -> "ContextualBanditModel":
        _check_mesh(self.get("mesh"), self.device)
        n = ds.num_rows
        actions_col = ds[self.featuresCol]
        shared_col = ds[self.sharedCol] if self.sharedCol in ds else None
        chosen = ds[self.chosenActionCol].astype(np.int64) - 1  # 1-based
        cost = ds[self.labelCol].astype(np.float32)
        prob = ds[self.probabilityCol].astype(np.float32)
        xs: List[np.ndarray] = []
        for i in range(n):
            acts = [np.asarray(a, np.float32).ravel() for a in actions_col[i]]
            sh = (np.asarray(shared_col[i], np.float32).ravel()
                  if shared_col is not None else None)
            xs.append(_row_features(sh, acts[chosen[i]], self.useInteractions))
        x = np.stack(xs)
        iw = 1.0 / np.maximum(prob, 1e-6)
        if self.ipsClip > 0:
            iw = np.minimum(iw, self.ipsClip)
        cfg = SGDConfig(loss="squared", learning_rate=self.learningRate,
                        power_t=self.powerT, l1=self.l1, l2=self.l2,
                        num_passes=self.numPasses, batch_size=self.batchSize)
        state, stats = train_sgd(x, cost, cfg, sample_weight=iw,
                                 mesh=self.get("mesh"), device=self.device)
        model = ContextualBanditModel()
        model._copy_values_from(self)
        model.clear("mesh")
        model.state = state
        model.training_stats = stats
        return model


class ContextualBanditModel(_SGDModelState, _BanditParams, Model):
    def _transform(self, ds: Dataset) -> Dataset:
        """Score every action; output predicted cost per action plus the
        greedy (cost-minimizing) action and its epsilon-greedy probability
        vector."""
        actions_col = ds[self.featuresCol]
        shared_col = ds[self.sharedCol] if self.sharedCol in ds else None
        scores_out, best_out, pmf_out = [], [], []
        eps = self.epsilon
        state = self._state_on_device()
        for i in range(ds.num_rows):
            acts = [np.asarray(a, np.float32).ravel() for a in actions_col[i]]
            sh = (np.asarray(shared_col[i], np.float32).ravel()
                  if shared_col is not None else None)
            x = np.stack([_row_features(sh, a, self.useInteractions) for a in acts])
            scores = predict_margin(state, x)
            k = len(acts)
            best = int(np.argmin(scores))
            pmf = np.full(k, eps / k)
            pmf[best] += 1.0 - eps
            scores_out.append(scores.astype(np.float64))
            best_out.append(best + 1)  # 1-based like the input schema
            pmf_out.append(pmf)
        return ds.with_columns({
            self.predictionCol: scores_out,
            "chosenActionOut": np.asarray(best_out, np.int64),
            "probabilities": pmf_out,
        })
