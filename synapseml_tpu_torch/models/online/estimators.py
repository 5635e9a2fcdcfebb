"""Online SGD estimator/model pipeline stages on one card.

The PyTorch port of the JAX package's ``models/online/estimators.py``
(the reference's VW Spark estimators: VowpalWabbitClassifier.scala,
VowpalWabbitRegressor.scala, VowpalWabbitBase.scala:45 passThroughArgs):
the same param surface (learningRate/powerT/l1/l2/numPasses/hashSeed),
plus ``device``; training is :func:`.sgd.train_sgd` on that device.
``mesh`` (a ``ProcessMesh``, called on every rank of the gang) trains
data-parallel: rows shard over its ``data`` axis and the states average
at the end of each pass, or after every batch's gradient with
``numSyncsPerPass`` > 0, as in the JAX package.
Models save their state as the JAX package's ``state.npz``, so a model
saved by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ...core.dataset import Dataset
from ...core.params import (BoolParam, DictParam, FloatParam, IntParam,
                            PyObjectParam, StringParam)
from ...core.pipeline import Estimator, Model
from ...device import resolve_device
from .sgd import (SGDConfig, SGDState, _check_mesh, predict_margin,
                  state_from_numpy, state_to, state_to_numpy, train_sgd)


class _OnlineSGDParams:
    device = StringParam(doc="device to train and score on: 'cuda' "
                             "(raises when no card is present) or 'cpu'",
                         default="cuda")
    featuresCol = StringParam(doc="dense vector column", default="features")
    labelCol = StringParam(doc="label column", default="label")
    weightCol = StringParam(doc="importance weight column")
    predictionCol = StringParam(doc="prediction output", default="prediction")
    learningRate = FloatParam(doc="base learning rate (VW -l)", default=0.5)
    powerT = FloatParam(doc="t-decay exponent (VW --power_t)", default=0.5)
    initialT = FloatParam(doc="schedule offset (VW --initial_t)", default=1.0)
    l1 = FloatParam(doc="L1 regularization (VW --l1)", default=0.0)
    l2 = FloatParam(doc="L2 regularization (VW --l2)", default=0.0)
    numPasses = IntParam(doc="passes over the data (VW --passes)", default=1)
    batchSize = IntParam(doc="rows per update step", default=32)
    adaptive = BoolParam(doc="AdaGrad per-coordinate rates", default=True)
    normalized = BoolParam(doc="scale-invariant updates", default=True)
    useBarrierExecutionMode = BoolParam(doc="parity: gang-schedule tasks",
                                        default=False)
    numSyncsPerPass = IntParam(doc="extra mid-pass weight averages "
                               "(VowpalWabbitSyncSchedule.scala); > 0 "
                               "averages every batch's gradient over a "
                               "mesh, as in the JAX package", default=0)
    hashSeed = IntParam(doc="featurizer hash seed", default=0)
    passThroughArgs = DictParam(doc="extra engine args (ParamsStringBuilder "
                                "pass-through analogue)")
    initialModel = PyObjectParam(doc="warm-start SGDState")

    def _config(self, loss: str, **over) -> SGDConfig:
        extra = dict(self.get_or_default("passThroughArgs") or {})
        extra.update(over)
        sync = 1 if self.numSyncsPerPass > 0 else 0
        return SGDConfig(
            loss=extra.pop("loss", loss),
            learning_rate=self.learningRate, power_t=self.powerT,
            initial_t=self.initialT, l1=self.l1, l2=self.l2,
            num_passes=self.numPasses, batch_size=self.batchSize,
            adaptive=self.adaptive, normalized=self.normalized,
            sync_every_batches=extra.pop("sync_every_batches", sync),
            **extra)

    def _xyw(self, ds: Dataset):
        x = ds.to_numpy([self.featuresCol], np.float32)
        y = ds[self.labelCol].astype(np.float32)
        w = (ds[self.weightCol].astype(np.float32)
             if self.is_set("weightCol") and self.weightCol in ds else None)
        return x, y, w


class _SGDModelState:
    """A fitted model's :class:`SGDState` (``state``) and its
    persistence as ``state.npz``."""

    state: Optional[SGDState] = None
    training_stats: Optional[dict] = None

    def _state_on_device(self) -> SGDState:
        return state_to(self.state, resolve_device(self.device))

    def _save_extra(self, path: str) -> None:
        np.savez(os.path.join(path, "state.npz"), **state_to_numpy(self.state))

    def _load_extra(self, path: str) -> None:
        with np.load(os.path.join(path, "state.npz")) as z:
            self.state = state_from_numpy({f: z[f] for f in SGDState._fields},
                                          "cpu")


def _fit_model(est, model, x, y, w, cfg):
    state, stats = train_sgd(x, y, cfg, sample_weight=w,
                             init=est.get("initialModel"),
                             mesh=est.get("mesh"), device=est.device)
    model._copy_values_from(est)
    model.clear("mesh")  # meshes are runtime handles, not model state
    model.state = state
    model.training_stats = stats
    return model


class OnlineSGDClassifier(_OnlineSGDParams, Estimator):
    """Binary linear classifier with logistic/hinge loss
    (VowpalWabbitClassifier analogue)."""

    lossFunction = StringParam(doc="logistic|hinge", default="logistic",
                               allowed=("logistic", "hinge"))
    probabilityCol = StringParam(doc="probability output", default="probability")
    rawPredictionCol = StringParam(doc="margin output", default="rawPrediction")
    mesh = PyObjectParam(doc="ProcessMesh for data-parallel training "
                             "over a torch.distributed group")

    def __init__(self, featuresCol: Optional[str] = None,
                 labelCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if featuresCol is not None:
            self.set("featuresCol", featuresCol)
        if labelCol is not None:
            self.set("labelCol", labelCol)

    def _fit(self, ds: Dataset) -> "OnlineSGDClassificationModel":
        _check_mesh(self.get("mesh"), self.device)
        x, y, w = self._xyw(ds)
        y_pm = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        return _fit_model(self, OnlineSGDClassificationModel(), x, y_pm, w,
                          self._config(self.lossFunction))


class OnlineSGDClassificationModel(_SGDModelState, _OnlineSGDParams, Model):
    lossFunction = StringParam(doc="logistic|hinge", default="logistic")
    probabilityCol = StringParam(doc="probability output", default="probability")
    rawPredictionCol = StringParam(doc="margin output", default="rawPrediction")
    mesh = PyObjectParam(doc="unused at predict")

    def _transform(self, ds: Dataset) -> Dataset:
        x = ds.to_numpy([self.featuresCol], np.float32)
        margin = predict_margin(self._state_on_device(), x)
        proba = 1.0 / (1.0 + np.exp(-margin))
        return ds.with_columns({
            self.rawPredictionCol: margin,
            self.probabilityCol: [np.array([1 - p, p]) for p in proba],
            self.predictionCol: (margin > 0).astype(np.float64),
        })


class OnlineSGDRegressor(_OnlineSGDParams, Estimator):
    """Linear regressor with squared/quantile/poisson loss
    (VowpalWabbitRegressor analogue)."""

    lossFunction = StringParam(doc="squared|quantile|poisson",
                               default="squared",
                               allowed=("squared", "quantile", "poisson"))
    quantileTau = FloatParam(doc="quantile loss tau", default=0.5)
    mesh = PyObjectParam(doc="ProcessMesh for data-parallel training "
                             "over a torch.distributed group")

    def __init__(self, featuresCol: Optional[str] = None,
                 labelCol: Optional[str] = None, **kw):
        super().__init__(**kw)
        if featuresCol is not None:
            self.set("featuresCol", featuresCol)
        if labelCol is not None:
            self.set("labelCol", labelCol)

    def _fit(self, ds: Dataset) -> "OnlineSGDRegressionModel":
        _check_mesh(self.get("mesh"), self.device)
        x, y, w = self._xyw(ds)
        cfg = self._config(self.lossFunction, quantile_tau=self.quantileTau)
        return _fit_model(self, OnlineSGDRegressionModel(), x, y, w, cfg)


class OnlineSGDRegressionModel(_SGDModelState, _OnlineSGDParams, Model):
    lossFunction = StringParam(doc="squared|quantile|poisson",
                               default="squared")
    quantileTau = FloatParam(doc="quantile loss tau", default=0.5)
    mesh = PyObjectParam(doc="unused at predict")

    def _transform(self, ds: Dataset) -> Dataset:
        x = ds.to_numpy([self.featuresCol], np.float32)
        margin = predict_margin(self._state_on_device(), x)
        if self.lossFunction == "poisson":
            margin = np.exp(margin)
        return ds.with_column(self.predictionCol, margin.astype(np.float64))
