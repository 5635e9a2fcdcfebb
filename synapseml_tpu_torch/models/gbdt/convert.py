"""Carry a model trained by the JAX package across to this package.

A model of either package is the version-2 JSON of ``Booster.to_dict()``
(trees as flat lists with their class and weight, the bin mapper's
bounds and categorical tables, the EFB bundler, the init score per
class, the config), so the conversion is a read of that JSON.
Multiclass models keep ``tree_class``, DART models their
``tree_weights``, RF models average their trees as in the JAX package,
and categorical models predict through bin space.  The reverse direction needs
nothing: this package's ``Booster.to_dict()`` emits the same schema,
which the JAX package's ``Booster.from_dict`` reads back.

The stages over the GBDT carry across the same way, from their plain
state: :func:`trained_model_from_reference` (``TrainClassifier`` /
``TrainRegressor``: the featurize plan, the label levels and the inner
booster's JSON), :func:`dml_model_from_reference` (the bootstrap
effects) and :func:`ortho_forest_model_from_reference` (the forest's
booster).
"""

from __future__ import annotations

from typing import Any, Dict

from ...device import DeviceLike
from .booster import Booster


def booster_from_reference(d: Dict[str, Any],
                           device: DeviceLike = "cuda") -> Booster:
    """The JAX package's ``Booster.to_dict()`` (plain JSON / numpy
    values) → this package's :class:`~.booster.Booster`, predicting on
    ``device``."""
    return Booster.from_dict(d, device=device)


def _inner_gbdt(state: Dict[str, Any], device: DeviceLike, regressor: bool):
    """The port's GBDT model around ``state["booster"]``."""
    from .estimators import GBDTClassificationModel, GBDTRegressionModel
    b = booster_from_reference(state["booster"], device=device)
    cols = {k: state[k] for k in ("featuresCol", "predictionCol")
            if state.get(k) is not None}
    if regressor:
        return GBDTRegressionModel(boosterModel=b, device=str(device),
                                   **cols)
    num_classes = max(b.num_class, 2)
    labels = state.get("classLabels")
    if labels is None:
        labels = [float(c) for c in range(num_classes)]
    return GBDTClassificationModel(boosterModel=b, device=str(device),
                                   numClasses=num_classes,
                                   classLabels=list(labels), **cols)


def trained_model_from_reference(state: Dict[str, Any],
                                 device: DeviceLike = "cuda"):
    """The JAX package's fitted ``TrainedClassifierModel`` /
    ``TrainedRegressorModel`` → the port's, its GBDT predicting on
    ``device``.

    ``state`` is the JAX model's plain state:

    - ``"plan"``: its ``FeaturizeModel``'s ``plan`` (with
      ``"imputeMissing"`` when not the default True);
    - ``"levels"``: the original label values by class index (None or
      absent for a regressor, or a classifier fit with
      ``reindexLabel=False``);
    - ``"booster"``: the inner GBDT's ``Booster.to_dict()``;
    - ``"regressor"``: True for a ``TrainedRegressorModel``;
    - optional ``"labelCol"``, ``"featuresCol"``, ``"predictionCol"`` and
      the inner classifier's ``"classLabels"`` (default 0..K-1, what a
      fit over indexed labels has).
    """
    from ...ops.featurize import FeaturizeModel
    from ...ops.train import TrainedClassifierModel, TrainedRegressorModel
    regressor = bool(state.get("regressor", False))
    default_features = ("TrainRegressor_features" if regressor
                        else "TrainClassifier_features")
    features = state.get("featuresCol") or default_features
    feat = FeaturizeModel(outputCol=features, plan=list(state["plan"]),
                          imputeMissing=bool(state.get("imputeMissing",
                                                       True)))
    inner = _inner_gbdt(dict(state, featuresCol=features), device,
                        regressor)
    common = dict(featurizer=feat, innerModel=inner, featuresCol=features,
                  labelCol=state.get("labelCol") or "label")
    if regressor:
        return TrainedRegressorModel(**common)
    model = TrainedClassifierModel(**common)
    if state.get("levels") is not None:
        model.set("levels", list(state["levels"]))
    return model


#: the DML params a carried model keeps (the JAX model's values)
_DML_PARAMS = ("treatmentCol", "outcomeCol", "featuresCol", "predictionCol",
               "probabilityCol")


def dml_model_from_reference(state: Dict[str, Any]):
    """The JAX package's fitted ``DoubleMLModel`` → the port's.  ``state``:
    ``"rawTreatmentEffects"`` (the bootstrap draws), optional
    ``"confidenceLevel"`` and the column params of :data:`_DML_PARAMS`.
    The model holds no nuisance model: its effects are host numbers."""
    from ...causal.dml import DoubleMLModel
    model = DoubleMLModel()
    model.set("rawTreatmentEffects",
              [float(e) for e in state["rawTreatmentEffects"]])
    if state.get("confidenceLevel") is not None:
        model.set("confidenceLevel", float(state["confidenceLevel"]))
    for k in _DML_PARAMS:
        if state.get(k) is not None:
            model.set(k, state[k])
    return model


def ortho_forest_model_from_reference(state: Dict[str, Any],
                                      device: DeviceLike = "cuda"):
    """The JAX package's fitted ``OrthoForestDMLModel`` → the port's, its
    forest predicting on ``device``.  ``state``: ``"booster"`` (the
    forest regressor's ``Booster.to_dict()``), optional ``"outputCol"``
    and the column params of :data:`_DML_PARAMS`."""
    from ...causal.dml import OrthoForestDMLModel
    model = OrthoForestDMLModel()
    model.set("forestModel", _inner_gbdt(
        {"booster": state["booster"],
         "featuresCol": state.get("featuresCol")}, device, regressor=True))
    for k in _DML_PARAMS + ("outputCol",):
        if state.get(k) is not None:
            model.set(k, state[k])
    return model
