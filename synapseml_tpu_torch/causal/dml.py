"""Double machine learning (reference: core/.../causal/).

``DoubleMLEstimator`` re-designs causal/DoubleMLEstimator.scala:63 —
per bootstrap iteration, split the data, cross-fit treatment and outcome
nuisance models, and estimate the average treatment effect by regressing
outcome residuals on treatment residuals (Neyman-orthogonal partialling
out); confidence intervals are percentile bootstrap over iterations, as
in the reference's ``maxIter`` loop.

``OrthoForestDMLEstimator`` (causal/OrthoForestDMLEstimator.scala)
estimates *heterogeneous* effects: after residualization it fits a
forest on the Robinson transformation — pseudo-outcome resY/resT with
weights resT² — so each leaf's weighted mean is a local ATE.

``ResidualTransformer`` (causal/ResidualTransformer.scala) emits
observed − predicted.

The PyTorch port's copy of the JAX package's ``causal/dml.py``: the
residuals and effects are numpy on the host, the nuisance and forest
models run where they were built.  The default heterogeneity forest is
the port's :class:`~synapseml_tpu_torch.models.gbdt.estimators.
GBDTRegressor` on its default device, the card; a caller who wants the
CPU passes ``heterogeneityModel=GBDTRegressor(..., device="cpu")``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (FloatParam, IntParam, ListParam, PyObjectParam,
                           StringParam)
from ..core.pipeline import Estimator, Model, Transformer


class ResidualTransformer(Transformer):
    """observed - predicted (reference: causal/ResidualTransformer.scala)."""

    observedCol = StringParam(doc="observed value column", default="label")
    predictedCol = StringParam(doc="prediction column", default="prediction")
    outputCol = StringParam(doc="residual column", default="residual")
    classIndex = IntParam(doc="probability-vector index when predictedCol "
                          "holds class probabilities", default=1)

    def _transform(self, ds: Dataset) -> Dataset:
        obs = ds[self.observedCol].astype(np.float64)
        pred_col = ds[self.predictedCol]
        if pred_col.dtype == object:
            idx = int(self.classIndex)
            pred = np.array([np.asarray(v, np.float64).ravel()[idx]
                             for v in pred_col])
        else:
            pred = pred_col.astype(np.float64)
        return ds.with_column(self.outputCol, obs - pred)


def _predictions(model: Model, ds: Dataset, pred_col: str,
                 prob_col: str) -> np.ndarray:
    """Continuous prediction: regression predictionCol, else P(class 1)."""
    out = model.transform(ds)
    if prob_col in out and out[prob_col].dtype == object:
        return np.array([np.asarray(v, np.float64).ravel()[-1]
                         for v in out[prob_col]])
    return out[pred_col].astype(np.float64)


class _DMLParams:
    treatmentModel = PyObjectParam(doc="nuisance estimator for treatment")
    outcomeModel = PyObjectParam(doc="nuisance estimator for outcome")
    treatmentCol = StringParam(doc="treatment column", default="treatment")
    outcomeCol = StringParam(doc="outcome column", default="outcome")
    featuresCol = StringParam(doc="confounder vector column",
                              default="features")
    predictionCol = StringParam(doc="nuisance prediction column",
                                default="prediction")
    probabilityCol = StringParam(doc="nuisance probability column",
                                 default="probability")


class DoubleMLEstimator(_DMLParams, Estimator):
    """Average treatment effect via cross-fitted partialling-out
    (reference: causal/DoubleMLEstimator.scala:63)."""

    maxIter = IntParam(doc="bootstrap iterations", default=1)
    sampleSplitRatio = ListParam(doc="two-fold split weights",
                                 default=[0.5, 0.5])
    confidenceLevel = FloatParam(doc="CI level", default=0.975)
    seed = IntParam(doc="rng seed", default=0)

    def _nuisance_residuals(self, half_fit: Dataset, half_pred: Dataset
                            ) -> Tuple[np.ndarray, np.ndarray]:
        tm: Estimator = self.get("treatmentModel").copy()
        om: Estimator = self.get("outcomeModel").copy()
        for m, col in ((tm, self.treatmentCol), (om, self.outcomeCol)):
            if m.has_param("labelCol"):
                m.set("labelCol", col)
            if m.has_param("featuresCol"):
                m.set("featuresCol", self.featuresCol)
        t_hat = _predictions(tm.fit(half_fit), half_pred,
                             self.predictionCol, self.probabilityCol)
        y_hat = _predictions(om.fit(half_fit), half_pred,
                             self.predictionCol, self.probabilityCol)
        res_t = half_pred[self.treatmentCol].astype(np.float64) - t_hat
        res_y = half_pred[self.outcomeCol].astype(np.float64) - y_hat
        return res_t, res_y

    def _fit(self, ds: Dataset) -> "DoubleMLModel":
        if self.get("treatmentModel") is None or \
                self.get("outcomeModel") is None:
            raise ValueError("treatmentModel and outcomeModel are required")
        rng = np.random.default_rng(int(self.seed))
        ratios = list(self.get_or_default("sampleSplitRatio"))
        effects = []
        for it in range(int(self.maxIter)):
            halves = ds.random_split(ratios, seed=int(rng.integers(1 << 31)))
            a, b = halves[0], halves[1]
            # cross-fitting: fit on A predict B, fit on B predict A
            res_t_b, res_y_b = self._nuisance_residuals(a, b)
            res_t_a, res_y_a = self._nuisance_residuals(b, a)
            res_t = np.concatenate([res_t_a, res_t_b])
            res_y = np.concatenate([res_y_a, res_y_b])
            denom = float((res_t * res_t).sum())
            if denom < 1e-12:
                continue
            effects.append(float((res_t * res_y).sum() / denom))
        if not effects:
            raise ValueError("all DML iterations degenerate (no treatment "
                             "variation after partialling out)")
        model = DoubleMLModel()
        model.set("rawTreatmentEffects", effects)
        model.set("confidenceLevel", float(self.confidenceLevel))
        model._copy_values_from(self)
        return model


class DoubleMLModel(_DMLParams, Model):
    rawTreatmentEffects = PyObjectParam(doc="bootstrap ATE draws")
    confidenceLevel = FloatParam(doc="CI level", default=0.975)

    def get_avg_treatment_effect(self) -> float:
        return float(np.mean(self.get("rawTreatmentEffects")))

    def get_confidence_interval(self) -> Tuple[float, float]:
        draws = np.asarray(self.get("rawTreatmentEffects"), np.float64)
        level = float(self.get_or_default("confidenceLevel"))
        alpha = 1.0 - level
        if len(draws) == 1:
            return (float(draws[0]), float(draws[0]))
        lo, hi = np.quantile(draws, [alpha, level])
        return float(lo), float(hi)

    def get_pvalue(self) -> float:
        """Two-sided p-value for ATE != 0 (normal approx over bootstrap
        draws).  NaN with a single draw — one sample has no spread, so any
        number here would be effect-size independent; raise ``maxIter``."""
        from math import erf, sqrt
        draws = np.asarray(self.get("rawTreatmentEffects"), np.float64)
        if len(draws) < 2:
            return float("nan")
        mu = draws.mean()
        sd = draws.std(ddof=1)
        z = abs(mu) / max(sd, 1e-12)
        return float(2 * (1 - 0.5 * (1 + erf(z / sqrt(2)))))

    def _transform(self, ds: Dataset) -> Dataset:
        ate = self.get_avg_treatment_effect()
        return ds.with_column("treatmentEffect",
                              np.full(ds.num_rows, ate, np.float64))


class OrthoForestDMLEstimator(_DMLParams, Estimator):
    """Heterogeneous treatment effects via residualization + a forest on
    the Robinson transformation (reference:
    causal/OrthoForestDMLEstimator.scala)."""

    heterogeneityModel = PyObjectParam(
        doc="regressor fit on the pseudo-outcome (default: random forest)")
    outputCol = StringParam(doc="per-row effect column",
                            default="treatmentEffect")
    minSampleWeight = FloatParam(doc="clip for resT^2 weights", default=1e-3)
    seed = IntParam(doc="rng seed", default=0)

    def _fit(self, ds: Dataset) -> "OrthoForestDMLModel":
        if self.get("treatmentModel") is None or \
                self.get("outcomeModel") is None:
            raise ValueError("treatmentModel and outcomeModel are required")
        halves = ds.random_split([0.5, 0.5], seed=int(self.seed))
        dml = DoubleMLEstimator()
        dml._paramMap.update({k: v for k, v in self._paramMap.items()
                              if dml.has_param(k)})
        res_t_b, res_y_b = dml._nuisance_residuals(halves[0], halves[1])
        res_t_a, res_y_a = dml._nuisance_residuals(halves[1], halves[0])
        # stitched residual vectors aligned with (B then A) row order
        stitched = halves[1].union(halves[0])
        res_t = np.concatenate([res_t_b, res_t_a])
        res_y = np.concatenate([res_y_b, res_y_a])
        w = np.maximum(res_t * res_t, float(self.minSampleWeight))
        pseudo = res_y / np.copysign(np.maximum(np.abs(res_t), 1e-8), res_t)

        het = self.get("heterogeneityModel")
        if het is None:
            from ..models.gbdt.estimators import GBDTRegressor
            het = GBDTRegressor(boostingType="rf", numIterations=32,
                                maxDepth=4)
        het = het.copy()
        if het.has_param("featuresCol"):
            het.set("featuresCol", self.featuresCol)
        if het.has_param("labelCol"):
            het.set("labelCol", "_pseudo_outcome")
        if het.has_param("weightCol"):
            het.set("weightCol", "_robinson_weight")
        train = stitched.with_columns({"_pseudo_outcome": pseudo,
                                       "_robinson_weight": w})
        fitted = het.fit(train)

        model = OrthoForestDMLModel()
        model.set("forestModel", fitted)
        model._copy_values_from(self)
        return model


class OrthoForestDMLModel(_DMLParams, Model):
    forestModel = PyObjectParam(doc="fitted heterogeneity regressor")
    outputCol = StringParam(doc="per-row effect column",
                            default="treatmentEffect")

    def _transform(self, ds: Dataset) -> Dataset:
        inner: Model = self.get("forestModel")
        out = inner.transform(ds)
        pred_col = (inner.predictionCol if inner.has_param("predictionCol")
                    else "prediction")
        return ds.with_column(self.outputCol,
                              out[pred_col].astype(np.float64))
