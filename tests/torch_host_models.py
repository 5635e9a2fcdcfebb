"""A ridge model written once over either package's Estimator/Model, so
the AutoML and causal stages can be held against the JAX package's with
nuisance / candidate models whose fits are numpy on the host in both
(a GBDT fit of the two packages agrees only to its quantization)."""

import numpy as np


def ridge_classes(pkg: str):
    """(RidgeRegressor, RidgeClassifier) over ``pkg``'s core: the
    ``"jax"`` package or the ``"torch"`` port."""
    if pkg == "jax":
        from synapseml_tpu.core.params import (BoolParam, FloatParam,
                                               StringParam)
        from synapseml_tpu.core.pipeline import Estimator, Model
    else:
        from synapseml_tpu_torch.core.params import (BoolParam, FloatParam,
                                                     StringParam)
        from synapseml_tpu_torch.core.pipeline import Estimator, Model

    class _Params:
        featuresCol = StringParam(doc="features", default="features")
        labelCol = StringParam(doc="label", default="label")
        predictionCol = StringParam(doc="prediction", default="prediction")
        probabilityCol = StringParam(doc="probability",
                                     default="probability")

    class RidgeModel(_Params, Model):
        """Scores ``[X, 1] @ _w`` (the weights live on the instance)."""
        classify = BoolParam(doc="a classifier", default=False)

        def _transform(self, ds):
            X = ds.to_numpy([self.featuresCol], dtype=np.float64)
            s = np.c_[X, np.ones(len(X))] @ self._w
            if not self.classify:
                return ds.with_column(self.predictionCol, s)
            p = 1.0 / (1.0 + np.exp(-4.0 * (s - 0.5)))
            prob = np.empty(len(p), dtype=object)
            for i, v in enumerate(p):
                prob[i] = np.array([1.0 - v, v])
            return ds.with_columns({
                self.probabilityCol: prob,
                self.predictionCol: (p > 0.5).astype(np.float64)})

    class RidgeRegressor(_Params, Estimator):
        alpha = FloatParam(doc="L2 penalty", default=1.0)
        _classify = False

        def _fit(self, ds):
            X = ds.to_numpy([self.featuresCol], dtype=np.float64)
            X = np.c_[X, np.ones(len(X))]
            y = np.asarray(ds[self.labelCol], np.float64)
            w = np.linalg.solve(X.T @ X + self.alpha * np.eye(X.shape[1]),
                                X.T @ y)
            m = RidgeModel(featuresCol=self.featuresCol,
                           predictionCol=self.predictionCol,
                           probabilityCol=self.probabilityCol,
                           classify=self._classify)
            m._w = w
            return m

    class RidgeClassifier(RidgeRegressor):
        _classify = True

    return RidgeRegressor, RidgeClassifier
