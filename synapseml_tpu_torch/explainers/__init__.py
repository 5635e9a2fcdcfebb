"""Model interpretability — LIME, Kernel SHAP, ICE.

Re-designs the reference's ``explainers`` package (reference:
core/src/main/scala/com/microsoft/azure/synapse/ml/explainers/
LocalExplainer.scala:13, LIMEBase.scala:137, KernelSHAPBase.scala:37,
ICEExplainer.scala:130).  All explainers only need ``model.transform``
over perturbed copies of a row — perturbation batches are built host-side
and scored in a few large batched calls so the model sees large blocks,
then the per-row weighted regressions are solved as one batched torch
solve on the explainer's ``device``.
"""

from .solvers import lasso_regression, least_squares_regression
from .lime import TabularLIME, TextLIME, VectorLIME, ImageLIME
from .shap import TabularSHAP, TextSHAP, VectorSHAP, ImageSHAP
from .ice import ICETransformer

__all__ = [
    "lasso_regression", "least_squares_regression",
    "TabularLIME", "VectorLIME", "TextLIME", "ImageLIME",
    "TabularSHAP", "VectorSHAP", "TextSHAP", "ImageSHAP",
    "ICETransformer",
]
