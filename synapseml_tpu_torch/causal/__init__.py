"""Causal inference (reference: core/.../causal/)."""

from .dml import (DoubleMLEstimator, DoubleMLModel, OrthoForestDMLEstimator,
                  OrthoForestDMLModel, ResidualTransformer)

__all__ = ["DoubleMLEstimator", "DoubleMLModel", "OrthoForestDMLEstimator",
           "OrthoForestDMLModel", "ResidualTransformer"]
