"""Isolation-forest outlier detection (reference: isolationforest/)."""

from .forest import IsolationForest, IsolationForestModel

__all__ = ["IsolationForest", "IsolationForestModel"]
