"""Nearest-neighbour search (reference: core/.../nn/)."""

from .knn import (BallTree, ConditionalKNN, ConditionalKNNModel, KNN,
                  KNNModel)

__all__ = ["BallTree", "ConditionalKNN", "ConditionalKNNModel", "KNN",
           "KNNModel"]
