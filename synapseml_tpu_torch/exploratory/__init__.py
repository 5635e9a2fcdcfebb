"""Data-balance analysis (reference: core/.../exploratory/)."""

from .balance import (AggregateBalanceMeasure, DistributionBalanceMeasure,
                      FeatureBalanceMeasure)

__all__ = ["AggregateBalanceMeasure", "DistributionBalanceMeasure",
           "FeatureBalanceMeasure"]
