"""Hyperparameter spaces (reference: core/.../automl/HyperparamBuilder.scala,
DefaultHyperparams.scala): discrete / range distributions per param, swept
as a full grid or random draws.  The PyTorch port's copy of the JAX
package's ``automl/space.py``."""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class DiscreteHyperParam:
    """Finite set of values (reference: DiscreteHyperParam)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def grid_values(self) -> List[Any]:
        return list(self.values)

    def sample(self, rng) -> Any:
        return self.values[int(rng.integers(0, len(self.values)))]


class RangeHyperParam:
    """Closed numeric range (reference: RangeHyperParam); ``log=True``
    samples log-uniformly; int ranges produce ints."""

    def __init__(self, low, high, log: bool = False, n_grid: int = 5):
        if high <= low:
            raise ValueError("high must exceed low")
        self.low, self.high = low, high
        self.log = log
        self.n_grid = n_grid
        self.is_int = isinstance(low, int) and isinstance(high, int)

    def grid_values(self) -> List[Any]:
        if self.log:
            pts = np.exp(np.linspace(np.log(self.low), np.log(self.high),
                                     self.n_grid))
        else:
            pts = np.linspace(self.low, self.high, self.n_grid)
        if self.is_int:
            return sorted({int(round(p)) for p in pts})
        return [float(p) for p in pts]

    def sample(self, rng) -> Any:
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.low),
                                         np.log(self.high))))
        else:
            v = float(rng.uniform(self.low, self.high))
        return int(round(v)) if self.is_int else v


class HyperparamBuilder:
    """Accumulates (estimator, paramName) -> distribution entries
    (reference: HyperparamBuilder.addHyperparam)."""

    def __init__(self):
        self._entries: List[Tuple[Any, str, Any]] = []

    def add_hyperparam(self, stage, param_name: str, dist) -> "HyperparamBuilder":
        stage.get_param(param_name)  # validate existence early
        self._entries.append((stage, param_name, dist))
        return self

    def build(self) -> List[Tuple[Any, str, Any]]:
        return list(self._entries)


class GridSpace:
    """Cartesian product of every distribution's grid values
    (reference: GridSpace)."""

    def __init__(self, entries: List[Tuple[Any, str, Any]]):
        self.entries = entries

    def param_maps(self) -> Iterator[List[Tuple[Any, str, Any]]]:
        grids = [d.grid_values() for _, _, d in self.entries]
        for combo in itertools.product(*grids):
            yield [(stage, name, val) for (stage, name, _), val
                   in zip(self.entries, combo)]


class RandomSpace:
    """Random draws from each distribution (reference: RandomSpace)."""

    def __init__(self, entries: List[Tuple[Any, str, Any]], seed: int = 0):
        self.entries = entries
        self.seed = seed

    def param_maps(self, n: int) -> Iterator[List[Tuple[Any, str, Any]]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(n):
            yield [(stage, name, d.sample(rng))
                   for stage, name, d in self.entries]


class DefaultHyperparams:
    """Sensible default search ranges per estimator family (reference:
    automl/DefaultHyperparams.scala:18-60 — per-learner
    ``defaultRange`` tables consumed by TuneHyperparameters)."""

    @staticmethod
    def gbdt(stage) -> List[Tuple[Any, str, Any]]:
        return (HyperparamBuilder()
                .add_hyperparam(stage, "numIterations",
                                RangeHyperParam(20, 100, n_grid=3))
                .add_hyperparam(stage, "learningRate",
                                RangeHyperParam(0.01, 0.3, log=True,
                                                n_grid=3))
                .add_hyperparam(stage, "numLeaves",
                                DiscreteHyperParam([15, 31, 63]))
                .add_hyperparam(stage, "lambdaL2",
                                RangeHyperParam(0.0, 1.0, n_grid=3))
                .build())

    @staticmethod
    def online_sgd(stage) -> List[Tuple[Any, str, Any]]:
        return (HyperparamBuilder()
                .add_hyperparam(stage, "learningRate",
                                RangeHyperParam(0.05, 2.0, log=True,
                                                n_grid=4))
                .add_hyperparam(stage, "l2",
                                DiscreteHyperParam([0.0, 1e-6, 1e-4]))
                .add_hyperparam(stage, "numPasses",
                                DiscreteHyperParam([1, 3, 5]))
                .build())

    @staticmethod
    def for_stage(stage) -> List[Tuple[Any, str, Any]]:
        """Dispatch by available params, mirroring the reference's
        per-learner overloads."""
        names = {p.name for p in stage.params}
        if "numLeaves" in names:
            return DefaultHyperparams.gbdt(stage)
        if "numPasses" in names:
            return DefaultHyperparams.online_sgd(stage)
        raise ValueError(
            f"no default hyperparam table for {type(stage).__name__}")
