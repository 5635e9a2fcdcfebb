"""Carry a model trained by the JAX package across to this package.

A model of either package is the version-2 JSON of ``Booster.to_dict()``
(trees as flat lists, the bin mapper's bounds, the init score, the
config), so the conversion is a read of that JSON with the checks that
what it holds is a model this package predicts: numeric features, no
bundles, one output.  The reverse direction needs nothing: this package's
``Booster.to_dict()`` emits the same schema, which the JAX package's
``Booster.from_dict`` reads back.
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
    if int(d.get("num_class", 1)) != 1:
        raise NotImplementedError(
            "multiclass models are not ported yet (ROADMAP queue A, GBDT "
            "breadth: multiclass)")
    return Booster.from_dict(d, device=device)
