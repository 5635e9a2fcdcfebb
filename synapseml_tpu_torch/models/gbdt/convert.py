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
