"""Load the JAX package's DL variables into the port.

:func:`params_from_reference` takes the reference's flax variables as
numpy — ``{"params": ...}`` for a ``TextEncoder``, ``{"params": ...,
"batch_stats": ...}`` for a ``ResNet``, unboxed (``flax.linen.meta.unbox``:
the reference boxes every text leaf with ``nn.with_partitioning``) — and
returns the port's state dict.  The port keeps the flax names and layouts
(:mod:`.transformer`, :mod:`.resnet`), so each leaf's path joined with
dots is its key and every value is kept bit for bit.  With a ``mesh``
that has an ``expert`` axis, each MoE layer's ``w_up``/``w_down`` hand
this rank its slice of the experts (``[i·E/ep, (i+1)·E/ep)`` for expert
index ``i``), the layout of a ``TextEncoder`` built on that mesh.  The
port never imports flax.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .resnet import BACKBONES
from .transformer import TransformerConfig


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts → ``{"a.b.c": leaf}``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key + "."))
        else:
            out[key] = v
    return out


def params_from_reference(variables: Mapping,
                          cfg: Union[TransformerConfig, str],
                          device: DeviceLike = "cuda",
                          mesh=None) -> Dict[str, torch.Tensor]:
    """The reference's variables → the port's state dict on ``device``.

    ``cfg`` is the ``TransformerConfig`` of a text model or the backbone
    name of a vision model (a MoE block's ``moe_ffn`` leaves ``router``,
    ``w_up`` and ``w_down`` keep their names); a vision tree without
    ``batch_stats`` raises.  ``mesh``: this rank's experts only (module
    docstring)."""
    from ...parallel.mesh import EXPERT_AXIS, axis_index, axis_size
    dev = resolve_device(device)
    if isinstance(cfg, TransformerConfig):
        sd = flatten_tree(variables.get("params", variables))
    else:
        if cfg not in BACKBONES:
            raise ValueError(f"unknown backbone {cfg!r}")
        if "batch_stats" not in variables:
            raise ValueError("a ResNet's variables need 'batch_stats'")
        sd = flatten_tree(variables["params"])
        sd.update(flatten_tree(variables["batch_stats"]))
    ep = axis_size(mesh, EXPERT_AXIS)
    if ep > 1:
        for k in [k for k in sd if k.endswith(("moe_ffn.w_up",
                                               "moe_ffn.w_down"))]:
            per = np.shape(sd[k])[0] // ep
            lo = axis_index(mesh, EXPERT_AXIS) * per
            sd[k] = np.asarray(sd[k])[lo:lo + per]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in sd.items()}
