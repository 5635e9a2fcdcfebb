"""Load the JAX package's DL variables into the port.

:func:`params_from_reference` takes the reference's flax variables as
numpy — ``{"params": ...}`` for a ``TextEncoder``, ``{"params": ...,
"batch_stats": ...}`` for a ``ResNet``, unboxed (``flax.linen.meta.unbox``:
the reference boxes every text leaf with ``nn.with_partitioning``) — and
returns the port's state dict.  The port keeps the flax names and layouts
(:mod:`.transformer`, :mod:`.resnet`), so each leaf's path joined with
dots is its key and every value is kept bit for bit.  With a ``mesh``
that shards a ``TextEncoder`` (an ``expert`` axis: each MoE layer's
``w_up``/``w_down`` hand this rank its experts ``[i·E/ep, (i+1)·E/ep)``;
a ``model`` axis: the vocab-, column- and row-parallel leaves hand this
rank its block), the state dict is one rank's shard, the layout of a
``TextEncoder`` built on that mesh.  The port never imports flax.
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
    ``batch_stats`` raises.  ``mesh``: this rank's shard only (module
    docstring)."""
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
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32))
           for k, v in sd.items()}
    if mesh is not None and isinstance(cfg, TransformerConfig):
        from .transformer import TextEncoder, slice_full
        # the layout of the model on this mesh (unset CPU parameters)
        specs = TextEncoder(cfg, device="cpu", seed=None,
                            mesh=mesh).shard_specs()
        out = slice_full(out, specs, mesh)
    return {k: v.to(dev) for k, v in out.items()}
