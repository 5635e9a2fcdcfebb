"""Load the JAX package's LLM parameters into the port.

:func:`params_from_reference` takes the reference's flax parameter tree
— nested dicts of numpy arrays, unboxed (``flax.linen.meta.unbox``: the
reference boxes every leaf with ``nn.with_partitioning``) — and returns
the state dict of :class:`~.model.LlamaModel`.  The layouts already
agree (``Dense`` kernels ``(in, out)``, the embedding ``(vocab,
d_model)``), so the conversion renames ``layer_{i}`` to ``layers.{i}``
and keeps every value bit for bit.  An int8 tree (the reference's
``quantize_int8``, for ``weight_quant="int8"``) carries ``kernel_q`` and
``scale`` per projection and, tied, ``embedding_q`` and ``scale`` for
the embedding; they keep their names.  With a ``mesh`` that has a
``model`` axis the result is one rank's shard (the Megatron layout of
:func:`~.model.tp_shard_specs`); :func:`shard_state_dict` cuts a whole
torch state dict the same way.  The port never imports flax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...parallel.mesh import MODEL_AXIS, axis_size
from .model import LlamaConfig, tp_shard_specs

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def shard_state_dict(sd: Mapping[str, torch.Tensor], mesh
                     ) -> Dict[str, torch.Tensor]:
    """A whole :class:`~.model.LlamaModel` state dict → this rank's shard
    on ``mesh``'s ``model`` axis (the dict itself without one)."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return dict(sd)
    from ..dl.transformer import slice_full
    return slice_full(dict(sd), tp_shard_specs(sd.keys()), mesh)


def params_from_reference(params: Mapping, cfg: LlamaConfig,
                          device: DeviceLike = "cuda", mesh=None
                          ) -> Dict[str, torch.Tensor]:
    """The reference's ``{"params": ...}`` tree (or its inner dict) →
    a :class:`~.model.LlamaModel` state dict on ``device`` (this rank's
    shard with a ``mesh``)."""
    dev = resolve_device(device)
    p = params.get("params", params)
    quant = "kernel_q" in p["layer_0"]["attn"]["q_proj"]
    if quant != (cfg.weight_quant == "int8"):
        raise ValueError(f"the tree is {'int8' if quant else 'float'} but "
                         f"cfg.weight_quant={cfg.weight_quant!r}")
    sd = {"ln_final.scale": p["ln_final"]["scale"]}
    for name, leaf in p["tok_embed"].items():
        sd["tok_embed." + name] = leaf
    for i in range(cfg.num_layers):
        layer = p[f"layer_{i}"]
        pre = f"layers.{i}."
        sd[pre + "ln_attn.scale"] = layer["ln_attn"]["scale"]
        sd[pre + "ln_mlp.scale"] = layer["ln_mlp"]["scale"]
        for n in _ATTN:
            for name, leaf in layer["attn"][n].items():
                sd[pre + f"attn.{n}.{name}"] = leaf
        for n in _MLP:
            for name, leaf in layer[n].items():
                sd[pre + f"{n}.{name}"] = leaf
    if not cfg.tie_embeddings:
        for name, leaf in p["lm_head"].items():
            sd["lm_head." + name] = leaf
    whole = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    return {k: v.to(dev) for k, v in shard_state_dict(whole, mesh).items()}
