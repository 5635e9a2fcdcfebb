"""Load the JAX package's LLM parameters into the port.

:func:`params_from_reference` takes the reference's flax parameter tree
— nested dicts of numpy arrays, unboxed (``flax.linen.meta.unbox``: the
reference boxes every leaf with ``nn.with_partitioning``) — and returns
the state dict of :class:`~.model.LlamaModel`.  The layouts already
agree (``Dense`` kernels ``(in, out)``, the embedding ``(vocab,
d_model)``), so the conversion renames ``layer_{i}`` to ``layers.{i}``
and keeps every value bit for bit.  The port never imports flax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .model import LlamaConfig

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def params_from_reference(params: Mapping, cfg: LlamaConfig,
                          device: DeviceLike = "cuda"
                          ) -> Dict[str, torch.Tensor]:
    """The reference's ``{"params": ...}`` tree (or its inner dict) →
    a :class:`~.model.LlamaModel` state dict on ``device``."""
    dev = resolve_device(device)
    p = params.get("params", params)
    if cfg.weight_quant != "none" or "embedding_q" in p.get("tok_embed", {}):
        raise NotImplementedError("int8 parameter trees are not ported yet "
                                  "(ROADMAP A1: int8 weights)")
    sd = {"tok_embed.embedding": p["tok_embed"]["embedding"],
          "ln_final.scale": p["ln_final"]["scale"]}
    for i in range(cfg.num_layers):
        layer = p[f"layer_{i}"]
        pre = f"layers.{i}."
        sd[pre + "ln_attn.scale"] = layer["ln_attn"]["scale"]
        sd[pre + "ln_mlp.scale"] = layer["ln_mlp"]["scale"]
        for n in _ATTN:
            sd[pre + f"attn.{n}.kernel"] = layer["attn"][n]["kernel"]
        for n in _MLP:
            sd[pre + f"{n}.kernel"] = layer[n]["kernel"]
    if not cfg.tie_embeddings:
        sd["lm_head.kernel"] = p["lm_head"]["kernel"]
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in sd.items()}
