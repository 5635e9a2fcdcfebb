"""Prompt-template interpolation, the one piece of the JAX package's
``core/utils.py`` the port needs so far (for
:class:`~synapseml_tpu_torch.models.llm.stage.LLMTransformer`); the rest
of that module is ROADMAP A8."""

from __future__ import annotations

import re

__all__ = ["TEMPLATE_RE", "interpolate_template"]

#: ``{column}`` interpolation slots of the prompt-templating stages
TEMPLATE_RE = re.compile(r"\{(\w+)\}")


def interpolate_template(template: str, lookup) -> str:
    """Replace ``{name}`` slots via ``lookup(name) -> Optional[str]``;
    slots whose lookup returns None (and literal braces) pass through."""
    def sub(m):
        v = lookup(m.group(1))
        return m.group(0) if v is None else str(v)
    return TEMPLATE_RE.sub(sub, template)
