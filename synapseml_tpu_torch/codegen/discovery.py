"""Stage discovery: import every package module, read the registry.

The reference reflects over the jar for all ``Wrappable`` classes
(reference: core/utils/JarLoadingUtils.scala — ``instantiateServices``);
here we walk the port's module tree (:data:`~.common.PACKAGE`), import
everything, and collect the stage registry that
``PipelineStage.__init_subclass__`` populates (core/pipeline.py).
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, List

from .common import PACKAGE

#: modules that require optional/native context and are skipped in codegen
_SKIP_PREFIXES = (PACKAGE + ".native",)


def load_all_modules() -> List[str]:
    """Import every submodule of the package; return imported names."""
    pkg = importlib.import_module(PACKAGE)
    loaded = []
    for info in pkgutil.walk_packages(pkg.__path__, prefix=PACKAGE + "."):
        if info.name.startswith(_SKIP_PREFIXES):
            continue
        importlib.import_module(info.name)
        loaded.append(info.name)
    return loaded


def discover_stages() -> Dict[str, type]:
    """qualified-name → stage class for every public, concrete stage."""
    from ..core.pipeline import (_STAGE_REGISTRY, Estimator, Model,
                                 Pipeline, PipelineModel, PipelineStage,
                                 Transformer)
    load_all_modules()
    base = {Transformer, Estimator, Model, PipelineStage,
            Pipeline, PipelineModel}
    out: Dict[str, type] = {}
    for qual, cls in sorted(_STAGE_REGISTRY.items()):
        if cls in base:
            continue
        if cls.__name__.startswith("_"):
            continue  # private helper bases
        if not cls.__module__.startswith(PACKAGE + "."):
            continue  # stages defined in tests/user code are not ours to wrap
        out[qual] = cls
    return out


def stage_kind(cls: type) -> str:
    """'estimator' | 'model' | 'transformer' (drives wrapper shape)."""
    from ..core.pipeline import Estimator, Model, Transformer
    if issubclass(cls, Estimator):
        return "estimator"
    if issubclass(cls, Model):
        return "model"
    if issubclass(cls, Transformer):
        return "transformer"
    return "stage"
