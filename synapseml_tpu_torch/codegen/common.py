"""Shared param-metadata helpers for the generators (reference:
codegen/DefaultParamInfo.scala — maps each param type to per-language
type names and default renderings), over the port's own
:mod:`synapseml_tpu_torch.core.params` classes.

:data:`PACKAGE` names the package the generators walk and write about;
every file name, namespace and header derives from it, and every strip
of the module prefix goes through :func:`short_module`."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.params import (ArrayParam, BoolParam, ComplexParam, DictParam,
                           FloatParam, IntParam, ListParam, Param,
                           StringParam)

#: the package whose stages the generators wrap
PACKAGE = "synapseml_tpu_torch"


def short_module(module: str) -> str:
    """A stage module's path inside :data:`PACKAGE`
    (``synapseml_tpu_torch.models.gbdt.estimators`` →
    ``models.gbdt.estimators``)."""
    prefix = PACKAGE + "."
    return module[len(prefix):] if module.startswith(prefix) else module


def public_params(cls: type) -> List[Param]:
    """Declared params, inheritance-ordered, skipping private names."""
    seen: Dict[str, Param] = {}
    for klass in reversed(cls.__mro__):
        for key, val in vars(klass).items():
            if isinstance(val, Param) and not val.name.startswith("_"):
                seen[val.name] = val
    return list(seen.values())


#: Param class → (python type, R roxygen type, C# type)
_TYPE_MAP: List[Tuple[type, Tuple[str, str, str]]] = [
    (IntParam, ("int", "integer", "int")),
    (FloatParam, ("float", "numeric", "double")),
    (BoolParam, ("bool", "logical", "bool")),
    (StringParam, ("str", "character", "string")),
    (ListParam, ("list", "list", "object[]")),
    (ArrayParam, ("numpy.ndarray", "numeric vector", "double[]")),
    (DictParam, ("dict", "named list", "Dictionary<string, object>")),
    (ComplexParam, ("typing.Any", "object", "object")),
]


def lang_types(p: Param) -> Tuple[str, str, str]:
    for klass, names in _TYPE_MAP:
        if isinstance(p, klass):
            return names
    return ("typing.Any", "object", "object")


def py_default_repr(p: Param) -> str:
    d = p.default
    if d is None or isinstance(d, (int, float, bool, str)):
        return repr(d)
    return "..."
