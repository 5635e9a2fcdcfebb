"""Typed parameter system for pipeline stages.

Re-designs the reference's Spark ML ``Params`` + SynapseML custom param types
(reference: core/src/main/scala/com/microsoft/azure/synapse/ml/param/*.scala,
core/serialize/ComplexParam.scala) as Python descriptors with full
introspection.  Every pipeline stage declares class-level :class:`Param`
objects; instances carry a ``paramMap`` of explicitly-set values over a
``defaultParamMap``.  Introspection (``stage.params``) powers generic
serialization and the fuzzing test harness, the way Spark param metadata
powers SynapseML's codegen (reference: core/.../codegen/Wrappable.scala).
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence


class Param:
    """A typed parameter declared on a stage class.

    Acts as a Python descriptor: ``stage.myParam`` reads the effective value
    (set value, else default); assignment sets it with validation.
    """

    #: set by subclasses that cannot be JSON-serialized inline (arrays,
    #: models, datasets, callables) — analogue of reference ComplexParam.
    is_complex = False

    def __init__(self, name: str = None, doc: str = "", default: Any = None,
                 validator: Optional[Callable[[Any], bool]] = None):
        self.name = name
        self.doc = doc
        self.default = default
        self.validator = validator

    def __set_name__(self, owner, name):
        if self.name is None:
            self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get_or_default(self.name)

    def __set__(self, obj, value):
        obj.set(self.name, value)

    # -- type plumbing -----------------------------------------------------
    def validate(self, value) -> Any:
        """Coerce + validate; raise TypeError/ValueError on bad input."""
        value = self._coerce(value)
        if self.validator is not None and value is not None:
            if not self.validator(value):
                raise ValueError(
                    f"Param {self.name}: value {value!r} failed validation")
        return value

    def _coerce(self, value):
        return value

    def json_value(self, value):
        """Representation for metadata.json (simple params only)."""
        return value

    def from_json(self, value):
        return value

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r}, default={self.default!r})"


class IntParam(Param):
    def _coerce(self, value):
        if value is None:
            return None
        if isinstance(value, bool):
            raise TypeError(f"Param {self.name}: expected int, got bool")
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if not isinstance(value, int):
            raise TypeError(f"Param {self.name}: expected int, got {type(value).__name__}")
        return value


class FloatParam(Param):
    def _coerce(self, value):
        if value is None:
            return None
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"Param {self.name}: expected float, got {type(value).__name__}")
        return float(value)


class BoolParam(Param):
    def _coerce(self, value):
        if value is None:
            return None
        if not isinstance(value, bool):
            raise TypeError(f"Param {self.name}: expected bool, got {type(value).__name__}")
        return value


class StringParam(Param):
    def __init__(self, name=None, doc="", default=None, validator=None,
                 allowed: Optional[Sequence[str]] = None):
        super().__init__(name, doc, default, validator)
        self.allowed = tuple(allowed) if allowed else None

    def _coerce(self, value):
        if value is None:
            return None
        if not isinstance(value, str):
            raise TypeError(f"Param {self.name}: expected str, got {type(value).__name__}")
        if self.allowed and value not in self.allowed:
            raise ValueError(
                f"Param {self.name}: {value!r} not in allowed values {self.allowed}")
        return value


class ListParam(Param):
    """A list of simple values (ints/floats/strings)."""

    def _coerce(self, value):
        if value is None:
            return None
        if isinstance(value, (list, tuple)):
            return list(value)
        raise TypeError(f"Param {self.name}: expected list, got {type(value).__name__}")


class DictParam(Param):
    def _coerce(self, value):
        if value is None:
            return None
        if not isinstance(value, dict):
            raise TypeError(f"Param {self.name}: expected dict, got {type(value).__name__}")
        return dict(value)


# --------------------------------------------------------------------------
# Complex params — values that need side-car files to serialize
# (reference: core/serialize/ComplexParam.scala and descendants:
#  UDFParam, DataFrameParam, EstimatorParam, TransformerParam, ArrayParam)
# --------------------------------------------------------------------------

class ComplexParam(Param):
    is_complex = True

    def json_value(self, value):  # stored as a pointer to the side-car
        raise RuntimeError("complex params are not inline-JSON serializable")


class ArrayParam(ComplexParam):
    """numpy / torch array valued param (e.g. initial scores, sample weights)."""

    def _coerce(self, value):
        if value is None:
            return None
        import numpy as np
        return np.asarray(value)


class UDFParam(ComplexParam):
    """Callable-valued param (reference: param/UDFParam.scala)."""

    def _coerce(self, value):
        if value is None:
            return None
        if not callable(value):
            raise TypeError(f"Param {self.name}: expected callable")
        return value


class EstimatorParam(ComplexParam):
    """Pipeline-stage-valued param (reference: param/EstimatorParam.scala)."""


class TransformerParam(ComplexParam):
    """Transformer-valued param (reference: param/PipelineStageParam)."""


class DatasetParam(ComplexParam):
    """Dataset-valued param (reference: param/DataFrameParam.scala)."""


class PyObjectParam(ComplexParam):
    """Arbitrary picklable object (pytrees of model weights etc.)."""


# --------------------------------------------------------------------------
# Params base
# --------------------------------------------------------------------------

def _next_uid(cls_name: str) -> str:
    import uuid
    return f"{cls_name}_{uuid.uuid4().hex[:12]}"


class Params:
    """Base for anything with params (stages, evaluators).

    Mirrors Spark ML ``Params`` semantics: an explicit ``paramMap`` layered
    over ``defaultParamMap``; ``copy`` produces an independent clone.
    """

    def __init__(self, **kwargs):
        self.uid = _next_uid(type(self).__name__)
        self._paramMap: Dict[str, Any] = {}
        self.set_params(**kwargs)

    # -- declaration introspection ----------------------------------------
    @classmethod
    def param_objs(cls) -> Dict[str, Param]:
        # cached per class (params are class declarations, so the walk is
        # invariant); cls.__dict__ lookup keeps subclasses from aliasing
        # their parent's cache.  Callers treat the dict as read-only —
        # this sits on the per-row hot path of the pipeline guard.
        cached = cls.__dict__.get("_param_objs_cache")
        if cached is not None:
            return cached
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for key, val in vars(klass).items():
                if isinstance(val, Param):
                    out[val.name] = val
        cls._param_objs_cache = out
        return out

    @property
    def params(self) -> List[Param]:
        return list(self.param_objs().values())

    def get_param(self, name: str) -> Param:
        try:
            return self.param_objs()[name]
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no param {name!r}") from None

    def has_param(self, name: str) -> bool:
        return name in self.param_objs()

    # -- get/set -----------------------------------------------------------
    def set(self, name: str, value: Any) -> "Params":
        p = self.get_param(name)
        self._paramMap[name] = p.validate(value)
        return self

    def set_params(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def get(self, name: str) -> Any:
        self.get_param(name)
        return self._paramMap.get(name)

    def is_set(self, name: str) -> bool:
        return name in self._paramMap

    def is_defined(self, name: str) -> bool:
        return self.is_set(name) or self.get_param(name).default is not None

    def clear(self, name: str) -> "Params":
        self._paramMap.pop(name, None)
        return self

    # -- cloning -----------------------------------------------------------
    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        new = _copy.copy(self)
        new._paramMap = dict(self._paramMap)
        if hasattr(self, "_defaultOverrides"):
            new._defaultOverrides = dict(self._defaultOverrides)
        if extra:
            for k, v in extra.items():
                new.set(k, v)
        return new

    def _copy_values_from(self, other: "Params") -> "Params":
        """Copy explicitly-set values of shared params from ``other``
        (estimator -> model param transfer)."""
        for name, value in other._paramMap.items():
            if self.has_param(name):
                self.set(name, value)
        return self

    def explain_params(self) -> str:
        lines = []
        for p in self.params:
            cur = self._paramMap.get(p.name, "undefined")
            lines.append(f"{p.name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    def _set_default(self, **kwargs) -> "Params":
        """Override declared defaults for this instance (Spark setDefault)."""
        for k, v in kwargs.items():
            p = self.get_param(k)
            # store instance-level default by shadowing the class param map
            if not hasattr(self, "_defaultOverrides"):
                self._defaultOverrides: Dict[str, Any] = {}
            self._defaultOverrides[k] = p.validate(v)
        return self

    def get_or_default(self, name: str) -> Any:
        p = self.get_param(name)
        if name in self._paramMap:
            return self._paramMap[name]
        ov = getattr(self, "_defaultOverrides", None)
        if ov and name in ov:
            return ov[name]
        return p.default

    def __repr__(self):
        set_params = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items())
                               if not isinstance(v, (bytes,)))
        return f"{type(self).__name__}(uid={self.uid}, {set_params})"


class HasInputCol(Params):
    inputCol = StringParam(doc="name of the input column")


class HasInputCols(Params):
    inputCols = ListParam(doc="names of the input columns")


class HasOutputCol(Params):
    outputCol = StringParam(doc="name of the output column")


class HasLabelCol(Params):
    labelCol = StringParam(doc="name of the label column", default="label")


class HasFeaturesCol(Params):
    featuresCol = StringParam(doc="name of the features column", default="features")


class HasPredictionCol(Params):
    predictionCol = StringParam(doc="name of the prediction column", default="prediction")


class HasWeightCol(Params):
    weightCol = StringParam(doc="name of the sample-weight column")


class HasProbabilityCol(Params):
    probabilityCol = StringParam(doc="name of the probability column", default="probability")


class HasRawPredictionCol(Params):
    rawPredictionCol = StringParam(doc="name of the raw-prediction (margin) column",
                                   default="rawPrediction")


class HasSeed(Params):
    seed = IntParam(doc="random seed", default=0)
