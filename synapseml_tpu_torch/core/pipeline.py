"""Pipeline algebra: Estimator.fit(ds) -> Model; Transformer.transform(ds).

The PyTorch port of the JAX package's ``core/pipeline.py`` (Spark ML's
Estimator/Transformer/Pipeline plus ``ComplexParamsWritable/Readable``
persistence).  Persistence layout:

    <path>/metadata.json      {class, uid, timestamp, simple params}
    <path>/complex/<name>.*   side-car per complex param (npy / pickle /
                              nested stage directory)

Every stage self-registers in a class registry keyed by qualified name so
generic :func:`load_stage` can reconstruct it.

Row-level fault isolation (``handleInvalid='skip'|'quarantine'``) is not
part of this slice of the port: those modes raise ``NotImplementedError``
at ``fit``/``transform``; ``'error'`` (the default) is a pass-through.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .dataset import Dataset
from .params import (DatasetParam, EstimatorParam, Param, Params,
                     PyObjectParam, StringParam, TransformerParam)

#: the row-guard modes of the JAX package; only "error" is ported
HANDLE_INVALID_MODES = ("error", "skip", "quarantine")

_STAGE_REGISTRY: Dict[str, type] = {}


def _qualname(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def register_stage(cls: type) -> type:
    _STAGE_REGISTRY[_qualname(cls)] = cls
    return cls


#: the JAX package's module prefix: a stage it saved loads as the port's
#: class of the same module path and name (the port never imports it)
_REFERENCE_PREFIX = "synapseml_tpu."


def lookup_stage(name: str) -> type:
    if name.startswith(_REFERENCE_PREFIX):
        name = "synapseml_tpu_torch." + name[len(_REFERENCE_PREFIX):]
    if name in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[name]
    # lazy import: module path is encoded in the qualified name
    module, _, _ = name.rpartition(".")
    import importlib
    importlib.import_module(module)
    if name not in _STAGE_REGISTRY:
        raise KeyError(f"stage class {name} not registered")
    return _STAGE_REGISTRY[name]


def _check_handle_invalid(stage: "PipelineStage") -> None:
    mode = stage.get_or_default("handleInvalid")
    if mode != "error":
        raise NotImplementedError(
            f"{type(stage).__name__}: handleInvalid={mode!r} needs the row "
            "guard, which the PyTorch port has not ported yet (ROADMAP "
            "queue A, resilience); use handleInvalid='error'")


class PipelineStage(Params):
    """Common base: params + save/load + the ``handleInvalid`` contract."""

    handleInvalid = StringParam(
        doc="row-level fault mode: 'error' raises on the first bad row "
            "(Spark default); 'skip' and 'quarantine' are not ported yet",
        default="error", allowed=HANDLE_INVALID_MODES)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        register_stage(cls)

    # -- persistence -------------------------------------------------------
    def save(self, path: str, overwrite: bool = True) -> None:
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        meta: Dict[str, Any] = {
            "class": _qualname(type(self)),
            "uid": self.uid,
            "timestamp": int(time.time() * 1000),
            "paramMap": {},
            "complexParams": [],
        }
        complex_dir = os.path.join(path, "complex")
        for name, value in self._paramMap.items():
            p = self.get_param(name)
            if value is None:
                meta["paramMap"][name] = None
            elif p.is_complex:
                os.makedirs(complex_dir, exist_ok=True)
                self._save_complex(complex_dir, p, value)
                meta["complexParams"].append(name)
            else:
                meta["paramMap"][name] = p.json_value(value)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=1, default=_json_default)
        self._save_extra(path)

    def _save_extra(self, path: str) -> None:
        """Hook for stages with non-param state (e.g. fitted weights)."""

    def _load_extra(self, path: str) -> None:
        pass

    @staticmethod
    def _save_complex(complex_dir: str, p: Param, value: Any) -> None:
        base = os.path.join(complex_dir, p.name)
        if isinstance(p, (EstimatorParam, TransformerParam)) or isinstance(value, PipelineStage):
            value.save(base)
        elif isinstance(p, DatasetParam) or isinstance(value, Dataset):
            save_dataset(value, base)
        elif isinstance(value, np.ndarray) and value.dtype != object:
            np.save(base + ".npy", value)
        else:
            with open(base + ".pkl", "wb") as f:
                pickle.dump(value, f)

    @staticmethod
    def _load_complex(complex_dir: str, name: str) -> Any:
        base = os.path.join(complex_dir, name)
        if os.path.isdir(base):
            if os.path.exists(os.path.join(base, "metadata.json")):
                return load_stage(base)
            return load_dataset(base)
        if os.path.exists(base + ".npy"):
            return np.load(base + ".npy", allow_pickle=False)
        with open(base + ".pkl", "rb") as f:
            return pickle.load(f)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        stage = load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(f"{path} holds {type(stage).__name__}, not {cls.__name__}")
        return stage


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def load_stage(path: str) -> PipelineStage:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = lookup_stage(meta["class"])
    stage: PipelineStage = cls.__new__(cls)
    Params.__init__(stage)
    stage.uid = meta["uid"]
    for name, value in meta["paramMap"].items():
        if value is None:
            stage._paramMap[name] = None
        else:
            p = stage.get_param(name)
            stage._paramMap[name] = p.validate(p.from_json(value))
    complex_dir = os.path.join(path, "complex")
    for name in meta.get("complexParams", []):
        stage._paramMap[name] = stage._load_complex(complex_dir, name)
    stage._load_extra(path)
    return stage


def save_dataset(ds: Dataset, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    obj_cols = {k: v for k, v in ds._cols.items() if v.dtype == object}
    num_cols = {k: v for k, v in ds._cols.items() if v.dtype != object}
    np.savez(os.path.join(path, "columns.npz"), **num_cols)
    with open(os.path.join(path, "object_columns.pkl"), "wb") as f:
        pickle.dump(obj_cols, f)
    with open(os.path.join(path, "dsmeta.json"), "w") as f:
        json.dump({"num_partitions": ds.num_partitions,
                   "order": ds.columns}, f)


def load_dataset(path: str) -> Dataset:
    with open(os.path.join(path, "dsmeta.json")) as f:
        meta = json.load(f)
    cols: Dict[str, Any] = {}
    with np.load(os.path.join(path, "columns.npz")) as z:
        for k in z.files:
            cols[k] = z[k]
    with open(os.path.join(path, "object_columns.pkl"), "rb") as f:
        cols.update(pickle.load(f))
    ordered = {k: cols[k] for k in meta["order"]}
    return Dataset(ordered, meta["num_partitions"])


# --------------------------------------------------------------------------


class Transformer(PipelineStage):
    """ds -> ds map. Subclasses implement ``_transform``."""

    def transform(self, ds: Dataset) -> Dataset:
        _check_handle_invalid(self)
        return self._transform(ds)

    def _transform(self, ds: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, ds: Dataset) -> Dataset:
        return self.transform(ds)


class Estimator(PipelineStage):
    """ds -> Model. Subclasses implement ``_fit``."""

    def fit(self, ds: Dataset) -> "Model":
        _check_handle_invalid(self)
        model = self._fit(ds)
        model._parent_uid = self.uid
        return model

    def _fit(self, ds: Dataset) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""

    _parent_uid: Optional[str] = None


class Evaluator(Params):
    """ds -> float metric."""

    def evaluate(self, ds: Dataset) -> float:
        raise NotImplementedError

    def is_larger_better(self) -> bool:
        return True


# --------------------------------------------------------------------------


class Pipeline(Estimator):
    """Sequential stage composition (Spark ML Pipeline semantics)."""

    stages = PyObjectParam(doc="ordered list of pipeline stages")

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set("stages", list(stages))

    def _fit(self, ds: Dataset) -> "PipelineModel":
        fitted: List[Transformer] = []
        cur = ds
        stages = self.get_or_default("stages") or []
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < len(stages) - 1:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(stages) - 1:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel(fitted)


class PipelineModel(Model):
    stages = PyObjectParam(doc="ordered list of fitted transformers")

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set("stages", list(stages))

    def _transform(self, ds: Dataset) -> Dataset:
        cur = ds
        for stage in self.get_or_default("stages") or []:
            cur = stage.transform(cur)
        return cur
