"""Pipeline algebra: Estimator.fit(ds) -> Model; Transformer.transform(ds).

The PyTorch port of the JAX package's ``core/pipeline.py`` (Spark ML's
Estimator/Transformer/Pipeline plus ``ComplexParamsWritable/Readable``
persistence).  Persistence layout:

    <path>/metadata.json      {class, uid, timestamp, simple params}
    <path>/complex/<name>.*   side-car per complex param (npy / pickle /
                              nested stage directory)

Every stage self-registers in a class registry keyed by qualified name so
generic :func:`load_stage` can reconstruct it.

Every ``fit``/``transform`` runs through the row guard
(:mod:`synapseml_tpu_torch.resilience.rowguard`) under the stage's
``handleInvalid`` policy; ``'error'`` (the default) is a pass-through.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .dataset import Dataset
from .logging import log_verb
from .params import (DatasetParam, EstimatorParam, Param, Params,
                     PyObjectParam, StringParam, TransformerParam)
from ..resilience.rowguard import (HANDLE_INVALID_MODES, guard_context,
                                   guarded_fit, guarded_transform)

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


class PipelineStage(Params):
    """Common base: params + save/load + row-level fault policy.

    Every stage carries the Spark ML ``handleInvalid`` contract, enforced
    at ``fit``/``transform`` entry by
    :mod:`synapseml_tpu_torch.resilience.rowguard`: ``"error"`` (default) is a
    strict pass-through, ``"skip"`` drops rows that fail the stage
    (NaN/Inf screens on declared input columns + poison-batch bisection
    on stage exceptions), ``"quarantine"`` additionally dead-letters them
    with source-row provenance for later :meth:`Quarantine.replay`.
    """

    handleInvalid = StringParam(
        doc="row-level fault mode: 'error' raises on the first bad row "
            "(Spark default), 'skip' drops bad rows, 'quarantine' routes "
            "them to the dead-letter store",
        default="error", allowed=HANDLE_INVALID_MODES)
    quarantineDir = StringParam(
        doc="dead-letter directory for handleInvalid='quarantine' "
            "(default: $SML_QUARANTINE_DIR, else ./sml_quarantine)")

    #: params whose values name input columns the row guard
    #: contract-checks (existence) and screens (NaN/Inf/None) — extend
    #: per stage family when the input lives under another name
    _guard_input_params = ("inputCol", "inputCols")
    _guard_fit_params = ("labelCol",)
    #: stages whose JOB is consuming NaN (imputers, NaN-native trainers)
    #: opt out of the NaN/Inf screen; bisection still applies
    _guard_screen_nan = True
    #: containers (Pipeline) that propagate the policy to their children
    #: instead of being guarded themselves
    _guard_exempt = False

    def guard_input_columns(self, for_fit: bool = False) -> List[str]:
        """Columns the row guard requires + screens for this invocation,
        resolved from the declared ``_guard_input_params`` (plus
        ``_guard_fit_params`` for ``fit``)."""
        names = self._guard_input_params
        if for_fit:
            names = tuple(names) + tuple(self._guard_fit_params)
        po = self.param_objs()
        cols: List[str] = []
        for name in names:
            if name not in po:
                continue
            v = self.get_or_default(name)
            if isinstance(v, str) and v:
                cols.append(v)
            elif isinstance(v, (list, tuple)):
                cols.extend(c for c in v if isinstance(c, str) and c)
        return cols

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
    """ds -> ds map. Subclasses implement ``_transform``; the public
    ``transform`` routes through the row guard (a pass-through in the
    default ``handleInvalid='error'`` mode)."""

    def transform(self, ds: Dataset) -> Dataset:
        with log_verb(self, "transform", n_rows=ds.num_rows):
            return guarded_transform(self, ds)

    def _transform(self, ds: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, ds: Dataset) -> Dataset:
        return self.transform(ds)


class Estimator(PipelineStage):
    """ds -> Model. Subclasses implement ``_fit``; the public ``fit``
    routes through the row guard (a pass-through in the default
    ``handleInvalid='error'`` mode)."""

    def fit(self, ds: Dataset) -> "Model":
        with log_verb(self, "fit", n_rows=ds.num_rows):
            model = guarded_fit(self, ds)
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
    """Sequential stage composition (Spark ML Pipeline semantics).

    A ``handleInvalid``/``quarantineDir`` set on the Pipeline propagates
    to every stage invocation (stages with their own explicit setting
    win), and source-row provenance is attached at entry so a row
    quarantined N stages deep still names the PIPELINE-input row that
    produced it."""

    stages = PyObjectParam(doc="ordered list of pipeline stages")
    #: the pipeline is not itself bisected — it propagates the policy to
    #: its children, which are
    _guard_exempt = True

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set("stages", list(stages))

    def _guard_ctx(self):
        mode = self._paramMap.get("handleInvalid")
        qdir = self._paramMap.get("quarantineDir")
        return guard_context(mode, qdir) if (mode or qdir) else None

    def _fit(self, ds: Dataset) -> "PipelineModel":
        ctx = self._guard_ctx()
        if ctx is None:
            return self._fit_stages(ds)
        with ctx:
            return self._fit_stages(ds.with_source_index())

    def _fit_stages(self, ds: Dataset) -> "PipelineModel":
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
        model = PipelineModel(fitted)
        for name in ("handleInvalid", "quarantineDir"):
            if self.is_set(name):         # policy rides along to serving
                model.set(name, self.get(name))
        return model


class PipelineModel(Model):
    stages = PyObjectParam(doc="ordered list of fitted transformers")
    _guard_exempt = True

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set("stages", list(stages))

    def _transform(self, ds: Dataset) -> Dataset:
        mode = self._paramMap.get("handleInvalid")
        qdir = self._paramMap.get("quarantineDir")
        if not (mode or qdir):
            cur = ds
            for stage in self.get_or_default("stages") or []:
                cur = stage.transform(cur)
            return cur
        with guard_context(mode, qdir):
            cur = ds.with_source_index()
            for stage in self.get_or_default("stages") or []:
                cur = stage.transform(cur)
            return cur
