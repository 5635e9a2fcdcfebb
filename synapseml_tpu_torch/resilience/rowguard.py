"""Row-level fault isolation: the data-plane half of the resilience story.

The PyTorch port's copy of the JAX package's ``resilience/rowguard.py``
(imports aside).  One NaN-poisoned feature, one ragged CSV line or one
request a service answers 4xx must degrade per row, never abort a whole
vectorized ``fit``/``transform`` (Spark ML's ``handleInvalid`` contract
and the reference's ``HasErrorCol`` pattern, as one layer every stage
executes through).

Pieces (wired up by :mod:`synapseml_tpu_torch.core.pipeline`):

- ``handleInvalid`` (``"error" | "skip" | "quarantine"``) is a param on
  every :class:`~synapseml_tpu_torch.core.pipeline.PipelineStage`;
  :func:`guarded_transform` / :func:`guarded_fit` enforce it at every
  ``transform``/``fit`` entry.  ``"error"`` is a strict pass-through —
  the default path is the unguarded stack, call for call.
- **Stage-boundary contracts**: declared input columns must exist
  (:class:`StageContractError` — not row-attributable, always raises),
  and NaN/Inf/None screens over the declared input columns route
  violating rows through the same ``handleInvalid`` policy before the
  stage ever runs.
- **Poison-batch bisection**: when a guarded stage throws on a batch,
  first-failure bisection isolates the offending row in ≤ ⌈log2 n⌉
  probe invocations plus one survivors re-run, emits it as a structured
  :class:`ErrorRecord`, and continues with the survivors.  Assumes
  row-deterministic failures (a poison row fails in any batch containing
  it); OOM (``torch.OutOfMemoryError`` included) and preemption errors
  are never attributed to rows.
- **Dead-letter quarantine** (:class:`Quarantine`): poisoned input rows
  land in an atomically-renamed batch directory (float32 columns in an
  SMLC column store written by :mod:`synapseml_tpu_torch.io.colstore`,
  everything else pickled, plus a schema-checked ``errors.json`` sidecar
  via :mod:`synapseml_tpu_torch.telemetry.artifact`) with their SOURCE
  row indices, and :meth:`Quarantine.replay` re-runs a fixed stage over
  them.  The layout is the JAX package's: either package reads a batch
  the other wrote.
- **OOM-adaptive batching** (:func:`run_adaptive`): consumers with a
  device batch dimension (the ONNX runner, the serving batch path) catch
  a device out-of-memory failure, halve the batch size, remember the
  safe size per key in the ``rowguard_safe_batch_size`` gauge, and retry
  instead of dying.

Fault sites: ``rowguard.poison_row`` fires per guarded stage invocation
(arm kind ``poison`` with a ``when`` predicate over the batch's source
rows to fail every batch containing a chosen row); ``oom`` fires before
every adaptive device call (arm kind ``oom`` with ``when`` on the batch
size); ``quarantine.write`` is a kill point between a quarantine batch's
row files and its atomic rename.

Telemetry: ``rowguard_stage_calls_total{stage,verb}``,
``rowguard_rows_total{stage,outcome}``,
``rowguard_bisection_probes_total{stage}``,
``rowguard_oom_events_total{key}``, ``rowguard_safe_batch_size{key}``,
``quarantine_batches_total{stage}``, ``quarantine_rows_total{stage}``.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dataset import Dataset
from ..core.logging import logger
from ..core.params import Params, StringParam
from ..telemetry import get_registry, read_json, write_json
from ..telemetry.flight import record as _flight
from .faults import PreemptionError, get_faults

__all__ = [
    "ErrorRecord", "HasErrorCol", "Quarantine", "QUARANTINE_DIR_ENV",
    "RowGuardError", "StageContractError", "default_quarantine_dir",
    "guard_context", "guarded_fit", "guarded_transform", "is_oom_error",
    "oom_fault_point", "run_adaptive", "safe_batch_size",
]

QUARANTINE_DIR_ENV = "SML_QUARANTINE_DIR"

#: handleInvalid values (Spark ML contract + the dead-letter extension)
HANDLE_INVALID_MODES = ("error", "skip", "quarantine")


class RowGuardError(RuntimeError):
    """Raised when a guarded stage cannot produce any output — every row
    was screened/bisected away (``all_rows_invalid=True``), or the
    isolation budget ran out on a batch-independent failure.  Carries
    the records so the caller sees WHY instead of a bare stage
    exception; the serving layer answers 422 for the former (the data
    was rejected) and 500 for the latter (the stage is broken)."""

    def __init__(self, message: str, records: Sequence["ErrorRecord"] = (),
                 all_rows_invalid: bool = False):
        super().__init__(message)
        self.records = list(records)
        self.all_rows_invalid = all_rows_invalid


class StageContractError(TypeError):
    """A declared stage-boundary contract is violated at the batch level
    (e.g. a required input column is missing) — there is no row to
    isolate, so this raises in every ``handleInvalid`` mode."""


@dataclass
class ErrorRecord:
    """One quarantined/skipped row — the shared error schema behind the
    ``errorCol`` sites, the quarantine sidecar, and the guard's records."""

    stage_uid: str
    stage_class: str
    #: index of the row in the SOURCE dataset (threaded through
    #: ``Dataset`` row ops via ``with_source_index``)
    row_index: int
    error_class: str
    error_message: str
    timestamp: float = field(default_factory=time.time)
    verb: str = "transform"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "stage_uid": self.stage_uid,
            "stage_class": self.stage_class,
            "row_index": int(self.row_index),
            "error_class": self.error_class,
            "error_message": self.error_message,
            "timestamp": float(self.timestamp),
            "verb": self.verb,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ErrorRecord":
        return ErrorRecord(
            stage_uid=d.get("stage_uid", ""),
            stage_class=d.get("stage_class", ""),
            row_index=int(d.get("row_index", -1)),
            error_class=d.get("error_class", ""),
            error_message=d.get("error_message", ""),
            timestamp=float(d.get("timestamp", 0.0)),
            verb=d.get("verb", "transform"))


class HasErrorCol(Params):
    """Mixin for stages that collect per-row errors into a column instead
    of raising (the reference's ``HasErrorCol``) — previously three
    hand-rolled copies in ``io.http`` / ``services.base`` /
    ``services.anomaly``, now one declaration with byte-compatible
    column name, default and value format."""

    errorCol = StringParam(doc="error column", default="errors")

    @staticmethod
    def response_error(resp) -> Optional[str]:
        """The shared errorCol value format: ``None`` for 2xx, else the
        exact ``"<status> <reason>"`` string the three original sites
        emitted."""
        return (None if 200 <= resp.status_code < 300
                else f"{resp.status_code} {resp.reason}")

    def error_records(self, ds: Dataset, errors: Sequence[Any],
                      verb: str = "transform") -> List[ErrorRecord]:
        """ErrorRecords for the non-None entries of an errorCol array,
        with source-row provenance from ``ds``."""
        src = ds.source_index
        return [ErrorRecord(stage_uid=self.uid,
                            stage_class=type(self).__name__,
                            row_index=int(src[i]),
                            error_class="ServiceError",
                            error_message=str(e), verb=verb)
                for i, e in enumerate(errors) if e is not None]


# --------------------------------------------------------------------------
# OOM detection + adaptive batching
# --------------------------------------------------------------------------

#: substrings marking a device allocation failure (XLA's status string,
#: the injected stand-in, and PyTorch's "CUDA out of memory" all carry one)
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "out of memory",
                "OUT_OF_MEMORY", "Out of memory")


def is_oom_error(e: BaseException) -> bool:
    """True for device out-of-memory failures (``torch.OutOfMemoryError``
    — "CUDA out of memory" —, host ``MemoryError``, or the injected
    :class:`~synapseml_tpu_torch.resilience.faults.ResourceExhaustedError`).
    These are batch-SIZE failures, not row failures: the row guard
    re-raises them and the adaptive batchers own the recovery."""
    if isinstance(e, MemoryError):
        return True
    text = f"{type(e).__name__}: {e}"
    return any(m in text for m in _OOM_MARKERS)


_safe_batch_lock = threading.Lock()
_safe_batch: Dict[str, int] = {}


def safe_batch_size(key: str, requested: int) -> int:
    """The remembered OOM-safe batch size for ``key`` capped at
    ``requested`` (``requested`` when nothing is remembered)."""
    with _safe_batch_lock:
        known = _safe_batch.get(key)
    return requested if known is None else max(1, min(requested, known))


def reset_safe_batch(key: Optional[str] = None) -> None:
    """Forget remembered OOM-safe batch sizes (all keys when None) —
    tests isolate their injected OOMs with this; a real deployment keeps
    the memory for the life of the process."""
    with _safe_batch_lock:
        if key is None:
            _safe_batch.clear()
        else:
            _safe_batch.pop(key, None)


def record_safe_batch(key: str, size: int) -> None:
    with _safe_batch_lock:
        _safe_batch[key] = int(size)
    get_registry().gauge(
        "rowguard_safe_batch_size",
        "largest batch size that ran without RESOURCE_EXHAUSTED",
        ("key",)).set(int(size), key=key)


def oom_fault_point(key: str, batch: int) -> None:
    """Injection site consulted before every adaptive device call: arm
    ``oom=oom`` (optionally with a ``when`` predicate on ``batch``) to
    manufacture a deterministic RESOURCE_EXHAUSTED."""
    get_faults().raise_point("oom", key=key, batch=int(batch))


def run_adaptive(key: str, batch_size: int, fn) -> Any:
    """Run ``fn(batch_size)`` with OOM-adaptive halving.

    ``fn`` executes the whole workload chunked at the given batch size
    (calling :func:`oom_fault_point` before each device dispatch).  On an
    out-of-memory failure the batch size halves and ``fn`` reruns; the size
    that completes is remembered per ``key`` (process-wide dict + the
    ``rowguard_safe_batch_size`` gauge) so later calls start at the safe
    size instead of re-discovering it.  Non-OOM errors propagate
    untouched; an OOM at batch size 1 is unrecoverable and re-raises.
    """
    requested = max(1, int(batch_size))
    bs = safe_batch_size(key, requested)
    reg = get_registry()
    hit_oom = False
    while True:
        try:
            out = fn(bs)
        except Exception as e:  # noqa: BLE001 — filtered to OOM below
            if not is_oom_error(e) or bs <= 1:
                raise
            bs = max(1, bs // 2)
            hit_oom = True
            reg.counter("rowguard_oom_events_total",
                        "RESOURCE_EXHAUSTED caught by adaptive batching",
                        ("key",)).inc(1, key=key)
            logger.warning("rowguard: %s hit RESOURCE_EXHAUSTED; retrying "
                           "with batch size %d", key, bs)
            continue
        if hit_oom:
            # remember only OOM-DISCOVERED ceilings: a small request
            # succeeding at its own (small) size says nothing about the
            # device limit and must not shrink the remembered one
            record_safe_batch(key, bs)
        return out


# --------------------------------------------------------------------------
# Dead-letter quarantine store
# --------------------------------------------------------------------------

def default_quarantine_dir() -> str:
    return os.environ.get(QUARANTINE_DIR_ENV) or os.path.join(
        os.getcwd(), "sml_quarantine")


#: required top-level keys of a batch's errors.json sidecar
_SIDECAR_SCHEMA = ("stage_uid", "stage_class", "written_at", "num_rows",
                   "columns", "colstore_columns", "pickle_columns",
                   "source_index", "records")

_batch_seq_lock = threading.Lock()
_batch_seq = 0


def _next_batch_name() -> str:
    global _batch_seq
    with _batch_seq_lock:
        _batch_seq += 1
        seq = _batch_seq
    return f"b{time.time_ns():x}-{os.getpid()}-{seq}"


class Quarantine:
    """Filesystem dead-letter store for poisoned rows.

    Layout::

        <dir>/<stage_uid>/<batch>/rows.smlc   float32 columns (colstore)
        <dir>/<stage_uid>/<batch>/rows.pkl    all other columns
        <dir>/<stage_uid>/<batch>/errors.json schema-checked sidecar

    Appends are SIGKILL-atomic: a batch is staged in a ``tmp-`` directory
    (sidecar written last via the atomic artifact writer) and
    ``os.rename``\\ d into place in one step — a reader never observes a
    partial batch, and a crash mid-write leaves only an ignored ``tmp-``
    directory.  The ``quarantine.write`` kill point sits between the row
    files and the rename so tests can prove it.
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or default_quarantine_dir()

    # -- writing -----------------------------------------------------------
    def add(self, stage_uid: str, rows: Dataset,
            records: Sequence[ErrorRecord],
            stage_class: str = "") -> str:
        """Atomically append one batch of poisoned rows + their records;
        returns the committed batch directory."""
        stage_dir = os.path.join(self.directory, stage_uid)
        os.makedirs(stage_dir, exist_ok=True)
        name = _next_batch_name()
        tmp = os.path.join(stage_dir, f"tmp-{name}")
        final = os.path.join(stage_dir, name)
        os.makedirs(tmp, exist_ok=True)

        col_cols = [c for c in rows.columns
                    if rows[c].dtype == np.float32]
        pkl_cols = [c for c in rows.columns if c not in col_cols]
        if col_cols:
            from ..io.colstore import write_matrix
            write_matrix(os.path.join(tmp, "rows.smlc"),
                         np.column_stack([rows[c] for c in col_cols]))
        if pkl_cols:
            with open(os.path.join(tmp, "rows.pkl"), "wb") as f:
                pickle.dump({c: rows[c] for c in pkl_cols}, f)
                f.flush()
                os.fsync(f.fileno())
        sidecar = {
            "stage_uid": stage_uid,
            "stage_class": stage_class,
            "written_at": time.time(),
            "num_rows": rows.num_rows,
            "columns": rows.columns,
            "colstore_columns": col_cols,
            "pickle_columns": pkl_cols,
            "source_index": [int(i) for i in rows.source_index],
            "records": [r.to_dict() for r in records],
        }
        write_json(os.path.join(tmp, "errors.json"), sidecar,
                   schema=_SIDECAR_SCHEMA)
        # kill point: a SIGKILL here leaves only the tmp- staging dir,
        # which every reader ignores — the store stays consistent
        get_faults().kill_point("quarantine.write", stage=stage_uid,
                                rows=rows.num_rows)
        os.rename(tmp, final)
        reg = get_registry()
        reg.counter("quarantine_batches_total",
                    "dead-letter batches committed", ("stage",)).inc(
                        1, stage=stage_uid)
        reg.counter("quarantine_rows_total",
                    "rows in the dead-letter store", ("stage",)).inc(
                        rows.num_rows, stage=stage_uid)
        return final

    # -- reading -----------------------------------------------------------
    def stage_uids(self) -> List[str]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(d for d in os.listdir(self.directory)
                      if os.path.isdir(os.path.join(self.directory, d)))

    def batches(self, stage_uid: str) -> List[str]:
        stage_dir = os.path.join(self.directory, stage_uid)
        if not os.path.isdir(stage_dir):
            return []
        out = []
        for name in sorted(os.listdir(stage_dir)):
            if name.startswith("tmp-"):
                continue               # torn write: never committed
            if os.path.exists(os.path.join(stage_dir, name, "errors.json")):
                out.append(os.path.join(stage_dir, name))
        return out

    @staticmethod
    def _load_batch(batch_dir: str) -> Tuple[Dataset, List[ErrorRecord]]:
        meta = read_json(os.path.join(batch_dir, "errors.json"),
                         schema=_SIDECAR_SCHEMA)
        cols: Dict[str, Any] = {}
        if meta["colstore_columns"]:
            from ..io.colstore import read_matrix
            mat = read_matrix(os.path.join(batch_dir, "rows.smlc"))
            for i, c in enumerate(meta["colstore_columns"]):
                cols[c] = mat[:, i].copy()
        if meta["pickle_columns"]:
            with open(os.path.join(batch_dir, "rows.pkl"), "rb") as f:
                cols.update(pickle.load(f))
        ordered = {c: cols[c] for c in meta["columns"]}
        ds = Dataset(ordered, row_index=np.asarray(meta["source_index"],
                                                   dtype=np.int64))
        records = [ErrorRecord.from_dict(r) for r in meta["records"]]
        return ds, records

    def records(self, stage_uid: Optional[str] = None) -> List[ErrorRecord]:
        uids = [stage_uid] if stage_uid else self.stage_uids()
        out: List[ErrorRecord] = []
        for uid in uids:
            for b in self.batches(uid):
                out.extend(self._load_batch(b)[1])
        return out

    def rows(self, stage_uid: str) -> Optional[Dataset]:
        """Union of every committed batch's rows for a stage (None when
        the stage has nothing quarantined)."""
        parts = [self._load_batch(b)[0] for b in self.batches(stage_uid)]
        if not parts:
            return None
        ds = parts[0]
        for p in parts[1:]:
            ds = ds.union(p)
        return ds

    # -- replay ------------------------------------------------------------
    def replay(self, stage, stage_uid: Optional[str] = None,
               remove: bool = True) -> Optional[Dataset]:
        """Re-run a (fixed) stage over its quarantined rows.

        ``stage_uid`` defaults to ``stage.uid`` — pass the original uid
        when the fixed stage is a fresh instance.  The stage's own
        ``handleInvalid`` applies, so still-poisoned rows re-quarantine
        under the replaying stage's policy.  On success the replayed
        batches are removed (``remove=False`` keeps them); returns the
        transformed rows, or None when nothing was quarantined."""
        uid = stage_uid or stage.uid
        batches = self.batches(uid)
        rows = self.rows(uid)
        if rows is None:
            return None
        out = stage.transform(rows)
        if remove:
            import shutil
            for b in batches:
                shutil.rmtree(b, ignore_errors=True)
        return out

    def clear(self, stage_uid: Optional[str] = None) -> None:
        import shutil
        uids = [stage_uid] if stage_uid else self.stage_uids()
        for uid in uids:
            shutil.rmtree(os.path.join(self.directory, uid),
                          ignore_errors=True)


# --------------------------------------------------------------------------
# Guard context (pipeline-level handleInvalid propagation)
# --------------------------------------------------------------------------

_ctx = threading.local()


class guard_context:
    """Propagate a ``handleInvalid`` mode / quarantine dir to every stage
    invoked inside the block whose own param is unset —
    ``Pipeline.fit``/``transform`` wrap their stage loop in this, so a
    pipeline-level policy reaches each stage while an explicitly-set
    stage param still wins.  Nests: inner None values inherit."""

    def __init__(self, mode: Optional[str] = None,
                 quarantine_dir: Optional[str] = None):
        if mode is not None and mode not in HANDLE_INVALID_MODES:
            raise ValueError(f"handleInvalid must be one of "
                             f"{HANDLE_INVALID_MODES}, got {mode!r}")
        self.mode = mode
        self.quarantine_dir = quarantine_dir
        self._saved: Tuple[Optional[str], Optional[str]] = (None, None)

    def __enter__(self):
        self._saved = (getattr(_ctx, "mode", None),
                       getattr(_ctx, "qdir", None))
        if self.mode is not None:
            _ctx.mode = self.mode
        if self.quarantine_dir is not None:
            _ctx.qdir = self.quarantine_dir
        return self

    def __exit__(self, *exc):
        _ctx.mode, _ctx.qdir = self._saved
        return False


def effective_mode(stage) -> str:
    """Explicitly-set stage param > enclosing guard_context > declared
    default ('error')."""
    if stage.is_set("handleInvalid"):
        return stage.get("handleInvalid")
    ctx = getattr(_ctx, "mode", None)
    if ctx:
        return ctx
    return stage.get_or_default("handleInvalid") or "error"


def _effective_quarantine_dir(stage) -> str:
    if stage.is_set("quarantineDir"):
        return stage.get("quarantineDir")
    ctx = getattr(_ctx, "qdir", None)
    return ctx or stage.get_or_default("quarantineDir") \
        or default_quarantine_dir()


# --------------------------------------------------------------------------
# The guard
# --------------------------------------------------------------------------

#: errors that must never be attributed to rows: preemption is control
#: plane, OOM is batch-size (handled by the adaptive batchers upstream)
_NON_ROW_ERRORS = (PreemptionError, KeyboardInterrupt, SystemExit)


def isolation_budget(n: int) -> int:
    """Exception-path invocations allowed while isolating poison records
    in a batch of ``n`` — enough to corner a few genuine poison rows
    (~4 at ⌈log2 n⌉+1 each), after which a batch-INDEPENDENT failure
    (broken stage/model, not bad data) fails wholesale.  Shared by the
    pipeline guard and the serving batch path so the bound is tuned in
    one place."""
    return 4 * max(1, n - 1).bit_length() + 8


def _concat_datasets(parts: Sequence[Dataset]) -> Dataset:
    """Linear multi-way union of same-schema datasets (pairwise
    ``Dataset.union`` over k poison slices would be O(k^2) row copies)."""
    if len(parts) == 1:
        return parts[0]
    cols: Dict[str, Any] = {}
    for k in parts[0].columns:
        arrs = [p[k] for p in parts]
        if any(a.dtype == object for a in arrs):
            out = np.empty(sum(len(a) for a in arrs), dtype=object)
            off = 0
            for a in arrs:
                out[off:off + len(a)] = a
                off += len(a)
            cols[k] = out
        else:
            cols[k] = np.concatenate(arrs)
    ri = None
    if all(p.has_source_index for p in parts):
        ri = np.concatenate([p.source_index for p in parts])
    return Dataset(cols, parts[0].num_partitions, row_index=ri)


def guarded_transform(stage, ds: Dataset) -> Dataset:
    """``Transformer.transform`` entry: pass through in 'error' mode,
    otherwise screen + bisect + skip/quarantine per row."""
    mode = effective_mode(stage)
    if mode == "error" or getattr(stage, "_guard_exempt", False):
        return stage._transform(ds)
    return _RowGuard(stage, mode, "transform").run(ds)


def guarded_fit(stage, ds: Dataset):
    """``Estimator.fit`` entry (returns the fitted model)."""
    mode = effective_mode(stage)
    if mode == "error" or getattr(stage, "_guard_exempt", False):
        return stage._fit(ds)
    return _RowGuard(stage, mode, "fit").run(ds)


_guard_metrics_cache = None


def _guard_metrics():
    """(calls, rows, probes) counters, registered once — the guard runs
    per transform, so metric get-or-create must not."""
    global _guard_metrics_cache
    if _guard_metrics_cache is None:
        reg = get_registry()
        _guard_metrics_cache = (
            reg.counter("rowguard_stage_calls_total",
                        "guarded stage invocations (probes included)",
                        ("stage", "verb")),
            reg.counter("rowguard_rows_total",
                        "rows screened out by the guard",
                        ("stage", "outcome")),
            reg.counter("rowguard_bisection_probes_total",
                        "extra stage invocations spent isolating poison "
                        "rows", ("stage",)),
        )
    return _guard_metrics_cache


class _RowGuard:
    """One guarded stage invocation: contract check → NaN/Inf screen →
    first-failure bisection → errorCol routing → skip/quarantine."""

    def __init__(self, stage, mode: str, verb: str):
        self.stage = stage
        self.mode = mode
        self.verb = verb
        self.records: List[ErrorRecord] = []
        self.bad_rows: List[Dataset] = []      # input-side poisoned slices
        self.faults = get_faults()
        self._m_calls, self._m_rows, self._m_probes = _guard_metrics()

    # -- plumbing ----------------------------------------------------------
    def _invoke(self, sub: Dataset):
        self._m_calls.inc(1, stage=self.stage.uid, verb=self.verb)
        f = self.faults
        if f.record_calls or f.active:
            f.note("rowguard.call", stage=self.stage.uid, verb=self.verb,
                   rows=sub.num_rows)
            f.raise_point("rowguard.poison_row", stage=self.stage.uid,
                          rows=sub.source_index, n=sub.num_rows)
        if self.verb == "transform":
            return self.stage._transform(sub)
        return self.stage._fit(sub)

    def _record(self, row: Dataset, error_class: str, message: str) -> None:
        self.records.append(ErrorRecord(
            stage_uid=self.stage.uid,
            stage_class=type(self.stage).__name__,
            row_index=int(row.source_index[0]),
            error_class=error_class, error_message=message, verb=self.verb))
        self.bad_rows.append(row)
        self._m_rows.inc(1, stage=self.stage.uid, outcome=self.mode)
        _flight("rowguard", stage=self.stage.uid, verdict=self.mode,
                rows=1, row=int(row.source_index[0]), error=error_class)

    def _record_mask(self, ds: Dataset, bad: np.ndarray,
                     error_class: str, reasons: Dict[int, str]) -> None:
        # attach identity provenance first (no-op when tracked): the bad
        # SLICE must carry original row numbers, not subset positions
        ds = ds.with_source_index()
        src = ds.source_index
        for i in np.flatnonzero(bad):
            self.records.append(ErrorRecord(
                stage_uid=self.stage.uid,
                stage_class=type(self.stage).__name__,
                row_index=int(src[i]), error_class=error_class,
                error_message=reasons.get(int(i), "invalid value"),
                verb=self.verb))
        self.bad_rows.append(ds._mask_rows(bad))
        self._m_rows.inc(int(bad.sum()), stage=self.stage.uid,
                         outcome=self.mode)
        _flight("rowguard", stage=self.stage.uid, verdict=self.mode,
                rows=int(bad.sum()), error=error_class)

    # -- stage-boundary contract + NaN/Inf screen --------------------------
    def _screen(self, ds: Dataset) -> Dataset:
        cols = self.stage.guard_input_columns(for_fit=(self.verb == "fit"))
        missing = [c for c in cols if c not in ds]
        if missing:
            raise StageContractError(
                f"{type(self.stage).__name__} (uid={self.stage.uid}) "
                f"requires input columns {missing}; dataset has "
                f"{ds.columns}")
        if not cols or not getattr(self.stage, "_guard_screen_nan", True):
            return ds
        n = ds.num_rows
        bad: Optional[np.ndarray] = None      # clean path allocates nothing
        reasons: Dict[int, str] = {}
        for c in cols:
            col = ds[c]
            if col.dtype.kind == "f":
                # allocation-free fast screen: a sum is non-finite iff
                # any element is (NaN propagates; inf±inf → ±inf/NaN);
                # an all-finite overflow only costs the slow re-check
                if np.isfinite(np.sum(col)):  # the overwhelmingly common case
                    continue
                m = ~np.isfinite(col)
                if not m.any():               # overflowed yet all finite
                    continue
                kind = "non-finite value"
            elif col.dtype == object:
                m = np.fromiter((v is None for v in col), dtype=bool,
                                count=n)
                if not m.any():
                    continue
                kind = "None value"
            else:
                continue
            if bad is None:
                bad = np.zeros(n, dtype=bool)
            for i in np.flatnonzero(m & ~bad):
                reasons[int(i)] = f"{kind} in input column {c!r}"
            bad |= m
        if bad is not None:
            # provenance attaches only now — the rare poisoned path —
            # so the clean path never pays for the identity index
            ds = ds.with_source_index()
            self._record_mask(ds, bad, "StageContractError", reasons)
            return ds._mask_rows(~bad)
        return ds

    def _spend_budget(self, err: Exception) -> None:
        """Bound isolation work for batch-INDEPENDENT failures (a broken
        stage fails every probe identically): once the budget — enough
        invocations to corner a few genuine poison rows — is gone, flush
        what was attributed and fail fast instead of burning O(n log n)
        stage calls on a stage that was never going to answer."""
        self._budget -= 1
        if self._budget >= 0:
            return
        self._finish()
        raise RowGuardError(
            f"{type(self.stage).__name__} (uid={self.stage.uid}): "
            f"isolation budget exhausted after {len(self.records)} "
            f"row(s) — the stage appears to fail batch-independently "
            f"({type(err).__name__}: {err})", self.records) from err

    # -- first-failure bisection -------------------------------------------
    def _find_first_poison(self, ds: Dataset,
                           err: Exception) -> Tuple[int, Exception]:
        """Position of the first poison row in ``ds`` (which failed as a
        whole), in ≤ ⌈log2 n⌉ probe invocations: probe the left half of
        the candidate range; success means the first failure sits right
        of it, failure narrows into it."""
        lo, hi = 0, ds.num_rows
        while hi - lo > 1:
            mid = (lo + hi) // 2
            self._m_probes.inc(1, stage=self.stage.uid)
            self._spend_budget(err)
            try:
                self._invoke(ds._mask_rows(slice(lo, mid)))
            except _NON_ROW_ERRORS:
                raise
            except Exception as e:  # noqa: BLE001 — recorded per row
                if is_oom_error(e):
                    raise
                err, hi = e, mid
            else:
                lo = mid
        return lo, err

    # -- errorCol routing --------------------------------------------------
    def _route_error_col(self, inp: Dataset, out: Dataset) -> Dataset:
        if not self.stage.has_param("errorCol"):
            return out
        ecol = self.stage.get_or_default("errorCol")
        if (not ecol or ecol not in out
                or out.num_rows != inp.num_rows):
            return out
        errs = out[ecol]
        if errs.dtype != object:
            return out
        bad = np.fromiter((e is not None for e in errs), dtype=bool,
                          count=out.num_rows)
        if not bad.any():
            return out
        reasons = {int(i): str(errs[i]) for i in np.flatnonzero(bad)}
        self._record_mask(inp, bad, "ServiceError", reasons)
        if not out.has_source_index:
            # output rows map 1:1 onto input rows here (checked above) —
            # carry the input's provenance through the mask
            out = out.with_source_index(inp.source_index)
        return out._mask_rows(~bad)

    # -- skip/quarantine finalization --------------------------------------
    def _finish(self) -> None:
        if not self.records:
            return
        if self.mode == "quarantine":
            Quarantine(_effective_quarantine_dir(self.stage)).add(
                self.stage.uid, _concat_datasets(self.bad_rows),
                self.records, stage_class=type(self.stage).__name__)
        logger.warning(
            "rowguard: %s %s dropped %d row(s) in %r mode (first: %s)",
            type(self.stage).__name__, self.stage.uid, len(self.records),
            self.mode, self.records[0].error_message)

    # -- one guarded invocation ---------------------------------------------
    def run(self, ds: Dataset):
        # provenance is attached LAZILY: the clean path stays untouched;
        # the screen and the exception path attach the identity index
        # right before the first row leaves (at which point positions
        # still equal source rows, so identity is correct)
        survivors = self._screen(ds)
        self._budget = isolation_budget(survivors.num_rows)
        while True:
            empty = survivors.num_rows == 0
            if empty and self.records:
                self._finish()
                raise RowGuardError(
                    f"no rows survived {type(self.stage).__name__} "
                    f"(uid={self.stage.uid}) in {self.mode!r} mode: all "
                    f"{len(self.records)} input rows were invalid "
                    f"(first: {self.records[0].error_message})",
                    self.records, all_rows_invalid=True)
            try:
                out = self._invoke(survivors)
                break
            except _NON_ROW_ERRORS:
                raise
            except (StageContractError, RowGuardError):
                raise
            except Exception as e:  # noqa: BLE001 — bisected into rows
                if is_oom_error(e) or empty:
                    raise
                self._spend_budget(e)
                survivors = survivors.with_source_index()
                if survivors.num_rows == 1:
                    pos, err = 0, e
                else:
                    pos, err = self._find_first_poison(survivors, e)
                self._record(survivors._mask_rows(slice(pos, pos + 1)),
                             type(err).__name__, str(err))
                keep = np.ones(survivors.num_rows, dtype=bool)
                keep[pos] = False
                survivors = survivors._mask_rows(keep)
        if self.verb == "transform":
            out = self._route_error_col(survivors, out)
        self._finish()
        return out
