"""Persisted per-(device, geometry) tuning tables: the storage half of
the port's self-tuning plane.

The PyTorch port of the JAX package's ``telemetry/tunetable.py``.  The
:class:`~synapseml_tpu_torch.telemetry.autotune.Autotuner` measures the
port's own kernels and records each search space's winner here; every
construction site that tunes (the GBDT histogram launches, ``SlotEngine``)
consults the SAME loader, so a machine tunes once and every later process
loads the table from :data:`TUNE_TABLE_ENV`.

**The honesty rule**: an entry exists only because a real measurement
produced it on a matching ``(device_kind, geometry)``.
:meth:`TunePlane.record` refuses non-positive/non-finite measurements;
:meth:`TunePlane.consult` returns a winner ONLY for an exact ``(space,
device_kind, geometry)`` match that is neither stale nor rejected by the
caller's validator — anything else returns ``None`` and the caller keeps
its defaults, launching exactly what a table-less process launches.

The device kind is per DEVICE, not per process: an entry is keyed by the
device its space ran on, and a consult site passes the device its work
runs on (:func:`device_kind`), so a CPU-fitted engine in a process that
has a card never loads the card's winner.

The table file is one schema-versioned JSON document written through
:func:`telemetry.artifact.write_json` (serialize → re-parse → tmpfile →
fsync → rename → dir fsync), so a SIGKILL mid-write leaves either the
old table or the new one.  The file format is the JAX package's: each
package reads the other's table.  Every consult is remembered (outcome +
site) and served by ``GET /tunez``.

Stdlib-only at import time; torch is touched lazily (device names).
"""

from __future__ import annotations

import functools
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .artifact import SchemaError, read_json, write_json
from .flight import record as flight_record
from .registry import get_registry

__all__ = [
    "TUNE_TABLE_ENV", "TUNE_TABLE_BASENAME", "TUNE_TABLE_SCHEMA_VERSION",
    "TUNE_TABLE_MAX_AGE_ENV", "DEFAULT_MAX_AGE_S",
    "CONSULT_OUTCOMES", "ENTRY_KEYS",
    "device_kind", "geometry_key", "table_path",
    "check_tune_table", "check_tunez",
    "TunePlane", "get_tuneplane", "set_tuneplane",
]

#: env var naming the tuning-table directory (the JAX package's name: a
#: directory may hold both packages' entries, under different spaces)
TUNE_TABLE_ENV = "SMLTPU_TUNE_TABLE_DIR"

#: the single table file inside that directory
TUNE_TABLE_BASENAME = "tunetable.json"

#: bumped on any incompatible entry-shape change; a table written under
#: another version refuses to load WHOLESALE (defaults everywhere) —
#: never a partial reinterpretation of old measurements
TUNE_TABLE_SCHEMA_VERSION = 1

#: entries older than this are ``stale`` (software rollouts, recabling,
#: firmware — measurements do rot); override via the env var below
DEFAULT_MAX_AGE_S = 30 * 24 * 3600.0
TUNE_TABLE_MAX_AGE_ENV = "SMLTPU_TUNE_TABLE_MAX_AGE_S"

#: required keys of one table entry
ENTRY_KEYS = ("space", "device_kind", "geometry", "winner", "measured_ms",
              "trials", "measured_unix", "source")

#: the closed consult-outcome set (``autotune_table_consults_total``
#: label values; only ``loaded`` changes dispatch)
CONSULT_OUTCOMES = ("loaded", "absent", "mismatch", "stale", "invalid",
                    "disabled")


def device_kind(device=None) -> str:
    """The table key of the device the work runs on: a card's CUDA name
    lowercased with ``_`` for spaces (``'nvidia_h100_80gb_hbm3'``),
    ``'cpu'`` for the CPU.  ``device=None`` is the process's default:
    the current card where one is present, else the CPU.  ``'unknown'``
    when the name cannot be read — and an unknown device matches no
    table entry, per the honesty rule."""
    try:
        import torch
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        if dev.type == "cpu":
            return "cpu"
        if dev.type != "cuda":
            return "unknown"
        return _cuda_kind(torch.cuda.current_device() if dev.index is None
                          else dev.index)
    except Exception:
        return "unknown"


@functools.lru_cache(maxsize=None)
def _cuda_kind(index: int) -> str:
    import torch
    kind = "_".join(str(torch.cuda.get_device_name(index)).strip().lower()
                    .split())
    return kind or "unknown"


def geometry_key(**dims: Any) -> str:
    """Canonical geometry string: ``k=v`` pairs sorted by key, joined
    with ``,`` — the recorder and every consult site MUST build the key
    through this one function or they silently never match."""
    return ",".join(f"{k}={dims[k]}" for k in sorted(dims))


def table_path(directory: str) -> str:
    return os.path.join(directory, TUNE_TABLE_BASENAME)


def _check_entry(e: Any) -> None:
    if not isinstance(e, dict):
        raise SchemaError(f"tune entry must be an object, got "
                          f"{type(e).__name__}")
    missing = [k for k in ENTRY_KEYS if k not in e]
    if missing:
        raise SchemaError(f"tune entry missing keys {missing}")
    for k in ("space", "device_kind", "geometry", "source"):
        if not isinstance(e[k], str) or not e[k]:
            raise SchemaError(f"tune entry[{k!r}] must be a non-empty "
                              f"string, got {e[k]!r}")
    if not isinstance(e["winner"], dict) or not e["winner"]:
        raise SchemaError("tune entry['winner'] must be a non-empty object")
    ms = e["measured_ms"]
    if (isinstance(ms, bool) or not isinstance(ms, (int, float))
            or not math.isfinite(ms) or ms <= 0.0):
        raise SchemaError(
            f"tune entry['measured_ms'] = {ms!r}: an entry requires a "
            "real, finite, positive measurement (the honesty rule)")
    tr = e["trials"]
    if isinstance(tr, bool) or not isinstance(tr, int) or tr < 1:
        raise SchemaError(f"tune entry['trials'] = {tr!r}: need an int >= 1")
    mu = e["measured_unix"]
    if (isinstance(mu, bool) or not isinstance(mu, (int, float))
            or not math.isfinite(mu)):
        raise SchemaError(f"tune entry['measured_unix'] = {mu!r}")


def check_tune_table(obj: Any) -> None:
    """Callable schema (``telemetry.artifact`` form) for the table file:
    schema-versioned top level + every entry honest."""
    if not isinstance(obj, dict):
        raise SchemaError("tune table must be a JSON object")
    if obj.get("schema_version") != TUNE_TABLE_SCHEMA_VERSION:
        raise SchemaError(
            f"tune table schema_version {obj.get('schema_version')!r} != "
            f"{TUNE_TABLE_SCHEMA_VERSION}: refusing the whole table")
    if not isinstance(obj.get("entries"), list):
        raise SchemaError("tune table needs an 'entries' list")
    for e in obj["entries"]:
        _check_entry(e)


def check_tunez(obj: Any) -> None:
    """Callable schema for the ``GET /tunez`` payload — validated before
    serving (the ``/sloz`` discipline: a malformed snapshot is a 500,
    never a silently wrong 200)."""
    if not isinstance(obj, dict):
        raise SchemaError("/tunez payload must be an object")
    for k in ("schema_version", "directory", "device_kind", "max_age_s",
              "load_error", "entries", "consults"):
        if k not in obj:
            raise SchemaError(f"/tunez payload missing {k!r}")
    if obj["schema_version"] != TUNE_TABLE_SCHEMA_VERSION:
        raise SchemaError(f"/tunez schema_version {obj['schema_version']!r}")
    if not isinstance(obj["entries"], list) \
            or not isinstance(obj["consults"], list):
        raise SchemaError("/tunez entries/consults must be lists")
    for e in obj["entries"]:
        _check_entry(e)
        for k in ("age_s", "stale", "matches_device"):
            if k not in e:
                raise SchemaError(f"/tunez entry missing {k!r}")
    for c in obj["consults"]:
        if not isinstance(c, dict):
            raise SchemaError("/tunez consult must be an object")
        for k in ("site", "space", "geometry", "outcome", "unix"):
            if k not in c:
                raise SchemaError(f"/tunez consult missing {k!r}")
        if c["outcome"] not in CONSULT_OUTCOMES:
            raise SchemaError(f"/tunez consult outcome {c['outcome']!r}")


class TunePlane:
    """The ONE loader between tuning tables and construction sites.

    ``consult(site, space, geometry, device=...)`` → the winner config
    dict, or ``None`` (keep defaults).  ``kind`` pins the device kind of
    every consult and record (tests, a table written for another
    machine); unpinned, each call keys by its ``device``.  Every consult
    lands in ``autotune_table_consults_total{space,outcome}``, a flight
    event, and the bounded consult log ``/tunez`` serves — so "which
    construction sites actually loaded the table this process" is an
    introspection answer.
    """

    #: bound on the remembered consult log (/tunez payload size)
    MAX_CONSULTS = 256

    def __init__(self, directory: Optional[str] = None,
                 kind: Optional[str] = None,
                 max_age_s: Optional[float] = None):
        if directory is None:
            directory = os.environ.get(TUNE_TABLE_ENV) or None
        self.directory = str(directory) if directory else None
        if max_age_s is None:
            raw = os.environ.get(TUNE_TABLE_MAX_AGE_ENV, "")
            try:
                max_age_s = float(raw) if raw else DEFAULT_MAX_AGE_S
            except ValueError:
                max_age_s = DEFAULT_MAX_AGE_S
        self.max_age_s = float(max_age_s)
        self._kind = str(kind) if kind else None
        self._lock = threading.RLock()
        self._entries: Dict[Tuple[str, str, str], dict] = {}
        self._loaded = False
        self._load_error: Optional[str] = None
        self._consults: List[dict] = []
        self._c_consults = get_registry().counter(
            "autotune_table_consults_total",
            "tuning-table consults by construction sites, by search space "
            "and outcome (loaded/absent/mismatch/stale/invalid/disabled; "
            "only 'loaded' changes dispatch)", ("space", "outcome"))

    # -- identity ----------------------------------------------------------
    @property
    def kind(self) -> str:
        """The pinned kind, else the process's default device's."""
        return self._kind if self._kind is not None else device_kind()

    def kind_of(self, device=None) -> str:
        """The kind a consult or record on ``device`` keys by."""
        if self._kind is not None:
            return self._kind
        return device_kind(device)

    # -- load --------------------------------------------------------------
    def _load_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        if not self.directory:
            return
        path = table_path(self.directory)
        if not os.path.exists(path):
            return
        try:
            obj = read_json(path, schema=check_tune_table)
        except (OSError, ValueError) as e:
            # SchemaError is a ValueError: a version-mismatched or
            # malformed table refuses WHOLESALE — defaults everywhere,
            # never a partial read of measurements we can't interpret
            self._load_error = f"{type(e).__name__}: {e}"
            return
        for e in obj["entries"]:
            self._entries[(e["space"], e["device_kind"], e["geometry"])] = e

    def reload(self) -> None:
        """Drop the in-memory view and re-read the table file (another
        process re-tuned)."""
        with self._lock:
            self._entries.clear()
            self._loaded = False
            self._load_error = None
            self._load_locked()

    # -- consult -----------------------------------------------------------
    def consult(self, site: str, space: str, geometry: str,
                validate: Optional[Callable[[dict], bool]] = None,
                device=None) -> Optional[dict]:
        """→ a copy of the winner config for ``(space, the kind of
        device, geometry)``, or ``None`` = keep defaults.  ``device`` is
        where the caller's work runs (default: the process's default
        device).  ``validate`` lets the construction site re-check the
        winner against its OWN gates (shared-memory fit) — a winner
        failing them is ``invalid``, not trusted; a validator that
        raises counts as rejection."""
        entry: Optional[dict] = None
        kind = self.kind_of(device)
        with self._lock:
            self._load_locked()
            if not self.directory:
                outcome = "disabled"
            elif self._load_error is not None:
                outcome = "mismatch"
            else:
                e = self._entries.get((str(space), kind, str(geometry)))
                if e is None:
                    # measurements exist for this space, but none on THIS
                    # (device, geometry): a mismatch, distinct from a
                    # space nobody ever tuned
                    any_for_space = any(k[0] == space for k in self._entries)
                    outcome = "mismatch" if any_for_space else "absent"
                elif (self.max_age_s > 0 and
                        time.time() - float(e["measured_unix"])
                        > self.max_age_s):
                    outcome = "stale"
                elif validate is not None and not _safe(validate, e["winner"]):
                    outcome = "invalid"
                else:
                    outcome = "loaded"
                    entry = e
            self._consults.append({
                "site": str(site), "space": str(space),
                "geometry": str(geometry), "outcome": outcome,
                "unix": time.time()})
            if len(self._consults) > self.MAX_CONSULTS:
                del self._consults[:-self.MAX_CONSULTS]
        self._c_consults.inc(1, space=str(space), outcome=outcome)
        flight_record("tune_consult", site=str(site), space=str(space),
                      geometry=str(geometry), outcome=outcome)
        return dict(entry["winner"]) if entry is not None else None

    # -- record ------------------------------------------------------------
    def record(self, space: str, geometry: str, winner: Dict[str, Any],
               measured_ms: float, trials: int,
               source: str = "autotune", device=None) -> dict:
        """Persist ONE measured winner, keyed by the kind of ``device``
        (where it was measured), and atomically rewrite the table.
        The honesty gate lives here: a non-finite or non-positive
        ``measured_ms`` (or an empty winner) raises — a number that was
        never measured cannot enter the table."""
        if not self.directory:
            raise ValueError(
                "TunePlane has no table directory (set SMLTPU_TUNE_TABLE_DIR"
                " or construct with directory=...) — nothing to record into")
        entry = {
            "space": str(space),
            "device_kind": self.kind_of(device),
            "geometry": str(geometry),
            "winner": dict(winner),
            "measured_ms": float(measured_ms),
            "trials": int(trials),
            "measured_unix": time.time(),
            "source": str(source),
        }
        _check_entry(entry)    # raises SchemaError on fabricated numbers
        with self._lock:
            self._load_locked()
            self._entries[(entry["space"], entry["device_kind"],
                           entry["geometry"])] = entry
            os.makedirs(self.directory, exist_ok=True)
            obj = {"schema_version": TUNE_TABLE_SCHEMA_VERSION,
                   "written_unix": time.time(),
                   "entries": sorted(
                       self._entries.values(),
                       key=lambda e: (e["space"], e["device_kind"],
                                      e["geometry"]))}
            write_json(table_path(self.directory), obj,
                       schema=check_tune_table)
        flight_record("tune_record", space=entry["space"],
                      device_kind=entry["device_kind"],
                      geometry=entry["geometry"],
                      measured_ms=entry["measured_ms"],
                      trials=entry["trials"], source=entry["source"])
        return entry

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        """The ``GET /tunez`` payload: every loaded entry with staleness
        and device-match annotations (against :attr:`kind`), plus the
        consult log."""
        kind = self.kind
        with self._lock:
            self._load_locked()
            now = time.time()
            entries = []
            for e in sorted(self._entries.values(),
                            key=lambda e: (e["space"], e["device_kind"],
                                           e["geometry"])):
                age = now - float(e["measured_unix"])
                entries.append({
                    **e,
                    "age_s": age,
                    "stale": bool(self.max_age_s > 0
                                  and age > self.max_age_s),
                    "matches_device": e["device_kind"] == kind,
                })
            return {
                "schema_version": TUNE_TABLE_SCHEMA_VERSION,
                "directory": self.directory,
                "device_kind": kind,
                "max_age_s": self.max_age_s,
                "load_error": self._load_error,
                "entries": entries,
                "consults": list(self._consults),
            }


def _safe(validate: Callable[[dict], bool], winner: dict) -> bool:
    try:
        return bool(validate(dict(winner)))
    except Exception:
        return False


# ---------------------------------------------------------------------------
# process-wide plane
# ---------------------------------------------------------------------------

_plane: Optional[TunePlane] = None
_plane_pinned = False
_plane_lock = threading.Lock()


def get_tuneplane() -> TunePlane:
    """The process-default plane.  Re-resolved when
    ``SMLTPU_TUNE_TABLE_DIR`` changes, unless a plane was pinned via
    :func:`set_tuneplane`."""
    global _plane
    with _plane_lock:
        env_dir = os.environ.get(TUNE_TABLE_ENV) or None
        if _plane is None or (not _plane_pinned
                              and _plane.directory != env_dir):
            _plane = TunePlane(env_dir)
        return _plane


def set_tuneplane(plane: Optional[TunePlane]) -> Optional[TunePlane]:
    """Swap the process-default plane (tests, ``chip_smoke.py``) → the
    previous one.  ``None`` unpins and reverts to env resolution."""
    global _plane, _plane_pinned
    with _plane_lock:
        prev = _plane
        _plane = plane
        _plane_pinned = plane is not None
        return prev
