"""Crash flight recorder: a bounded, allocation-stable ring of structured
events, dumped SIGKILL-atomically for post-mortem bundles.

Gang supervision tears a failed gang down with only bounded log
tails as evidence — every rank's counters, spans and step timings die
with its process, so a hung/killed rank yields a verdict string but no
structured trace of *what it was doing*.  The flight recorder closes
that gap the way an aircraft FDR does: every instrumented layer writes
compact events into a fixed-size in-process ring (collective begin/end
with op/axis/bytes, checkpoint publishes, retry/backoff firings, fault
injections, heartbeat emits, rowguard verdicts), and the ring's tail is

- exported live over the gang wire (``SMLMP_TM:`` batches — see
  the JAX package's ``telemetry/gangplane.py``), so the gang's launcher
  holds a near-current tail even for a rank that dies by SIGKILL, and
- dumped to a per-rank file on signal/teardown with the same
  tmp + fsync + rename discipline as :mod:`.artifact` — a kill at the
  ``flight.dump`` fault site leaves the previous bundle (or nothing),
  never a torn file.

Allocation-stable: the ring is a preallocated slot list written in
place; recording never grows it, so a recorder left on in production
costs one lock + one tuple store per event and a fixed memory ceiling.

Stdlib-only; importable before (and without) torch, from any layer.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from .artifact import dumps_checked

__all__ = ["FlightRecorder", "get_flight", "record", "sanitize_floats",
           "FLIGHT_SCHEMA", "DEFAULT_CAPACITY", "CAPACITY_ENV"]

#: ring capacity (events) unless overridden per recorder or via env
DEFAULT_CAPACITY = 512
#: env var overriding the process-default recorder's capacity
CAPACITY_ENV = "SMLTPU_FLIGHT_EVENTS"

#: required top-level keys of a dumped flight record
FLIGHT_SCHEMA = ("events", "last_seq")


def sanitize_floats(obj):
    """NaN/Inf → string, recursively: the artifact writer rejects
    non-finite floats by design (``allow_nan=False``), and one poisoned
    gauge or event field must not abort a crash dump or post-mortem."""
    if isinstance(obj, float):
        if obj != obj or obj in (float("inf"), float("-inf")):
            return repr(obj)
        return obj
    if isinstance(obj, dict):
        return {k: sanitize_floats(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_floats(v) for v in obj]
    return obj


class FlightRecorder:
    """Fixed-capacity ring of ``(seq, ts, kind, fields)`` events.

    Thread-safe; ``enabled=False`` turns :meth:`record` into a single
    attribute read (the bench's paired off leg).  ``seq`` is a
    monotonically increasing per-recorder counter, so consumers (the
    gang wire, the post-mortem gather) can express "events since" and
    compare the freshness of two tails of the same rank.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.enabled = True
        # REENTRANT: the worker's SIGTERM handler dumps the ring from the
        # main thread, which may have been interrupted INSIDE record()'s
        # critical section — a plain Lock would self-deadlock there (and
        # the rank would miss its grace window and lose the dump to the
        # follow-up SIGKILL).  The worst a reentrant read sees is a seq
        # one ahead of its slot — acceptable for a crash artifact.
        self._lock = threading.RLock()
        # preallocated slots, written in place — the ring never grows
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._next = 0          # slot index the next event lands in
        self._seq = 0           # total events ever recorded

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one structured event (dropped oldest-first once the
        ring is full).  Never raises — a telemetry write must not break
        the instrumented code path."""
        if not self.enabled:
            return
        try:
            ts = time.time()
            with self._lock:
                self._seq += 1
                self._slots[self._next] = (self._seq, ts, kind, fields)
                self._next = (self._next + 1) % self.capacity
        except Exception:
            pass

    # -- reading -----------------------------------------------------------
    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def _ordered(self) -> List[tuple]:
        # oldest → newest: the slots after the cursor wrapped earlier
        with self._lock:
            head = self._slots[self._next:] + self._slots[:self._next]
        return [s for s in head if s is not None]

    @staticmethod
    def _as_dict(slot: tuple) -> Dict[str, Any]:
        seq, ts, kind, fields = slot
        return {"seq": seq, "ts": ts, "kind": kind, **fields}

    def events(self) -> List[Dict[str, Any]]:
        """Every retained event, oldest first."""
        return [self._as_dict(s) for s in self._ordered()]

    def tail(self, n: int) -> List[Dict[str, Any]]:
        return [self._as_dict(s) for s in self._ordered()[-max(0, n):]]

    def events_since(self, seq: int,
                     limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Events with ``seq`` strictly greater than the given watermark
        (capped at the newest ``limit`` when set) — the gang wire's
        incremental-export primitive."""
        out = [self._as_dict(s) for s in self._ordered() if s[0] > seq]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._next = 0
            self._seq = 0

    # -- dumping -----------------------------------------------------------
    def dump(self, path: str, rank: Optional[int] = None,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """SIGKILL-atomic dump of the whole ring to ``path``.

        Same discipline as :func:`~synapseml_tpu_torch.telemetry.artifact.
        write_json`, inlined so the ``flight.dump`` kill point sits at
        the worst possible instant — temp file written and fsynced, the
        rename still ahead: a SIGKILL there leaves only the invisible
        temp file, never a torn ``path``.  Safe to call from a signal
        handler (pure-python IO)."""
        payload: Dict[str, Any] = {
            "rank": rank, "last_seq": self.last_seq,
            "dumped_unix": time.time(), "events": self.events()}
        if extra:
            payload.update(extra)
        text = dumps_checked(sanitize_floats(payload), schema=FLIGHT_SCHEMA)
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=directory, prefix=os.path.basename(path) + ".tmp.")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(text)
                if not text.endswith("\n"):
                    f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.chmod(tmp, 0o644)
            # the atomicity fault site: ``kill`` armed here SIGKILLs the
            # process with the temp file complete but unpublished — the
            # test that proves "no partial bundle" observes exactly this
            try:
                from ..resilience.faults import get_faults
                get_faults().kill_point("flight.dump", path=path)
            except ImportError:      # pragma: no cover - stripped builds
                pass
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        try:
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # pragma: no cover - platform without dir fsync
            pass
        return payload


_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def get_flight() -> FlightRecorder:
    """The process-wide recorder every built-in layer writes into."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                try:
                    cap = int(os.environ.get(CAPACITY_ENV, "") or
                              DEFAULT_CAPACITY)
                except ValueError:
                    cap = DEFAULT_CAPACITY
                _default = FlightRecorder(capacity=max(1, cap))
    return _default


def record(kind: str, **fields) -> None:
    """``flight.record(...)`` on the process-default recorder."""
    get_flight().record(kind, **fields)
