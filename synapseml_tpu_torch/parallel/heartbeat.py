"""Worker-side heartbeat channel — the liveness half of gang supervision.

The PyTorch port of the JAX package's ``parallel/heartbeat.py`` (the same
wire format, so either package's launcher reads the other's beats).  Each
worker process of a launched gang emits a periodic

    SMLMP_HB:{"rank": r, "step": s, "ts": t}

line on stdout — the SAME pipe that carries ``RESULT_MARKER`` — and the
launcher's per-rank reader threads feed every beat into the
:class:`~synapseml_tpu_torch.parallel.supervisor.HeartbeatMonitor`.  A dead OR
hung rank is therefore declared failed in O(heartbeat interval) instead
of O(global timeout): a crashed process closes the pipe, a wedged one
(GIL held by a stuck extension, a collective blocked forever) stops
producing beats, and both look identical to the detector.

The emitter is a daemon thread started by ``worker.main`` before the
cluster rendezvous, so "no heartbeat at all" cleanly separates
boot/rendezvous failures from mid-task hangs.  Training code reports
progress through :func:`beat` (the data-parallel GBDT beats after every
iteration), which rides the next emitted line as the rank's last-known
step — the supervisor uses it for ``hang at step N`` verdicts and for the
kill-to-resumed-step recovery clock.

Stdlib-only: importable before torch, from any layer.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["HB_MARKER", "HB_INTERVAL_ENV", "HeartbeatEmitter", "beat",
           "current_step", "parse_heartbeat", "start_emitter"]

#: marker in front of the heartbeat JSON line (the RESULT_MARKER sibling)
HB_MARKER = "SMLMP_HB:"
#: env var the launcher sets to enable emission (seconds; 0/unset = off)
HB_INTERVAL_ENV = "SMLTPU_HB_INTERVAL_S"

_state_lock = threading.Lock()
_state = {"step": None}


def beat(step: Optional[int] = None) -> None:
    """Report training progress: the emitted heartbeat carries the most
    recent step so the launcher knows each rank's last durable position.
    Free when no emitter runs (one lock + dict store)."""
    if step is None:
        return
    with _state_lock:
        prev = _state["step"]
        if prev is None or step >= prev:
            _state["step"] = step


def current_step() -> Optional[int]:
    with _state_lock:
        return _state["step"]


def reset_step() -> None:
    """Forget the reported step (a worker process never needs this — it
    dies with its gang attempt; in-process tests do)."""
    with _state_lock:
        _state["step"] = None


def parse_heartbeat(line: str) -> Optional[dict]:
    """``SMLMP_HB:{...}`` line → dict (None for non-heartbeat lines or
    garbage — a chatty task must not crash the launcher's reader)."""
    if not line.startswith(HB_MARKER):
        return None
    try:
        d = json.loads(line[len(HB_MARKER):])
        return d if isinstance(d, dict) else None
    except ValueError:
        return None


class HeartbeatEmitter(threading.Thread):
    """Daemon thread printing one heartbeat line every ``interval_s``.

    Each emission passes the ``heartbeat.emit`` fault site, so tests make
    a rank go silent (kind ``hang`` wedges this thread → beats stop while
    the process lives) or die (kind ``kill_rank``) deterministically.
    """

    def __init__(self, rank: int, interval_s: float, stream=None):
        super().__init__(name=f"hb-emitter-r{rank}", daemon=True)
        self.rank = int(rank)
        self.interval_s = float(interval_s)
        self._stream = stream
        # NB: not named _stop — threading.Thread owns that name internally
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def _emit(self) -> None:
        from ..resilience.faults import get_faults
        from ..telemetry.flight import record as flight_record
        step = current_step()
        faults = get_faults()
        # the silent-rank fault site: ``hang`` blocks right here
        faults.raise_point("heartbeat.emit", rank=self.rank, step=step)
        faults.note("heartbeat.emit", rank=self.rank, step=step)
        flight_record("heartbeat", rank=self.rank, step=step)
        from ..telemetry.gangplane import write_wire_line
        write_wire_line(HB_MARKER + json.dumps(
            {"rank": self.rank, "step": step, "ts": time.time()}),
            self._stream)

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                self._emit()
            except Exception:
                # an injected raise kind (or a closed pipe at teardown)
                # silences this rank — exactly what the detector watches
                return
            self._halt.wait(self.interval_s)


def start_emitter(rank: int,
                  interval_s: Optional[float] = None) -> Optional[HeartbeatEmitter]:
    """Start the emitter when heartbeats are enabled (``interval_s`` or
    the ``SMLTPU_HB_INTERVAL_S`` env var > 0); returns it, or None."""
    if interval_s is None:
        try:
            interval_s = float(os.environ.get(HB_INTERVAL_ENV, "0") or 0)
        except ValueError:
            interval_s = 0.0
    if interval_s <= 0:
        return None
    emitter = HeartbeatEmitter(rank, interval_s)
    emitter.start()
    return emitter
