"""Serving health, readiness and graceful drain.

Kubernetes-shaped serving contract for :class:`~synapseml_tpu_torch.serving.
ServingServer` (both are reserved paths on every listener, like
``/metrics``):

- ``GET /healthz`` — liveness: 200 while the listener's event loop is
  alive; a hung process stops answering and the orchestrator restarts it.
- ``GET /readyz`` — readiness: 200 only while the server is accepting
  work; 503 (with ``Retry-After``) while draining or saturated, so load
  balancers stop routing BEFORE requests start getting shed.

Load shedding: when an API's bounded queue is full the server already
answers 503; the health state computes the ``Retry-After`` it attaches —
queue depth over observed drain rate, clamped — so well-behaved clients
(our :class:`~synapseml_tpu_torch.io.http.HTTPClient` honors Retry-After)
back off for roughly one queue-flush instead of hammering.

Graceful drain: ``server.drain()`` flips readiness off, stops admitting
new exchanges (503 + Retry-After), waits until every ACCEPTED exchange
has been answered (queues empty, pending maps empty), then closes the
listener — zero dropped in-flight work, the serving analogue of the
trainers' preemption checkpoints.
"""

from __future__ import annotations

import json
import threading
from typing import Optional, Tuple

from ..telemetry import get_registry

__all__ = ["HealthState", "retry_after_from_depth"]

#: clamp for computed Retry-After hints (seconds)
MIN_RETRY_AFTER_S = 0.05
MAX_RETRY_AFTER_S = 30.0
#: assumed drain rate when no throughput has been observed yet
DEFAULT_DRAIN_RPS = 100.0


def retry_after_from_depth(queue_depth: int, drain_rps: float,
                           min_s: float = MIN_RETRY_AFTER_S,
                           max_s: float = MAX_RETRY_AFTER_S) -> float:
    """Seconds until roughly one queue flush: depth / rate, clamped."""
    rate = drain_rps if drain_rps and drain_rps > 0 else DEFAULT_DRAIN_RPS
    return round(min(max_s, max(min_s, queue_depth / rate)), 3)


class HealthState:
    """Liveness/readiness/drain flags for one server, exported as gauges
    ``serving_ready`` / ``serving_draining`` and counter
    ``serving_drains_total``."""

    def __init__(self, name: str = "server"):
        self.name = name
        self._lock = threading.Lock()
        self._ready = True
        self._draining = False
        self._closed = False
        #: live warmup snapshot fn (compile plane): () -> dict with at
        #: least {"state": ...}; cold/warming makes /readyz answer
        #: 503 "warming" WITHOUT flipping :attr:`ready` — the listener
        #: keeps accepting (requests queue behind the warming engine;
        #: the decode loop holds them compile-aware) while balancers
        #: stop routing.  None: no warmup axis (the pre-plane behavior).
        self._warmup_fn = None
        reg = get_registry()
        self._g_ready = reg.gauge(
            "serving_ready", "1 while the server accepts new work",
            ("server",))
        self._g_draining = reg.gauge(
            "serving_draining", "1 while a graceful drain is in progress",
            ("server",))
        self._c_drains = reg.counter(
            "serving_drains_total", "graceful drains completed", ("server",))
        self._g_ready.set(1, server=name)
        self._g_draining.set(0, server=name)

    # -- flags -------------------------------------------------------------
    @property
    def ready(self) -> bool:
        with self._lock:
            return self._ready and not self._draining and not self._closed

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def warming(self) -> bool:
        """True while an installed compile plane (:meth:`set_warmup`)
        reports cold/warming — the same verdict ``/readyz`` answers 503
        ``"warming"`` for, readable in-process so a local replica pool
        can count capacity-in-flight without an HTTP probe."""
        return self._snapshot_warming(self._warmup_snapshot())

    def set_ready(self, ready: bool) -> None:
        with self._lock:
            self._ready = bool(ready)
            self._g_ready.set(1 if self.__effective_ready() else 0,
                              server=self.name)

    # -- warmup axis (the serving compile plane) ---------------------------
    def set_warmup(self, snapshot_fn) -> None:
        """Install (or clear, with None) the warmup snapshot source.
        The fn is called per /readyz — readiness follows the LIVE plane
        state, no completion callback to race."""
        with self._lock:
            self._warmup_fn = snapshot_fn

    def _warmup_snapshot(self):
        with self._lock:
            fn = self._warmup_fn
        if fn is None:
            return None
        try:
            snap = fn()
        except Exception:  # noqa: BLE001 — a broken probe must not
            #                 wedge readiness; the state is just unknown
            return {"state": "unknown"}
        return snap if isinstance(snap, dict) else {"state": str(snap)}

    @staticmethod
    def _snapshot_warming(snap) -> bool:
        """Only a plane actively working toward warm gates readiness:
        ``failed`` (the engine serves, programs compile lazily) and
        ``unknown`` (broken snapshot fn) must NOT answer 503 forever —
        a permanently-wedged-out-of-rotation healthy replica would be
        strictly worse than the lazy compiles the plane exists to
        avoid."""
        return snap is not None and snap.get("state") in ("cold",
                                                          "warming")

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True
            self._g_draining.set(1, server=self.name)
            self._g_ready.set(0, server=self.name)

    def finish_drain(self) -> None:
        with self._lock:
            if self._draining:
                self._c_drains.inc(1, server=self.name)
            self._draining = False
            self._closed = True
            self._g_draining.set(0, server=self.name)

    def mark_closed(self) -> None:
        with self._lock:
            self._closed = True
            self._g_ready.set(0, server=self.name)

    def __effective_ready(self) -> bool:
        return self._ready and not self._draining and not self._closed

    # -- reserved-path responses -------------------------------------------
    def healthz(self) -> Tuple[int, bytes, dict]:
        """Liveness reply: reachable listener ⇒ alive."""
        body = json.dumps({"status": "ok"}).encode()
        return 200, body, {"Content-Type": "application/json"}

    def readyz(self, queue_depth: int = 0,
               drain_rps: float = 0.0) -> Tuple[int, bytes, dict]:
        """Readiness reply; 503 carries a Retry-After hint sized to the
        current backlog while draining/unready.  With a compile plane
        installed (:meth:`set_warmup`) the payload carries its live
        snapshot under ``"warmup"`` and a cold/warming plane answers
        503 ``"warming"`` (balancers stop routing; the listener itself
        still accepts, the decode loop holds queued work
        compile-aware).  A ``failed`` plane un-gates — the replica
        serves with lazy compiles, the failure visible in the
        snapshot."""
        warm = self._warmup_snapshot()
        if self.ready:
            if self._snapshot_warming(warm):
                ra = retry_after_from_depth(queue_depth, drain_rps)
                body = json.dumps({"status": "warming",
                                   "warmup": warm}).encode()
                return 503, body, {"Content-Type": "application/json",
                                   "Retry-After": str(ra)}
            payload = {"status": "ready"}
            if warm is not None:
                payload["warmup"] = warm
            body = json.dumps(payload).encode()
            return 200, body, {"Content-Type": "application/json"}
        reason = "draining" if self.draining else "not_ready"
        ra = retry_after_from_depth(queue_depth, drain_rps)
        body = json.dumps({"status": reason}).encode()
        return 503, body, {"Content-Type": "application/json",
                           "Retry-After": str(ra)}
