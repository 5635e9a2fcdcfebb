"""Span tracing: nested, queryable, Chrome-trace-exportable.

Horovod's timeline (Sergeev & Del Balso, arXiv:1802.05799) made the
per-op schedule of a distributed run *visible*; the analogue here is a
host-side span tracer: ``with span("gbdt.train", rows=n):`` produces an
in-memory record with parent/child nesting (thread-local stack),
host/process-index attribution, and wall+monotonic timestamps, and the
whole trace exports as Chrome-trace JSON (load in ``chrome://tracing``
or Perfetto).

Device-side op scheduling stays the job of
:func:`synapseml_tpu_torch.core.profiling.trace` (the XLA profiler); spans
cover everything the profiler cannot see — host phases, serving loops,
binning, checkpoint writes — cheaply enough to stay on in production.
"""

from __future__ import annotations

import contextlib
import itertools
import socket
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "span",
           "RequestTraceStore", "get_request_tracer", "mint_trace_id"]

_ids = itertools.count(1)
_tls = threading.local()


def _process_index() -> int:
    """The ``torch.distributed`` rank when a process group is up, else 0
    — resolved lazily so importing telemetry never imports torch."""
    try:
        import sys
        dist = sys.modules.get("torch.distributed")
        if dist is None or not dist.is_initialized():
            return 0
        return int(dist.get_rank())
    except Exception:
        return 0


@dataclass
class Span:
    """One finished (or live) span."""
    name: str
    span_id: int
    parent_id: Optional[int]
    start_wall_s: float                  # epoch seconds (chrome ts base)
    start_s: float                       # perf_counter
    end_s: Optional[float] = None        # perf_counter; None while live
    attrs: Dict[str, Any] = field(default_factory=dict)
    thread_id: int = 0
    process_index: int = 0
    host: str = ""

    @property
    def duration_s(self) -> float:
        return (self.end_s or time.perf_counter()) - self.start_s


class Tracer:
    """Bounded in-memory trace; one per process is plenty."""

    def __init__(self, max_spans: int = 100_000):
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._dropped = 0
        self._host = socket.gethostname()

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        stack: List[Span] = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        sp = Span(name=name, span_id=next(_ids),
                  parent_id=stack[-1].span_id if stack else None,
                  start_wall_s=time.time(), start_s=time.perf_counter(),
                  attrs=dict(attrs), thread_id=threading.get_ident(),
                  process_index=_process_index(), host=self._host)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            sp.end_s = time.perf_counter()
            with self._lock:
                if len(self._spans) < self.max_spans:
                    self._spans.append(sp)
                else:
                    self._dropped += 1

    def record(self, name: str, duration_s: float, *,
               start_wall_s: Optional[float] = None,
               parent_id: Optional[int] = None, **attrs) -> Span:
        """Append an already-measured interval as a finished span — for
        call sites that keep their own perf_counter bookkeeping (e.g. the
        GBDT ``InstrumentationMeasures``) and publish retrospectively."""
        now_perf = time.perf_counter()
        if start_wall_s is None:
            start_wall_s = time.time() - duration_s
        sp = Span(name=name, span_id=next(_ids), parent_id=parent_id,
                  start_wall_s=start_wall_s,
                  start_s=now_perf - duration_s, end_s=now_perf,
                  attrs=dict(attrs), thread_id=threading.get_ident(),
                  process_index=_process_index(), host=self._host)
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(sp)
            else:
                self._dropped += 1
        return sp

    # -- queries -----------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def children(self, parent: Span) -> List[Span]:
        return [s for s in self.spans() if s.parent_id == parent.span_id]

    def roots(self) -> List[Span]:
        return [s for s in self.spans() if s.parent_id is None]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace ("Trace Event Format") dict: complete ("X")
        events, pid = process index, tid = OS thread id, ts/dur in us."""
        events = []
        for s in self.spans():
            if s.end_s is None:
                continue
            events.append({
                "name": s.name, "ph": "X", "cat": "host",
                "ts": s.start_wall_s * 1e6,
                "dur": (s.end_s - s.start_s) * 1e6,
                "pid": s.process_index, "tid": s.thread_id,
                "args": {**s.attrs, "host": s.host,
                         "span_id": s.span_id,
                         "parent_id": s.parent_id},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> Dict[str, Any]:
        """Atomically write the Chrome-trace JSON to ``path`` (via the
        artifact writer, so a crash cannot leave a truncated trace)."""
        from .artifact import write_json
        return write_json(path, self.chrome_trace(),
                          schema=("traceEvents",))


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    return _default_tracer


def span(name: str, **attrs):
    """``with span("phase", key=val):`` on the process-default tracer."""
    return _default_tracer.span(name, **attrs)


# ---------------------------------------------------------------------------
# request-scoped tracing (the serving plane's per-request timelines)
# ---------------------------------------------------------------------------

def mint_trace_id() -> str:
    """A fresh request trace id (opaque hex; minted once per request at
    admission and propagated across serving hops via the
    ``X-SML-Trace-Id`` exchange header)."""
    return uuid.uuid4().hex


class RequestTraceStore:
    """Bounded store of per-request event timelines — the serving
    plane's answer to "follow THIS request from router to retired
    slot" when an aggregate percentile goes bad.

    One *trace* is one request's lifecycle: ``queued`` →
    ``shed``/``admitted`` → ``prefill`` (with its bucket) →
    ``decode``/``verify`` steps (with committed-span sizes) →
    ``retired``/``cancelled``/``expired``.  Producers call
    :meth:`begin` once (None ⇒ this request is not sampled — every
    later call with a None id is a no-op attribute check), then
    :meth:`event` per transition, then :meth:`finish` with the
    outcome.  Finishing also records one ``serving.request`` span on
    the process :class:`Tracer` (so request spans ride the existing
    Chrome-trace/gang-plane export) and one ``request`` event on the
    flight recorder (so a crash bundle names the requests in flight).

    Bounded on BOTH axes: at most ``max_traces`` timelines are
    retained (oldest evicted first) and at most ``max_events`` events
    per timeline (later events are counted, not stored).  Sampling is
    deterministic 1-in-``sample_every`` at :meth:`begin`; a PROPAGATED
    id (minted by an upstream hop) is always sampled, so a
    cross-replica request is never half-traced.  Thread-safe: the
    listener, decode loop, and ``/tracez`` reads interleave freely.
    """

    def __init__(self, max_traces: int = 256, max_events: int = 160,
                 sample_every: int = 1):
        self.max_traces = max(1, int(max_traces))
        self.max_events = max(1, int(max_events))
        self.sample_every = max(0, int(sample_every))
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._seen = 0
        self.sampled = 0
        self.dropped_events = 0

    # -- producing ---------------------------------------------------------
    def begin(self, trace_id: Optional[str] = None,
              **attrs) -> Optional[str]:
        """Start a timeline.  ``trace_id=None`` mints one subject to
        sampling (None returned ⇒ not sampled); a caller-provided id
        (the propagated cross-hop case) is always sampled."""
        with self._lock:
            if trace_id is None:
                self._seen += 1
                if (self.sample_every == 0
                        or (self._seen - 1) % self.sample_every != 0):
                    return None
                trace_id = mint_trace_id()
            self.sampled += 1
            self._traces[trace_id] = {
                "trace_id": trace_id, "started_unix": time.time(),
                "started_s": time.perf_counter(), "attrs": dict(attrs),
                "events": [], "dropped_events": 0,
                "outcome": None, "duration_s": None}
            self._traces.move_to_end(trace_id)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
        return trace_id

    def event(self, trace_id: Optional[str], name: str, **attrs) -> None:
        """Append one event (relative-time stamped).  Unknown/None ids
        no-op — the unsampled request's fast path."""
        if trace_id is None:
            return
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return
            if len(tr["events"]) >= self.max_events:
                tr["dropped_events"] += 1
                self.dropped_events += 1
                return
            tr["events"].append(
                {"t_s": time.perf_counter() - tr["started_s"],
                 "name": name, **attrs})

    def finish(self, trace_id: Optional[str], outcome: str,
               **attrs) -> None:
        """Close a timeline with its terminal outcome (``retired`` /
        ``shed`` / ``cancelled`` / ``expired`` / ``error``) and publish
        the request span + flight event."""
        if trace_id is None:
            return
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None or tr["outcome"] is not None:
                return
            tr["outcome"] = outcome
            tr["duration_s"] = time.perf_counter() - tr["started_s"]
            tr["attrs"].update(attrs)
            started_wall, dur = tr["started_unix"], tr["duration_s"]
            span_attrs = {"trace_id": trace_id, "outcome": outcome,
                          **tr["attrs"]}
        get_tracer().record("serving.request", dur,
                            start_wall_s=started_wall, **span_attrs)
        try:
            from .flight import record as flight_record
            flight_record("request", trace_id=trace_id, outcome=outcome,
                          duration_s=dur)
        except Exception:  # noqa: BLE001 — telemetry must not raise
            pass

    # -- reading -----------------------------------------------------------
    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            tr = self._traces.get(trace_id)
            return None if tr is None else _copy_trace(tr)

    def traces(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-first timelines (live ones included, outcome None);
        ``limit <= 0`` returns none (``[-0:]`` would be the whole
        store — 256 full timelines in one response)."""
        limit = int(limit)
        if limit <= 0:
            return []
        with self._lock:
            out = [_copy_trace(t)
                   for t in list(self._traces.values())[-limit:]]
        out.reverse()
        return out

    def snapshot(self, limit: int = 50) -> Dict[str, Any]:
        """The ``/tracez`` payload: recent timelines + store counters."""
        return {"traces": self.traces(limit), "sampled": self.sampled,
                "sample_every": self.sample_every,
                "dropped_events": self.dropped_events,
                "generated_unix": time.time()}

    def chrome_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """One request's timeline as Chrome-trace JSON: a single "X"
        span for the whole request plus an instant ("i") event per
        transition — load in chrome://tracing / Perfetto.  Works on a
        LIVE trace too (span runs up to now), so an operator can
        export a request that is stuck mid-decode — which is exactly
        when they want the export."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return None
            base_us = tr["started_unix"] * 1e6
            dur_s = tr["duration_s"]
            if dur_s is None:                     # live: span up to now
                dur_s = time.perf_counter() - tr["started_s"]
            outcome = tr["outcome"]
            attrs = dict(tr["attrs"])
            timeline = [dict(e) for e in tr["events"]]
        events = [{
            "name": "serving.request", "ph": "X", "cat": "request",
            "ts": base_us, "dur": dur_s * 1e6, "pid": 0, "tid": 0,
            "args": {"trace_id": trace_id, "outcome": outcome, **attrs}}]
        for ev in timeline:
            args = {k: v for k, v in ev.items() if k not in ("t_s", "name")}
            events.append({"name": ev["name"], "ph": "i", "cat": "request",
                           "ts": base_us + ev["t_s"] * 1e6, "pid": 0,
                           "tid": 0, "s": "t", "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._seen = 0
            self.sampled = 0
            self.dropped_events = 0


def _copy_trace(tr: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(tr)
    out["attrs"] = dict(tr["attrs"])
    out["events"] = [dict(e) for e in tr["events"]]
    out.pop("started_s", None)          # perf_counter base is internal
    return out


_default_request_tracer = RequestTraceStore()


def get_request_tracer() -> RequestTraceStore:
    """The process-wide request-trace store (served at ``/tracez``)."""
    return _default_request_tracer
