"""The gang-wide observability plane and the step-level training profiler.

The PyTorch port of the JAX package's ``telemetry/gangplane.py``:

- **wire export** — each worker rank periodically writes one
  ``SMLMP_TM:{...}`` line (a compact metric snapshot, its completed spans
  and the flight-record increment) on the pipe that carries its result
  (:class:`TelemetryEmitter`).  The launcher's per-rank readers feed
  :class:`GangPlane`, which mirrors worker metrics into the
  coordinator's registry under a ``worker_`` prefix with a ``rank``
  label and stitches per-rank spans into one multi-lane Chrome trace.
- **post-mortem bundles** — :func:`write_postmortem` gathers a dead
  gang attempt's verdict, each rank's flight tail (the on-disk dump a
  SIGTERMed rank left, or the wire tail), last step and metrics into a
  schema-checked ``postmortem.json``.
- **:class:`StepProfiler`** decomposes each train step's wall time into
  data / compute / collective / other segments, exports
  ``train_step_seconds{model,segment}`` histograms and
  ``train_steps_total``, and with ``capture_xla=True`` captures each
  step's cost once per key for a roofline-ready :meth:`StepProfiler.summary`
  (``train_step_bytes_per_sample``, ``train_step_mfu``).  The parameter
  keeps the reference's name; here it means "capture the step's cost
  through :func:`~.roofline.capture`", which runs the step once, so the
  callers hand it copies of their state.  :meth:`StepProfiler.measure`
  is the alternating min-of-blocks timing protocol the autotuner times
  its candidates with.  The collective segment is fed by
  :func:`observe_collective`, which every collective of
  :mod:`synapseml_tpu_torch.parallel.collectives` calls.

Stdlib-only at import time; torch is touched by the cost capture and the
peak lookup.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .artifact import SchemaError, write_json
from .flight import get_flight, sanitize_floats as _sanitize
from .registry import MetricsRegistry, get_registry
from .tracing import get_tracer

__all__ = ["TM_MARKER", "TM_INTERVAL_ENV", "OBS_DIR_ENV",
           "TelemetryEmitter", "start_emitter", "parse_telemetry",
           "telemetry_batch", "GangPlane", "mirror_snapshot",
           "StepProfiler", "current_profiler", "observe_collective",
           "check_profiler", "check_postmortem", "write_postmortem",
           "GANG_METRICS", "STEP_METRICS"]

#: the metric names the profiler exports
STEP_METRICS = frozenset({"train_step_seconds", "train_steps_total",
                          "train_step_bytes_per_sample", "train_step_mfu"})


#: marker in front of the telemetry-batch JSON line (``SMLMP_HB`` sibling)
TM_MARKER = "SMLMP_TM:"
#: env var the launcher sets to enable wire export (seconds; 0/unset = off)
TM_INTERVAL_ENV = "SMLTPU_TM_INTERVAL_S"
#: env var naming the observability directory (flight dumps, post-mortems)
OBS_DIR_ENV = "SMLTPU_OBS_DIR"

#: held around every line a worker writes on its result pipe (heartbeats,
#: telemetry batches, the result): a write larger than the pipe's buffer
#: goes out in pieces, and another thread's line must not land between
#: them
WIRE_LOCK = threading.Lock()


def write_wire_line(line: str, stream=None) -> None:
    """Write one whole line to ``stream`` (default stdout) under
    :data:`WIRE_LOCK` and flush it."""
    stream = stream if stream is not None else sys.stdout
    with WIRE_LOCK:
        stream.write(line + "\n")
        stream.flush()


#: newest flight events per wire batch (one batch is one pipe line)
MAX_FLIGHT_PER_BATCH = 200
#: newest spans per wire batch
MAX_SPANS_PER_BATCH = 1000

#: gang-level metric names this plane and the gang supervisor export
#: (worker metrics also surface under the ``worker_`` prefix with a
#: ``rank`` label)
GANG_METRICS = frozenset({
    "gangplane_batches_total", "gangplane_spans_total",
    "postmortem_bundles_total", "gang_world_size", "train_step_seconds",
    "train_steps_total", "train_step_bytes_per_sample", "train_step_mfu",
})


# ---------------------------------------------------------------------------
# worker side: the wire
# ---------------------------------------------------------------------------

def _compact_snapshot(registry: Optional[MetricsRegistry] = None
                      ) -> Dict[str, Any]:
    """Registry snapshot minus help strings (the wire carries values,
    not documentation — help text is re-attached at mirror time)."""
    snap = (registry or get_registry()).snapshot()
    return {name: {"kind": m["kind"], "labelnames": m["labelnames"],
                   "series": m["series"]}
            for name, m in snap.items()}


def _chrome_event(span) -> Dict[str, Any]:
    """One finished Span → a pid-less Chrome complete event (the launcher
    assigns ``pid`` = rank when stitching)."""
    return {"name": span.name, "ph": "X", "cat": "host",
            "ts": span.start_wall_s * 1e6,
            "dur": (span.end_s - span.start_s) * 1e6,
            "tid": span.thread_id,
            "args": {**span.attrs, "span_id": span.span_id,
                     "parent_id": span.parent_id}}


def telemetry_batch(rank: int, *, span_cursor: int = 0,
                    flight_seq: int = 0, seq: int = 0,
                    final: bool = False) -> Tuple[Dict[str, Any], int, int]:
    """Build one wire batch → ``(payload, new_span_cursor,
    new_flight_seq)``.  The payload's metric snapshot is cumulative
    (mirrors are SET, not added, so re-sends are idempotent); spans and
    flight events are incremental since the given cursors."""
    tracer = get_tracer()
    spans = tracer.spans()
    if span_cursor > len(spans):        # tracer was reset mid-run
        span_cursor = 0
    new_spans = [s for s in spans[span_cursor:] if s.end_s is not None]
    if len(new_spans) > MAX_SPANS_PER_BATCH:
        new_spans = new_spans[-MAX_SPANS_PER_BATCH:]
    flight = get_flight()
    events = flight.events_since(flight_seq, limit=MAX_FLIGHT_PER_BATCH)
    payload = {
        "rank": int(rank), "seq": int(seq), "ts": time.time(),
        "final": bool(final),
        "metrics": _compact_snapshot(),
        "spans": [_chrome_event(s) for s in new_spans],
        "flight": events,
    }
    new_flight_seq = events[-1]["seq"] if events else flight_seq
    return payload, len(spans), new_flight_seq


def parse_telemetry(line: str) -> Optional[dict]:
    """``SMLMP_TM:{...}`` line → dict (None for other lines or garbage —
    a chatty task must never crash the launcher's reader)."""
    if not line.startswith(TM_MARKER):
        return None
    try:
        d = json.loads(line[len(TM_MARKER):])
        return d if isinstance(d, dict) else None
    except ValueError:
        return None


class TelemetryEmitter(threading.Thread):
    """Daemon thread printing one ``SMLMP_TM:`` batch every
    ``interval_s`` — and, via :meth:`emit_now`, a final batch flushed
    synchronously BEFORE the worker's result marker, so a clean exit
    drops no spans or metrics (crashes are covered by the periodic
    batches and the launcher-held flight tail)."""

    def __init__(self, rank: int, interval_s: float, stream=None):
        super().__init__(name=f"tm-emitter-r{rank}", daemon=True)
        self.rank = int(rank)
        self.interval_s = float(interval_s)
        self._stream = stream
        self._halt = threading.Event()
        self._emit_lock = threading.Lock()
        self._span_cursor = 0
        self._flight_seq = 0
        self._seq = 0

    def stop(self) -> None:
        self._halt.set()

    def emit_now(self, final: bool = False) -> None:
        """Serialize + write one batch on the caller's thread (the
        emitter lock keeps cursors consistent with the periodic loop)."""
        with self._emit_lock:
            payload, self._span_cursor, self._flight_seq = telemetry_batch(
                self.rank, span_cursor=self._span_cursor,
                flight_seq=self._flight_seq, seq=self._seq, final=final)
            self._seq += 1
            from .artifact import _jsonify
            write_wire_line(
                TM_MARKER + json.dumps(payload, default=_jsonify),
                self._stream)

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                self.emit_now()
            except Exception:
                # a closed pipe at teardown silences this rank's export;
                # the launcher already holds everything sent so far
                return
            self._halt.wait(self.interval_s)


def start_emitter(rank: int, interval_s: Optional[float] = None,
                  stream=None) -> Optional[TelemetryEmitter]:
    """Start the wire emitter when export is enabled (``interval_s`` or
    the ``SMLTPU_TM_INTERVAL_S`` env var > 0); returns it, or None."""
    if interval_s is None:
        try:
            interval_s = float(os.environ.get(TM_INTERVAL_ENV, "0") or 0)
        except ValueError:
            interval_s = 0.0
    if interval_s <= 0:
        return None
    emitter = TelemetryEmitter(rank, interval_s, stream=stream)
    emitter.start()
    return emitter


# ---------------------------------------------------------------------------
# launcher side: merge + stitch
# ---------------------------------------------------------------------------

def mirror_snapshot(snapshot: Dict[str, Any], *, prefix: str = "worker_",
                    extra_labels: Optional[Dict[str, str]] = None,
                    registry: Optional[MetricsRegistry] = None,
                    help_note: str = "mirrored from a worker rank") -> int:
    """SET a compact snapshot's series into ``registry`` under
    ``prefix<name>`` with ``extra_labels`` appended (labels the source
    already carries are NOT duplicated).  Values are assigned, not
    accumulated, so re-mirroring a cumulative snapshot is idempotent.
    Returns the number of series written; a malformed metric is skipped,
    never raised (exposition must survive a garbled wire line)."""
    reg = registry or get_registry()
    extra = dict(extra_labels or {})
    written = 0
    for name, m in snapshot.items():
        try:
            kind = m.get("kind")
            orig_lns = tuple(m.get("labelnames") or ())
            add = {k: str(v) for k, v in extra.items() if k not in orig_lns}
            lns = orig_lns + tuple(add)
            series = m.get("series") or []
            mname = prefix + name
            if kind == "counter":
                metric = reg.counter(mname, help_note, lns)
            elif kind == "gauge":
                metric = reg.gauge(mname, help_note, lns)
            elif kind == "histogram":
                if not series:
                    continue
                bounds = sorted(float(b) for b in series[0]["buckets"])
                metric = reg.histogram(mname, help_note, lns, buckets=bounds)
            else:
                continue
            for s in series:
                labels = {**(s.get("labels") or {}), **add}
                key = tuple(str(labels.get(ln, "")) for ln in lns)
                if kind == "histogram":
                    by_bound = {float(b): int(n)
                                for b, n in s["buckets"].items()}
                    st = {"buckets": [by_bound.get(b, 0)
                                      for b in metric.buckets],
                          "sum": float(s["sum"]), "count": int(s["count"])}
                    with metric._lock:
                        metric._series[key] = st
                else:
                    with metric._lock:
                        metric._series[key] = float(s["value"])
                written += 1
        except Exception:
            continue
    return written


class _RankState:
    """The launcher-held view of one rank's exported telemetry."""

    def __init__(self, span_limit: int, flight_tail: int):
        self.metrics: Optional[Dict[str, Any]] = None
        self.spans: "collections.deque[dict]" = collections.deque(
            maxlen=span_limit)
        self.flight: "collections.deque[dict]" = collections.deque(
            maxlen=flight_tail)
        self.batches = 0
        self.final = False
        self.last_ts: Optional[float] = None


class GangPlane:
    """The coordinator's merged view of every rank's exported telemetry.

    Fed by the launcher's per-rank reader threads (:meth:`ingest`);
    mirrors worker metrics into ``registry`` (default: the process
    registry behind ``/metrics``) as ``worker_<name>{...,rank=<r>}``,
    retains a bounded span store per rank for Chrome-trace stitching,
    and a bounded flight tail per rank for the post-mortem bundle."""

    def __init__(self, n_ranks: int,
                 registry: Optional[MetricsRegistry] = None,
                 span_limit: int = 20_000, flight_tail: int = 256):
        self.n_ranks = int(n_ranks)
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._ranks: Dict[int, _RankState] = {
            r: _RankState(span_limit, flight_tail)
            for r in range(self.n_ranks)}
        self._c_batches = self._registry.counter(
            "gangplane_batches_total",
            "telemetry wire batches ingested from workers", ("rank",))
        self._c_spans = self._registry.counter(
            "gangplane_spans_total",
            "worker spans stitched into the gang trace", ("rank",))

    # -- feeding -----------------------------------------------------------
    def ingest(self, rank: int, payload: Dict[str, Any]) -> None:
        """One parsed ``SMLMP_TM:`` batch.  Thread-safe; never raises
        (a garbled line must not kill the reader thread)."""
        try:
            st = self._ranks.get(int(rank))
            if st is None:
                return
            spans = payload.get("spans") or []
            with self._lock:
                if payload.get("metrics") is not None:
                    st.metrics = payload["metrics"]
                for ev in spans:
                    st.spans.append(dict(ev, pid=int(rank)))
                for ev in payload.get("flight") or []:
                    st.flight.append(ev)
                st.batches += 1
                st.final = st.final or bool(payload.get("final"))
                st.last_ts = payload.get("ts")
            if payload.get("metrics") is not None:
                mirror_snapshot(payload["metrics"],
                                extra_labels={"rank": str(rank)},
                                registry=self._registry)
            self._c_batches.inc(1, rank=str(rank))
            if spans:
                self._c_spans.inc(len(spans), rank=str(rank))
        except Exception:
            pass

    # -- reading -----------------------------------------------------------
    def batches(self, rank: int) -> int:
        with self._lock:
            return self._ranks[rank].batches

    def saw_final(self, rank: int) -> bool:
        with self._lock:
            return self._ranks[rank].final

    def metrics_for(self, rank: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            m = self._ranks[rank].metrics
        return dict(m) if m is not None else None

    def spans_for(self, rank: int) -> List[dict]:
        with self._lock:
            return list(self._ranks[rank].spans)

    def flight_tail(self, rank: int,
                    n: Optional[int] = None) -> List[dict]:
        with self._lock:
            tail = list(self._ranks[rank].flight)
        return tail if n is None else tail[-n:]

    # -- stitching ---------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """All ranks' spans as one Chrome trace: ``pid`` = rank, one
        named lane per rank (process_name metadata events)."""
        events: List[dict] = []
        for r in range(self.n_ranks):
            events.append({"name": "process_name", "ph": "M", "pid": r,
                           "args": {"name": f"rank {r}"}})
            events.extend(self.spans_for(r))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> Dict[str, Any]:
        """Atomically write the stitched multi-lane trace (non-finite
        span attrs stringified — one NaN must not abort the file)."""
        return write_json(path, _sanitize(self.chrome_trace()),
                          schema=("traceEvents",))


# ---------------------------------------------------------------------------
# post-mortem bundles
# ---------------------------------------------------------------------------

def check_postmortem(obj: Any) -> None:
    """Schema validator for ``postmortem.json`` (artifact-writer
    callable form): top-level task/verdict/causes/ranks, every rank
    entry carrying cause, last_step, flight_tail (list) and metrics."""
    if not isinstance(obj, dict):
        raise SchemaError("postmortem bundle must be a JSON object")
    for k in ("task", "verdict", "causes", "ranks", "attempt", "n_ranks",
              "world_size", "created_unix"):
        if k not in obj:
            raise SchemaError(f"postmortem bundle missing key {k!r}")
    if not isinstance(obj["causes"], dict):
        raise SchemaError("causes must be a rank → verdict map")
    if not isinstance(obj["world_size"], int) or obj["world_size"] < 1:
        raise SchemaError("world_size must be a positive rank count")
    rh = obj.get("resize_history", [])
    if not isinstance(rh, list):
        raise SchemaError("resize_history must be a list of resize events")
    for ev in rh:
        if not isinstance(ev, dict) or not {"from", "to",
                                            "direction"} <= set(ev):
            raise SchemaError(
                "resize_history events need from/to/direction keys")
    if not isinstance(obj["ranks"], dict) or not obj["ranks"]:
        raise SchemaError("ranks must be a nonempty rank → state map")
    for r, st in obj["ranks"].items():
        if not isinstance(st, dict):
            raise SchemaError(f"rank {r} entry must be an object")
        for k in ("cause", "last_step", "flight_tail", "metrics"):
            if k not in st:
                raise SchemaError(f"rank {r} entry missing key {k!r}")
        if not isinstance(st["flight_tail"], list):
            raise SchemaError(f"rank {r} flight_tail must be a list")


def _ondisk_flight(obs_dir: str, rank: int) -> Optional[Dict[str, Any]]:
    path = os.path.join(obs_dir, f"flight-rank{rank}.json")
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        return d if isinstance(d, dict) else None
    except (OSError, ValueError):
        return None


def write_postmortem(path: str, *, task: str, causes: Dict[int, str],
                     attempt: int, n_ranks: int,
                     plane: Optional[GangPlane] = None,
                     last_steps: Optional[Dict[int, Optional[int]]] = None,
                     obs_dir: Optional[str] = None,
                     tail_events: int = 64,
                     verdict: Optional[str] = None,
                     resize_history: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
    """Gather one dead gang attempt into a schema-checked bundle.

    Per rank, the flight tail prefers the on-disk dump a SIGTERMed rank
    left (richer: the whole ring) over the wire tail the launcher held —
    unless the wire tail is fresher (higher ``seq``), which is the
    SIGKILL case where the dump never happened.

    ``n_ranks`` is the ATTEMPT's world size (post-resize, not the job's
    launch size) — recorded twice: the legacy ``n_ranks`` key and the
    explicit ``world_size``; ``resize_history`` carries every elastic
    resize the supervisor applied before this attempt died."""
    last_steps = dict(last_steps or {})
    ranks: Dict[str, Any] = {}
    for r in range(int(n_ranks)):
        wire = plane.flight_tail(r) if plane is not None else []
        wire_seq = max((e.get("seq", 0) for e in wire), default=0)
        tail = wire
        if obs_dir:
            dumped = _ondisk_flight(obs_dir, r)
            if dumped is not None and dumped.get("last_seq", 0) >= wire_seq:
                tail = [e for e in dumped.get("events", [])
                        if isinstance(e, dict)]
        ranks[str(r)] = {
            "cause": causes.get(r),
            "last_step": last_steps.get(r),
            "flight_tail": tail[-max(1, tail_events):],
            "metrics": (plane.metrics_for(r) if plane is not None
                        else None),
            "final_batch_seen": (plane.saw_final(r)
                                 if plane is not None else False),
        }
    known_steps = [s for s in last_steps.values() if s is not None]
    bundle = {
        "task": task,
        "verdict": verdict or "; ".join(
            f"rank {r}: {c}" for r, c in sorted(causes.items())) or
        "gang attempt failed (no per-rank verdict)",
        "causes": {str(r): c for r, c in causes.items()},
        "attempt": int(attempt),
        "n_ranks": int(n_ranks),
        "world_size": int(n_ranks),
        "resize_history": list(resize_history or []),
        "last_durable_step": max(known_steps) if known_steps else None,
        "created_unix": time.time(),
        "ranks": ranks,
    }
    out = write_json(path, _sanitize(bundle), schema=check_postmortem)
    get_registry().counter(
        "postmortem_bundles_total",
        "post-mortem bundles written for dead gang attempts",
        ("task",)).inc(1, task=task)
    return out


# ---------------------------------------------------------------------------
# step profiler
# ---------------------------------------------------------------------------

_active = threading.local()

#: train-step buckets: sub-ms dispatches through multi-second steps
_STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0)


def current_profiler() -> Optional["StepProfiler"]:
    """The profiler whose step is open on THIS thread (None outside)."""
    return getattr(_active, "profiler", None)


def observe_collective(seconds: float, nbytes: int = 0,
                       strategy: str = "flat") -> None:
    """Collective-dispatch hook: attributes host-observed collective
    time to the open step's ``collective`` segment, split by the
    planner route that dispatched it (``strategy`` — 'flat' for the
    direct dispatch).  Free when no step is open."""
    prof = getattr(_active, "profiler", None)
    if prof is not None:
        prof._note_collective(seconds, nbytes, strategy=strategy)


def check_profiler(prof: Any, owner: str) -> None:
    """Raise ``TypeError`` unless ``prof`` is None or has the profiler
    surface the training loops call (``step_begin``, ``mark``,
    ``step_end``, ``finish``, ``capture_cost``, ``capture_xla``): a wrong
    object fails before any work, not in the middle of a fit."""
    need = ("step_begin", "mark", "step_end", "finish", "capture_cost",
            "capture_xla")
    if prof is not None and not all(hasattr(prof, n) for n in need):
        raise TypeError(f"{owner}: the step profiler must be a "
                        f"telemetry.gangplane.StepProfiler (it needs "
                        f"{', '.join(need)}); got {type(prof).__name__}")


#: the counted costs a capture over a mesh agrees on
_GANG_COUNTS = ("flops", "matmul_flops", "bytes_accessed")


def _gang_max(entry: Optional[Dict[str, Any]], mesh: Any
              ) -> Optional[Dict[str, Any]]:
    """Each count of a captured cost at its maximum over the ranks (one
    all-reduce); None on every rank where any rank's capture failed."""
    import torch
    import torch.distributed as dist
    vals = [1.0] + [0.0] * len(_GANG_COUNTS)
    if entry is not None:
        vals = [0.0] + [float(entry[k]) for k in _GANG_COUNTS]
    t = torch.tensor(vals, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if entry is None or float(t[0]) > 0:
        return None
    return {**entry, **{k: float(v) for k, v in
                        zip(_GANG_COUNTS, t[1:].tolist())}}


def agree_capture(prof: Any, mesh: Any) -> None:
    """Over a mesh, the cost capture reruns one step on copies, its
    collectives included, so every rank must capture the same step
    together or the gang deadlocks.  One all-reduce over the whole group
    checks, before any work, that the ranks agree on ``capture_xla``;
    ``ValueError`` on every rank otherwise.  Free without a mesh."""
    if mesh is None:
        return
    import torch
    import torch.distributed as dist
    on = int(prof is not None and bool(prof.capture_xla))
    votes = torch.tensor([on, 1 - on], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(votes)
    if int(votes[0]) and int(votes[1]):
        raise ValueError(
            f"the step profiler's capture_xla is on at {int(votes[0])} "
            f"rank(s) and off at {int(votes[1])}: a capture over a mesh "
            "reruns a step's collectives, so every rank must capture")


class StepProfiler:
    """Wall-time decomposition of train steps into data / compute /
    collective / other segments.

    Two APIs over the same accounting:

    - context managers (new loops)::

          prof = StepProfiler("dl_text")
          with prof.step(i):
              with prof.segment("data"):    batch = shard(...)
              with prof.segment("compute"): state, m = step_fn(...)

    - begin/mark (retrofits into large existing loops, no re-indent)::

          prof.step_begin(i)
          ...prep...; prof.mark("data")
          ...dispatch...; prof.mark("compute")
          ...eval/checkpoint...; prof.step_end()   # remainder → "other"

    The ``collective`` segment is fed by :func:`observe_collective`
    (the hook-fed number is reported alongside, not subtracted).
    Per-segment wall time lands in ``train_step_seconds{model,segment}``
    plus a ``total`` series per step; :meth:`summary` returns a
    roofline-ready block, with the counted cost from
    :meth:`capture_cost`.  A step on a card is asynchronous: the caller
    synchronizes before ``mark("compute")`` so the segment times the
    work, not its enqueue.
    """

    SEGMENTS = ("data", "compute", "collective", "other")

    @staticmethod
    def measure(legs, *, blocks: int = 3, pairs: int = 6,
                timer: Callable[[], float] = time.perf_counter):
        """The alternating min-of-blocks timing protocol as a library
        call (the autotuner times its candidates with it).

        Two shapes of ``legs``:

        - **paired** — a 2-tuple ``(base_fn, other_fn)``: each block
          runs ``pairs`` interleaved executions whose leg order
          alternates pair to pair (cancelling monotone host-load
          drift), takes the per-block MEDIAN of the base times and of
          the other-minus-base differences, and reports the block with
          the minimum difference → ``(base_seconds, delta_seconds)``.
          The median-of-differences statistic is what makes small
          overheads resolvable on a noisy host.
        - **multi** — a dict ``name -> fn``: each block runs every leg
          once, in an order that reverses block to block, and each
          leg's statistic is its MINIMUM across blocks →
          ``{name: seconds}``.  Min-of-blocks is the right statistic
          for "how fast CAN this candidate go" questions (autotuning,
          codec comparisons); contention only ever inflates a block.

        A leg that returns an ``int``/``float`` is trusted as its own
        measurement in seconds (self-timing legs — e.g. a leg that
        reads a profiler's accounting); any other return value means
        the wall clock between ``timer()`` calls is the measurement.
        ``timer`` is injectable so tests can pin the statistics with a
        deterministic clock.
        """

        def _seconds(ret, t0, t1):
            if isinstance(ret, (int, float)) and not isinstance(ret, bool):
                return float(ret)
            return t1 - t0

        blocks = max(1, int(blocks))
        if isinstance(legs, dict):
            names = list(legs)
            best: Dict[str, float] = {}
            for b in range(blocks):
                order = names if b % 2 == 0 else list(reversed(names))
                for name in order:
                    t0 = timer()
                    ret = legs[name]()
                    s = _seconds(ret, t0, timer())
                    prev = best.get(name)
                    best[name] = s if prev is None else min(prev, s)
            return best
        if (isinstance(legs, (tuple, list)) and len(legs) == 2
                and all(callable(f) for f in legs)):
            base_fn, other_fn = legs
            pairs = max(1, int(pairs))
            winner = None
            for _ in range(blocks):
                bases, deltas = [], []
                for i in range(pairs):
                    first, second = ((base_fn, other_fn) if i % 2 == 0
                                     else (other_fn, base_fn))
                    t0 = timer()
                    r1 = first()
                    t1 = timer()
                    r2 = second()
                    t2 = timer()
                    d1 = _seconds(r1, t0, t1)
                    d2 = _seconds(r2, t1, t2)
                    base_s, other_s = (d1, d2) if i % 2 == 0 else (d2, d1)
                    bases.append(base_s)
                    deltas.append(other_s - base_s)
                blk_base = sorted(bases)[len(bases) // 2]
                blk_delta = sorted(deltas)[len(deltas) // 2]
                if winner is None or blk_delta < winner[1]:
                    winner = (blk_base, blk_delta)
            return winner
        raise TypeError("measure() wants a (base_fn, other_fn) pair or a "
                        f"{{name: fn}} dict, got {type(legs).__name__}")

    def __init__(self, model: str,
                 registry: Optional[MetricsRegistry] = None,
                 max_step_records: int = 1024,
                 capture_xla: bool = False):
        reg = registry or get_registry()
        self.model = str(model)
        #: the reference's name: capture each step's cost once per key
        #: through :func:`~.roofline.capture` (which RUNS the step)
        self.capture_xla = bool(capture_xla)
        self._hist = reg.histogram(
            "train_step_seconds",
            "wall-clock decomposition of train steps, by model and "
            "segment (data/compute/collective/other/total)",
            ("model", "segment"), buckets=_STEP_BUCKETS)
        self._c_steps = reg.counter(
            "train_steps_total", "profiled train steps", ("model",))
        self._lock = threading.Lock()
        self.steps = 0
        self.totals: Dict[str, float] = {s: 0.0 for s in
                                         (*self.SEGMENTS, "total")}
        self.collective_bytes = 0
        #: hook-fed collective seconds by planner route ('flat' = the
        #: direct dispatch)
        self.collective_by_strategy: Dict[str, float] = {}
        self.costs: Dict[str, Optional[Dict[str, float]]] = {}
        #: the device each captured step ran on (its peak prices MFU)
        self._cost_device: Dict[str, Any] = {}
        #: per-device items (samples/rows) one step processes, by capture
        #: key — feeds the per-sample gauges in :meth:`summary`
        self._cost_items: Dict[str, float] = {}
        self._g_bytes = reg.gauge(
            "train_step_bytes_per_sample",
            "counted bytes accessed per sample of the train step (per "
            "device; telemetry.roofline.capture)", ("model", "key"))
        self._g_mfu = reg.gauge(
            "train_step_mfu",
            "achieved model-flops utilization of the profiled train step "
            "against the device's spec-sheet peak (absent table entry = "
            "gauge not set)", ("model", "key"))
        self._tail: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, max_step_records))
        # open-step state (thread-local via _active while a step is open)
        self._open: Optional[dict] = None

    # -- begin/mark API ----------------------------------------------------
    def step_begin(self, index: Optional[int] = None) -> None:
        if self._open is not None:      # a break skipped step_end: close it
            self.step_end()
        now = time.perf_counter()
        self._open = {"index": index, "t0": now, "t_last": now,
                      "segs": {}, "collective": 0.0, "prev": (
                          getattr(_active, "profiler", None))}
        _active.profiler = self

    def mark(self, segment: str) -> None:
        """Attribute the wall time since the previous mark (or step
        begin) to ``segment``."""
        st = self._open
        if st is None:
            return
        now = time.perf_counter()
        st["segs"][segment] = st["segs"].get(segment, 0.0) \
            + (now - st["t_last"])
        st["t_last"] = now

    def step_end(self) -> None:
        st = self._open
        if st is None:
            return
        self._open = None
        _active.profiler = st["prev"]
        now = time.perf_counter()
        total = now - st["t0"]
        segs = st["segs"]
        other = max(0.0, total - sum(segs.values()))
        segs["other"] = segs.get("other", 0.0) + other
        segs["collective"] = segs.get("collective", 0.0) + st["collective"]
        rec = {"step": st["index"], "total": total,
               **{s: segs.get(s, 0.0) for s in self.SEGMENTS}}
        with self._lock:
            self.steps += 1
            self.totals["total"] += total
            for s in self.SEGMENTS:
                self.totals[s] += segs.get(s, 0.0)
            self._tail.append(rec)
        try:
            for s in self.SEGMENTS:
                if segs.get(s, 0.0) > 0.0:
                    self._hist.observe(segs[s], model=self.model, segment=s)
            self._hist.observe(total, model=self.model, segment="total")
            self._c_steps.inc(1, model=self.model)
        except Exception:       # telemetry must never break training
            pass

    def finish(self) -> None:
        """Close any dangling step (early-stopping ``break`` paths)."""
        if self._open is not None:
            self.step_end()

    # -- context API -------------------------------------------------------
    @contextlib.contextmanager
    def step(self, index: Optional[int] = None) -> Iterator[None]:
        self.step_begin(index)
        try:
            yield
        finally:
            self.step_end()

    @contextlib.contextmanager
    def segment(self, name: str) -> Iterator[None]:
        st = self._open
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if st is not None and st is self._open:
                st["segs"][name] = st["segs"].get(name, 0.0) \
                    + (time.perf_counter() - t0)
                st["t_last"] = time.perf_counter()

    @contextlib.contextmanager
    def excluded(self) -> Iterator[None]:
        """Leave the body's wall time out of the open step (the step's
        start and last mark move past it): the loops wrap their cost
        capture, its copies and its run in it, so a profiled step times
        the step alone."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            st = self._open
            if st is not None:
                dt = time.perf_counter() - t0
                st["t0"] += dt
                st["t_last"] += dt

    # -- collective hook ---------------------------------------------------
    def _note_collective(self, seconds: float, nbytes: int = 0,
                         strategy: str = "flat") -> None:
        st = self._open
        if st is not None:
            st["collective"] += float(seconds)
        with self._lock:
            self.collective_bytes += int(nbytes)
            self.collective_by_strategy[strategy] = \
                self.collective_by_strategy.get(strategy, 0.0) \
                + float(seconds)

    # -- cost capture ----------------------------------------------------
    def capture_cost(self, key: str, fn, *args, items: Optional[float] = None,
                     device=None, mesh=None,
                     **kw) -> Optional[Dict[str, float]]:
        """Once per ``key``: run ``fn(*args, **kw)`` under
        :func:`~.roofline.capture` and record its flops, bytes and top
        byte movers.  ``items`` is the sample (or row) count one step
        processes — when given, :meth:`summary` also exports the
        ``train_step_bytes_per_sample`` / ``train_step_mfu`` gauges.
        ``device`` is where the step runs (default: the first tensor's
        device among ``args``); its spec-sheet peak prices MFU.  The
        call EXECUTES ``fn``: hand it copies of live state.  Any failure
        records None and never propagates.  Over a ``mesh`` every rank
        captures the same step together (``fn`` runs its collectives);
        one all-reduce then makes the counts each count's maximum over the
        ranks (a rank's eager work depends on its rows), the same on every
        rank, and None everywhere if any rank's capture failed."""
        if key in self.costs:
            return self.costs[key]
        from . import roofline as _roofline
        if device is None:
            device = next((a.device for a in args
                           if hasattr(a, "device")
                           and hasattr(a, "data_ptr")), None)
        entry = _roofline.capture(fn, *args, **kw)
        if mesh is not None:
            entry = _gang_max(entry, mesh)
        self.costs[key] = entry
        self._cost_device[key] = device
        if items:
            self._cost_items[key] = float(items)
        return entry

    # -- export ------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Roofline-ready block: totals, per-step averages, hook-fed
        collective bytes, and achieved flops/s / bytes/s per captured
        captured step (against the average compute-segment second)."""
        with self._lock:
            steps = self.steps
            totals = dict(self.totals)
            cbytes = self.collective_bytes
            by_strategy = dict(self.collective_by_strategy)
            tail = list(self._tail)
        avg = {s: (totals[s] / steps if steps else 0.0) for s in totals}
        roofline = {}
        for key, cost in self.costs.items():
            if not cost:
                roofline[key] = None
                continue
            compute_s = avg.get("compute") or avg.get("total") or 0.0
            items = self._cost_items.get(key)
            roofline[key] = {
                **cost,
                "arithmetic_intensity": (
                    cost["flops"] / cost["bytes_accessed"]
                    if cost["bytes_accessed"] else None),
                "achieved_flops_per_sec": (
                    cost["flops"] / compute_s if compute_s else None),
                "achieved_bytes_per_sec": (
                    cost["bytes_accessed"] / compute_s
                    if compute_s else None),
                "bytes_per_sample": (cost["bytes_accessed"] / items
                                     if items else None),
            }
            # live-telemetry export; telemetry must never break the
            # summary
            try:
                if items and cost["bytes_accessed"]:
                    self._g_bytes.set(cost["bytes_accessed"] / items,
                                      model=self.model, key=key)
                device = self._cost_device.get(key)
                if compute_s and cost["flops"] and device is not None:
                    from . import roofline as _roofline
                    peak = _roofline.chip_peak_flops(device)
                    if peak:
                        self._g_mfu.set(
                            cost["flops"] / compute_s / peak,
                            model=self.model, key=key)
            except Exception:
                pass
        return {"model": self.model, "steps": steps, "seconds": totals,
                "per_step_avg_seconds": avg,
                "collective_bytes": cbytes,
                "collective_seconds_by_strategy": by_strategy,
                "roofline": roofline, "last_steps": tail[-16:]}

    def export(self, path: str) -> Dict[str, Any]:
        """Atomically write :meth:`summary`."""
        return write_json(path, _sanitize(self.summary()),
                          schema=("model", "steps", "seconds"))
