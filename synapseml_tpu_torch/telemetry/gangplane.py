"""The step-level training profiler of the PyTorch port.

The step-profiler part of the JAX package's ``telemetry/gangplane.py``:
:class:`StepProfiler` decomposes each train step's wall time into
data / compute / collective / other segments, exports
``train_step_seconds{model,segment}`` histograms and
``train_steps_total``, and with ``capture_xla=True`` captures each
step's cost once per key for a roofline-ready :meth:`StepProfiler.summary`
(``train_step_bytes_per_sample``, ``train_step_mfu``).  The parameter
keeps the reference's name; here it means "capture the step's cost
through :func:`~.roofline.capture`", which runs the step once, so the
callers hand it copies of their state.  :meth:`StepProfiler.measure` is
the alternating min-of-blocks timing protocol, which the
autotuner times its candidates with.

The gang half of the reference module (the cross-rank wire export,
``GangPlane`` and the post-mortem bundles) waits for the multi-process
layer (ROADMAP A5).

Stdlib-only at import time; torch is touched by the cost capture and the
peak lookup.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from .artifact import write_json
from .flight import sanitize_floats as _sanitize
from .registry import MetricsRegistry, get_registry

__all__ = ["StepProfiler", "current_profiler", "observe_collective",
           "check_profiler", "STEP_METRICS"]

#: the metric names the profiler exports
STEP_METRICS = frozenset({"train_step_seconds", "train_steps_total",
                          "train_step_bytes_per_sample", "train_step_mfu"})


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
    direct dispatch).  The port has no collectives yet (ROADMAP A5):
    the hook is kept for them; free when no step is open."""
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
                     device=None, **kw) -> Optional[Dict[str, float]]:
        """Once per ``key``: run ``fn(*args, **kw)`` under
        :func:`~.roofline.capture` and record its flops, bytes and top
        byte movers.  ``items`` is the sample (or row) count one step
        processes — when given, :meth:`summary` also exports the
        ``train_step_bytes_per_sample`` / ``train_step_mfu`` gauges.
        ``device`` is where the step runs (default: the first tensor's
        device among ``args``); its spec-sheet peak prices MFU.  The
        call EXECUTES ``fn``: hand it copies of live state.  Any failure
        records None and never propagates."""
        if key in self.costs:
            return self.costs[key]
        from . import roofline as _roofline
        if device is None:
            device = next((a.device for a in args
                           if hasattr(a, "device")
                           and hasattr(a, "data_ptr")), None)
        entry = _roofline.capture(fn, *args, **kw)
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
