"""Process-wide metrics registry: Counter / Gauge / Histogram with labels.

The reference ships structured per-verb telemetry (``SynapseMLLogging``)
and per-phase wall measures (``LightGBMPerformance.scala``) but no live,
queryable metric surface; this module is the TPU-native stack's answer —
a single in-process registry every layer (collectives, GBDT phases, DL
steps, serving loops) writes into, exportable as Prometheus text or JSON
(:mod:`synapseml_tpu_torch.telemetry.exposition`).

Design points:

- **stdlib-only** — importable before (or without) torch.
- **thread-safe** — serving loops, the GBDT warm-compile thread, and the
  asyncio listener all write concurrently; every mutation holds the
  metric's lock.
- **resettable** — ``registry.reset()`` zeroes all series (registrations
  survive), so tests can assert deltas without process isolation.
- **get-or-create** — ``registry.counter(name, ...)`` returns the
  existing metric when already registered (same kind + label names), so
  call sites need no import-order coordination.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_BUCKETS", "SERVING_TTFT_BUCKETS",
           "SERVING_TOKEN_LATENCY_BUCKETS", "bucket_quantile"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Prometheus' default latency buckets (seconds) + +Inf implicit
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: serving-tuned TTFT buckets (seconds): the default ladder starts at
#: 5 ms, which collapses a whole low-latency serving regime into one
#: bucket — these add 1/2.5 ms resolution below it and keep the long
#: tail out to 30 s (queueing under overload).  Shared by the live
#: ``llm_ttft_seconds`` histogram and the SLO window digests, so both
#: surfaces quantize identically.
SERVING_TTFT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0)

#: serving-tuned per-token decode-latency buckets (seconds): decode
#: steps on real chips are sub-millisecond, where the Prometheus
#: defaults have zero resolution — the ladder starts at 100 µs.
SERVING_TOKEN_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 1.0)


def bucket_quantile(bounds: Sequence[float], cumulative: Sequence[int],
                    count: int, q: float) -> float:
    """Bucket-interpolated quantile over Prometheus-style CUMULATIVE
    bucket counts (``cumulative[i]`` = observations <= ``bounds[i]``;
    ``count`` includes the implicit +Inf bucket).

    Linear interpolation inside the bucket holding the q-rank, assuming
    a uniform spread (the ``histogram_quantile`` model) and a lower
    edge of 0 for the first bucket — the estimator for non-negative
    observations (latencies).  Ranks landing in the +Inf bucket clamp
    to the highest finite bound.  The estimate is exact at bucket
    boundaries and off by at most one bucket width anywhere else —
    which is why live percentile gauges can ride this instead of
    retaining raw samples.  NaN when the window is empty."""
    if count <= 0:
        return float("nan")
    q = min(1.0, max(0.0, float(q)))
    rank = q * count
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in zip(bounds, cumulative):
        if cum >= rank:
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return float(bound)
            frac = (rank - prev_cum) / in_bucket
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = float(bound), int(cum)
    return float(bounds[-1])


class _Metric:
    """Shared label-series plumbing for the three metric kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def series(self) -> Dict[Tuple[str, ...], object]:
        """Snapshot of every label-set's current value.  Scalar series
        are immutable floats so a shallow copy IS a snapshot; Histogram
        overrides this to deep-copy its mutable per-series state."""
        with self._lock:
            return dict(self._series)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def remove(self, **labels) -> None:
        """Drop one label-set's series (no-op if absent) — for surfaces
        whose membership shrinks, e.g. a refreshed routing table."""
        key = self._key(labels)
        with self._lock:
            self._series.pop(key, None)


class Counter(_Metric):
    """Monotonically increasing value per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))  # type: ignore[arg-type]


class Gauge(_Metric):
    """Point-in-time value per label set (set/inc/dec)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))  # type: ignore[arg-type]


class Histogram(_Metric):
    """Cumulative-bucket histogram per label set (Prometheus semantics:
    ``bucket[i]`` counts observations <= ``buckets[i]``, +Inf implicit)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bounds:
            raise ValueError(f"{self.name}: need at least one bucket bound")
        self.buckets: Tuple[float, ...] = bounds

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        if math.isnan(value):
            return
        key = self._key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = {"buckets": [0] * len(self.buckets),
                      "sum": 0.0, "count": 0}
                self._series[key] = st
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    st["buckets"][i] += 1            # type: ignore[index]
            st["sum"] += value                       # type: ignore[index]
            st["count"] += 1                         # type: ignore[index]

    def series(self) -> Dict[Tuple[str, ...], object]:
        """Deep-copied snapshot taken under the lock — exposition must
        never see a bucket array mid-observe (a torn read would emit a
        non-monotonic cumulative histogram)."""
        with self._lock:
            return {k: {"buckets": list(v["buckets"]),  # type: ignore[index]
                        "sum": v["sum"], "count": v["count"]}  # type: ignore[index]
                    for k, v in self._series.items()}

    def stats(self, **labels) -> Dict[str, object]:
        key = self._key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                return {"buckets": [0] * len(self.buckets),
                        "sum": 0.0, "count": 0}
            return {"buckets": list(st["buckets"]),   # type: ignore[index]
                    "sum": st["sum"], "count": st["count"]}  # type: ignore[index]

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate for one label set (see
        :func:`bucket_quantile`): live percentile gauges without raw-
        sample retention, accurate to within one bucket width.  NaN
        when the series has no observations."""
        st = self.stats(**labels)
        return bucket_quantile(self.buckets, st["buckets"],  # type: ignore[arg-type]
                               int(st["count"]), q)  # type: ignore[arg-type]


class MetricsRegistry:
    """Named metric collection with get-or-create registration."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                if existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{existing.labelnames}, not {tuple(labelnames)}")
                want = kw.get("buckets")
                if want is not None:
                    want = tuple(sorted(float(b) for b in want))
                    if want != existing.buckets:     # type: ignore[attr-defined]
                        raise ValueError(
                            f"metric {name!r} already registered with "
                            f"buckets {existing.buckets}, "  # type: ignore[attr-defined]
                            f"not {want}")
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def reset(self) -> None:
        """Zero every series; registrations (and cached metric handles
        held by call sites) stay valid."""
        for m in self.metrics():
            m.reset()

    def clear(self) -> None:
        """Drop all registrations — only for tests that exercise
        registration itself; cached handles go stale."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view of everything: {name: {kind, help, labelnames,
        series: [{labels, value|stats}]}}."""
        out: Dict[str, object] = {}
        for m in self.metrics():
            series = []
            for key, val in sorted(m.series().items()):
                labels = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    series.append({"labels": labels,
                                   "sum": val["sum"],          # type: ignore[index]
                                   "count": val["count"],      # type: ignore[index]
                                   "buckets": dict(zip(
                                       [str(b) for b in m.buckets],  # type: ignore[attr-defined]
                                       val["buckets"]))})      # type: ignore[index]
                else:
                    series.append({"labels": labels, "value": val})
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames),
                           "series": series}
        return out


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every built-in layer writes to."""
    return _default_registry
