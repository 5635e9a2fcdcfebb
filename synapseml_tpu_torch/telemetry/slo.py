"""Windowed SLO plane: sliding-window percentile digests + live
attainment/burn-rate gauges for the serving path.

The serving plane already exports cumulative counters and whole-run
histograms — fine for dashboards, useless for an autoscaler: a
counter's lifetime total says nothing about the last minute, which is
the signal a resize decision needs.  This module is
the telemetry half of that loop:

- :class:`WindowedHistogram` — a time-sliced cumulative-bucket digest:
  observations land in the slice owning ``now``, slices older than the
  window roll off, and quantiles come from bucket interpolation
  (:func:`~synapseml_tpu_torch.telemetry.registry.bucket_quantile`), so live
  p50/p95/p99 need no raw-sample retention and are accurate to within
  one bucket width.
- :class:`WindowedCounter` — the same slice ring counting events
  (admissions, sheds, retirements → windowed rates).
- :class:`SloWindow` — one serving plane's window set: TTFT +
  per-token-latency digests (on the serving-tuned bucket ladders),
  occupancy samples, admission/shed/retirement counts, and declared
  *objectives* (``threshold_s`` + ``target``) from which it computes
  **attainment** (fraction of windowed observations under the
  threshold) and **burn rate** ((1 − attainment) / (1 − target): 1.0
  = burning error budget exactly at the sustainable rate, >1 = an SLO
  violation in progress).
- :class:`SloStore` — the process-wide get-or-create registry of
  windows; its :meth:`~SloStore.snapshot` is the schema-checked JSON
  served at the reserved ``GET /sloz`` path — deliberately the exact
  input contract for the ROADMAP-item-4 autoscaler.

Everything exports live to ``/metrics`` too (``slo_attainment``,
``slo_burn_rate``, ``slo_window_quantile_seconds``,
``slo_window_shed_ratio``, ``slo_window_occupancy``), so a Prometheus
alert and the ``/sloz`` consumer read the same windows.

Stdlib-only; importable before (and without) torch.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from .registry import (SERVING_TOKEN_LATENCY_BUCKETS, SERVING_TTFT_BUCKETS,
                       bucket_quantile, get_registry)

__all__ = ["WindowedHistogram", "WindowedCounter", "SloWindow", "SloStore",
           "get_slo_store", "check_sloz", "SLOZ_SCHEMA",
           "SLOZ_SCHEMA_VERSION", "SLO_METRICS",
           "DEFAULT_WINDOW_S", "DEFAULT_SLICES",
           "TENANT_PLANE_SEP", "tenant_plane_name", "plane_tenant",
           "PHASE_PLANE_SEP", "phase_plane_name", "plane_phase"]

#: default sliding-window length (seconds) and slice count — six 10 s
#: slices: the window advances in 10 s steps, so the digest spans
#: between 50 and 60 s of traffic at any instant
DEFAULT_WINDOW_S = 60.0
DEFAULT_SLICES = 6

#: required top-level keys of a ``/sloz`` snapshot
SLOZ_SCHEMA = ("schema_version", "generated_unix", "window_s", "planes")

#: the ``/sloz`` contract version every snapshot is stamped with.  The
#: unversioned PR-13 payload is retroactively version 1; version 2 is
#: the first STAMPED shape (identical fields plus the stamp itself).
#: Bump on any change to the plane-block layout — ``check_sloz``
#: rejects a mismatched stamp, so a consumer built against this module
#: (the autoscaler is the second consumer after ``/sloz`` itself) can
#: never silently misread a snapshot from a different contract era.
SLOZ_SCHEMA_VERSION = 2

#: SLO-plane metric names (the metric-hygiene sweep holds every one of
#: these to the docs bar, like GANG_METRICS)
SLO_METRICS = frozenset({
    "slo_attainment", "slo_burn_rate", "slo_window_quantile_seconds",
    "slo_window_shed_ratio", "slo_window_occupancy",
    # session-affinity visibility (registered by serving.distributed):
    # part of the same serving-observability plane, same docs bar
    "serving_affinity_total",
})

#: quantiles every window exports (gauge label + snapshot fields)
_QUANTILES: Tuple[Tuple[str, float], ...] = (
    ("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

#: separator embedding a tenant id in a plane name.  Per-tenant SLO
#: attribution rides the EXISTING get-or-create plane registry — a
#: tenant's plane is just ``<base>@tenant=<id>`` — so ``/sloz`` needs
#: no schema change (version 2 holds) and ``/sloz?tenant=`` is a pure
#: plane-name filter.
TENANT_PLANE_SEP = "@tenant="


def tenant_plane_name(base: str, tenant: str) -> str:
    """The plane name carrying ``base``'s per-tenant window for
    ``tenant`` (e.g. ``"/llm@tenant=acme"``)."""
    return f"{base}{TENANT_PLANE_SEP}{tenant}"


def plane_tenant(name: str) -> Optional[str]:
    """The tenant a plane name is attributed to (None for aggregate
    planes)."""
    if TENANT_PLANE_SEP not in name:
        return None
    return name.split(TENANT_PLANE_SEP, 1)[1]


#: separator embedding a serving phase in a plane name — the
#: disaggregated prefill/decode mirror of :data:`TENANT_PLANE_SEP`.
#: A phase's plane is just ``<base>@phase=<prefill|decode>`` riding the
#: same get-or-create registry, so ``/sloz`` needs no schema change
#: (version 2 still holds, exactly as per-tenant planes established)
#: and ``/sloz?phase=`` is a pure plane-name filter the autoscaler can
#: scale each pool off independently.
PHASE_PLANE_SEP = "@phase="


def phase_plane_name(base: str, phase: str) -> str:
    """The plane name carrying ``base``'s per-phase window for
    ``phase`` (e.g. ``"/generate@phase=prefill"``)."""
    return f"{base}{PHASE_PLANE_SEP}{phase}"


def plane_phase(name: str) -> Optional[str]:
    """The serving phase a plane name is attributed to (None for
    aggregate and per-tenant planes)."""
    if PHASE_PLANE_SEP not in name:
        return None
    return name.split(PHASE_PLANE_SEP, 1)[1]


def _num(v) -> Optional[float]:
    """JSON-safe numeric: non-finite (empty-window NaN) → None."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


class _SliceRing:
    """Shared slice mechanics: a deque of ``[slice_index, payload]``
    entries, rotated on every touch so entries older than the window
    roll off.  ``slice_index = floor(now / slice_s)``; the live window
    is the newest ``slices`` indices."""

    def __init__(self, window_s: float, slices: int):
        if window_s <= 0 or slices < 1:
            raise ValueError("window_s must be > 0 and slices >= 1")
        self.window_s = float(window_s)
        self.slices = int(slices)
        self.slice_s = self.window_s / self.slices
        self._ring: Deque[List[Any]] = deque()
        self._lock = threading.Lock()

    def _rotate(self, now: float) -> int:
        idx = int(now // self.slice_s)
        while self._ring and self._ring[0][0] <= idx - self.slices:
            self._ring.popleft()
        return idx

    def _slot(self, now: float, fresh) -> Any:
        idx = self._rotate(now)
        if not self._ring or self._ring[-1][0] != idx:
            self._ring.append([idx, fresh()])
        return self._ring[-1][1]

    def _live(self, now: float) -> List[Any]:
        self._rotate(now)
        return [payload for _, payload in self._ring]


class WindowedHistogram(_SliceRing):
    """Sliding-window cumulative-bucket histogram (thread-safe).

    Same bucket semantics as the registry
    :class:`~synapseml_tpu_torch.telemetry.registry.Histogram`
    (``buckets[i]`` counts observations <= ``bounds[i]``), but scoped
    to the trailing window instead of the process lifetime — quantiles
    and means describe the last ``window_s`` seconds of traffic."""

    def __init__(self, buckets: Sequence[float],
                 window_s: float = DEFAULT_WINDOW_S,
                 slices: int = DEFAULT_SLICES):
        super().__init__(window_s, slices)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("need at least one bucket bound")
        self.buckets: Tuple[float, ...] = bounds

    def _fresh(self):
        # per-slice counts are NON-cumulative (one bisect + one
        # increment per observe — this sits on the serving hot path,
        # once per token); merged() cumulates at read time, which is
        # where the Prometheus-shaped view is actually needed
        return {"buckets": [0] * len(self.buckets), "sum": 0.0, "count": 0}

    def observe(self, value: float, now: Optional[float] = None) -> None:
        value = float(value)
        if math.isnan(value):
            return
        now = time.monotonic() if now is None else now
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            st = self._slot(now, self._fresh)
            if i < len(self.buckets):
                st["buckets"][i] += 1
            st["sum"] += value
            st["count"] += 1

    def merged(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The window's CUMULATIVE buckets/sum/count (Prometheus
        semantics — ``buckets[i]`` = observations <= ``bounds[i]``),
        all live slices summed."""
        now = time.monotonic() if now is None else now
        out = self._fresh()
        with self._lock:
            for st in self._live(now):
                for i, n in enumerate(st["buckets"]):
                    out["buckets"][i] += n
                out["sum"] += st["sum"]
                out["count"] += st["count"]
        run = 0
        for i, n in enumerate(out["buckets"]):
            run += n
            out["buckets"][i] = run
        return out

    def count(self, now: Optional[float] = None) -> int:
        return int(self.merged(now)["count"])

    def mean(self, now: Optional[float] = None) -> float:
        m = self.merged(now)
        return m["sum"] / m["count"] if m["count"] else float("nan")

    def quantile(self, q: float, now: Optional[float] = None) -> float:
        """Bucket-interpolated windowed quantile (NaN when empty)."""
        m = self.merged(now)
        return bucket_quantile(self.buckets, m["buckets"], m["count"], q)

    def fraction_below(self, threshold: float,
                       now: Optional[float] = None) -> float:
        """Interpolated fraction of windowed observations <= threshold
        — the attainment estimator (exact when the threshold sits on a
        bucket bound, which is why SLO thresholds should)."""
        m = self.merged(now)
        if not m["count"]:
            return float("nan")
        prev_bound, prev_cum = 0.0, 0
        for bound, cum in zip(self.buckets, m["buckets"]):
            if threshold <= bound:
                width = bound - prev_bound
                frac = ((threshold - prev_bound) / width) if width > 0 \
                    else 1.0
                est = prev_cum + (cum - prev_cum) * min(1.0, max(0.0, frac))
                return est / m["count"]
            prev_bound, prev_cum = float(bound), int(cum)
        return 1.0 if threshold >= self.buckets[-1] else 0.0


class WindowedCounter(_SliceRing):
    """Sliding-window event counter → windowed rates (thread-safe)."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 slices: int = DEFAULT_SLICES):
        super().__init__(window_s, slices)

    def inc(self, amount: float = 1.0, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            slot = self._slot(now, lambda: [0.0])
            slot[0] += amount

    def count(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return float(sum(s[0] for s in self._live(now)))

    def rate(self, now: Optional[float] = None) -> float:
        """Events per second over the window (window-length normalized
        — a conservative under-estimate while the first window fills)."""
        return self.count(now) / self.window_s


class SloWindow:
    """One serving plane's windowed SLO state.

    Feed it from the serving loop (``observe_ttft`` /
    ``observe_token_latency`` per event, ``observe_occupancy`` per
    step, ``count("admitted"|"shed"|"retired")`` per transition),
    declare objectives with :meth:`set_objective`, and read back
    either the live ``/metrics`` gauges (:meth:`export_gauges`) or the
    ``/sloz`` snapshot block (:meth:`snapshot`)."""

    #: counter kinds the rates block reports
    KINDS = ("admitted", "shed", "retired")

    def __init__(self, name: str, window_s: float = DEFAULT_WINDOW_S,
                 slices: int = DEFAULT_SLICES):
        self.name = name
        self.window_s = float(window_s)
        self.slices = int(slices)
        self._ttft = WindowedHistogram(SERVING_TTFT_BUCKETS, window_s,
                                       slices)
        self._token = WindowedHistogram(SERVING_TOKEN_LATENCY_BUCKETS,
                                        window_s, slices)
        # occupancy is a fraction in [0, 1]: a fine uniform ladder makes
        # the windowed mean/quantiles sharp at every load level
        self._occ = WindowedHistogram(
            tuple(i / 16 for i in range(1, 17)), window_s, slices)
        self._counts = {k: WindowedCounter(window_s, slices)
                        for k in self.KINDS}
        #: signal -> (threshold_s, target attainment)
        self.objectives: Dict[str, Tuple[float, float]] = {}
        reg = get_registry()
        self._g_attain = reg.gauge(
            "slo_attainment", "windowed fraction of observations meeting "
            "the declared objective", ("plane", "signal"))
        self._g_burn = reg.gauge(
            "slo_burn_rate", "(1 - attainment) / (1 - target): 1.0 burns "
            "error budget exactly at the sustainable rate", ("plane",
                                                             "signal"))
        self._g_quant = reg.gauge(
            "slo_window_quantile_seconds",
            "windowed latency quantile (bucket-interpolated)",
            ("plane", "signal", "quantile"))
        self._g_shed = reg.gauge(
            "slo_window_shed_ratio",
            "windowed sheds / (sheds + admissions)", ("plane",))
        self._g_occ = reg.gauge(
            "slo_window_occupancy", "windowed mean slot occupancy",
            ("plane",))

    # -- feeding -----------------------------------------------------------
    def observe_ttft(self, seconds: float,
                     now: Optional[float] = None) -> None:
        self._ttft.observe(seconds, now)

    def observe_token_latency(self, seconds: float,
                              now: Optional[float] = None) -> None:
        self._token.observe(seconds, now)

    def observe_occupancy(self, fraction: float,
                          now: Optional[float] = None) -> None:
        self._occ.observe(fraction, now)

    def count(self, kind: str, amount: float = 1.0,
              now: Optional[float] = None) -> None:
        self._counts[kind].inc(amount, now)

    def set_objective(self, signal: str, threshold_s: float,
                      target: float = 0.99) -> None:
        """Declare an SLO: ``signal`` in ``ttft``/``token_latency``,
        ``threshold_s`` the latency bound, ``target`` the attainment
        goal the burn rate is normalized against."""
        if signal not in ("ttft", "token_latency"):
            raise ValueError(f"unknown SLO signal {signal!r}")
        self.objectives[signal] = (float(threshold_s),
                                   min(0.9999, max(0.0, float(target))))

    # -- reading -----------------------------------------------------------
    def _signal(self, signal: str) -> WindowedHistogram:
        return self._ttft if signal == "ttft" else self._token

    def attainment(self, signal: str,
                   now: Optional[float] = None) -> float:
        thr, _ = self.objectives[signal]
        return self._signal(signal).fraction_below(thr, now)

    def burn_rate(self, signal: str, now: Optional[float] = None) -> float:
        thr, target = self.objectives[signal]
        att = self._signal(signal).fraction_below(thr, now)
        return (1.0 - att) / (1.0 - target)

    def shed_ratio(self, now: Optional[float] = None) -> float:
        shed = self._counts["shed"].count(now)
        admitted = self._counts["admitted"].count(now)
        total = shed + admitted
        return shed / total if total else 0.0

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """This plane's ``/sloz`` block (all leaves numeric-or-null)."""
        now = time.monotonic() if now is None else now
        signals: Dict[str, Any] = {}
        for sig, hist in (("ttft", self._ttft),
                          ("token_latency", self._token)):
            block = {"count": int(hist.count(now)),
                     "mean_s": _num(hist.mean(now))}
            for label, q in _QUANTILES:
                block[f"{label}_s"] = _num(hist.quantile(q, now))
            signals[sig] = block
        slo: Dict[str, Any] = {}
        for sig, (thr, target) in self.objectives.items():
            slo[sig] = {"threshold_s": thr, "target": target,
                        "attainment": _num(self.attainment(sig, now)),
                        "burn_rate": _num(self.burn_rate(sig, now))}
        rates = {f"{k}_per_s": _num(self._counts[k].rate(now))
                 for k in self.KINDS}
        rates["shed_ratio"] = _num(self.shed_ratio(now))
        return {"window_s": self.window_s, "slices": self.slices,
                "signals": signals,
                "occupancy": {"mean": _num(self._occ.mean(now)),
                              "samples": int(self._occ.count(now))},
                "rates": rates, "slo": slo}

    def export_gauges(self, now: Optional[float] = None) -> None:
        """Refresh this plane's live gauges from the windows (the
        serving loop calls this on a ~1 s cadence; empty windows export
        NaN, which the exposition renders as literal ``NaN``)."""
        now = time.monotonic() if now is None else now
        for sig, hist in (("ttft", self._ttft),
                          ("token_latency", self._token)):
            for label, q in _QUANTILES:
                self._g_quant.set(hist.quantile(q, now), plane=self.name,
                                  signal=sig, quantile=label)
        for sig in self.objectives:
            self._g_attain.set(self.attainment(sig, now),
                               plane=self.name, signal=sig)
            self._g_burn.set(self.burn_rate(sig, now),
                             plane=self.name, signal=sig)
        self._g_shed.set(self.shed_ratio(now), plane=self.name)
        occ = self._occ.mean(now)
        self._g_occ.set(0.0 if math.isnan(occ) else occ, plane=self.name)


class SloStore:
    """Get-or-create registry of :class:`SloWindow` planes; the
    ``/sloz`` endpoint serves :meth:`snapshot`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._windows: Dict[str, SloWindow] = {}

    def window(self, name: str, window_s: float = DEFAULT_WINDOW_S,
               slices: int = DEFAULT_SLICES) -> SloWindow:
        with self._lock:
            w = self._windows.get(name)
            if w is None:
                w = self._windows[name] = SloWindow(name, window_s, slices)
            return w

    def windows(self) -> List[SloWindow]:
        with self._lock:
            return sorted(self._windows.values(), key=lambda w: w.name)

    def snapshot(self) -> Dict[str, Any]:
        """The full ``/sloz`` payload (validated by :func:`check_sloz`
        before it is served — a malformed window is a 500, never a
        silently wrong autoscaler input).  The top-level ``window_s``
        is the registered planes' COMMON window length; planes with
        differing windows make it null (each plane block always
        carries its own), so a consumer can never misread a custom
        window by trusting a hardcoded top-level value."""
        windows = self.windows()
        lengths = {w.window_s for w in windows}
        common = (lengths.pop() if len(lengths) == 1
                  else DEFAULT_WINDOW_S if not lengths else None)
        return {"schema_version": SLOZ_SCHEMA_VERSION,
                "generated_unix": time.time(),
                "window_s": common,
                "planes": {w.name: w.snapshot() for w in windows}}

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()


#: per-plane block keys check_sloz requires
_PLANE_KEYS = ("window_s", "slices", "signals", "occupancy", "rates", "slo")
_SIGNAL_KEYS = ("count", "mean_s", "p50_s", "p95_s", "p99_s")
_SLO_KEYS = ("threshold_s", "target", "attainment", "burn_rate")


def check_sloz(obj: Any, tenant: Optional[str] = None,
               phase: Optional[str] = None) -> None:
    """Validate a ``/sloz`` snapshot (raises ``ValueError``): required
    keys at every level, every leaf numeric or null — the contract the
    ROADMAP-item-4 autoscaler consumes.  With ``tenant`` set the
    snapshot must additionally be a tenant-filtered view: every plane
    name carries exactly that tenant (the ``/sloz?tenant=`` contract —
    a filter that leaked another tenant's plane is a validation error,
    not a smaller bug).  ``phase`` is the same contract for the
    disaggregated ``/sloz?phase=`` view: every plane name must carry
    exactly that serving phase."""
    if not isinstance(obj, dict):
        raise ValueError("sloz snapshot must be a dict")
    for key in SLOZ_SCHEMA:
        if key not in obj:
            raise ValueError(f"sloz snapshot missing key {key!r}")
    version = obj["schema_version"]
    if version != SLOZ_SCHEMA_VERSION:
        raise ValueError(
            f"sloz schema_version {version!r} unsupported (this consumer "
            f"speaks version {SLOZ_SCHEMA_VERSION}); refusing to guess at "
            "a foreign contract era")
    if not isinstance(obj["planes"], dict):
        raise ValueError("sloz planes must be a dict")
    if tenant is not None:
        for name in obj["planes"]:
            if plane_tenant(name) != tenant:
                raise ValueError(
                    f"sloz plane {name!r} leaked into the tenant="
                    f"{tenant!r} filtered view")
    if phase is not None:
        for name in obj["planes"]:
            if plane_phase(name) != phase:
                raise ValueError(
                    f"sloz plane {name!r} leaked into the phase="
                    f"{phase!r} filtered view")

    def _leaf(path: str, v: Any) -> None:
        if v is not None and not isinstance(v, (int, float)):
            raise ValueError(f"sloz {path} must be numeric or null, "
                             f"got {v!r}")
        if isinstance(v, float) and not math.isfinite(v):
            raise ValueError(f"sloz {path} is non-finite")

    _leaf("generated_unix", obj["generated_unix"])
    _leaf("window_s", obj["window_s"])
    for name, plane in obj["planes"].items():
        for key in _PLANE_KEYS:
            if key not in plane:
                raise ValueError(f"sloz plane {name!r} missing {key!r}")
        for sig in ("ttft", "token_latency"):
            block = plane["signals"].get(sig)
            if not isinstance(block, dict):
                raise ValueError(f"sloz plane {name!r} missing signal "
                                 f"{sig!r}")
            for key in _SIGNAL_KEYS:
                if key not in block:
                    raise ValueError(
                        f"sloz plane {name!r} signal {sig!r} missing "
                        f"{key!r}")
                _leaf(f"{name}.{sig}.{key}", block[key])
        for key, v in plane["occupancy"].items():
            _leaf(f"{name}.occupancy.{key}", v)
        for key, v in plane["rates"].items():
            _leaf(f"{name}.rates.{key}", v)
        for sig, block in plane["slo"].items():
            for key in _SLO_KEYS:
                if key not in block:
                    raise ValueError(
                        f"sloz plane {name!r} slo {sig!r} missing {key!r}")
                _leaf(f"{name}.slo.{sig}.{key}", block[key])


_default_store: Optional[SloStore] = None
_default_lock = threading.Lock()


def get_slo_store() -> SloStore:
    """The process-wide SLO store every serving loop feeds."""
    global _default_store
    if _default_store is None:
        with _default_lock:
            if _default_store is None:
                _default_store = SloStore()
    return _default_store
