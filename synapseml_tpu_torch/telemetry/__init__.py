"""Telemetry of the PyTorch port: metrics registry, span and request
tracing, exposition, atomic artifacts, the flight recorder and the
windowed SLO plane.

Copies of the JAX package's stdlib-only ``telemetry`` modules, imports
aside:

- :mod:`.registry` — process-wide ``Counter``/``Gauge``/``Histogram``
  with label sets; thread-safe, resettable (``get_registry()``).
- :mod:`.tracing` — nested host-side spans with Chrome-trace export and
  the per-request trace store behind ``GET /tracez``.
- :mod:`.exposition` — Prometheus text + JSON rendering; served by
  ``ServingServer`` at ``GET /metrics``.
- :mod:`.artifact` — atomic, round-trip-verified JSON artifact writes.
- :mod:`.flight` — the crash flight recorder's bounded event ring.
- :mod:`.slo` — sliding-window percentile digests and SLO burn rates,
  served at ``GET /sloz``.

and the profiling and tuning plane:

- :mod:`.gangplane` — :class:`StepProfiler`, the step-level training
  profiler, and the gang plane: the ``SMLMP_TM:`` wire export of worker
  ranks, :class:`~.gangplane.GangPlane` (the launcher's merged view) and
  the post-mortem bundles.
- :mod:`.roofline` — counted bytes and flops of a step
  (:func:`~.roofline.capture`) and the roofline blocks, against the
  card's spec-sheet peaks.
- :mod:`.tunetable` — the persisted per-(device, geometry) tuning table
  behind ``GET /tunez``.
- :mod:`.autotune` — the measured autotuner of the port's kernels and
  the α-β collective cost model.
"""

from .artifact import (SchemaError, check_schema, dumps_checked, read_json,
                       write_json)
from .autotune import (AUTOTUNE_METRICS, Autotuner, CollectiveCostModel,
                       TuneSpace, fit_alpha_beta, register_space,
                       registered_spaces, resolve_entry_point)
from .exposition import (PROMETHEUS_CONTENT_TYPE, render_json,
                         render_prometheus)
from .flight import FlightRecorder, get_flight
from .gangplane import (GangPlane, StepProfiler, TM_MARKER,
                        check_postmortem, current_profiler, parse_telemetry,
                        write_postmortem)
from .registry import (DEFAULT_BUCKETS, SERVING_TOKEN_LATENCY_BUCKETS,
                       SERVING_TTFT_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, bucket_quantile, get_registry)
from .roofline import (ROOFLINE_BLOCK_KEYS, check_roofline_block,
                       paired_roofline, roofline_block)
from .slo import (SLO_METRICS, SLOZ_SCHEMA, SLOZ_SCHEMA_VERSION, SloStore,
                  SloWindow, WindowedCounter, WindowedHistogram, check_sloz,
                  get_slo_store, plane_tenant, tenant_plane_name)
from .tracing import (RequestTraceStore, Span, Tracer, get_request_tracer,
                      get_tracer, mint_trace_id, span)
from .tunetable import (TUNE_TABLE_ENV, TUNE_TABLE_SCHEMA_VERSION, TunePlane,
                        check_tune_table, check_tunez, device_kind,
                        geometry_key, get_tuneplane, set_tuneplane)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_BUCKETS", "SERVING_TTFT_BUCKETS",
    "SERVING_TOKEN_LATENCY_BUCKETS", "bucket_quantile",
    "Span", "Tracer", "get_tracer", "span",
    "RequestTraceStore", "get_request_tracer", "mint_trace_id",
    "SloStore", "SloWindow", "WindowedCounter", "WindowedHistogram",
    "check_sloz", "get_slo_store", "SLOZ_SCHEMA", "SLOZ_SCHEMA_VERSION",
    "SLO_METRICS", "plane_tenant", "tenant_plane_name",
    "render_prometheus", "render_json", "PROMETHEUS_CONTENT_TYPE",
    "SchemaError", "check_schema", "dumps_checked", "write_json",
    "read_json",
    "FlightRecorder", "get_flight",
    "GangPlane", "StepProfiler", "TM_MARKER", "check_postmortem",
    "current_profiler", "parse_telemetry", "write_postmortem",
    "ROOFLINE_BLOCK_KEYS", "check_roofline_block", "paired_roofline",
    "roofline_block",
    "AUTOTUNE_METRICS", "Autotuner", "CollectiveCostModel", "TuneSpace",
    "fit_alpha_beta", "register_space", "registered_spaces",
    "resolve_entry_point",
    "TUNE_TABLE_ENV", "TUNE_TABLE_SCHEMA_VERSION", "TunePlane",
    "check_tune_table", "check_tunez", "device_kind", "geometry_key",
    "get_tuneplane", "set_tuneplane",
]
