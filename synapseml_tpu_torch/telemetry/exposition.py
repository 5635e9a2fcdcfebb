"""Prometheus text + JSON exposition of a MetricsRegistry.

``render_prometheus`` emits the text format (version 0.0.4) a Prometheus
scraper expects; ``render_json`` emits the registry snapshot for humans
and tests.  :class:`synapseml_tpu_torch.serving.server.ServingServer` serves
both on ``GET /metrics`` (reserved path).
"""

from __future__ import annotations

import json
import math
from typing import Optional

from .registry import MetricsRegistry, get_registry

__all__ = ["render_prometheus", "render_json", "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(labelnames, key, extra=()) -> str:
    pairs = [f'{ln}="{_escape_label(lv)}"'
             for ln, lv in zip(labelnames, key)]
    pairs += [f'{ln}="{_escape_label(lv)}"' for ln, lv in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    # the text format has literal NaN/±Inf spellings — a poisoned gauge
    # must render, not kill every subsequent scrape
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    registry = registry or get_registry()
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key, val in sorted(m.series().items()):
            if m.kind == "histogram":
                for bound, n in zip(m.buckets, val["buckets"]):
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(m.labelnames, key, [('le', _fmt_value(bound))])}"
                        f" {n}")
                lines.append(
                    f"{m.name}_bucket"
                    f"{_fmt_labels(m.labelnames, key, [('le', '+Inf')])}"
                    f" {val['count']}")
                lines.append(f"{m.name}_sum"
                             f"{_fmt_labels(m.labelnames, key)}"
                             f" {_fmt_value(val['sum'])}")
                lines.append(f"{m.name}_count"
                             f"{_fmt_labels(m.labelnames, key)}"
                             f" {val['count']}")
            else:
                lines.append(f"{m.name}{_fmt_labels(m.labelnames, key)}"
                             f" {_fmt_value(val)}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_json(registry: Optional[MetricsRegistry] = None) -> str:
    registry = registry or get_registry()
    return json.dumps(registry.snapshot(), sort_keys=True)
