"""Structured telemetry around every public verb.

The port's copy of the JAX package's ``core/logging.py`` (the analogue of
SynapseML's ``SynapseMLLogging``): :func:`log_verb` wraps every
``fit``/``transform`` and emits one JSON record per verb, with a SAS/key
scrubber, through the stdlib ``logging`` module under the
``synapseml_tpu_torch`` logger.  The row guard and the CSV ingest warn
through :data:`logger` too.
"""

from __future__ import annotations

import contextlib
import json
import logging
import re
import time
import traceback
from typing import Any, Dict

from .. import __version__ as _build_version

logger = logging.getLogger("synapseml_tpu_torch")

_SAS_RE = re.compile(r"(sig=)[^&\s\"']+", re.IGNORECASE)
_KEY_RE = re.compile(r"(key=|token=|bearer\s+)[A-Za-z0-9+/=._-]{8,}", re.IGNORECASE)


def scrub(message: str) -> str:
    """Scrub SAS signatures / keys out of log text
    (reference: logging/common/SASScrubber.scala)."""
    message = _SAS_RE.sub(r"\1####", message)
    message = _KEY_RE.sub(r"\1####", message)
    return message


def _emit(payload: Dict[str, Any]) -> None:
    payload["buildVersion"] = _build_version
    try:
        logger.info(json.dumps(payload, default=str))
    except Exception:  # telemetry must never break the pipeline
        pass


@contextlib.contextmanager
def log_verb(stage, verb: str, **info):
    """Wraps fit/transform/predict with timing + error telemetry."""
    t0 = time.perf_counter()
    payload: Dict[str, Any] = {
        "className": type(stage).__name__,
        "uid": getattr(stage, "uid", None),
        "method": verb,
        **info,
    }
    try:
        yield
    except Exception as e:
        payload["error"] = scrub(f"{type(e).__name__}: {e}")
        payload["traceback"] = scrub(traceback.format_exc(limit=5))
        payload["elapsedMs"] = (time.perf_counter() - t0) * 1e3
        _emit(payload)
        raise
    payload["elapsedMs"] = (time.perf_counter() - t0) * 1e3
    _emit(payload)
