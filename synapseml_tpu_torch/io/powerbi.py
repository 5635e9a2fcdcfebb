"""PowerBI streaming-dataset sink (reference: core/.../io/powerbi/
PowerBIWriter.scala:27-116 — rows are minibatched (fixed/dynamic/timed),
optionally funneled through PartitionConsolidator, and POSTed as JSON
arrays; non-200 responses raise).  The PyTorch port's copy of the JAX
package's ``io/powerbi.py``: host-only, no ``device``."""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..core.dataset import Dataset
from .http import HTTPClient, HTTPRequestData

_APPLICABLE_OPTIONS = {
    "consolidate", "concurrency", "concurrentTimeout", "minibatcher",
    "maxBatchSize", "batchSize", "buffered", "maxBufferSize",
    "millisToWait",
}


class PowerBIResponseError(RuntimeError):
    """Non-200 from the PowerBI endpoint (reference: PowerBIWriter's
    CustomOutputParser throws HttpResponseException)."""

    def __init__(self, status_code: int, reason: str, content: str):
        super().__init__(
            f"Request failed with\n code: {status_code},\n "
            f"reason: {reason},\n content: {content}")
        self.status_code = status_code


def _batch_sizes(ds: Dataset, options: Dict[str, str]) -> List[int]:
    """Row counts per POST, honoring the reference's minibatcher modes
    (PowerBIWriter.scala:55-68)."""
    kind = options.get("minibatcher", "fixed")
    n = ds.num_rows
    if kind == "fixed":
        b = int(options.get("batchSize", 10))
        return [min(b, n - s) for s in range(0, n, b)]
    if kind in ("dynamic", "timed"):
        cap = int(options.get("maxBatchSize", 2 ** 31 - 1))
        sizes = []
        for a, b in ds.partition_bounds():
            size = b - a
            while size > 0:
                sizes.append(min(size, cap))
                size -= cap
        return sizes
    raise ValueError(f"unknown minibatcher {kind!r}")


class PowerBIWriter:
    """Dataset → PowerBI push-dataset REST endpoint."""

    @staticmethod
    def write(ds: Dataset, url: str,
              options: Optional[Dict[str, str]] = None) -> None:
        options = dict(options or {})
        unknown = set(options) - _APPLICABLE_OPTIONS
        if unknown:
            raise ValueError(
                f"{sorted(unknown)} not applicable options "
                f"{sorted(_APPLICABLE_OPTIONS)}")

        if options.get("consolidate", "false").lower() == "true":
            from ..ops.stages import PartitionConsolidator
            ds = PartitionConsolidator().transform(ds)

        concurrency = int(options.get("concurrency", 1))
        cols = list(ds.columns)
        sizes = _batch_sizes(ds, options)
        http = HTTPClient(timeout_s=float(
            options.get("concurrentTimeout", 30.0)))

        def post(bounds):
            start, stop = bounds
            rows = []
            for i in range(start, stop):
                row = {}
                for c in cols:
                    v = ds[c][i]
                    row[c] = v.item() if isinstance(v, np.generic) else v
                rows.append(row)
            resp = http.send(HTTPRequestData(
                url=url, method="POST",
                headers={"Content-Type": "application/json"},
                entity=json.dumps(rows).encode()))
            if resp.status_code != 200:
                raise PowerBIResponseError(
                    resp.status_code, resp.reason,
                    (resp.entity or b"").decode("utf-8", "replace"))

        bounds = []
        start = 0
        for s in sizes:
            bounds.append((start, start + s))
            start += s
        with ThreadPoolExecutor(max_workers=max(1, concurrency)) as pool:
            # list() propagates the first PowerBIResponseError
            list(pool.map(post, bounds))

    #: reference exposes stream() as well; the port's streaming entry
    #: point is the serving layer, so write() is the parity point
    stream = write
