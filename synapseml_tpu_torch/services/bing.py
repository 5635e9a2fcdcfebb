"""Bing image search stage (reference: cognitive/.../bing/
BingImageSearch.scala — GET with q/count/offset query params, plus the
``downloadFromUrls`` helper that fetches result bytes).

The PyTorch port's copy of the JAX package's ``services/bing.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..core.dataset import Dataset
from ..core.params import IntParam, StringParam
from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer, with_query


class BingImageSearch(RemoteServiceTransformer):
    """Image web search per row (reference: BingImageSearch.scala)."""

    queryCol = StringParam(doc="query text column", default="query")
    count = IntParam(doc="results per query", default=10)
    offset = IntParam(doc="result offset", default=0)
    imageType = StringParam(doc="image type filter", default="")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        q = {"q": str(row[self.queryCol]), "count": int(self.count),
             "offset": int(self.offset)}
        if self.imageType:
            q["imageType"] = self.imageType
        return HTTPRequestData(url=with_query(self.url, q), method="GET")

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "value" in value:
            return value["value"]
        return value

    @staticmethod
    def download_from_urls(ds: Dataset, url_col: str,
                           output_col: str = "bytes",
                           concurrency: int = 4,
                           retries: int = 1) -> Dataset:
        """Fetch each URL's bytes (reference: BingImageSearch.scala
        downloadFromUrls — a companion helper, not a stage).  Dispatch
        rides HTTPTransformer's concurrent machinery."""
        from ..io.http import HTTPTransformer
        reqs = np.empty(ds.num_rows, dtype=object)
        for i, u in enumerate(ds[url_col]):
            reqs[i] = HTTPRequestData(url=str(u), method="GET")
        scored = HTTPTransformer(
            inputCol="_req", outputCol="_resp",
            concurrency=concurrency, retries=retries,
        ).transform(ds.with_column("_req", reqs))
        out = np.empty(ds.num_rows, dtype=object)
        for i, resp in enumerate(scored["_resp"]):
            out[i] = resp.entity if 200 <= resp.status_code < 300 else None
        return ds.with_column(output_col, out)
