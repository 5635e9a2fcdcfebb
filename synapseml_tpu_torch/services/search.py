"""Search-index sink (reference: cognitive/.../search/AzureSearch.scala —
AzureSearchWriter/AddDocuments: batches rows into ``{"value": [...]}``
index actions; it is a *sink*, SURVEY §2.9).

The PyTorch port's copy of the JAX package's ``services/search.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

from ..core.dataset import Dataset
from ..core.params import IntParam, StringParam
from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer


class AddDocuments(RemoteServiceTransformer):
    """Push rows into a search index in batches (reference:
    AzureSearch.scala AddDocuments — actionCol selects
    upload/merge/delete per row; batchSize groups rows per request)."""

    actionCol = StringParam(doc="per-row index action column", default="")
    batchSize = IntParam(doc="documents per request", default=100)

    def _transform(self, ds: Dataset) -> Dataset:
        http = self._http_client()
        cols = [c for c in ds.columns]
        action_col = self.actionCol
        bs = max(1, int(self.batchSize))
        status = np.empty(ds.num_rows, dtype=object)

        def run_batch(start: int):
            idx = range(start, min(start + bs, ds.num_rows))
            docs: List[Dict[str, Any]] = []
            for i in idx:
                row = {c: ds[c][i] for c in cols}
                action = row.pop(action_col, "upload") if action_col \
                    else "upload"
                doc = {"@search.action": action}
                for k, v in row.items():
                    doc[k] = v.item() if isinstance(v, np.generic) else v
                docs.append(doc)
            row0 = {c: ds[c][start] for c in cols}
            req = HTTPRequestData(
                url=self.url, method="POST",
                headers={"Content-Type": "application/json",
                         **self._auth_headers(row0)},
                entity=json.dumps({"value": docs}).encode())
            return idx, http.send(req)

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=max(1, int(self.concurrency))) as pool:
            results = list(pool.map(run_batch,
                                    range(0, ds.num_rows, bs)))
        for idx, resp in results:
            ok = 200 <= resp.status_code < 300
            for i in idx:
                status[i] = "ok" if ok \
                    else f"{resp.status_code} {resp.reason}"
        return ds.with_column(self.outputCol, status)


class AzureSearchWriter:
    """Dataset → search-index convenience writer (reference:
    AzureSearch.scala AzureSearchWriter.write)."""

    @staticmethod
    def write(ds: Dataset, url: str, key: str = "",
              batch_size: int = 100) -> Dataset:
        stage = AddDocuments(url=url, batchSize=batch_size)
        if key:
            stage.set_scalar("subscriptionKey", key)
        return stage.transform(ds)
