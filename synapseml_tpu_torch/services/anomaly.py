"""Anomaly-detector service stages (reference: cognitive/.../anomaly/
AnomalyDetection.scala — DetectLastAnomaly, DetectAnomalies,
SimpleDetectAnomalies; MultivariateAnomalyDetection.scala:758 —
FitMultivariateAnomaly estimator + DetectMultivariateAnomaly model).

The PyTorch port's copy of the JAX package's ``services/anomaly.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

from ..core.dataset import Dataset
from ..core.params import StringParam
from ..core.pipeline import Estimator, Model
from ..io.http import HTTPClient, HTTPRequestData
from .base import RemoteServiceTransformer, ServiceParam


class _AnomalyBase(RemoteServiceTransformer):
    """Series-shaped request body (reference: AnomalyDetection.scala
    TimeSeriesPoint / AnomalyDetectorBase)."""

    seriesCol = StringParam(doc="column of [{timestamp, value}] series",
                            default="series")
    granularity = StringParam(doc="series granularity", default="daily")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        body = {"series": list(row[self.seriesCol]),
                "granularity": self.granularity}
        return HTTPRequestData(url=self.url, method="POST",
                               headers={"Content-Type": "application/json"},
                               entity=json.dumps(body).encode())


class DetectLastAnomaly(_AnomalyBase):
    """Is the latest point anomalous (reference: AnomalyDetection.scala
    DetectLastAnomaly → /last/detect)."""


class DetectAnomalies(_AnomalyBase):
    """Batch anomaly flags for the whole series (reference:
    AnomalyDetection.scala DetectAnomalies → /entire/detect)."""


class SimpleDetectAnomalies(_AnomalyBase):
    """Row-level anomaly detection with grouping (reference:
    AnomalyDetection.scala SimpleDetectAnomalies — groups rows by
    ``groupbyCol`` into series, calls the service once per group, then
    redistributes per-point verdicts back onto rows)."""

    timestampCol = StringParam(doc="timestamp column", default="timestamp")
    valueCol = StringParam(doc="value column", default="value")
    groupbyCol = StringParam(doc="series grouping column", default="group")

    def _transform(self, ds: Dataset) -> Dataset:
        groups: Dict[Any, List[int]] = {}
        for i, g in enumerate(ds[self.groupbyCol]):
            groups.setdefault(g, []).append(i)

        http = self._http_client()
        out = np.empty(ds.num_rows, dtype=object)
        errors = np.empty(ds.num_rows, dtype=object)
        ts, vals = ds[self.timestampCol], ds[self.valueCol]

        def run_group(idx):
            order = sorted(idx, key=lambda i: ts[i])
            series = [{"timestamp": str(ts[i]), "value": float(vals[i])}
                      for i in order]
            row0 = {c: ds[c][order[0]] for c in ds.columns}
            req = HTTPRequestData(
                url=self.url, method="POST",
                headers={"Content-Type": "application/json",
                         **self._auth_headers(row0)},
                entity=json.dumps({"series": series,
                                   "granularity": self.granularity}).encode())
            return order, http.send(req)

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=max(1, int(self.concurrency))) as pool:
            results = list(pool.map(run_group, groups.values()))
        for order, resp in results:
            err = self.response_error(resp)   # shared HasErrorCol format
            if err is None:
                body = json.loads(resp.entity.decode())
                flags = body.get("isAnomaly", [])
                for pos, i in enumerate(order):
                    out[i] = {"isAnomaly":
                              bool(flags[pos]) if pos < len(flags) else None}
                    errors[i] = None
            else:
                for i in order:
                    out[i] = None
                    errors[i] = err
        return ds.with_columns({self.outputCol: out, self.errorCol: errors})


class FitMultivariateAnomaly(Estimator):
    """Train a multivariate anomaly model via the service (reference:
    MultivariateAnomalyDetection.scala FitMultivariateAnomaly — posts
    training window, receives a model id, returns a detect model)."""

    url = StringParam(doc="training endpoint")
    subscriptionKey = ServiceParam(doc="auth key")
    startTime = StringParam(doc="training window start", default="")
    endTime = StringParam(doc="training window end", default="")
    inputCols = StringParam(doc="comma-joined variable columns", default="")
    timestampCol = StringParam(doc="timestamp column", default="timestamp")
    outputCol = StringParam(doc="result column", default="output")

    def _fit(self, ds: Dataset) -> "DetectMultivariateAnomaly":
        cols = [c for c in self.inputCols.split(",") if c]
        variables = [{"name": c,
                      "values": [float(v) for v in ds[c]]} for c in cols]
        body = {"variables": variables,
                "startTime": self.startTime, "endTime": self.endTime}
        row0 = {c: ds[c][0] for c in ds.columns} if ds.num_rows else {}
        key = self.get_param("subscriptionKey").resolve(self, row0)
        headers = {"Content-Type": "application/json"}
        if key:
            headers["Ocp-Apim-Subscription-Key"] = key
        resp = HTTPClient().send(HTTPRequestData(
            url=self.url, method="POST", headers=headers,
            entity=json.dumps(body).encode()))
        if not (200 <= resp.status_code < 300):
            raise RuntimeError(
                f"multivariate anomaly training failed: "
                f"{resp.status_code} {resp.reason}")
        model_id = json.loads(resp.entity.decode()).get("modelId", "") \
            if resp.entity else ""
        m = DetectMultivariateAnomaly(
            url=self.url, modelId=model_id,
            timestampCol=self.timestampCol, outputCol=self.outputCol,
            inputCols=self.inputCols)
        m.set("subscriptionKey", self.get("subscriptionKey"))
        return m


class DetectMultivariateAnomaly(Model, RemoteServiceTransformer):
    """Detect with a trained multivariate model (reference:
    MultivariateAnomalyDetection.scala DetectMultivariateAnomaly)."""

    modelId = StringParam(doc="trained model id", default="")
    inputCols = StringParam(doc="comma-joined variable columns", default="")
    timestampCol = StringParam(doc="timestamp column", default="timestamp")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        cols = [c for c in self.inputCols.split(",") if c]
        body = {"modelId": self.modelId,
                "timestamp": str(row.get(self.timestampCol, "")),
                "variables": {c: float(row[c]) for c in cols}}
        return HTTPRequestData(url=self.url, method="POST",
                               headers={"Content-Type": "application/json"},
                               entity=json.dumps(body).encode())
