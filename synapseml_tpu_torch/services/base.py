"""Service-stage base machinery.

Re-designs the reference's cognitive base (reference: cognitive/.../
CognitiveServiceBase.scala:31-128 ``ServiceParam[T]`` =
Either[value, columnName]; :260 ``HasCognitiveServiceInput`` row →
request; :341 ``HasInternalJsonOutputParser``; :444 CognitiveServicesBase
retry/async machinery).  A :class:`ServiceParam` resolves per row — a
fixed value or a column lookup — and :class:`RemoteServiceTransformer`
drives request building, concurrent dispatch with backoff, JSON parsing,
and the error column.

The PyTorch port's copy of the JAX package's ``services/base.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..core.dataset import Dataset
from ..core.params import IntParam, Param, PyObjectParam, StringParam
from ..core.pipeline import Transformer
from ..io.http import (HTTPClient, HTTPRequestData, HTTPTransformer,
                       JSONOutputParser)
from ..resilience import breaker_for
from ..resilience.rowguard import HasErrorCol


class ServiceParam(Param):
    """Scalar-or-column param (reference: ServiceParam.scala).

    Holds ``{"value": v}`` or ``{"col": name}``; ``resolve(stage, row)``
    produces the effective per-row value.
    """

    is_complex = False

    def _coerce(self, value):
        if value is None:
            return None
        if isinstance(value, dict) and ("value" in value or "col" in value):
            return value
        return {"value": value}

    def resolve(self, stage, row: Dict[str, Any], default=None):
        v = stage.get_or_default(self.name)
        if v is None:
            return default
        if "col" in v:
            return row.get(v["col"], default)
        return v["value"]


def with_query(url: str, q: Dict[str, Any]) -> str:
    """Append query params to a URL that may already carry some."""
    if not q:
        return url
    from urllib.parse import urlencode
    sep = "&" if "?" in url else "?"
    return url + sep + urlencode(q, doseq=True)


class HasServiceParams:
    """Mixin helpers for stages with ServiceParams."""

    def set_scalar(self, name: str, value) -> "HasServiceParams":
        self.set(name, {"value": value})
        return self

    def set_col(self, name: str, col: str) -> "HasServiceParams":
        self.set(name, {"col": col})
        return self

    def resolve_service_param(self, name: str, row: Dict[str, Any],
                              default=None):
        p = self.get_param(name)
        if not isinstance(p, ServiceParam):
            raise TypeError(f"{name} is not a ServiceParam")
        return p.resolve(self, row, default)


class RemoteServiceTransformer(HasServiceParams, HasErrorCol, Transformer):
    """Base for remote-call stages (reference: CognitiveServicesBase).

    Subclasses implement ``prepare_request(row) -> HTTPRequestData`` and
    optionally ``parse_response(json_value) -> value``.  Per-row failures
    land in the shared :class:`HasErrorCol` ``errorCol`` (default
    ``"errors"``, value ``"<status> <reason>"``) — byte-compatible with
    the three formerly hand-rolled sites, and routed through
    ``handleInvalid`` by the row guard.
    """

    url = StringParam(doc="service endpoint")
    subscriptionKey = ServiceParam(doc="auth key (value or column)")
    outputCol = StringParam(doc="parsed output column", default="output")
    concurrency = IntParam(doc="concurrent requests", default=1)
    retries = IntParam(doc="retry count on 429/5xx", default=3)
    retryPolicy = PyObjectParam(
        doc="RetryPolicy overriding `retries` (exponential backoff + full "
            "jitter, Retry-After honoring, optional shared RetryBudget)")
    breaker = PyObjectParam(
        doc="CircuitBreaker for this endpoint; True = share the "
            "process-wide breaker keyed by the service URL")

    #: subclasses whose response entity is not JSON (audio, thumbnails)
    #: set this True to surface raw bytes in ``outputCol``
    binary_output = False

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        raise NotImplementedError

    def parse_response(self, value: Any) -> Any:
        return value

    def _auth_headers(self, row: Dict[str, Any]) -> Dict[str, str]:
        key = self.resolve_service_param("subscriptionKey", row)
        return {"Ocp-Apim-Subscription-Key": key} if key else {}

    def _breaker(self):
        breaker = self.get("breaker")
        if breaker is True:          # opt into the per-endpoint shared one
            breaker = breaker_for(self.url or type(self).__name__)
        return breaker

    def _http_client(self) -> HTTPClient:
        """The client of the stages that batch rows into their own
        requests (anomaly groups, search batches): the same ``retries``,
        ``retryPolicy`` and ``breaker`` as the per-row path."""
        return HTTPClient(retries=int(self.retries),
                          policy=self.get("retryPolicy"),
                          breaker=self._breaker())

    def _transform(self, ds: Dataset) -> Dataset:
        reqs = np.empty(ds.num_rows, dtype=object)
        cols = ds.columns
        for i in range(ds.num_rows):
            row = {c: ds[c][i] for c in cols}
            req = self.prepare_request(row)
            req.headers.update(self._auth_headers(row))
            reqs[i] = req
        http = HTTPTransformer(inputCol="_req", outputCol="_resp",
                               concurrency=int(self.concurrency),
                               retries=int(self.retries),
                               retryPolicy=self.get("retryPolicy"),
                               breaker=self._breaker())
        scored = http.transform(ds.with_column("_req", reqs))
        parse_json = JSONOutputParser()
        out = np.empty(ds.num_rows, dtype=object)
        errors = np.empty(ds.num_rows, dtype=object)
        for i, resp in enumerate(scored["_resp"]):
            errors[i] = self.response_error(resp)
            if errors[i] is None:
                out[i] = resp.entity if self.binary_output \
                    else self.parse_response(parse_json(resp))
            else:
                out[i] = None
        return ds.with_columns({self.outputCol: out, self.errorCol: errors})
