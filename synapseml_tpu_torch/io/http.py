"""HTTP client pipeline stages.

Re-designs the reference's HTTP stack (reference: core/.../io/http/
HTTPTransformer.scala:44-95 — ``concurrency``/``concurrentTimeout``
params over an async Apache HttpClient; HTTPClients.scala:65-189 —
``AdvancedHTTPHandling`` retry/backoff on 429/5xx; HTTPSchema.scala —
request/response row codecs; SimpleHTTPTransformer.scala:65 — JSON
in/out convenience).  Python shape: dataclass request/response rows, a
stdlib-``urllib`` client with a composable retry policy, and a thread
pool for concurrency (requests are IO-bound; the GIL is released in
socket waits, matching the reference's async client semantics).

Failure handling routes through :mod:`synapseml_tpu_torch.resilience`: the
client takes a :class:`~synapseml_tpu_torch.resilience.RetryPolicy`
(exponential backoff + full jitter, ``Retry-After`` honoring, shared
retry budgets) and an optional per-endpoint
:class:`~synapseml_tpu_torch.resilience.CircuitBreaker`; a
:class:`~synapseml_tpu_torch.resilience.Deadline` propagates the caller's
remaining patience through every retry, and the ``http.send`` fault
site lets tests inject 429/503s, resets and slow responses
deterministically.  The PyTorch port's copy of the JAX package's
``io/http.py``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (DictParam, FloatParam, IntParam, ListParam,
                           Param, PyObjectParam, StringParam, UDFParam)
from ..core.pipeline import Transformer
from ..resilience import (Deadline, RetryPolicy, get_faults,
                          parse_retry_after)
from ..resilience.rowguard import HasErrorCol
from ..telemetry import get_registry


@dataclass
class HTTPRequestData:
    """Request row (reference: HTTPSchema request codec)."""
    url: str
    method: str = "GET"
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "HTTPRequestData":
        entity = d.get("entity")
        if isinstance(entity, str):
            entity = entity.encode("utf-8")
        return HTTPRequestData(url=d["url"], method=d.get("method", "GET"),
                               headers=dict(d.get("headers", {})),
                               entity=entity)


@dataclass
class HTTPResponseData:
    """Response row (reference: HTTPSchema response codec)."""
    status_code: int
    reason: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    entity: bytes = b""

    def json(self) -> Any:
        return json.loads(self.entity.decode("utf-8"))

    def text(self) -> str:
        return self.entity.decode("utf-8", errors="replace")


#: statuses the advanced handler retries (reference: HTTPClients.scala:65)
RETRY_STATUSES = (429, 500, 502, 503, 504)


class HTTPClient:
    """Blocking client with policy-driven retries on 429/5xx
    (reference: AdvancedHTTPHandling, HTTPClients.scala:65-175).

    ``policy`` owns the retry shape (exponential backoff + full jitter by
    default, ``Retry-After`` honored as a floor); ``breaker`` — when the
    circuit is open the client fabricates a 503 carrying the remaining
    cooldown as ``Retry-After`` without touching the network.

    Compatibility: an EXPLICIT ``backoffs_ms`` builds a fixed-ladder
    policy with the identical unjittered timing.  Call sites passing only
    ``retries`` (or nothing) now get the jittered exponential default
    instead of the old hard-coded 100/500/1000 ms ladder — deliberate:
    full jitter decorrelates retry storms and ``Retry-After`` (which the
    old ladder ignored) lets throttling servers set the real pace.
    """

    def __init__(self, retries: int = 3,
                 backoffs_ms: Optional[Sequence[int]] = None,
                 timeout_s: float = 60.0,
                 policy: Optional[RetryPolicy] = None,
                 breaker=None):
        if policy is None:
            policy = (RetryPolicy.from_ladder(backoffs_ms, retries)
                      if backoffs_ms is not None
                      else RetryPolicy(max_retries=retries))
        self.policy = policy
        self.breaker = breaker
        self.timeout_s = timeout_s
        self._m_retries = get_registry().counter(
            "resilience_retries_total", "retries slept through a policy",
            ("site",))

    #: legacy surface (old call sites introspected these)
    @property
    def retries(self) -> int:
        return self.policy.max_retries

    def _attempt(self, req: HTTPRequestData,
                 timeout_s: float) -> HTTPResponseData:
        """One network attempt → response row (status 0 = transport
        error).  The ``http.send`` fault site can fabricate 429/503s,
        raise resets, or delay here — upstream of the real socket."""
        fault = get_faults().http_fault("http.send", url=req.url)
        if fault is not None:
            status, headers = fault
            return HTTPResponseData(status_code=status,
                                    reason="injected fault",
                                    headers=headers)
        r = urllib.request.Request(
            req.url, data=req.entity, method=req.method,
            headers=dict(req.headers))
        with urllib.request.urlopen(r, timeout=timeout_s) as resp:
            return HTTPResponseData(
                status_code=resp.status,
                reason=getattr(resp, "reason", "") or "",
                headers=dict(resp.headers),
                entity=resp.read())

    def send(self, req: HTTPRequestData,
             deadline: Optional[Deadline] = None) -> HTTPResponseData:
        policy = self.policy
        last: Optional[HTTPResponseData] = None
        for attempt in range(policy.max_retries + 1):
            if deadline is not None and deadline.expired:
                return last if last is not None else HTTPResponseData(
                    status_code=504, reason="deadline expired before attempt")
            if self.breaker is not None and not self.breaker.allow():
                ra = self.breaker.retry_after_s()
                return HTTPResponseData(
                    status_code=503, reason="circuit breaker open",
                    headers={"Retry-After": f"{ra:.3f}"})
            timeout = (deadline.limit(self.timeout_s) if deadline is not None
                       else self.timeout_s)
            try:
                last = self._attempt(req, max(timeout, 1e-3))
            except urllib.error.HTTPError as e:
                last = HTTPResponseData(status_code=e.code,
                                        reason=str(e.reason),
                                        headers=dict(e.headers or {}),
                                        entity=e.read() or b"")
            except (urllib.error.URLError, OSError) as e:
                last = HTTPResponseData(status_code=0, reason=str(e))
            if not policy.retryable(last.status_code):
                # success and non-retryable client errors both close the
                # failure streak — the breaker counts outages, not 404s
                if self.breaker is not None:
                    self.breaker.record_success()
                return last
            if self.breaker is not None:
                self.breaker.record_failure()
            if attempt >= policy.max_retries or not policy.acquire_retry():
                return last
            ra = parse_retry_after(last.headers.get("Retry-After")) \
                if policy.honor_retry_after else None
            delay = policy.backoff_s(attempt, ra)
            if deadline is not None:
                remaining = deadline.remaining()
                if remaining <= 0:
                    return last
                delay = min(delay, remaining)
            self._m_retries.inc(1, site="http")
            policy.sleep(delay, site="http.backoff")
        return last if last is not None else HTTPResponseData(
            status_code=0, reason="no attempt made")


class HTTPTransformer(Transformer):
    """Send one HTTP request per row, concurrently
    (reference: HTTPTransformer.scala:95; params ``concurrency`` and
    ``concurrentTimeout`` match :44-60)."""

    inputCol = StringParam(doc="column of request dicts/HTTPRequestData",
                           default="request")
    outputCol = StringParam(doc="column of HTTPResponseData", default="response")
    concurrency = IntParam(doc="concurrent requests per host", default=1)
    concurrentTimeout = FloatParam(doc="seconds to wait for the batch "
                                   "(None = forever)")
    handler = UDFParam(doc="custom (client, request) -> response handler")
    retries = IntParam(doc="retry count for 429/5xx", default=3)
    retryPolicy = PyObjectParam(doc="RetryPolicy overriding `retries` "
                                    "(exp backoff + jitter + Retry-After)")
    breaker = PyObjectParam(doc="CircuitBreaker shared across this stage's "
                                "requests (fail fast while open)")

    def _transform(self, ds: Dataset) -> Dataset:
        client = HTTPClient(retries=int(self.retries),
                            policy=self.get("retryPolicy"),
                            breaker=self.get("breaker"))
        handler: Optional[Callable] = self.get("handler")
        timeout = self.get("concurrentTimeout")
        # ONE deadline bounds the whole batch and propagates into every
        # send: once it expires, in-flight sends stop retrying instead of
        # running out their full backoff schedule on leaked pool threads
        # (custom handlers keep their (client, request) signature and are
        # bounded only by the collection loop below)
        deadline = Deadline(float(timeout)) if timeout else None

        def send_one(raw) -> HTTPResponseData:
            req = raw if isinstance(raw, HTTPRequestData) \
                else HTTPRequestData.from_dict(raw)
            if handler is not None:
                return handler(client, req)
            return client.send(req, deadline=deadline)

        reqs = list(ds[self.inputCol])
        workers = max(1, int(self.concurrency))
        if workers == 1:
            responses = [send_one(r) for r in reqs]
        else:
            # remaining() is clamped at 0, so rows past the budget collect
            # synthetic 504 rows (the old arithmetic handed f.result a
            # NEGATIVE timeout, which raises ValueError and aborted the
            # whole transform)
            pool = ThreadPoolExecutor(max_workers=workers)
            futs = [pool.submit(send_one, r) for r in reqs]
            responses = []
            try:
                for f in futs:
                    left = deadline.remaining() if deadline else None
                    try:
                        responses.append(f.result(timeout=left))
                    except FutureTimeoutError:
                        f.cancel()
                        responses.append(HTTPResponseData(
                            status_code=504,
                            reason="concurrentTimeout exceeded"))
            finally:
                # never-started rows are cancelled; already-running sends
                # finish on their worker threads without blocking the
                # caller (shutdown does not wait)
                for f in futs:
                    f.cancel()
                pool.shutdown(wait=False)
        col = np.empty(len(responses), dtype=object)
        col[:] = responses
        return ds.with_column(self.outputCol, col)


class JSONInputParser:
    """Row dict -> HTTPRequestData with a JSON body
    (reference: SimpleHTTPTransformer JSONInputParser)."""

    def __init__(self, url: str, method: str = "POST",
                 headers: Optional[Dict[str, str]] = None):
        self.url = url
        self.method = method
        self.headers = dict(headers or {})
        self.headers.setdefault("Content-Type", "application/json")

    @staticmethod
    def _json_default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
        raise TypeError(f"not JSON serializable: {type(o)}")

    def __call__(self, row: Dict[str, Any]) -> HTTPRequestData:
        body = json.dumps(row, default=self._json_default).encode()
        return HTTPRequestData(url=self.url, method=self.method,
                               headers=self.headers, entity=body)


class JSONOutputParser:
    """HTTPResponseData -> parsed JSON (reference: JSONOutputParser)."""

    def __call__(self, resp: HTTPResponseData) -> Any:
        if resp.status_code == 0 or not resp.entity:
            return None
        try:
            return resp.json()
        except (ValueError, UnicodeDecodeError):
            return None

class CustomInputParser:
    """Row dict -> HTTPRequestData via a user function
    (reference: parsers CustomInputParser — udf-driven request building)."""

    def __init__(self, udf):
        self.udf = udf

    def __call__(self, row):
        out = self.udf(row)
        if isinstance(out, HTTPRequestData):
            return out
        raise TypeError("CustomInputParser udf must return HTTPRequestData")


class StringOutputParser:
    """HTTPResponseData -> decoded body string
    (reference: parsers StringOutputParser)."""

    def __call__(self, resp: HTTPResponseData) -> Optional[str]:
        if resp.status_code == 0 or resp.entity is None:
            return None
        return resp.entity.decode("utf-8", errors="replace")


class CustomOutputParser:
    """HTTPResponseData -> anything via a user function
    (reference: parsers CustomOutputParser)."""

    def __init__(self, udf):
        self.udf = udf

    def __call__(self, resp: HTTPResponseData):
        return self.udf(resp)



class SimpleHTTPTransformer(HasErrorCol, Transformer):
    """JSON-in / JSON-out service call per row
    (reference: SimpleHTTPTransformer.scala:65): selected input columns
    become the JSON body; the JSON response lands in ``outputCol``.
    The shared :class:`HasErrorCol` mixin collects the status line for
    failed rows (``errorCol``, default ``"errors"``) — and under
    ``handleInvalid='skip'/'quarantine'`` those rows leave the output via
    the row guard instead of flowing downstream."""

    inputCols = ListParam(doc="columns forming the JSON request body")
    outputCol = StringParam(doc="parsed JSON output column", default="output")
    url = StringParam(doc="service endpoint")
    method = StringParam(doc="HTTP method", default="POST")
    headers = DictParam(doc="extra headers", default=None)
    concurrency = IntParam(doc="concurrent requests", default=1)
    retries = IntParam(doc="retry count", default=3)
    retryPolicy = PyObjectParam(doc="RetryPolicy overriding `retries`")
    breaker = PyObjectParam(doc="CircuitBreaker for this endpoint")
    inputParser = UDFParam(doc="custom row -> HTTPRequestData")
    outputParser = UDFParam(doc="custom HTTPResponseData -> value")

    def _transform(self, ds: Dataset) -> Dataset:
        in_cols = self.inputCols or [c for c in ds.columns]
        parser = self.get("inputParser") or JSONInputParser(
            self.url, self.method, self.get("headers"))
        out_parser = self.get("outputParser") or JSONOutputParser()

        reqs = np.empty(ds.num_rows, dtype=object)
        for i in range(ds.num_rows):
            reqs[i] = parser({c: ds[c][i] for c in in_cols})
        http = HTTPTransformer(
            inputCol="_req", outputCol="_resp",
            concurrency=int(self.concurrency), retries=int(self.retries),
            retryPolicy=self.get("retryPolicy"), breaker=self.get("breaker"))
        scored = http.transform(ds.with_column("_req", reqs))
        out = np.empty(ds.num_rows, dtype=object)
        errors = np.empty(ds.num_rows, dtype=object)
        for i, resp in enumerate(scored["_resp"]):
            out[i] = out_parser(resp)
            errors[i] = self.response_error(resp)
        return ds.with_columns({self.outputCol: out, self.errorCol: errors})
