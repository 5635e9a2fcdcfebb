"""HTTP ⇄ Dataset serving: the pipeline servers and the LLM decode loop.

The PyTorch port's copy of the JAX package's ``serving/server.py``,
imports aside:

- :class:`ServingServer` hosts any number of registered APIs on one
  asyncio listener; each API owns a bounded request queue (backpressure:
  a full queue answers 503 immediately instead of parking the exchange)
  and a pending-exchange map keyed by request id.
- ``GET /metrics``, ``/healthz``, ``/readyz``, ``/tracez``, ``/sloz`` and
  ``/tunez`` are RESERVED paths on every listener: the process-wide
  :mod:`synapseml_tpu_torch.telemetry` registry as Prometheus text (JSON
  with ``?format=json``), liveness, readiness (503 + ``Retry-After``
  while draining or while the engine's compile plane warms), the
  per-request traces, the windowed SLO snapshot and the tuning table's
  snapshot (entries and this process's consults,
  schema-checked before serving; ``?space=`` filters).
- :class:`PipelineServer` is the continuous-serving loop for one model:
  batch → ``model.transform`` → reply (:class:`_ApiLoop`), so the model
  sees micro-batches instead of per-request calls; every batch runs
  under the row guard's serving face (a poison record 500s itself, an
  unparseable one 400s itself, a device OOM halves the batch, a
  preemption sheds it with 503).  :class:`MultiPipelineServer` runs
  several named pipelines on one listener, one loop per API.  The
  servers take no device: the model carries its own (every stage of the
  port takes ``device``), and the loop never moves a batch or a model.
- Clients reach an API over HTTP/1.1 (keep-alive) or, after an
  ``Upgrade: sml-frames`` handshake, over length-prefixed frames (the
  client is :class:`~.continuous.ContinuousClient`).
- :class:`_DecodeLoop` is the continuous-batching loop over a duck-typed
  decode engine (the port's
  :class:`~synapseml_tpu_torch.models.llm.SlotEngine`): admission every
  step, SLO-aware shedding, eviction, streaming, QoS and tracing.
- :meth:`ServingServer.drain` stops accepting, flushes every accepted
  in-flight exchange, then closes — zero dropped work.
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.client import responses as _http_reasons
from queue import Empty, Full, Queue
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.dataset import Dataset
from ..core.pipeline import Transformer
from ..resilience.health import HealthState, retry_after_from_depth
from ..telemetry import (PROMETHEUS_CONTENT_TYPE, SERVING_TOKEN_LATENCY_BUCKETS,
                         SERVING_TTFT_BUCKETS, check_sloz, get_registry,
                         get_request_tracer, get_slo_store, render_json,
                         render_prometheus)
from ..telemetry.flight import record as _flight_record

#: request header (lower-cased, as the listener normalizes) carrying a
#: propagated request trace id across serving hops; replies echo it
#: back in canonical case so a client/balancer can stitch the hop chain
TRACE_HEADER = "x-sml-trace-id"
#: the reply-side spelling of the SAME contract — derived, so a header
#: rename can never desync the echo from what clients read
TRACE_HEADER_CANONICAL = "-".join(
    p.upper() if p == "sml" else p.capitalize()
    for p in TRACE_HEADER.split("-"))

#: request header (lower-cased) naming the tenant a request bills to —
#: the multi-tenant QoS plane keys admission weights, shed budgets, and
#: SLO attribution by it; absent ⇒ the default tenant, so single-tenant
#: traffic is untouched
TENANT_HEADER = "x-sml-tenant"
TENANT_HEADER_CANONICAL = "-".join(
    p.upper() if p == "sml" else p.capitalize()
    for p in TENANT_HEADER.split("-"))

#: every reserved ``GET`` path a ServingServer listener answers before
#: API routing: the reference's tuple, and the keys of
#: ``ServingServer._reserved_handler`` (both held by the port's server
#: tests).
RESERVED_GET_PATHS = ("/metrics", "/healthz", "/readyz", "/tracez", "/sloz",
                      "/tunez")


@dataclass
class ServingRequest:
    """One pending request row (reference: HTTPSourceV2 row schema
    {id, request})."""
    id: str
    method: str
    path: str
    headers: Dict[str, str]
    body: bytes
    #: monotonic enqueue time — lets serving loops bound queue wait
    enqueued_at: float = 0.0
    #: propagated request trace id (the ``X-SML-Trace-Id`` header when
    #: the client/balancer minted one upstream; None ⇒ the serving loop
    #: mints its own subject to sampling)
    trace_id: Optional[str] = None
    #: billing/QoS tenant (the ``X-SML-Tenant`` header, overridable by
    #: a ``tenant`` payload field); every pre-existing caller lands on
    #: the default tenant with unchanged behavior
    tenant: str = "default"
    #: priority class override carried by the request (``priority``
    #: payload field); None ⇒ the tenant policy's class applies
    priority: Optional[int] = None

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))


@dataclass
class ServingReply:
    status: int = 200
    body: bytes = b""
    headers: Dict[str, str] = field(default_factory=dict)


class _Exchange:
    __slots__ = ("request", "event", "reply", "waiter")

    def __init__(self, request: ServingRequest):
        self.request = request
        self.event = threading.Event()
        self.reply: Optional[ServingReply] = None
        #: (loop, future) for the asyncio listener awaiting this reply
        self.waiter = None


class ApiHandle:
    """One named API's source/sink pair: bounded request queue + pending
    exchanges.  ``get_batch``/``reply`` mirror HTTPSourceV2 getBatch and
    ServingUDFs.sendReplyUDF for this API only."""

    def __init__(self, path: str, max_queue: int = 1024,
                 reply_timeout_s: float = 30.0):
        self.path = path
        self.max_queue = max_queue
        self.reply_timeout_s = reply_timeout_s
        self._queue: "Queue[_Exchange]" = Queue(maxsize=max_queue)
        self._pending: Dict[str, _Exchange] = {}
        self._lock = threading.Lock()

    # -- server side -------------------------------------------------------
    def submit(self, req: ServingRequest) -> Optional[_Exchange]:
        """Enqueue; None ⇒ queue saturated (caller answers 503).

        Registered in ``_pending`` BEFORE the queue put: a fast pipeline
        can drain + reply the instant the exchange is visible, and a reply
        must find the registration or it would be silently dropped."""
        req.enqueued_at = time.monotonic()
        ex = _Exchange(req)
        with self._lock:
            self._pending[req.id] = ex
        try:
            self._queue.put_nowait(ex)
        except Full:
            with self._lock:
                self._pending.pop(req.id, None)
            return None
        return ex

    def forget(self, request_id: str) -> None:
        with self._lock:
            self._pending.pop(request_id, None)

    # -- source side (micro-batch pull; HTTPSourceV2 getBatch analogue) ----
    def get_batch(self, max_rows: int = 64,
                  timeout_s: float = 0.05) -> List[ServingRequest]:
        """Block up to ``timeout_s`` for the first request, then drain only
        what is already queued — continuous-mode semantics: a lone request
        is served immediately instead of waiting out the batch window,
        while a burst still rides one batched transform.

        ``timeout_s <= 0`` is the non-blocking fast path (``poll``): a
        decode loop with sequences in flight must never stall a running
        batch waiting on new arrivals."""
        if timeout_s <= 0:
            return self.poll(max_rows)
        out: List[_Exchange] = []
        try:
            out.append(self._queue.get(timeout=timeout_s))
        except Empty:
            return []
        while len(out) < max_rows:
            try:
                out.append(self._queue.get_nowait())
            except Empty:
                break
        return [e.request for e in out]

    def poll(self, max_rows: int = 64) -> List[ServingRequest]:
        """Non-blocking :meth:`get_batch`: return whatever is already
        queued (possibly nothing) without waiting — the admission path
        of a continuous-batching loop, which checks for new arrivals
        EVERY decode step and must not park the in-flight batch."""
        out: List[_Exchange] = []
        while len(out) < max_rows:
            try:
                out.append(self._queue.get_nowait())
            except Empty:
                break
        return [e.request for e in out]

    # -- sink side (ServingUDFs.sendReplyUDF analogue) ---------------------
    def reply(self, request_id: str, reply: ServingReply) -> bool:
        with self._lock:
            ex = self._pending.get(request_id)
        if ex is None:
            return False
        ex.reply = reply
        ex.event.set()
        w = ex.waiter
        if w is not None:
            loop, fut = w
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None))
        return True


class ServingServer:
    """One HTTP listener per host hosting any number of named APIs (the
    DistributedHTTPSource model — one server per JVM, many sources;
    multi-host serving runs one per host behind an external
    balancer).  The single-API constructor arguments keep the original
    one-endpoint usage working unchanged."""

    #: process-wide instance counter — names each server's health series
    _instances = 0
    _instances_lock = threading.Lock()

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", reply_timeout_s: float = 30.0,
                 max_queue: int = 1024,
                 max_body_bytes: int = 16 * 1024 * 1024):
        #: requests larger than this answer 413 and close — an unbounded
        #: readexactly would let one request allocate arbitrary memory
        self.max_body_bytes = max_body_bytes
        self.api_path = api_path.rstrip("/") or "/"
        self._apis: Dict[str, ApiHandle] = {}
        self._apis_lock = threading.Lock()
        with ServingServer._instances_lock:
            ServingServer._instances += 1
            self.health = HealthState(f"serving-{ServingServer._instances}")
        #: accepted exchanges not yet fully written back (loop-thread only)
        self._inflight = 0
        self._default = self.register_api(self.api_path, max_queue,
                                          reply_timeout_s)
        self._addr: Tuple[str, int] = (host, port)
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._closed = False
        self._aserver = None
        self._thread = threading.Thread(target=self._run_loop,
                                        args=(host, port), daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("serving listener failed to start")
        if self._start_error is not None:    # e.g. EADDRINUSE, synchronous
            raise self._start_error

    # -- asyncio listener --------------------------------------------------
    # One event loop handles every connection: no per-request threads, so a
    # 64-way burst costs 64 coroutines instead of 64 OS threads fighting
    # the GIL.  Decode work runs on the _DecodeLoop thread; the event
    # loop only parses, enqueues, and awaits each exchange's reply
    # future.

    def _run_loop(self, host: str, port: int) -> None:
        asyncio.set_event_loop(self._loop)

        async def _start():
            self._aserver = await asyncio.start_server(
                self._handle_conn, host, port, backlog=256)
            self._addr = self._aserver.sockets[0].getsockname()[:2]
            self._started.set()

        try:
            self._loop.run_until_complete(_start())
        except BaseException as e:      # surface bind errors to the caller
            self._start_error = e
            self._started.set()
            self._loop.close()
            return
        try:
            self._loop.run_forever()
        finally:
            try:
                self._loop.run_until_complete(
                    self._loop.shutdown_asyncgens())
            finally:
                self._loop.close()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                parts = line.decode("latin1").split()
                if len(parts) < 2:
                    break
                method, path = parts[0], parts[1]
                # header keys lower-cased: HTTP headers are
                # case-insensitive (the old BaseHTTPRequestHandler was too)
                headers: Dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                if headers.get("upgrade", "").lower() == "sml-frames":
                    # continuous mode: the connection leaves HTTP for a
                    # length-prefixed frame stream (the reference's
                    # continuousServer analogue — one parse-free exchange
                    # per record instead of one HTTP request)
                    await self._handle_frames(reader, writer, path)
                    break
                te = headers.get("transfer-encoding", "").lower()
                if "chunked" in te:
                    body = await self._read_chunked(reader, writer)
                    if body is None:       # oversize: 413 already written
                        break
                else:
                    try:
                        length = int(headers.get("content-length", 0) or 0)
                    except ValueError:
                        writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                                     b"Content-Length: 0\r\n"
                                     b"Connection: close\r\n\r\n")
                        await writer.drain()
                        break
                    if length > self.max_body_bytes:
                        await self._write_413(writer)
                        break
                    body = await reader.readexactly(length) if length else b""
                # in-flight from dispatch until the reply is fully written:
                # drain() waits on this so an accepted exchange can never
                # lose the race between computing its reply and the
                # listener closing
                self._inflight += 1
                try:
                    status, rbody, rheaders = await self._dispatch(
                        method, path, headers, body)
                    keep = headers.get("connection", "").lower() != "close"
                    reason = _http_reasons.get(status, "Unknown")
                    head = [f"HTTP/1.1 {status} {reason}"]
                    ctype_set = False
                    for k, v in rheaders.items():
                        head.append(f"{k}: {v}")
                        ctype_set = ctype_set or k.lower() == "content-type"
                    if not ctype_set:
                        head.append("Content-Type: application/json")
                    if isinstance(rbody, (bytes, bytearray)):
                        head.append(f"Content-Length: {len(rbody)}")
                        head.append("Connection: " + ("keep-alive" if keep
                                                      else "close"))
                        writer.write(("\r\n".join(head) + "\r\n\r\n")
                                     .encode("latin1") + bytes(rbody))
                        await writer.drain()
                    else:
                        # streaming reply: an ITERABLE body goes out with
                        # chunked transfer-encoding (the reference's
                        # continuous-mode reply stream)
                        head.append("Transfer-Encoding: chunked")
                        head.append("Connection: " + ("keep-alive" if keep
                                                      else "close"))
                        writer.write(("\r\n".join(head) + "\r\n\r\n")
                                     .encode("latin1"))
                        # pull chunks on a worker thread: a generator that
                        # blocks between yields (live token streams) must
                        # not stall the event loop for every other
                        # connection.  A write failure (client gone
                        # mid-stream) tells an abandonable body before
                        # propagating, so a live token stream's producer
                        # can stop decoding for the dead connection
                        it = iter(rbody)
                        _end = object()
                        try:
                            while True:
                                chunk = await self._loop.run_in_executor(
                                    None, next, it, _end)
                                if chunk is _end:
                                    break
                                chunk = bytes(chunk)
                                if not chunk:
                                    continue
                                writer.write(
                                    f"{len(chunk):x}\r\n".encode("latin1")
                                    + chunk + b"\r\n")
                                await writer.drain()
                            writer.write(b"0\r\n\r\n")
                            await writer.drain()
                        except BaseException:
                            abandon = getattr(rbody, "abandon", None)
                            if abandon is not None:
                                abandon()
                            raise
                finally:
                    self._inflight -= 1
                if not keep:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, asyncio.LimitOverrunError, ValueError):
            pass      # truncated/oversized/undecodable request: drop conn
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _await_reply(self, api: ApiHandle, ex: _Exchange):
        """Attach this loop's waiter to ``ex`` and await its reply — the
        ONE place the waiter-attach race and reply timeout live for both
        the HTTP and frame paths.  The timeout is anchored at SUBMIT time
        (``enqueued_at``), so pipelined frames awaited serially do not
        compound each other's timeouts.  Always forgets the exchange;
        raises ``asyncio.TimeoutError`` on expiry; returns the
        ServingReply (None when the pipeline replied nothing)."""
        fut = self._loop.create_future()
        ex.waiter = (self._loop, fut)
        if ex.event.is_set() and not fut.done():       # reply raced attach
            fut.set_result(None)
        remaining = max(
            ex.request.enqueued_at + api.reply_timeout_s - time.monotonic(),
            0.0)
        try:
            await asyncio.wait_for(fut, remaining)
        finally:
            api.forget(ex.request.id)
        return ex.reply

    async def _handle_frames(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter,
                             path: str) -> None:
        """Continuous (framed) mode: ``Upgrade: sml-frames``.

        The reference's ``continuousServer`` keeps the exchange open and
        streams record-at-a-time replies (spark_serving/about.md's
        sub-millisecond continuous mode); the analogue here upgrades the
        connection to a binary frame stream so the per-record cost drops
        to one length-prefixed read — no request line, headers, routing,
        or reply-head formatting per record.

        Wire format: requests are ``u32le length + payload``; replies are
        ``u32le (2+len) + u16le status + body``, always in request order
        (a per-connection BOUNDED fifo of pending exchanges — a full
        fifo backpressures the frame reader, so one fast client cannot
        grow server memory without bound).  Client EOF ends the stream;
        queued replies flush before close, and whatever neither side
        consumed is forgotten so ``_pending`` never leaks."""
        import struct

        api = self._route(path)
        if api is None:
            writer.write(b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
            return
        writer.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                     b"Upgrade: sml-frames\r\nConnection: Upgrade\r\n\r\n")
        await writer.drain()
        conn = uuid.uuid4().hex
        fifo: "asyncio.Queue" = asyncio.Queue(maxsize=max(api.max_queue, 1))

        async def write_replies():
            while True:
                item = await fifo.get()
                if item is None:
                    return
                try:
                    if item[0] == "now":
                        status, body = item[1]
                    else:
                        try:
                            rep = await self._await_reply(api, item[1])
                            status = rep.status if rep else 500
                            body = (rep.body if rep
                                    else b'{"error": "empty reply"}')
                            if not isinstance(body, (bytes, bytearray)):
                                # frames are single messages; stream bodies
                                # (iterables) concatenate
                                body = b"".join(bytes(c) for c in body)
                        except asyncio.TimeoutError:
                            status = 504
                            body = b'{"error": "serving pipeline timeout"}'
                    writer.write(struct.pack("<IH", 2 + len(body), status)
                                 + bytes(body))
                    await writer.drain()
                finally:
                    self._inflight -= 1        # enqueued by the read loop

        wtask = asyncio.ensure_future(write_replies())

        async def fifo_put(item) -> bool:
            """Bounded put that cannot deadlock on a dead writer: a plain
            ``await fifo.put`` on a full fifo blocks forever once the
            writer task has died (nothing consumes), leaking the handler
            and every queued exchange — poll instead, and report failure
            when the writer is gone."""
            while True:
                try:
                    fifo.put_nowait(item)
                    return True
                except asyncio.QueueFull:
                    if wtask.done():
                        return False
                    # race the blocking put against the writer's death so
                    # a freed slot wakes us immediately (no poll latency
                    # on the live-writer backpressure path)
                    put = asyncio.ensure_future(fifo.put(item))
                    try:
                        await asyncio.wait({put, wtask},
                                           return_when=asyncio.FIRST_COMPLETED)
                        if put.done() and put.exception() is None:
                            return True
                    finally:
                        # also on handler cancellation: never orphan the
                        # put task (it could enqueue after the drain ran)
                        if not put.done():
                            put.cancel()
                            try:
                                await put
                            except (asyncio.CancelledError, Exception):
                                pass

        seq = 0
        try:
            while True:
                hdr = await reader.readexactly(4)
                (ln,) = struct.unpack("<I", hdr)
                if ln > self.max_body_bytes:
                    if not wtask.done():
                        self._inflight += 1
                        if not await fifo_put(("now", (413, b""))):
                            self._inflight -= 1
                    break
                payload = await reader.readexactly(ln) if ln else b""
                if not self.health.ready:      # draining: shed new frames
                    self._inflight += 1
                    if not await fifo_put(
                            ("now", (503, b'{"error": "server '
                                          b'draining"}'))):
                        self._inflight -= 1
                        break
                    continue
                req = ServingRequest(id=f"{conn}:{seq}", method="FRAME",
                                     path=path, headers={}, body=payload)
                seq += 1
                ex = api.submit(req)
                if wtask.done():          # writer died: stop accepting
                    if ex is not None:
                        api.forget(req.id)
                    break
                if ex is None:                          # backpressure
                    self._inflight += 1
                    if not await fifo_put(
                            ("now", (503, b'{"error": "serving queue '
                                          b'saturated"}'))):
                        self._inflight -= 1
                        break
                    continue
                self._inflight += 1
                if not await fifo_put(("ex", ex)):      # writer died
                    self._inflight -= 1
                    api.forget(req.id)
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass                                        # client went away
        finally:
            if not wtask.done():
                await fifo_put(None)                    # flush in order
            try:
                await wtask
            except (ConnectionResetError, BrokenPipeError):
                pass
            finally:
                # forget exchanges neither flushed nor timed out (writer
                # died mid-burst) so ApiHandle._pending cannot leak —
                # runs even when wtask re-raises something unexpected
                while not fifo.empty():
                    item = fifo.get_nowait()
                    if item is not None:
                        self._inflight -= 1     # writer never consumed it
                        if item[0] == "ex":
                            api.forget(item[1].request.id)

    async def _write_413(self, writer: asyncio.StreamWriter) -> None:
        writer.write(b"HTTP/1.1 413 Payload Too Large\r\n"
                     b"Content-Length: 0\r\nConnection: close\r\n\r\n")
        await writer.drain()

    async def _read_chunked(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> Optional[bytes]:
        """Decode a chunked request body (size cap enforced; None ⇒ the
        connection must close).  Trailer section is consumed and ignored."""
        parts: List[bytes] = []
        total = 0
        while True:
            line = await reader.readline()
            if not line:
                # EOF mid-body: a truncated upload must NOT dispatch as a
                # complete request (the Content-Length path's
                # IncompleteReadError equivalent)
                raise asyncio.IncompleteReadError(b"", None)
            size = int(line.split(b";")[0].strip() or b"0", 16)
            if size == 0:
                break
            total += size
            if total > self.max_body_bytes:
                await self._write_413(writer)
                return None
            parts.append(await reader.readexactly(size))
            await reader.readexactly(2)                # chunk CRLF
        while True:                                    # trailers
            t = await reader.readline()
            if t in (b"\r\n", b"\n", b""):
                break
        return b"".join(parts)

    # -- health / load-shedding helpers ------------------------------------
    def _queue_depth(self) -> int:
        """Accepted-but-unanswered work across every API.  ``_pending``
        alone is exact: submit registers there BEFORE the queue put and
        entries leave only on reply/forget, so queued exchanges are a
        subset (adding ``_queue.qsize()`` would double-count them and
        inflate Retry-After hints up to 2x)."""
        with self._apis_lock:
            handles = list(self._apis.values())
        return sum(len(h._pending) for h in handles)

    def _drain_rps(self) -> float:
        """Best observed per-API throughput — the denominator of the
        Retry-After hint (0 when nothing has been served yet)."""
        g = get_registry().get("serving_records_per_sec")
        best = 0.0
        if g is not None:
            for _, val in g.series().items():
                try:
                    best = max(best, float(val))  # type: ignore[arg-type]
                except (TypeError, ValueError):
                    pass
        return best

    def _shed_headers(self) -> Dict[str, str]:
        ra = retry_after_from_depth(self._queue_depth(), self._drain_rps())
        return {"Retry-After": str(ra)}

    # -- reserved GET endpoints --------------------------------------------
    def _reserved_handler(self, bare: str):
        """Handler for one RESERVED_GET_PATHS entry (None when ``bare``
        is not reserved) — served before API routing, even while
        draining.  One map, one tuple."""
        return {"/metrics": self._serve_metrics,
                "/healthz": self._serve_healthz,
                "/readyz": self._serve_readyz,
                "/tracez": self._serve_tracez,
                "/sloz": self._serve_sloz,
                "/tunez": self._serve_tunez}.get(bare)

    def _serve_healthz(self, query: str, headers: Dict[str, str]):
        return self.health.healthz()

    def _serve_readyz(self, query: str, headers: Dict[str, str]):
        return self.health.readyz(self._queue_depth(), self._drain_rps())

    def _serve_metrics(self, query: str, headers: Dict[str, str]):
        # the process metrics registry as Prometheus text, or JSON with
        # ?format=json / an application/json Accept header
        want_json = ("format=json" in query
                     or "application/json" in headers.get("accept", ""))
        if want_json:
            body, ctype = render_json().encode("utf-8"), "application/json"
        else:
            body, ctype = (render_prometheus().encode("utf-8"),
                           PROMETHEUS_CONTENT_TYPE)
        return 200, body, {"Content-Type": ctype}

    def _serve_tracez(self, query: str, headers: Dict[str, str]):
        """Recent request timelines from the process
        :class:`~synapseml_tpu_torch.telemetry.tracing.RequestTraceStore`;
        ``?id=<trace_id>`` exports ONE request as Chrome-trace JSON
        (chrome://tracing / Perfetto), ``?limit=N`` bounds the listing."""
        from urllib.parse import parse_qs
        params = parse_qs(query)
        store = get_request_tracer()
        trace_id = (params.get("id") or [None])[0]
        if trace_id is not None:
            trace = store.chrome_trace(trace_id)
            if trace is None:
                return (404, json.dumps(
                    {"error": f"no trace {trace_id!r} retained"}).encode(),
                    {"Content-Type": "application/json"})
            payload = trace
        else:
            try:
                limit = int((params.get("limit") or ["50"])[0])
            except ValueError:
                limit = 50
            payload = store.snapshot(limit)
        return 200, json.dumps(payload).encode("utf-8"), {
            "Content-Type": "application/json"}

    def _serve_sloz(self, query: str, headers: Dict[str, str]):
        """The windowed SLO snapshot (the autoscaler input contract):
        schema-validated BEFORE serving — a malformed window answers
        500, never a silently wrong consumer input.  ``?tenant=<id>``
        filters to that tenant's attribution planes (named
        ``<base>@tenant=<id>``) so one tenant's burn rate is readable
        without digging it out of aggregate percentiles;
        ``?phase=prefill|decode`` is the same filter over the
        disaggregated per-phase planes (``<base>@phase=<p>``) — the
        per-phase autoscalers each consume one filtered view."""
        from urllib.parse import parse_qs
        from ..telemetry.slo import plane_phase, plane_tenant
        params = parse_qs(query)
        tenant = (params.get("tenant") or [None])[0]
        phase = (params.get("phase") or [None])[0]
        snap = get_slo_store().snapshot()
        if tenant is not None:
            snap["planes"] = {name: plane
                              for name, plane in snap["planes"].items()
                              if plane_tenant(name) == tenant}
        if phase is not None:
            snap["planes"] = {name: plane
                              for name, plane in snap["planes"].items()
                              if plane_phase(name) == phase}
        try:
            check_sloz(snap, tenant=tenant, phase=phase)
        except ValueError as e:
            return (500, json.dumps(
                {"error": f"sloz snapshot failed validation: {e}"}).encode(),
                {"Content-Type": "application/json"})
        return 200, json.dumps(snap).encode("utf-8"), {
            "Content-Type": "application/json"}

    def _serve_tunez(self, query: str, headers: Dict[str, str]):
        """The autotune tuning-table snapshot: per-space winner with its
        measured ms and provenance (``source``/``measured_unix``/
        ``device_kind``), staleness against the plane's max age, and the
        consult log — which construction sites loaded (or refused) the
        table in THIS process.  Schema-validated BEFORE serving (the
        ``/sloz`` discipline); ``?space=<name>`` filters entries and
        consults to one search space."""
        from urllib.parse import parse_qs
        from ..telemetry.tunetable import check_tunez, get_tuneplane
        params = parse_qs(query)
        space = (params.get("space") or [None])[0]
        snap = get_tuneplane().snapshot()
        if space is not None:
            snap["entries"] = [e for e in snap["entries"]
                               if e.get("space") == space]
            snap["consults"] = [c for c in snap["consults"]
                                if c.get("space") == space]
        try:
            check_tunez(snap)
        except ValueError as e:
            return (500, json.dumps(
                {"error": f"tunez snapshot failed validation: {e}"}).encode(),
                {"Content-Type": "application/json"})
        return 200, json.dumps(snap).encode("utf-8"), {
            "Content-Type": "application/json"}

    async def _dispatch(self, method: str, path: str,
                        headers: Dict[str, str], body: bytes):
        bare, _, query = path.partition("?")
        reserved = self._reserved_handler(bare.rstrip("/"))
        if reserved is not None and method in ("GET", "HEAD"):
            # HEAD gets an empty body — the generic writer emits whatever
            # body we return, and body bytes after a HEAD reply desync
            # the keep-alive connection
            status, hbody, hheaders = reserved(query, headers)
            return status, (b"" if method == "HEAD" else hbody), hheaders
        api = self._route(path)
        if api is None:
            return 404, b'{"error": "no API registered at this path"}', {}
        if not self.health.ready:                      # draining: shed new
            return (503, b'{"error": "server draining"}',
                    self._shed_headers())
        req = ServingRequest(id=uuid.uuid4().hex, method=method, path=path,
                             headers=headers, body=body,
                             trace_id=headers.get(TRACE_HEADER),
                             tenant=headers.get(TENANT_HEADER, "default"))
        ex = api.submit(req)
        if ex is None:                                 # backpressure
            return (503, b'{"error": "serving queue saturated"}',
                    self._shed_headers())
        try:
            rep = await self._await_reply(api, ex)
        except asyncio.TimeoutError:
            return 504, b'{"error": "serving pipeline timeout"}', {}
        if rep is None:
            return 500, b'{"error": "empty reply"}', {}
        return rep.status, rep.body, dict(rep.headers)

    # -- API registry (HTTPSourceV2 ServiceInfo analogue) ------------------
    def register_api(self, path: str, max_queue: int = 1024,
                     reply_timeout_s: float = 30.0) -> ApiHandle:
        path = path.rstrip("/") or "/"
        with self._apis_lock:
            if path in self._apis:
                return self._apis[path]
            handle = ApiHandle(path, max_queue, reply_timeout_s)
            self._apis[path] = handle
            return handle

    def _route(self, request_path: str) -> Optional[ApiHandle]:
        """Longest registered prefix wins ("/a/b" before "/a")."""
        with self._apis_lock:
            best = None
            for path, handle in self._apis.items():
                if path == "/" or request_path == path \
                        or request_path.startswith(path + "/") \
                        or request_path.startswith(path + "?"):
                    if best is None or len(path) > len(best.path):
                        best = handle
            return best

    @property
    def address(self) -> Tuple[str, int]:
        return self._addr

    @property
    def url(self) -> str:
        h, p = self.address
        return f"http://{h}:{p}{'' if self.api_path == '/' else self.api_path}"

    def url_for(self, path: str) -> str:
        h, p = self.address
        path = path.rstrip("/") or "/"
        return f"http://{h}:{p}{'' if path == '/' else path}"

    # -- default-API passthrough (original one-endpoint surface) -----------
    def get_batch(self, max_rows: int = 64,
                  timeout_s: float = 0.05) -> List[ServingRequest]:
        return self._default.get_batch(max_rows, timeout_s)

    def reply(self, request_id: str, reply: ServingReply) -> bool:
        # request ids are unique across APIs; try the owning handle first
        if self._default.reply(request_id, reply):
            return True
        with self._apis_lock:
            handles = list(self._apis.values())
        return any(h.reply(request_id, reply) for h in handles
                   if h is not self._default)

    #: drain must observe queues+inflight idle for this long before
    #: closing — covers request bytes in transit that have not reached
    #: dispatch yet (sampling a single idle instant would close under
    #: them; a starved event loop can sit on unread requests for well
    #: over 100 ms, so the window is generous).  A request that still
    #: races the close gets a prompt connection-close — a retryable
    #: transport error, which HTTPClient's policy absorbs.
    _DRAIN_SETTLE_S = 0.2

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: immediately stop accepting NEW connections
        (listener closed) and shed new requests/frames on existing ones
        (503 + ``Retry-After``; readyz → 503), wait until every ACCEPTED
        exchange has been answered and written back (queues empty,
        pending maps empty, no reply mid-write — held for a settle
        window), then close.

        Returns True when fully drained, False when ``timeout_s`` expired
        with work still in flight (the listener closes either way — a
        drain must terminate)."""
        self.health.begin_drain()

        def _stop_listener():
            if self._aserver is not None:
                self._aserver.close()
        try:
            self._loop.call_soon_threadsafe(_stop_listener)
        except RuntimeError:
            pass                         # loop already gone
        deadline = time.monotonic() + max(0.0, timeout_s)
        drained = False
        quiet_since: Optional[float] = None
        while True:
            now = time.monotonic()
            if self._queue_depth() == 0 and self._inflight == 0:
                if quiet_since is None:
                    quiet_since = now
                elif now - quiet_since >= self._DRAIN_SETTLE_S:
                    drained = True
                    break
            else:
                quiet_since = None
            if now >= deadline:
                break
            time.sleep(0.005)
        self.health.finish_drain()
        self.close()
        return drained

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.health.mark_closed()

        def _stop():
            if self._aserver is not None:
                self._aserver.close()
            tasks = [t for t in asyncio.all_tasks(self._loop)
                     if t is not asyncio.current_task(self._loop)]
            for task in tasks:
                task.cancel()

            async def _finish():
                # let the cancellations unwind BEFORE stopping the loop:
                # each handler's finally closes its transport, so racing
                # clients see a prompt connection-close instead of a
                # socket that leaks open until process exit (observed as
                # full client-side timeouts).  Bounded: a handler parked
                # in run_in_executor (a blocked streaming generator)
                # cannot be interrupted by cancel — stop the loop anyway
                # after the wait instead of hanging close() on it
                if tasks:
                    await asyncio.wait(tasks, timeout=2.0)
                self._loop.stop()
            asyncio.ensure_future(_finish(), loop=self._loop)
        try:
            self._loop.call_soon_threadsafe(_stop)
        except RuntimeError:      # loop already gone (failed start)
            return
        self._thread.join(timeout=5)


def _reply_never_raises(api: ApiHandle, request_id: str,
                        rep: ServingReply) -> bool:
    """``api.reply`` that cannot kill a serving worker thread: after
    drain/close the asyncio loop is gone and call_soon_threadsafe
    raises — the exchange is already lost either way, the loop must
    live.  Shared by ``_ApiLoop`` and ``_DecodeLoop``."""
    try:
        return api.reply(request_id, rep)
    except Exception:  # noqa: BLE001 — serving must not die
        return False


class _BatchAlignmentError(RuntimeError):
    """Model output rows cannot be mapped back onto requests (row count
    changed with no provenance) — a deployment bug, not poison data, so
    it must NOT enter the bisection path."""


class _ApiLoop:
    """One API's continuous loop: batch → transform → reply.

    Row-level fault isolation (the serving face of
    :mod:`synapseml_tpu_torch.resilience.rowguard`):

    - a record whose ``input_parser`` throws answers 400 for ITSELF;
      the rest of the batch proceeds;
    - a poison record that makes ``transform`` throw is isolated by
      recursive batch halving and answers 500 for itself — clean
      records in the same micro-batch still get their 200s;
    - a device out-of-memory failure (``torch.OutOfMemoryError`` from the
      card, or the injected stand-in) halves the batch and retries both
      halves; the safe size is remembered (``rowguard_safe_batch_size``
      gauge) and caps every later micro-batch pull, so one oversized
      burst degrades throughput instead of killing the loop;
    - a ``PreemptionError`` sheds the batch with 503, never bisected.

    The loop hands ``model.transform`` the batch as the parser built it
    and never moves a batch or a model between devices: the model runs
    where it was built.  :attr:`timings` sums the host seconds of each
    part of a batch (parse, ``Dataset.from_rows``, ``transform``,
    format + reply) over the batches served.
    """

    def __init__(self, server: ServingServer, api: ApiHandle,
                 model: Transformer,
                 input_parser: Callable[[ServingRequest], Dict[str, Any]],
                 output_col: str,
                 output_formatter: Callable[[Any], bytes],
                 batch_size: int, batch_timeout_s: float,
                 num_workers: int = 1,
                 max_queue_wait_s: Optional[float] = None):
        self.server = server
        self.api = api
        self.model = model
        self.input_parser = input_parser
        self.output_col = output_col
        self.output_formatter = output_formatter
        self.batch_size = batch_size
        self.batch_timeout_s = batch_timeout_s
        #: bound on time a request may sit queued before being shed with
        #: 503 — under overload the tail stays bounded instead of every
        #: request slowly timing out (None: no shedding)
        self.max_queue_wait_s = max_queue_wait_s
        reg = get_registry()
        self._m_records = reg.counter(
            "serving_records_total", "records replied 200", ("api",))
        self._m_rps = reg.gauge(
            "serving_records_per_sec",
            "last-batch records/sec through transform+reply", ("api",))
        self._m_batch = reg.histogram(
            "serving_batch_size", "records per micro-batch", ("api",),
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._m_errors = reg.counter(
            "serving_errors_total", "batches failed (500) or shed (503)",
            ("api", "kind"))
        self._stop = threading.Event()
        #: summed host seconds per part of a batch, and the batches and
        #: records they cover (bisection probes included)
        self.timings = {"batches": 0, "records": 0, "parse_s": 0.0,
                        "from_rows_s": 0.0, "transform_s": 0.0,
                        "reply_s": 0.0}
        self._timings_lock = threading.Lock()
        #: >1 workers drain one queue concurrently: while one worker's
        #: transform holds the device/CPU (releasing the GIL), another
        #: batches and replies — opt-in, because concurrent transform
        #: calls require a thread-safe model.  The port's models are:
        #: ``transform`` reads a fitted stage's state and writes none of
        #: it (the GBDT stacks its host trees into tensors of its own on
        #: every call); the caches some stages fill on first use (the
        #: ONNX model's compiled plans) are idempotent, so two threads
        #: filling one entry build equal values; and two threads' CUDA
        #: calls queue on the card's default stream, which every thread
        #: shares, through PyTorch's thread-safe caching allocator.
        self._threads = [threading.Thread(target=self._loop, daemon=True)
                         for _ in range(max(1, num_workers))]
        for t in self._threads:
            t.start()

    @property
    def _oom_key(self) -> str:
        return f"serving:{self.api.path}"

    def _loop(self) -> None:
        from ..resilience.rowguard import safe_batch_size
        while not self._stop.is_set():
            pull = safe_batch_size(self._oom_key, self.batch_size)
            batch = self.api.get_batch(pull, self.batch_timeout_s)
            if not batch:
                continue
            if self.max_queue_wait_s is not None:
                now = time.monotonic()
                stale = [r for r in batch
                         if now - r.enqueued_at > self.max_queue_wait_s]
                if stale:
                    body = json.dumps({"error": "queue wait exceeded "
                                       f"{self.max_queue_wait_s}s"}).encode()
                    for req in stale:
                        self._safe_reply(req.id, ServingReply(503, body))
                    self._m_errors.inc(len(stale), api=self.api.path,
                                       kind="shed")
                    batch = [r for r in batch
                             if now - r.enqueued_at <= self.max_queue_wait_s]
                    if not batch:
                        continue
            # per-record parse: a malformed record 400s ITSELF only
            t_parse = time.perf_counter()
            rows, good = [], []
            for req in batch:
                try:
                    rows.append(self.input_parser(req))
                    good.append(req)
                except Exception as e:  # noqa: BLE001 — isolated to record
                    self._m_errors.inc(1, api=self.api.path, kind="parse")
                    self._safe_reply(req.id, ServingReply(400, json.dumps(
                        {"error": f"unparseable record: {e}"}).encode()))
            if not good:
                continue
            t0 = time.perf_counter()
            self._add_timing(parse_s=t0 - t_parse)
            served = self._transform_reply(good, rows)
            dt = time.perf_counter() - t0
            if served:
                self._m_records.inc(served, api=self.api.path)
                self._m_batch.observe(served, api=self.api.path)
                if dt > 0:
                    self._m_rps.set(served / dt, api=self.api.path)

    def _safe_reply(self, request_id: str, rep: ServingReply) -> bool:
        return _reply_never_raises(self.api, request_id, rep)

    def _add_timing(self, **parts) -> None:
        with self._timings_lock:
            for k, v in parts.items():
                self.timings[k] += v

    def _reply_all(self, reqs: List[ServingRequest], status: int,
                   e: Exception, kind: str) -> None:
        self._m_errors.inc(len(reqs), api=self.api.path, kind=kind)
        body = json.dumps({"error": str(e)}).encode()
        for req in reqs:
            self._safe_reply(req.id, ServingReply(status, body))

    def _format_reply(self, req: ServingRequest, val: Any,
                      to_send: List) -> None:
        """Format one record's 200 (a formatter failure 500s only that
        record — formatting is per-record work, not batch work)."""
        try:
            body = self.output_formatter(val)
        except Exception as e:  # noqa: BLE001 — isolated to the record
            self._m_errors.inc(1, api=self.api.path, kind="format")
            to_send.append((req, ServingReply(500, json.dumps(
                {"error": f"output formatting failed: {e}"}).encode())))
            return
        to_send.append((req, ServingReply(
            200, body, {"Content-Type": "application/json"})))

    def _transform_reply(self, reqs: List[ServingRequest],
                         rows: List[Dict[str, Any]],
                         budget: Optional[List[int]] = None) -> int:
        """Transform + reply with row-level isolation; returns the number
        of records answered 200.  No reply leaves inside the try: a
        late exception after partial sends would otherwise re-answer
        already-answered records from the bisection path."""
        from ..resilience.faults import PreemptionError
        from ..resilience.rowguard import (is_oom_error, isolation_budget,
                                           oom_fault_point,
                                           record_safe_batch)
        if budget is None:
            # bounds isolation work for batch-INDEPENDENT failures (a
            # broken model fails both halves of every split): after the
            # shared budget the remaining batch 500s wholesale — the
            # pre-isolation behavior — instead of burning 2n-1
            # transforms on a model that was never going to answer
            budget = [isolation_budget(len(reqs))]
        budget[0] -= 1
        to_send: List[Tuple[ServingRequest, ServingReply]] = []
        rejected = 0
        try:
            oom_fault_point(self._oom_key, len(rows))
            t0 = time.perf_counter()
            ds = Dataset.from_rows(rows)
            t1 = time.perf_counter()
            out = self.model.transform(ds)
            t2 = time.perf_counter()
            self._add_timing(from_rows_s=t1 - t0, transform_s=t2 - t1)
            col = out[self.output_col]
            if out.num_rows != len(reqs):
                # a guarded model (handleInvalid='skip'/'quarantine')
                # dropped poisoned rows: re-align replies through the
                # guard's source-row provenance — positional zip would
                # hand every later record its neighbor's prediction
                if not out.has_source_index:
                    raise _BatchAlignmentError(
                        f"model returned {out.num_rows} rows for "
                        f"{len(reqs)} records without row provenance; "
                        "replies cannot be aligned")
                idx = [int(p) for p in out.source_index]
                if (len(set(idx)) != len(idx)
                        or not all(0 <= p < len(reqs) for p in idx)):
                    # a row-EXPANDING model (Explode-style duplicate
                    # provenance) or foreign provenance: answering one
                    # request several times would race the exchange —
                    # fail loudly instead
                    raise _BatchAlignmentError(
                        "model output rows do not map 1:1 onto records "
                        "(duplicate or out-of-range source rows)")
                answered = set(idx)
                for pos, val in zip(idx, col):
                    self._format_reply(reqs[pos], val, to_send)
                body = json.dumps({"error": "record rejected by the "
                                   "model's handleInvalid policy"}).encode()
                for i, req in enumerate(reqs):
                    if i not in answered:
                        rejected += 1
                        to_send.append((req, ServingReply(422, body)))
            else:
                for req, val in zip(reqs, col):
                    self._format_reply(req, val, to_send)
        except PreemptionError as e:
            # control plane, never row-attributable (rowguard's
            # _NON_ROW_ERRORS contract): the process is being evicted —
            # shed the batch retryably instead of bisecting it
            self._reply_all(reqs, 503, e, "preempt")
            return 0
        except _BatchAlignmentError as e:
            self._reply_all(reqs, 500, e, "transform")
            return 0
        except Exception as e:  # noqa: BLE001 — serving must not die
            if getattr(e, "all_rows_invalid", False):
                # the model's OWN row guard rejected every record in
                # this (sub-)batch — that's a data verdict, not a model
                # failure: same 422 the provenance-aligned path answers
                self._reply_all(reqs, 422, e, "rejected")
                return 0
            oom = is_oom_error(e)
            if len(reqs) == 1 or (budget[0] <= 0 and not oom):
                self._reply_all(reqs, 500, e, "oom" if oom else "transform")
                return 0
            mid = len(reqs) // 2
            if oom:
                # batch-size failure: remember the size that fits so
                # later micro-batch pulls stay under it
                record_safe_batch(self._oom_key, max(1, mid))
                self._m_errors.inc(1, api=self.api.path, kind="oom")
            # halve either way: OOM retries smaller, a poison record is
            # cornered in O(log n) transforms while clean ones still
            # answer 200
            return (self._transform_reply(reqs[:mid], rows[:mid], budget)
                    + self._transform_reply(reqs[mid:], rows[mid:], budget))
        if rejected:
            self._m_errors.inc(rejected, api=self.api.path, kind="rejected")
        served = 0
        for req, rep in to_send:
            self._safe_reply(req.id, rep)
            if rep.status == 200:
                served += 1
        self._add_timing(reply_s=time.perf_counter() - t2, batches=1,
                         records=len(reqs))
        return served

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)


class _TokenStream:
    """Blocking token-chunk iterator bridging the decode loop and the
    chunked-transfer reply writer: the loop pushes encoded chunks as
    tokens are sampled, the listener's executor thread pulls them.  The
    exchange stays in-flight until ``finish()``'s sentinel drains, so
    ``drain()``'s zero-drop guarantee covers live token streams.

    ``abandon()`` is the listener's back-signal for a client that
    disconnected mid-stream: the decode loop checks the flag every
    tick and cancels the slot instead of decoding the full budget for
    nobody (the streaming counterpart of the non-stream reply-window
    expiry).  An abandoned stream drops further pushes so the queue
    cannot grow behind a dead connection."""

    _DONE = object()

    def __init__(self):
        self._q: "Queue" = Queue()
        self.abandoned = False

    def push(self, chunk: bytes) -> None:
        if not self.abandoned:
            self._q.put(chunk)

    def finish(self) -> None:
        self._q.put(self._DONE)

    def abandon(self) -> None:
        self.abandoned = True

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        return item


@dataclass
class _DecodeSeq:
    """One request's decode lifecycle (queued → slotted → retired)."""
    req: ServingRequest
    ids: List[int]
    max_new: int
    stream: bool
    slot: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    stream_obj: Optional[_TokenStream] = None
    first_token_at: Optional[float] = None
    #: request-scoped trace id (None ⇒ not sampled — every trace call
    #: with a None id is a no-op)
    trace_id: Optional[str] = None
    #: the request was held in queue for an in-flight program compile
    #: at least once (the compile_wait trace event fires on the first
    #: hold only)
    compile_waited: bool = False
    #: conversation key for the session journal
    session: Optional[str] = None
    #: the sequence was rebuilt from a journal replay: ``ids`` is the
    #: journaled prompt + committed tokens, ``tokens`` pre-seeded with the
    #: committed tokens, ``max_new`` the REMAINING budget — the admit
    #: prefills the whole context and the continuation is token-exact
    #: with the interrupted turn
    resumed: bool = False
    #: the journal replay already holds the turn's FULL token budget (the
    #: crash landed after the last token commit but before the reply):
    #: the replay IS the reply
    replay_complete: bool = False
    #: QoS tenant this sequence bills to (from the ``X-SML-Tenant``
    #: header or the ``tenant`` payload field)
    tenant: str = "default"
    #: per-request priority-class override (None ⇒ tenant policy)
    priority: Optional[int] = None
    #: preemption ticket from ``engine.preempt`` while parked — the
    #: sequence holds no slot and re-enters via ``engine.resume``
    ticket: Optional[Dict[str, Any]] = None
    #: the per-tenant rate budget was already charged for this request
    #: (charged once, at first admission consideration)
    budget_spent: bool = False
    #: disaggregated-prefill handoff outcome for this request (None ⇒
    #: no pool armed, or the handoff has not run yet — it runs at most
    #: once per request; see serving.disagg.HANDOFF_OUTCOMES)
    handoff_outcome: Optional[str] = None

    @property
    def remaining(self) -> int:
        """Tokens left in this sequence's budget (the preemption
        victim tie-break: longest-remaining is cheapest to set aside)."""
        return max(0, int(self.max_new) - len(self.tokens))


class _DecodeLoop:
    """Continuous-batching serving loop for an LLM decode engine.

    Instead of batch → transform → reply, the loop runs one SLOTTED
    decode step at a time and re-schedules between steps:

    - **admission every step** — queued requests are pulled with the
      non-blocking :meth:`ApiHandle.poll` and admitted into free cache
      slots the moment one exists; a request never waits for a "full
      batch" and an in-flight batch never stalls waiting on arrivals;
    - **SLO-aware shedding** — with ``ttft_slo_s`` set, a queued request
      whose PROJECTED time-to-first-token (time already waited + the
      soonest slot release, from the engine's remaining-token floor ×
      the observed step time) exceeds the SLO answers 503 with the
      queue-depth ``Retry-After`` hint instead of serving a stale
      reply — including while the server drains;
    - **eviction per step** — EOS / token-budget retirement frees the
      slot immediately for the next admission; a reply window that
      expired mid-decode cancels the slot;
    - **streaming** — ``stream`` requests are answered immediately with
      a chunked body fed token-by-token through the existing
      exchange/reply machinery (one JSON line per token, a final
      ``done`` line with the full ids).

    The engine is duck-typed (``admit``/``step``/``cancel``/
    ``n_slots``/``active_count``/``free_slot_count``/
    ``min_remaining_tokens``, plus optional
    ``tokens_per_step_estimate`` — a speculative engine's
    accepted-tokens-per-step EWMA, folded into the SLO projection —
    optional ``trace_sink``: when present and unset the loop
    installs its request-trace hook so the engine's per-slot
    decode/verify outcomes land on the request timelines — and the
    optional compile plane: ``admission_ready(prompt_len)`` holds
    requests in queue until the plane is warm, and ``compile_plane``
    exempts the
    pre-ready warmup window from the SLO shed projection) so this
    module never imports torch; pass a
    :class:`synapseml_tpu_torch.models.llm.SlotEngine`.  A ``step()`` may
    return SEVERAL events per slot (a speculative engine commits whole
    accepted spans); the loop streams each committed token in order.

    **Observability**: every request gets a ``trace_id`` at admission
    into the plane (or adopts the propagated ``X-SML-Trace-Id``) and a
    sampled per-request timeline — queued → shed/admitted →
    prefill(bucket) → decode/verify steps → retired/cancelled/expired
    — in the process :class:`~synapseml_tpu_torch.telemetry.tracing.
    RequestTraceStore` (served at ``GET /tracez``); TTFT, per-token
    latency, occupancy, and admission/shed/retirement counts
    additionally feed the windowed SLO plane
    (:mod:`synapseml_tpu_torch.telemetry.slo`, served at ``GET /sloz``) with
    ``ttft_slo_s``/``token_slo_s`` as its declared objectives.
    """

    def __init__(self, server: ServingServer, api: ApiHandle, engine: Any,
                 input_parser: Callable[[ServingRequest], Dict[str, Any]],
                 output_formatter: Optional[
                     Callable[[List[int]], Dict[str, Any]]] = None,
                 max_new_tokens_default: int = 32,
                 ttft_slo_s: Optional[float] = None,
                 token_slo_s: Optional[float] = None,
                 idle_timeout_s: float = 0.02,
                 trace_sample_every: Optional[int] = None,
                 request_tracer=None, slo_window=None, journal=None,
                 qos=None, max_tenants: int = 256, disagg=None):
        self.server = server
        self.api = api
        self.engine = engine
        #: optional session journal (duck-typed on
        #: :class:`~synapseml_tpu_torch.models.llm.kvtier.SessionJournal`:
        #: ``begin``/``append_tokens``/``retire``/``replay`` with a
        #: ``tenant`` keyword, and a public ``metrics``/``name``): every
        #: committed token is journaled fsync-first, and a ``resume``
        #: request replays the journal so a killed replica's conversation
        #: continues token-exactly here
        self.journal = journal
        self.input_parser = input_parser
        self.output_formatter = output_formatter or (
            lambda ids: {"ids": [int(t) for t in ids]})
        self.max_new_tokens_default = int(max_new_tokens_default)
        self.ttft_slo_s = ttft_slo_s
        self.token_slo_s = token_slo_s
        self.idle_timeout_s = idle_timeout_s
        #: the multi-tenant scheduling policy: weighted-fair admission
        #: order, per-tenant rate budgets, and preemption verdicts all
        #: come from here (torch-free; a default scheduler treats every
        #: tenant equally, so single-tenant traffic behaves exactly as
        #: the old FIFO did)
        from .qos import DEFAULT_TENANT, OVERFLOW_TENANT, QosScheduler
        self._overflow_tenant = OVERFLOW_TENANT
        self.qos = qos if qos is not None else QosScheduler()
        #: cardinality bound on CLIENT-MINTED tenant ids: every distinct
        #: tenant permanently materialises an SLO plane, metric label
        #: sets, and QoS deficit/budget state — all unauthenticated
        #: client-controlled, so without a cap a client cycling random
        #: ids grows server memory and /sloz payloads without bound.
        #: Tenants with a registered TenantPolicy always get their own
        #: plane; dynamic (unregistered) ids are granted planes up to
        #: this cap and rejected 429 past it.
        self.max_tenants = max(1, int(max_tenants))
        self._tenant_ids = {DEFAULT_TENANT}
        self._waiting: List[_DecodeSeq] = []
        #: preempted sequences holding a resume ticket instead of a
        #: slot — auto-resumed token-exactly once pressure clears
        self._parked: List[_DecodeSeq] = []
        self._by_slot: Dict[int, _DecodeSeq] = {}
        # duck-typed engine compatibility: only thread tenant
        # kwargs through surfaces that declare them (test fakes and
        # older engines keep working untouched)
        import inspect
        def _takes_tenant(fn) -> bool:
            try:
                return "tenant" in inspect.signature(fn).parameters
            except (TypeError, ValueError):
                return False
        self._engine_tenant_kw = _takes_tenant(
            getattr(engine, "admit", lambda: None))
        self._step_ewma: Optional[float] = None
        self._retired_window: List[float] = []
        # request-scoped tracing: the process store by default (so the
        # listener's /tracez sees this loop's requests); the sampling
        # knob adjusts THAT store (process-wide — /tracez is one surface)
        self._tracer = request_tracer or get_request_tracer()
        if trace_sample_every is not None:
            self._tracer.sample_every = max(0, int(trace_sample_every))
        # the engine reports per-slot step outcomes (decode/verify with
        # span sizes) through its optional trace_sink hook; only claim
        # an unset one — a caller-installed sink wins
        if getattr(engine, "trace_sink", "absent") is None:
            engine.trace_sink = self._engine_trace
        # windowed SLO plane (served at /sloz): one plane per API path
        self._slo = slo_window or get_slo_store().window(api.path)
        if ttft_slo_s is not None:
            self._slo.set_objective("ttft", float(ttft_slo_s))
        if token_slo_s is not None:
            self._slo.set_objective("token_latency", float(token_slo_s))
        #: lazily-created per-tenant attribution planes (named
        #: ``<api>@tenant=<id>``; filtered by ``/sloz?tenant=``) — fed
        #: alongside the aggregate plane so a noisy tenant cannot hide
        #: inside aggregate percentiles.  Occupancy is engine-wide, not
        #: per-tenant, so tenant planes never observe it (their null
        #: occupancy is skipped by the autoscaler reduction).
        self._tenant_windows: Dict[str, Any] = {}
        #: disaggregated prefill pool (duck-typed on serving.disagg.
        #: PrefillPool: ``handoff(ids, session=, tenant=) -> outcome``):
        #: when armed, every fresh request's prompt is offered to the
        #: pool before admission — an ``ok`` handoff lands its K/V in
        #: this engine's host arena so the admit warm-restores it; any
        #: other outcome just means the admit prefills locally.  The
        #: decode phase gets its own ``@phase=decode`` SLO plane so the
        #: two pools scale independently.
        self.disagg = disagg
        self._phase_slo = None
        if disagg is not None:
            from ..telemetry.slo import phase_plane_name
            self._phase_slo = get_slo_store().window(
                phase_plane_name(api.path, "decode"))
            if ttft_slo_s is not None:
                self._phase_slo.set_objective("ttft", float(ttft_slo_s))
            if token_slo_s is not None:
                self._phase_slo.set_objective("token_latency",
                                              float(token_slo_s))
        self._slo_export_at = 0.0
        reg = get_registry()
        self._m_ttft = reg.histogram(
            "llm_ttft_seconds", "request arrival to first generated token",
            ("api",), buckets=SERVING_TTFT_BUCKETS)
        self._m_tok_lat = reg.histogram(
            "llm_token_latency_seconds",
            "per-token decode latency (one observation per emitted token)",
            ("api",), buckets=SERVING_TOKEN_LATENCY_BUCKETS)
        self._m_tokens = reg.counter(
            "llm_tokens_total", "tokens streamed/replied by the decode "
            "loop", ("api",))
        self._m_sheds = reg.counter(
            "llm_sheds_total", "requests shed by the decode loop",
            ("api", "reason", "tenant"))
        self._m_preempt = reg.counter(
            "llm_qos_preemptions_total", "slots preempted by the QoS "
            "plane for a higher priority class", ("api", "tenant"))
        self._m_errors = reg.counter(
            "serving_errors_total", "batches failed (500) or shed (503)",
            ("api", "kind"))
        self._m_records = reg.counter(
            "serving_records_total", "records replied 200", ("api",))
        self._m_rps = reg.gauge(
            "serving_records_per_sec",
            "last-batch records/sec through transform+reply", ("api",))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _safe_reply(self, request_id: str, rep: ServingReply) -> bool:
        return _reply_never_raises(self.api, request_id, rep)

    # -- request-scoped tracing -------------------------------------------
    def _engine_trace(self, slot: int, name: str, **attrs) -> None:
        """The engine's ``trace_sink``: map the slot back to its
        sequence and append the step event to the request timeline
        (cancelled-under-us slots and unsampled requests no-op)."""
        seq = self._by_slot.get(slot)
        if seq is not None and seq.trace_id is not None:
            self._tracer.event(seq.trace_id, name, slot=slot, **attrs)

    @staticmethod
    def _trace_headers(seq: _DecodeSeq) -> Dict[str, str]:
        """Reply header echoing the request's trace id (sampled
        requests only) — lets a client/balancer stitch the hop chain."""
        if seq.trace_id is None:
            return {}
        return {TRACE_HEADER_CANONICAL: seq.trace_id}

    # -- admission ---------------------------------------------------------
    def _pump_queue(self) -> None:
        """Move newly-arrived requests into the waiting list.  Blocks
        only when the loop is otherwise idle.  The pull is sized to
        FILL the waiting list up to its cap — ``max(2·n_slots,
        max_queue)`` — rather than a few slots' worth, because QoS
        admission (priority tiers, weighted-fair order, tenant
        budgets) can only reorder what it has seen: a small fixed pull
        would leave a high-priority tenant head-of-line-blocked in the
        raw FIFO behind a flooding neighbor's burst.  Crucially the
        pull is the cap MINUS the backlog already held
        (waiting + parked): once the backlog reaches the cap the pump
        stops draining, the api queue fills, and enqueue-time 503
        backpressure fires — without the subtraction a sustained flood
        would be drained into ``_waiting`` every tick and accumulate
        there without bound while the queue-full 503 never tripped."""
        cap = max(2 * self.engine.n_slots,
                  getattr(self.api, "max_queue", 1024))
        room = max(0, cap - len(self._waiting) - len(self._parked))
        if room == 0:
            return
        if self.engine.active_count or self._waiting:
            batch = self.api.poll(room)
        else:
            batch = self.api.get_batch(room, self.idle_timeout_s)
        for req in batch:
            try:
                spec = self.input_parser(req)
                ids = [int(t) for t in spec.get("ids", [])]
                session = spec.get("session")
                resume = bool(spec.get("resume", False)) \
                    and session is not None and self.journal is not None
                if not ids and not resume:
                    raise ValueError("empty prompt")
                max_new = int(spec.get("max_new_tokens",
                                       self.max_new_tokens_default))
                # payload wins over the X-SML-Tenant header (a gateway
                # may inject the header; an authenticated body field is
                # more specific); absent both ⇒ the default tenant
                tenant = str(spec.get("tenant") or req.tenant or "default")
                if len(tenant) > 256:
                    # a tenant id is a namespace key (planes, labels,
                    # QoS state) — an arbitrarily long one is abuse, and
                    # truncating would silently merge two namespaces
                    raise ValueError("tenant id exceeds 256 chars")
                prio = spec.get("priority", req.priority)
                prio = int(prio) if prio is not None else None
            except Exception as e:  # noqa: BLE001 — isolated to record
                self._m_errors.inc(1, api=self.api.path, kind="parse")
                self._safe_reply(req.id, ServingReply(400, json.dumps(
                    {"error": f"unparseable record: {e}"}).encode()))
                continue
            if not self._tenant_admitted(tenant):
                # dynamic-tenant cardinality cap: tenant ids are
                # client-controlled and each distinct one permanently
                # allocates an SLO plane, metric labels, and QoS state
                # — past the cap an unregistered id is rejected, under
                # the bounded overflow label so the rejection itself
                # cannot be used to grow cardinality either
                self._m_sheds.inc(1, api=self.api.path,
                                  reason="tenant_cap",
                                  tenant=self._overflow_tenant)
                self._m_errors.inc(1, api=self.api.path, kind="shed")
                self._slo.count("shed")
                self._safe_reply(req.id, ServingReply(429, json.dumps(
                    {"error": "tenant plane limit reached: register a "
                     "TenantPolicy for this tenant or raise "
                     "max_tenants"}).encode()))
                continue
            seq = _DecodeSeq(req, ids, max_new,
                             bool(spec.get("stream", False)),
                             tenant=tenant, priority=prio)
            if session is not None:
                seq.session = str(session)
            if resume:
                self._try_resume(seq)
                if not seq.ids:
                    # replay found nothing usable and the request carried
                    # no prompt of its own: nothing to serve
                    self._m_errors.inc(1, api=self.api.path, kind="parse")
                    self._safe_reply(req.id, ServingReply(
                        404, json.dumps(
                            {"error": "resume: no journaled state for "
                             "session"}).encode()))
                    continue
                if seq.replay_complete:
                    payload = self.output_formatter(seq.tokens)
                    self._safe_reply(req.id, ServingReply(
                        200, json.dumps(payload).encode(),
                        {"Content-Type": "application/json"}))
                    self._m_records.inc(1, api=self.api.path)
                    continue
            # trace minted here (admission into the serving plane) or
            # adopted from the upstream hop (always sampled: a
            # propagated request is never half-traced)
            seq.trace_id = self._tracer.begin(req.trace_id,
                                              api=self.api.path)
            self._tracer.event(seq.trace_id, "queued",
                               prompt_tokens=len(ids), max_new=max_new,
                               stream=seq.stream)
            self._waiting.append(seq)

    def _try_resume(self, seq: _DecodeSeq) -> None:
        """Rebuild an interrupted conversation from the session journal
        (the crash-failover path).  On a usable replay the sequence becomes
        journaled prompt + committed tokens with the REMAINING budget, so
        the prefill reproduces the dead replica's state and the
        continuation is token-exact.  Every degraded outcome (no journal
        file, a truncated state) is counted and the request falls back to
        its own ids: a cold start, never a wrong token."""
        m = self.journal.metrics
        name = getattr(self.journal, "name", "llm")
        try:
            # tenant-namespaced replay: a cross-tenant session-id
            # collision reads as a miss, never as another tenant's tokens
            st = self.journal.replay(seq.session, tenant=seq.tenant)
        except Exception:  # noqa: BLE001 — degraded, never fatal
            st = None
        if st is None or not (st.prompt or st.committed):
            m.restores.inc(1, engine=name, source="journal",
                           outcome="miss")
            return
        if st.truncated:
            # the size cap dropped oldest tokens: a suffix is not
            # token-exact material
            m.restores.inc(1, engine=name, source="journal",
                           outcome="truncated")
            return
        committed = [int(t) for t in st.committed]
        seq.ids = [int(t) for t in st.prompt] + committed
        seq.tokens = list(committed)
        remaining = int(st.max_new) - len(committed)
        if remaining <= 0:
            # every budgeted token was journaled before the crash: the
            # turn finished, only the reply was lost
            seq.replay_complete = True
        seq.max_new = max(1, remaining)
        seq.resumed = True
        m.restores.inc(1, engine=name, source="journal", outcome="ok")
        _flight_record("kvtier_session_resume", api=self.api.path,
                       session=seq.session, committed=len(committed),
                       remaining=seq.max_new)

    def _journal_safe(self, fn) -> None:
        """Run one journal operation without ever failing the serving
        path: a full disk loses durability (flight-recorded), not the
        conversation.  An armed ``kill`` fault SIGKILLs inside ``fn``,
        which is the crash the journal protects against."""
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — serving must not die
            _flight_record("kvtier_journal_error", api=self.api.path,
                           error=repr(exc))

    def _queue_waited(self, seq: _DecodeSeq) -> float:
        """Seconds this request has spent as REAL queue pressure.
        Warmup/compile time is not queue pressure: while the engine's
        compile plane is still warming, the whole wait is exempt (a
        cold replica would otherwise project absurd TTFTs and shed its
        entire first wave the moment warmup gating lands), and once it
        is warm the clock starts at plane-ready time for requests that
        arrived during the warm — not at their enqueue time."""
        anchor = seq.req.enqueued_at
        plane = getattr(self.engine, "compile_plane", None)
        if plane is not None:
            if not plane.is_warm:
                return 0.0
            ready_at = plane.ready_at
            if ready_at is not None and ready_at > anchor:
                anchor = ready_at
        return time.monotonic() - anchor

    def _projected_ttft(self, seq: _DecodeSeq, position: int) -> float:
        """Projection of this request's TTFT if admitted as soon as
        capacity allows: time already queued plus the soonest slot
        release, scaled by how many queued requests are ahead of it.

        The release estimate is the SMALLER of the engine's
        remaining-token floor × observed step time (exact when
        sequences run their full budget) and the observed
        inter-retirement interval from the recent window (the honest
        estimate when EOS retires sequences far under budget —
        budget-based projection alone would shed requests that real
        retirement traffic was about to serve).  A SPECULATIVE engine
        advances each slot by its accepted span, so the floor divides
        by the engine's accepted-tokens-per-step estimate
        (``tokens_per_step_estimate``, optional in the duck-type
        contract): remaining-tokens ÷ accepted-tokens-per-step steps
        remain, not remaining-tokens steps — without this the
        projection over-sheds by the whole speculative speedup."""
        waited = self._queue_waited(seq)
        if self.engine.free_slot_count > 0:
            return waited
        rem = self.engine.min_remaining_tokens()
        if rem is None or self._step_ewma is None:
            return waited
        tps_fn = getattr(self.engine, "tokens_per_step_estimate", None)
        tps = max(1.0, float(tps_fn())) if tps_fn is not None else 1.0
        next_free = rem / tps * self._step_ewma
        now = time.monotonic()
        recent = [t for t in self._retired_window if now - t < 5.0]
        if recent:
            next_free = min(next_free, 5.0 / len(recent))
        waves = 1 + position // max(1, self.engine.n_slots)
        return waited + next_free * waves

    def _shed_headers(self) -> Dict[str, str]:
        from ..resilience.health import retry_after_from_depth
        depth = len(self._waiting) + self.engine.active_count
        now = time.monotonic()
        self._retired_window = [t for t in self._retired_window
                                if now - t < 5.0]
        rps = len(self._retired_window) / 5.0
        return {"Retry-After": str(retry_after_from_depth(depth, rps))}

    def _tenant_admitted(self, tenant: str) -> bool:
        """Bound the universe of tenant ids this plane materialises
        state for: always the default tenant and every tenant with a
        registered :class:`TenantPolicy`; dynamic (client-minted) ids
        are granted a plane first-come up to ``max_tenants`` and
        rejected past it — an unauthenticated client cycling random
        ids cannot grow the SLO store, metric label sets, or QoS
        ledgers without bound."""
        if tenant in self._tenant_ids:
            return True
        registered = getattr(self.qos, "is_registered", None)
        if ((registered is not None and registered(tenant))
                or len(self._tenant_ids) < self.max_tenants):
            self._tenant_ids.add(tenant)
            return True
        return False

    def _tenant_slo(self, tenant: str):
        """Get-or-create the per-tenant attribution plane (same
        objectives as the aggregate plane, so burn rate is comparable
        per tenant)."""
        w = self._tenant_windows.get(tenant)
        if w is None:
            from ..telemetry.slo import tenant_plane_name
            w = get_slo_store().window(
                tenant_plane_name(self.api.path, tenant))
            if self.ttft_slo_s is not None:
                w.set_objective("ttft", float(self.ttft_slo_s))
            if self.token_slo_s is not None:
                w.set_objective("token_latency", float(self.token_slo_s))
            self._tenant_windows[tenant] = w
        return w

    def _shed(self, seq: _DecodeSeq, reason: str) -> None:
        self._m_sheds.inc(1, api=self.api.path, reason=reason,
                          tenant=seq.tenant)
        self._m_errors.inc(1, api=self.api.path, kind="shed")
        self._slo.count("shed")
        self._tenant_slo(seq.tenant).count("shed")
        if self._phase_slo is not None:
            self._phase_slo.count("shed")
        self._tracer.event(seq.trace_id, "shed", reason=reason)
        self._tracer.finish(seq.trace_id, "shed")
        self._safe_reply(seq.req.id, ServingReply(
            503, json.dumps({"error": "projected time-to-first-token "
                             "exceeds the serving SLO"}).encode(),
            {**self._shed_headers(), **self._trace_headers(seq)}))

    def _shed_budget(self, seq: _DecodeSeq, retry_after_s: float) -> None:
        """Per-tenant rate-budget shed: 429 with the budget's own
        refill horizon as ``Retry-After`` — the throttled tenant gets
        an honest backoff hint, every other tenant is untouched."""
        self._m_sheds.inc(1, api=self.api.path, reason="budget",
                          tenant=seq.tenant)
        self._m_errors.inc(1, api=self.api.path, kind="shed")
        self._slo.count("shed")
        self._tenant_slo(seq.tenant).count("shed")
        if self._phase_slo is not None:
            self._phase_slo.count("shed")
        self._tracer.event(seq.trace_id, "shed", reason="budget")
        self._tracer.finish(seq.trace_id, "shed")
        self._safe_reply(seq.req.id, ServingReply(
            429, json.dumps({"error": "tenant over rate budget"}).encode(),
            {"Retry-After": str(max(1, int(math.ceil(retry_after_s)))),
             **self._trace_headers(seq)}))

    def _admit_waiting(self) -> None:
        keep: List[_DecodeSeq] = []
        ready_fn = getattr(self.engine, "admission_ready", None)
        # per-tenant rate budgets first (charged ONCE per request, in
        # tokens = the requested budget, through the token-bucket
        # RetryBudget): an over-budget tenant sheds 429 with its own
        # refill horizon while every other tenant is untouched
        pool: List[_DecodeSeq] = list(self._parked)
        self._parked = []
        for seq in self._waiting:
            if not seq.budget_spent:
                seq.budget_spent = True
                ok, retry_after = self.qos.shed_verdict(
                    seq.tenant, float(seq.max_new))
                if not ok:
                    self._shed_budget(seq, retry_after)
                    continue
            pool.append(seq)
        # weighted-fair admission order: strict priority tiers, token-
        # weighted deficit round robin across tenants within a tier
        # (parked preempted sequences compete through the same order)
        starved: List[_DecodeSeq] = []
        for pos, seq in enumerate(self.qos.admission_order(pool)):
            if seq.ticket is not None:
                # preempted earlier: re-enter through engine.resume —
                # restore + continue is token-exact (the engine's
                # ticket contract), so pressure clearing auto-resumes
                # the victim with zero wrong tokens
                slot = (self.engine.resume(seq.ticket)
                        if self.engine.free_slot_count > 0 else None)
                if slot is None:
                    starved.append(seq)
                    keep.append(seq)
                    continue
                seq.ticket = None
                seq.slot = slot
                self._by_slot[slot] = seq
                self._tracer.event(seq.trace_id, "resumed", slot=slot)
                continue
            if ready_fn is not None and not ready_fn(len(seq.ids)):
                # the compile plane is still warming (admission waits
                # for the whole plane: no step may touch the device
                # while its thread captures): hold the request in
                # queue, and _queue_waited exempts the wait from SLO
                # shedding
                if not seq.compile_waited:
                    seq.compile_waited = True
                    self._tracer.event(seq.trace_id, "compile_wait",
                                       prompt_tokens=len(seq.ids))
                keep.append(seq)
                continue
            if (self.ttft_slo_s is not None
                    and self._projected_ttft(seq, pos) > self.ttft_slo_s):
                self._shed(seq, "slo")
                continue
            if self.engine.free_slot_count == 0:
                starved.append(seq)
                keep.append(seq)
                continue
            if (self.disagg is not None and seq.handoff_outcome is None
                    and not seq.resumed):
                # disaggregated prefill: offer the prompt to the pool
                # FIRST (at most once per request).  handoff() never
                # raises — every failure mode is an attributed outcome
                # — and an "ok" lands the K/V in this engine's arena so
                # the admit below warm-restores it token-exactly; any
                # other outcome means the admit prefills locally (the
                # colocated fallback, never a wrong token).  Resumed
                # turns skip the pool: the journal failover path owns
                # their context reconstruction.
                try:
                    seq.handoff_outcome = self.disagg.handoff(
                        seq.ids, session=seq.session, tenant=seq.tenant)
                except Exception:  # noqa: BLE001 — belt over the contract
                    seq.handoff_outcome = "fallback"
                    _flight_record("disagg_handoff", api=self.api.path,
                                   outcome="fallback", error=True)
                self._tracer.event(seq.trace_id, "disagg_handoff",
                                   outcome=seq.handoff_outcome)
            try:
                res = (self.engine.admit(seq.ids, seq.max_new,
                                         tenant=seq.tenant)
                       if self._engine_tenant_kw
                       else self.engine.admit(seq.ids, seq.max_new))
            except ValueError as e:             # prompt cannot fit
                self._m_errors.inc(1, api=self.api.path, kind="parse")
                self._tracer.finish(seq.trace_id, "error", error=str(e))
                self._safe_reply(seq.req.id, ServingReply(
                    400, json.dumps({"error": str(e)}).encode()))
                continue
            if res is None:                     # raced full — requeue
                starved.append(seq)
                keep.append(seq)
                continue
            seq.slot = res.slot
            seq.first_token_at = time.monotonic()
            ttft = seq.first_token_at - seq.req.enqueued_at
            self._m_ttft.observe(ttft, api=self.api.path)
            self._slo.observe_ttft(ttft)
            self._slo.count("admitted")
            tslo = self._tenant_slo(seq.tenant)
            tslo.observe_ttft(ttft)
            tslo.count("admitted")
            if self._phase_slo is not None:
                self._phase_slo.observe_ttft(ttft)
                self._phase_slo.count("admitted")
            self._tracer.event(
                seq.trace_id, "admitted", slot=res.slot,
                reused_tokens=getattr(res, "reused_tokens", 0))
            self._tracer.event(seq.trace_id, "prefill", slot=res.slot,
                               bucket=getattr(res, "bucket", 0))
            if seq.stream:
                seq.stream_obj = _TokenStream()
                if not self._safe_reply(seq.req.id, ServingReply(
                        200, seq.stream_obj,
                        {"Content-Type": "application/json",
                         **self._trace_headers(seq)})):
                    self.engine.cancel(res.slot)
                    # the reply window expired before admission: close
                    # the timeline like every other termination path —
                    # /tracez must not show this request live forever
                    self._tracer.finish(seq.trace_id, "expired")
                    continue
            self._by_slot[res.slot] = seq
            if self.journal is not None and seq.session is not None:
                # (re)baseline the journal BEFORE the first token lands:
                # for a resumed turn ids already embeds the committed
                # tokens, so a second crash stays token-exact
                self._journal_safe(lambda s=seq: self.journal.begin(
                    s.session, s.ids, s.max_new, tenant=s.tenant))
            self._on_token(seq, res.token, res.finished,
                           getattr(res, "reason", None))
        self._waiting = [s for s in keep if s.ticket is None]
        self._parked = [s for s in keep if s.ticket is not None]
        self._maybe_preempt(starved)

    def _maybe_preempt(self, starved: List[_DecodeSeq]) -> None:
        """Preemption policy: when capacity-starved demand includes a
        STRICTLY higher priority class than some active slot, evict the
        lowest-priority longest-remaining slot through the engine's
        ticket path (``preempt``/``resume``) and park it — the
        freed slot serves the higher class next tick and the victim
        auto-resumes token-exactly when pressure clears.  Every verdict
        is flight-recorded with the justifying pressure snapshot."""
        if not starved or self.engine.free_slot_count > 0:
            return
        preempt_fn = getattr(self.engine, "preempt", None)
        if preempt_fn is None or not self._by_slot:
            return
        demand = max(self.qos.priority_of(s) for s in starved)
        victim = self.qos.preemption_victim(
            demand, list(self._by_slot.values()))
        if victim is None:
            return
        # snapshot the JUSTIFYING state before the eviction mutates it
        # (preempt frees the slot, so free_slots would read post-hoc)
        snap = self.qos.pressure_snapshot(starved,
                                          self.engine.free_slot_count)
        ticket = preempt_fn(victim.slot)
        if ticket is None:
            # the engine declined (slot raced to retirement, arena
            # full): the verdict never happened — committing it here
            # would overcount preemptions and burn the anti-thrash
            # cooldown, delaying the next legitimate eviction
            return
        self.qos.commit_preemption()
        self._by_slot.pop(victim.slot, None)
        victim.ticket = ticket
        victim.slot = None
        self._parked.append(victim)
        self._m_preempt.inc(1, api=self.api.path, tenant=victim.tenant)
        self._tracer.event(victim.trace_id, "preempted",
                           demand_priority=demand)
        _flight_record("qos_preemption", api=self.api.path,
                       tenant=victim.tenant,
                       victim_priority=self.qos.priority_of(victim),
                       demand_priority=demand,
                       victim_remaining=victim.remaining,
                       pressure=snap)

    # -- token/retirement handling ----------------------------------------
    def _on_token(self, seq: _DecodeSeq, token: int, finished: bool,
                  reason: Optional[str] = None) -> None:
        if self.journal is not None and seq.session is not None:
            # journal BEFORE the client sees the token: a token the client
            # received survives a SIGKILL one instruction later (fsync'd)
            self._journal_safe(lambda s=seq, t=token:
                               self.journal.append_tokens(
                                   s.session, [int(t)], tenant=s.tenant))
        seq.tokens.append(int(token))
        self._m_tokens.inc(1, api=self.api.path)
        if seq.stream_obj is not None:
            seq.stream_obj.push(
                json.dumps({"token": int(token)}).encode() + b"\n")
        if finished:
            self._finish(seq, reason)

    def _finish(self, seq: _DecodeSeq,
                reason: Optional[str] = None) -> None:
        self._by_slot.pop(seq.slot, None)
        now = time.monotonic()
        # prune at the append site: the window must stay ~5s of
        # timestamps, not one float per request served since startup
        self._retired_window = [t for t in self._retired_window
                                if now - t < 5.0]
        self._retired_window.append(now)
        self._slo.count("retired")
        self._tenant_slo(seq.tenant).count("retired")
        if self._phase_slo is not None:
            self._phase_slo.count("retired")
        self._tracer.event(seq.trace_id, "retired",
                           tokens=len(seq.tokens), reason=reason)
        self._tracer.finish(seq.trace_id, "retired",
                            tokens=len(seq.tokens), reason=reason)
        if self.journal is not None and seq.session is not None:
            # compaction at retirement: the session's history collapses to
            # one state record, kept as the next turn's failover source
            self._journal_safe(lambda s=seq:
                               self.journal.retire(s.session,
                                                   tenant=s.tenant))
        payload = self.output_formatter(seq.tokens)
        if seq.stream_obj is not None:
            payload["done"] = True
            seq.stream_obj.push(json.dumps(payload).encode() + b"\n")
            seq.stream_obj.finish()
            self._m_records.inc(1, api=self.api.path)
        else:
            ok = self._safe_reply(seq.req.id, ServingReply(
                200, json.dumps(payload).encode(),
                {"Content-Type": "application/json",
                 **self._trace_headers(seq)}))
            if ok:
                self._m_records.inc(1, api=self.api.path)

    def _cancel_expired(self) -> None:
        """A sequence nobody is waiting on must not hold a slot (and
        SLO-shed queued requests on its behalf): a NON-STREAM request
        whose reply window expired (the listener answered 504 and
        forgot the exchange), or a STREAM whose client disconnected
        mid-decode (the chunk writer flagged the stream abandoned).
        Streams replied at admission, so the window applies only to
        non-stream sequences."""
        now = time.monotonic()
        for slot, seq in list(self._by_slot.items()):
            if seq.stream_obj is not None:
                dead = seq.stream_obj.abandoned
                kind = "disconnect"
            else:
                dead = (now - seq.req.enqueued_at
                        > self.api.reply_timeout_s)
                kind = "expired"
            if dead:
                self.engine.cancel(slot)
                self._by_slot.pop(slot, None)
                self._m_errors.inc(1, api=self.api.path, kind=kind)
                self._tracer.event(seq.trace_id, "cancelled", reason=kind)
                self._tracer.finish(seq.trace_id, kind,
                                    tokens=len(seq.tokens))
        # a PARKED (preempted) sequence holds no slot but still owns a
        # reply window/stream — the same expiry rules drop its ticket
        live_parked: List[_DecodeSeq] = []
        for seq in self._parked:
            if seq.stream_obj is not None:
                dead = seq.stream_obj.abandoned
                kind = "disconnect"
            else:
                dead = (now - seq.req.enqueued_at
                        > self.api.reply_timeout_s)
                kind = "expired"
            if dead:
                self._m_errors.inc(1, api=self.api.path, kind=kind)
                self._tracer.event(seq.trace_id, "cancelled", reason=kind)
                self._tracer.finish(seq.trace_id, kind,
                                    tokens=len(seq.tokens))
            else:
                live_parked.append(seq)
        self._parked = live_parked
        # a WAITING request past its reply window is dead weight: the
        # listener already answered 504 and forgot the exchange, so
        # admitting it would decode tokens nobody can receive (and
        # SLO-shed live requests queued behind it).  Streams have no
        # window here — a waiting stream has not been replied yet, so
        # the same expiry applies.
        live_waiting: List[_DecodeSeq] = []
        for seq in self._waiting:
            if now - seq.req.enqueued_at > self.api.reply_timeout_s:
                self._m_errors.inc(1, api=self.api.path, kind="expired")
                self._tracer.event(seq.trace_id, "cancelled",
                                   reason="expired")
                self._tracer.finish(seq.trace_id, "expired", tokens=0)
            else:
                live_waiting.append(seq)
        self._waiting = live_waiting

    # -- the loop ----------------------------------------------------------
    def _loop(self) -> None:
        # serving must not die: any engine failure (a CUDA error, a
        # duck-typed engine bug) fails the IN-FLIGHT sequences with 500s, frees
        # their slots, and keeps the thread serving
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — serving must not die
                self._fail_inflight(e)
                time.sleep(0.05)    # a persistently-broken engine must
                #                     not spin the loop hot

    def _tick(self) -> None:
        self._pump_queue()
        self._admit_waiting()
        self._cancel_expired()
        self._export_slo()
        if not self.engine.active_count:
            if self._waiting:
                # requests held while the compile plane warms: wait out a
                # tick instead of spinning, which would starve the
                # plane's own thread of the interpreter
                self._stop.wait(self.idle_timeout_s)
            return
        t0 = time.perf_counter()
        events = self.engine.step()
        dt = time.perf_counter() - t0
        self._step_ewma = (dt if self._step_ewma is None
                           else 0.8 * self._step_ewma + 0.2 * dt)
        # a speculative engine commits a SPAN per slot per step: the
        # per-token latency observation is the step time amortized
        # over the slot's committed span (observing the full dt once
        # per token would overcount it span-fold and read as spec
        # WORSENING token latency when it improved it)
        span: Dict[int, int] = {}
        for ev in events:
            span[ev.slot] = span.get(ev.slot, 0) + 1
        for ev in events:
            seq = self._by_slot.get(ev.slot)
            if seq is None:         # cancelled under us
                continue
            tok_s = dt / span[ev.slot]
            self._m_tok_lat.observe(tok_s, api=self.api.path)
            self._slo.observe_token_latency(tok_s)
            self._tenant_slo(seq.tenant).observe_token_latency(tok_s)
            if self._phase_slo is not None:
                self._phase_slo.observe_token_latency(tok_s)
            # the DRR deficit is charged by COMMITTED tokens, one per
            # step event — a speculative engine commits several per
            # slot per step, so token-weighting (not request-counting)
            # is what keeps the fair shares honest under spec decode
            self.qos.charge(seq.tenant, 1)
            self._on_token(seq, ev.token, ev.finished, ev.reason)
        if events and dt > 0:
            self._m_rps.set(len(events) / dt, api=self.api.path)

    def _export_slo(self) -> None:
        """Refresh the plane's /metrics gauges from the windows on a
        ~1 s cadence.  Occupancy is sampled HERE — time-uniformly,
        idle ticks included — not per decode step: per-step sampling
        only ever sees busy instants, so a plane idle 59 s of every 60
        would read ~1.0 occupancy and the autoscaler consuming /sloz
        ("shrink on idle occupancy") would never scale it down."""
        now = time.monotonic()
        if now - self._slo_export_at >= 1.0:
            self._slo_export_at = now
            self._slo.observe_occupancy(
                self.engine.active_count / max(1, self.engine.n_slots))
            self._slo.export_gauges()
            if self._phase_slo is not None:
                # the decode phase's occupancy IS this engine's slots —
                # the prefill pool samples its own plane per handoff
                self._phase_slo.observe_occupancy(
                    self.engine.active_count / max(1, self.engine.n_slots))
                self._phase_slo.export_gauges()
            for w in self._tenant_windows.values():
                w.export_gauges()

    def _fail_inflight(self, e: Exception) -> None:
        """Answer every in-flight sequence 500 (streams get a final
        error line) and free its slot after an engine failure.
        PARKED (preempted) sequences are in flight too — their resume
        tickets reference engine/arena state the failure (and the
        recovery reset below) invalidates, so they get the same 500
        instead of hanging un-notified until their reply window
        expires on a persistently-broken engine."""
        body = json.dumps({"error": str(e)}).encode()
        for slot, seq in list(self._by_slot.items()):
            try:
                self.engine.cancel(slot)
            except Exception:  # noqa: BLE001 — engine may be broken
                pass
            self._fail_seq(seq, e, body)
            self._by_slot.pop(slot, None)
        for seq in self._parked:
            self._fail_seq(seq, e, body)
        self._parked = []
        self._m_errors.inc(1, api=self.api.path, kind="transform")
        # an exception mid-step can leave the cache half written: the
        # engine's reset clears every slot and zeroes the cache in place
        # (its graphs stay bound to the storage) — recovery, not cleanup
        reset = getattr(self.engine, "reset", None)
        if reset is not None:
            try:
                reset()
            except Exception:  # noqa: BLE001 — stay alive regardless
                pass

    def _fail_seq(self, seq: _DecodeSeq, e: Exception,
                  body: bytes) -> None:
        """Terminate one in-flight sequence with the engine error
        (final stream line or a 500 reply) and close its timeline."""
        if seq.stream_obj is not None:
            seq.stream_obj.push(json.dumps(
                {"error": str(e)}).encode() + b"\n")
            seq.stream_obj.finish()
        else:
            self._safe_reply(seq.req.id, ServingReply(500, body))
        self._tracer.finish(seq.trace_id, "error", error=str(e))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        # release every still-open stream: the listener's executor
        # thread is parked in Queue.get() on it, and an unfinished
        # stream would leak that (non-daemon) thread past close —
        # observed as a process that never exits.  After the join the
        # loop thread is gone, so this cannot race a push.
        for seq in list(self._by_slot.values()) + self._parked:
            if seq.stream_obj is not None:
                seq.stream_obj.finish()
        self._by_slot.clear()
        self._parked.clear()


def _default_format(value: Any) -> bytes:
    if isinstance(value, np.ndarray):
        value = value.tolist()
    elif isinstance(value, (np.generic,)):
        value = value.item()
    return json.dumps({"prediction": value}).encode()


class PipelineServer:
    """Continuous serving loop for ONE model: requests → Dataset →
    ``model.transform`` → replies (the ``readStream.continuousServer()``
    pipeline of reference §3.5 collapsed into one object)."""

    def __init__(self, model: Transformer,
                 input_parser: Callable[[ServingRequest], Dict[str, Any]],
                 output_col: str = "prediction",
                 output_formatter: Optional[Callable[[Any], bytes]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", batch_size: int = 64,
                 batch_timeout_s: float = 0.01, max_queue: int = 1024,
                 num_workers: int = 1,
                 max_queue_wait_s: Optional[float] = None):
        self.model = model
        self.server = ServingServer(host, port, api_path,
                                    max_queue=max_queue)
        self._loop = _ApiLoop(self.server, self.server._default, model,
                              input_parser, output_col,
                              output_formatter or _default_format,
                              batch_size, batch_timeout_s,
                              num_workers=num_workers,
                              max_queue_wait_s=max_queue_wait_s)

    _default_format = staticmethod(_default_format)

    @property
    def url(self) -> str:
        return self.server.url

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: the serving loop keeps replying while the
        server sheds new work and flushes accepted exchanges, THEN the
        loop stops (stopping it first would deadlock the flush)."""
        drained = self.server.drain(timeout_s)
        self._loop.stop()
        return drained

    def close(self) -> None:
        self._loop.stop()
        self.server.close()


class MultiPipelineServer:
    """Several named pipelines on ONE server — request paths route to the
    API whose pipeline should serve them (reference: multiple named APIs
    with per-executor shared servers, HTTPSourceV2.scala:47-90,
    DistributedHTTPSource.scala:203).

    ``apis``: {path: spec} where spec is a dict with keys ``model``,
    ``input_parser`` and optional ``output_col``/``output_formatter``/
    ``batch_size``/``batch_timeout_s``/``max_queue``.
    """

    def __init__(self, apis: Dict[str, Dict[str, Any]],
                 host: str = "127.0.0.1", port: int = 0):
        if not apis:
            raise ValueError("MultiPipelineServer needs at least one API")
        first = next(iter(apis))
        self.server = ServingServer(
            host, port, api_path=first,
            max_queue=int(apis[first].get("max_queue", 1024)))
        self._loops: List[_ApiLoop] = []
        for path, spec in apis.items():
            handle = self.server.register_api(
                path, max_queue=int(spec.get("max_queue", 1024)))
            self._loops.append(_ApiLoop(
                self.server, handle, spec["model"], spec["input_parser"],
                spec.get("output_col", "prediction"),
                spec.get("output_formatter") or _default_format,
                int(spec.get("batch_size", 64)),
                float(spec.get("batch_timeout_s", 0.01)),
                num_workers=int(spec.get("num_workers", 1)),
                max_queue_wait_s=spec.get("max_queue_wait_s")))

    def url_for(self, path: str) -> str:
        return self.server.url_for(path)

    def drain(self, timeout_s: float = 30.0) -> bool:
        drained = self.server.drain(timeout_s)
        for loop in self._loops:
            loop.stop()
        return drained

    def close(self) -> None:
        for loop in self._loops:
            loop.stop()
        self.server.close()
