"""Continuous-mode serving client: one persistent framed connection.

The port's copy of the JAX package's ``serving/continuous.py``.  The
continuous server mode keeps the HTTP exchange machinery out of the
per-record path (Spark Serving's "continuousServer", documented as
sub-millisecond latency).  :class:`ContinuousClient` is the matching
client for :class:`~.server.ServingServer`'s ``Upgrade: sml-frames``
mode: after one HTTP/1.1 upgrade handshake the connection carries
length-prefixed binary frames both ways, replies always in request
order.

Pipelining is the point — ``request_many`` keeps a window of frames in
flight so the server batches them into one ``transform`` and the
per-record marginal cost is a 4-byte framed read, not an HTTP exchange.

Resilience: a long-lived connection WILL break (server restart, LB idle
reset).  ``request``/``request_many`` transparently reconnect ONCE per
call on ``ECONNRESET``/broken pipe/server EOF — replies arrive in
request order, so every payload after the last received reply is known
to be unanswered and is resent on the fresh connection.  Reconnect
attempts back off under a
:class:`~synapseml_tpu_torch.resilience.RetryPolicy` and the
``continuous.send``/``continuous.connect`` fault sites make the whole
path testable without killing a real server.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Iterable, List, Optional, Tuple

from ..resilience import RetryPolicy, get_faults
from ..telemetry import get_registry


class ContinuousClient:
    """Persistent framed connection to one ServingServer API.

    >>> with ContinuousClient(host, port, "/model") as c:
    ...     status, body = c.request(b'{"x": 1.0}')
    ...     replies = c.request_many(payloads)      # pipelined, in order
    """

    def __init__(self, host: str, port: int, path: str = "/",
                 timeout_s: float = 30.0,
                 reconnect_policy: Optional[RetryPolicy] = None):
        reg = get_registry()
        self._m_records = reg.counter(
            "serving_continuous_client_records_total",
            "frames exchanged through ContinuousClient", ("path",))
        self._m_rps = reg.gauge(
            "serving_continuous_client_records_per_sec",
            "last request_many window's end-to-end records/sec", ("path",))
        self._m_reconnects = reg.counter(
            "serving_continuous_client_reconnects_total",
            "transparent reconnects after a broken connection", ("path",))
        self._host, self._port = host, port
        self._path = path or "/"
        self._timeout_s = timeout_s
        self._reconnect_policy = reconnect_policy or RetryPolicy(
            max_retries=2, base_s=0.05, max_backoff_s=1.0)
        self._closed = False
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._in_flight = 0
        self._connect()

    def _connect(self) -> None:
        """Dial + upgrade handshake (fault site ``continuous.connect``)."""
        get_faults().raise_point("continuous.connect")
        self._sock = socket.create_connection((self._host, self._port),
                                              timeout=self._timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        self._in_flight = 0
        req = (f"GET {self._path} HTTP/1.1\r\n"
               f"Host: {self._host}:{self._port}\r\n"
               "Connection: Upgrade\r\n"
               "Upgrade: sml-frames\r\n\r\n").encode("latin1")
        self._sock.sendall(req)
        status_line = self._rfile.readline().decode("latin1")
        while True:                       # drain the handshake headers
            line = self._rfile.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        if " 101 " not in status_line:
            self._teardown()
            raise ConnectionError(
                f"continuous upgrade refused: {status_line.strip()!r}")

    def _reconnect(self) -> None:
        """Re-dial under the reconnect policy's backoff; in-flight frames
        on the dead connection are the caller's to resend."""
        self._teardown()
        policy = self._reconnect_policy
        last: Optional[Exception] = None
        for attempt in range(policy.max_retries + 1):
            try:
                self._connect()
                self._m_reconnects.inc(1, path=self._path)
                return
            except (ConnectionError, OSError) as e:
                last = e
                if attempt < policy.max_retries:
                    policy.sleep(policy.backoff_s(attempt),
                                 site="continuous.reconnect")
        raise ConnectionError(
            f"continuous reconnect to {self._host}:{self._port} failed: "
            f"{last}")

    # -- framed protocol ---------------------------------------------------
    def send(self, payload: bytes) -> None:
        """Fire one request frame without waiting for its reply."""
        get_faults().raise_point("continuous.send")
        self._sock.sendall(struct.pack("<I", len(payload)) + payload)
        self._in_flight += 1

    def recv(self) -> Tuple[int, bytes]:
        """Next in-order reply → (status, body)."""
        get_faults().raise_point("continuous.recv")
        hdr = self._rfile.read(4)
        if len(hdr) < 4:
            raise ConnectionError("continuous connection closed by server")
        (total,) = struct.unpack("<I", hdr)
        frame = self._rfile.read(total)
        if len(frame) < total or total < 2:
            raise ConnectionError("truncated continuous reply frame")
        (status,) = struct.unpack("<H", frame[:2])
        self._in_flight -= 1
        return status, frame[2:]

    def request(self, payload: bytes) -> Tuple[int, bytes]:
        """One synchronous round trip (send + recv), with one transparent
        reconnect-and-resend on a broken connection."""
        try:
            self.send(payload)
            reply = self.recv()
        except (ConnectionResetError, BrokenPipeError, ConnectionError):
            if self._closed:
                raise
            self._reconnect()
            self.send(payload)
            reply = self.recv()
        self._m_records.inc(1, path=self._path)
        return reply

    def request_many(self, payloads: Iterable[bytes],
                     window: int = 64) -> List[Tuple[int, bytes]]:
        """Pipelined exchange: keep up to ``window`` frames in flight,
        collect every reply in request order.

        On ``ECONNRESET``/broken pipe/server EOF mid-exchange the client
        reconnects ONCE and resends exactly the unanswered suffix
        (replies are in order, so everything after the last received
        reply is known-unanswered); a second break raises."""
        t0 = time.perf_counter()
        items = list(payloads)
        out: List[Tuple[int, bytes]] = []
        sent = 0
        reconnects_left = 1
        while len(out) < len(items):
            try:
                if sent < len(items) and self._in_flight < max(1, window):
                    self.send(items[sent])
                    sent += 1
                else:
                    out.append(self.recv())
            except (ConnectionResetError, BrokenPipeError, ConnectionError):
                if self._closed or reconnects_left <= 0:
                    raise
                reconnects_left -= 1
                self._reconnect()
                sent = len(out)          # resend the unanswered suffix
        dt = time.perf_counter() - t0
        self._m_records.inc(len(out), path=self._path)
        if out and dt > 0:
            self._m_rps.set(len(out) / dt, path=self._path)
        return out

    # -- lifecycle ---------------------------------------------------------
    def _teardown(self) -> None:
        """Close the socket + its makefile handle (both, or the fd leaks
        through the buffered reader), tolerating any prior state."""
        rfile, sock = self._rfile, self._sock
        self._rfile = self._sock = None
        self._in_flight = 0
        if rfile is not None:
            try:
                rfile.close()
            except OSError:
                pass
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        """Idempotent: EOF the stream so queued server replies flush,
        then release the socket and makefile handle."""
        if self._closed:
            return
        self._closed = True
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_WR)   # EOF ends the stream
            except OSError:
                pass
        self._teardown()

    def __enter__(self) -> "ContinuousClient":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None

    def __del__(self):       # last-resort leak guard; close() is the API
        try:
            self.close()
        except Exception:
            pass
