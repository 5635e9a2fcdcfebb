"""A recording mock of the remote services, for the port's service,
PowerBI and downloader tests.

One ``ThreadingHTTPServer`` on 127.0.0.1 answers every endpoint shape the
service stages speak (the union of the JAX package's ``_MockHandler``,
``_EchoHandler`` and ``_PBIHandler``), serves files for the model
downloader, and records each request it receives: method, path, query,
body bytes and headers (``User-Agent`` left out).  A test drives the JAX
stage and the port's stage against the same server and compares the two
recordings.  ``fail_next(path, *statuses)`` queues error answers for the
next requests to a path, so a test can inject a 503 that the client
retries or a 400 that lands in ``errorCol``.
"""

import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


def embedding_of(text: str, dim: int, seed: int = 0) -> list:
    """The mock's embedding of ``text``: ``dim`` normal draws from a
    generator seeded by ``seed`` and a hash of the text.  A text that
    starts ``topic <t>`` lies at half that scale around topic t's center
    (drawn from ``seed`` and t), as texts on one subject do."""
    h = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
    v = np.random.default_rng([seed, h]).normal(size=dim)
    words = text.split()
    if words and words[0] == "topic":
        v = 0.5 * v + np.random.default_rng(
            [seed, int(words[1])]).normal(size=dim)
    return v.tolist()


class _Handler(BaseHTTPRequestHandler):
    # headers and body leave in separate writes: without this, Nagle holds
    # the body until the client's delayed ACK (~40 ms a request)
    disable_nagle_algorithm = True

    def log_message(self, *a):
        pass

    def _reply(self, data: bytes, status=200, ctype="application/json"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, payload, status=200):
        self._reply(json.dumps(payload).encode(), status)

    def _handle(self):
        srv = self.server.mock
        length = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(length) if length else b""
        url = urlparse(self.path)
        srv.record(dict(
            method=self.command, path=url.path, query=url.query, body=raw,
            headers={k: v for k, v in self.headers.items()
                     if k.lower() != "user-agent"}))
        status = srv.injected(url.path)
        if status is not None:
            self.send_error(status)
            return
        q = parse_qs(url.query)
        ctype = self.headers.get("Content-Type", "")
        body = json.loads(raw) if ctype.startswith("application/json") \
            and raw else None
        route = getattr(self, "_r_" + url.path.strip("/").split("/")[0],
                        None)
        if route is None or not route(url.path, q, body, raw):
            self._json({"echo": body, "nbytes": len(raw),
                        "query": url.query})

    do_GET = do_POST = _handle

    # -- routes, by the first path segment -------------------------------
    def _r_vision(self, path, q, body, raw):
        if path.startswith("/vision/analyze"):
            self._json({"url": (body or {}).get("url"),
                        "nbytes": 0 if body else len(raw),
                        "features": q.get("visualFeatures", [""])[0]})
        elif path.startswith("/vision/describe"):
            self._json({"description": {"captions": [
                {"text": "a mock caption", "confidence": 0.9}]}})
        elif path.startswith("/vision/thumb"):
            self._reply(b"THUMB" + q["width"][0].encode(), ctype="image/jpeg")
        else:
            return False
        return True

    def _r_face(self, path, q, body, raw):
        if path.startswith("/face/detect"):
            self._json([{"faceId": "f1", "faceRectangle":
                         {"top": 1, "left": 2}}])
        elif path.startswith("/face/verify"):
            same = body["faceId1"] == body["faceId2"]
            self._json({"isIdentical": same,
                        "confidence": 1.0 if same else 0.1})
        else:
            return False
        return True

    def _r_translate(self, path, q, body, raw):
        to = q.get("to", ["en"])
        self._json([{"translations": [{"text": f"[{lang}] {d['Text']}",
                                       "to": lang} for lang in to]}
                    for d in body])
        return True

    def _r_anomaly(self, path, q, body, raw):
        vals = [p["value"] for p in body["series"]]
        self._json({"isAnomaly": [v > 50 for v in vals]})
        return True

    def _r_mvad(self, path, q, body, raw):
        if path.startswith("/mvad/train"):
            self._json({"modelId": "model-42"})
        else:
            self._json({"modelId": body["modelId"], "isAnomaly":
                        abs(sum(body["variables"].values())) > 10})
        return True

    def _r_search(self, path, q, body, raw):
        self._json({"value": [{"status": True} for _ in body["value"]]})
        return True

    def _r_speech(self, path, q, body, raw):
        if path.startswith("/speech/tts"):
            self._reply(b"RIFFaudio", ctype="audio/wav")
        else:
            self._json({"DisplayText": f"heard {len(raw)} bytes"})
        return True

    def _r_geo(self, path, q, body, raw):
        if path.startswith("/geo/pip"):
            self._json({"result": {
                "pointInPolygons": float(q["lat"][0]) > 0}})
        else:
            self._json({"batchItems": [
                {"lat": 47.6, "lon": -122.3,
                 "query": body["batchItems"][0]["query"]}]})
        return True

    def _r_text(self, path, q, body, raw):
        text = body["documents"][0]["text"]
        if path.startswith("/text/language"):
            lang = "fr" if "bonjour" in text else "en"
            self._json({"documents": [
                {"id": "0", "detectedLanguage": {"iso6391Name": lang}}]})
        elif path.startswith("/text/ner"):
            self._json({"documents": [
                {"id": "0", "entities": [{"text": "Seattle",
                                          "category": "Location"}]}]})
        else:
            return False
        return True

    def _r_sentiment(self, path, q, body, raw):
        text = body["documents"][0]["text"]
        self._json({"documents": [{
            "id": "0",
            "sentiment": "positive" if "good" in text else "negative"}]})
        return True

    def _r_completions(self, path, q, body, raw):
        self._json({"choices": [{"text": "echo: " + body["prompt"]}]})
        return True

    def _r_embeddings(self, path, q, body, raw):
        srv = self.server.mock
        self._json({"data": [{"embedding": embedding_of(
            body["input"], srv.embed_dim, srv.seed)}]})
        return True

    def _r_bing(self, path, q, body, raw):
        n = int(q["count"][0])
        self._json({"value": [{"contentUrl": f"http://x/{q['q'][0]}/{i}"}
                              for i in range(n)]})
        return True

    def _r_push(self, path, q, body, raw):
        srv = self.server.mock
        if srv.pbi_fail:
            self.send_error(400, "Bad payload")
            return True
        with srv.lock:
            srv.pbi_batches.append(body)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()
        return True

    def _r_files(self, path, q, body, raw):
        data = self.server.mock.files.get(path[len("/files/"):])
        if data is None:
            self.send_error(404)
        else:
            self._reply(data, ctype="application/octet-stream")
        return True


class MockServices:
    """The recording server; ``url`` is its base address."""

    def __init__(self, embed_dim: int = 16, seed: int = 0):
        self.embed_dim, self.seed = embed_dim, seed
        self.lock = threading.Lock()
        self.requests = []
        self.pbi_batches = []
        self.pbi_fail = False
        self.files = {}
        self._fail = {}
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.mock = self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def record(self, req: dict) -> None:
        with self.lock:
            self.requests.append(req)

    def take(self) -> list:
        """The requests recorded since the last call, in arrival order."""
        with self.lock:
            out, self.requests = self.requests, []
        return out

    def fail_next(self, path: str, *statuses: int) -> None:
        with self.lock:
            self._fail.setdefault(path, []).extend(statuses)

    def injected(self, path: str):
        with self.lock:
            queue = self._fail.get(path)
            return queue.pop(0) if queue else None

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def canonical(requests: list) -> list:
    """Requests in a stable order, for stages that send concurrently."""
    return sorted(requests, key=lambda r: (r["method"], r["path"],
                                           r["query"], r["body"]))


def same_value(a, b) -> bool:
    """Equality of two output cells: arrays by value, containers
    elementwise, everything else with ``==``."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same_value(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k])
                                            for k in a)
    return type(a) is type(b) and a == b
