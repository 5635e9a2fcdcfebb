"""The port's HTTP stages and port forwarding (``io/http.py``,
``io/port_forward.py``) under the contracts ``tests/test_io_serving.py``
holds the JAX package's to, against a local ``ThreadingHTTPServer`` (no
network), and the requests the port sends byte-equal to the JAX
package's: the recorded method, path, JSON body and content type of every
request, and the parsed replies."""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.io import HTTPRequestData as JRequest
from synapseml_tpu.io import JSONInputParser as JJSONInputParser
from synapseml_tpu.io import SimpleHTTPTransformer as JSimple
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.io import (HTTPClient, HTTPRequestData,
                                    HTTPTransformer, JSONInputParser,
                                    SimpleHTTPTransformer)
from torch_fuzzing import TestObject, TransformerFuzzing
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


class _EchoHandler(BaseHTTPRequestHandler):
    """Echoes JSON bodies; /flaky fails twice per path then succeeds;
    every request under /rec/<tag> is recorded under its tag."""

    fail_counts = {}
    recorded = {}
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(length)
        body = json.loads(raw or b"{}")
        if self.path.startswith("/rec/"):
            tag = self.path.split("/")[2]
            with _EchoHandler.lock:
                _EchoHandler.recorded.setdefault(tag, []).append(
                    (self.command, self.path, raw,
                     self.headers.get("Content-Type")))
        if self.path.startswith("/flaky"):
            with _EchoHandler.lock:
                n = _EchoHandler.fail_counts.get(self.path, 0)
                _EchoHandler.fail_counts[self.path] = n + 1
            if n < 2:
                self.send_error(503)
                return
            payload = {"ok": True, "attempts": n + 1}
        else:
            payload = {"echo": body}
        data = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    do_GET = do_POST
    do_PUT = do_POST


_SERVER = {}


def _server_url():
    """One server for the module (the fuzzing suite builds its stages
    outside any fixture)."""
    if "url" not in _SERVER:
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _EchoHandler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        host, port = httpd.server_address[:2]
        _SERVER.update(httpd=httpd, url=f"http://{host}:{port}")
    return _SERVER["url"]


@pytest.fixture(scope="module")
def echo_server():
    yield _server_url()
    httpd = _SERVER.pop("httpd")
    _SERVER.pop("url")
    httpd.shutdown()
    httpd.server_close()


class TestHTTPClient:
    def test_retry_on_503(self, echo_server):
        client = HTTPClient(retries=3, backoffs_ms=[10, 10, 10])
        resp = client.send(HTTPRequestData(
            url=echo_server + "/flaky/a", method="POST",
            headers={"Content-Type": "application/json"}, entity=b"{}"))
        assert resp.status_code == 200
        assert resp.json()["attempts"] == 3

    def test_connection_refused_reported(self):
        client = HTTPClient(retries=0)
        resp = client.send(HTTPRequestData(url="http://127.0.0.1:1/nope"))
        assert resp.status_code == 0
        assert resp.reason


class TestHTTPTransformer:
    def test_concurrent_requests(self, echo_server):
        n = 12
        reqs = np.empty(n, dtype=object)
        for i in range(n):
            reqs[i] = {"url": echo_server + "/echo", "method": "POST",
                       "headers": {"Content-Type": "application/json"},
                       "entity": json.dumps({"i": i}).encode()}
        ds = Dataset({"request": reqs})
        out = HTTPTransformer(concurrency=4).transform(ds)
        for i, resp in enumerate(out["response"]):
            assert resp.status_code == 200
            assert resp.json()["echo"]["i"] == i


class TestSimpleHTTPTransformer:
    def test_json_round_trip(self, echo_server):
        ds = Dataset({"a": np.arange(3), "b": np.array(["x", "y", "z"])})
        stage = SimpleHTTPTransformer(
            inputCols=["a", "b"], url=echo_server + "/echo", concurrency=2)
        out = stage.transform(ds)
        assert out["output"][1]["echo"] == {"a": 1, "b": "y"}
        assert all(e is None for e in out["errors"])

    def test_failed_rows_fill_the_error_column(self):
        ds = Dataset({"a": np.arange(2)})
        out = SimpleHTTPTransformer(url="http://127.0.0.1:1/x",
                                    retries=0).transform(ds)
        assert all(o is None for o in out["output"])
        assert all(e is not None for e in out["errors"])


class TestParserStages:
    def test_string_and_custom_parsers(self):
        from synapseml_tpu_torch.io import (CustomInputParser,
                                            CustomOutputParser,
                                            StringOutputParser)
        from synapseml_tpu_torch.io.http import HTTPResponseData

        sp = StringOutputParser()
        assert sp(HTTPResponseData(status_code=200, entity=b"ok",
                                   headers={})) == "ok"
        assert sp(HTTPResponseData(status_code=0, entity=None,
                                   headers={})) is None

        cip = CustomInputParser(lambda row: HTTPRequestData(
            url="http://x/", method="GET", headers={}, entity=None))
        req = cip({"a": 1})
        assert req.method == "GET"

        cop = CustomOutputParser(lambda resp: resp.status_code * 2)
        assert cop(HTTPResponseData(status_code=21, entity=b"",
                                    headers={})) == 42


def _rows(seed, n=8):
    rng = np.random.default_rng(seed)
    vec = np.empty(n, dtype=object)
    for i in range(n):
        vec[i] = rng.normal(size=3).astype(np.float32)
    return {"i": np.arange(n), "x": rng.normal(size=n),
            "s": np.array([f"r{k}" for k in rng.integers(0, 99, n)]),
            "v": vec}


@pytest.mark.parametrize("seed", [0, 1])
def test_json_input_parser_equals_jax(seed):
    cols = _rows(seed)
    tp = JSONInputParser("http://h/p", "PUT", {"X-K": "1"})
    jp = JJSONInputParser("http://h/p", "PUT", {"X-K": "1"})
    for r in range(len(cols["i"])):
        row = {c: cols[c][r] for c in cols}
        t, j = tp(row), jp(row)
        assert (t.url, t.method, t.headers, t.entity) == \
            (j.url, j.method, j.headers, j.entity)


@pytest.mark.parametrize("concurrency", [1, 4])
def test_simple_http_payloads_equal_jax(echo_server, concurrency):
    """The same rows through both packages' SimpleHTTPTransformer: the
    server records the same requests and both parse the same replies."""
    cols = _rows(concurrency)
    tag_t, tag_j = f"t{concurrency}", f"j{concurrency}"
    out_t = SimpleHTTPTransformer(
        inputCols=["i", "x", "s", "v"], url=f"{echo_server}/rec/{tag_t}",
        concurrency=concurrency).transform(Dataset(dict(cols)))
    out_j = JSimple(
        inputCols=["i", "x", "s", "v"], url=f"{echo_server}/rec/{tag_j}",
        concurrency=concurrency).transform(JDataset(dict(cols)))
    assert out_t.columns == out_j.columns
    assert list(out_t["output"]) == list(out_j["output"])
    assert list(out_t["errors"]) == list(out_j["errors"])

    def requests(tag):
        return sorted((m, p.replace(tag, ""), body, ct)
                      for m, p, body, ct in _EchoHandler.recorded[tag])
    assert requests(tag_t) == requests(tag_j)
    assert len(requests(tag_t)) == len(cols["i"])


def test_request_data_from_dict_equals_jax():
    d = {"url": "http://h/x", "method": "POST",
         "headers": {"A": "b"}, "entity": b"{}"}
    t, j = HTTPRequestData.from_dict(d), JRequest.from_dict(d)
    assert (t.url, t.method, t.headers, t.entity) == \
        (j.url, j.method, j.headers, j.entity)


class TestSimpleHTTPFuzzing(TransformerFuzzing):
    invalid_input_kinds = ("None", "wrong dtype")

    def fuzzing_objects(self):
        ds = Dataset({"a": np.arange(4, dtype=np.float64),
                      "b": np.array(["w", "x", "y", "z"])})
        return [TestObject(SimpleHTTPTransformer(
            inputCols=["a", "b"], url=_server_url() + "/echo"), ds)]


class _Doubler:
    """A model with no device work, so the relay test measures the
    serving path only."""

    def transform(self, ds):
        x = np.asarray([float(v) for v in ds["x"]])
        return Dataset({"x": ds["x"], "prediction": 2.0 * x})


class TestPortForwarding:
    """io/http PortForwarding analogue (PortForwarding.scala): reverse
    ssh tunnel via the system ssh binary + a pure-Python TCP relay."""

    def test_ssh_command_matches_reference_semantics(self):
        from synapseml_tpu.io.port_forward import \
            build_ssh_command as j_build
        from synapseml_tpu_torch.io.port_forward import build_ssh_command
        cmd = build_ssh_command("hadoop", "db-cluster", 2200, "*", 9999,
                                "0.0.0.0", 8899, key_file="/keys/id_rsa")
        assert cmd[0] == "ssh" and "-N" in cmd
        assert "StrictHostKeyChecking=no" in cmd   # reference sets this
        assert "ExitOnForwardFailure=yes" in cmd   # port-walk detection
        assert "*:9999:0.0.0.0:8899" in cmd
        assert cmd[cmd.index("-i") + 1] == "/keys/id_rsa"
        assert cmd[-1] == "hadoop@db-cluster"
        assert cmd[cmd.index("-p") + 1] == "2200"
        assert cmd == j_build("hadoop", "db-cluster", 2200, "*", 9999,
                              "0.0.0.0", 8899, key_file="/keys/id_rsa")

    def test_relay_pipes_a_serving_endpoint(self):
        """End-to-end through the relay: a PipelineServer behind a
        TcpRelay answers HTTP exactly as if reached directly."""
        from synapseml_tpu_torch.io.port_forward import TcpRelay
        from synapseml_tpu_torch.serving import PipelineServer
        ps = PipelineServer(_Doubler(), lambda r: {"x": r.json()["x"]},
                            batch_timeout_s=0.01)
        try:
            host, port = ps.server.address
            relay = TcpRelay((host, port))
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{relay.port}/",
                    data=json.dumps({"x": 21.0}).encode(), method="POST")
                with urllib.request.urlopen(req, timeout=10) as r:
                    assert json.loads(r.read())["prediction"] == 42.0
                # teardown revokes live connections, like an ssh forward
                import socket as _socket
                s2 = _socket.create_connection(("127.0.0.1", relay.port))
                s2.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
                time.sleep(0.3)
            finally:
                relay.close()
            s2.settimeout(5)
            tail = b"x"
            while tail:                      # drain until remote close
                tail = s2.recv(65536)
            s2.close()
        finally:
            ps.close()

    def test_forward_walks_ports_and_reports_failure(self, monkeypatch):
        """The retry walk covers the whole remote port range and fails
        cleanly with the range in the message; a missing ssh binary gets
        its own clear error."""
        import io as _io
        import subprocess as _sp

        from synapseml_tpu_torch.io import port_forward as pf

        seen = []

        class FakeProc:
            def __init__(self, cmd, **kw):
                seen.append(cmd)
                self.stderr = _io.BytesIO(b"bind: port taken")

            def poll(self):
                return 255        # immediate exit = forward bind failed

        monkeypatch.setattr(pf.subprocess, "Popen", FakeProc)
        with pytest.raises(RuntimeError, match=r"\[9990, 9991\]"):
            pf.forward_port_to_remote("nobody", "host",
                                      remote_port_start=9990,
                                      local_port=80, max_retries=1,
                                      settle_s=0.0)
        forwards = [c[c.index("-R") + 1] for c in seen]
        assert forwards == ["*:9990:0.0.0.0:80", "*:9991:0.0.0.0:80"]
        monkeypatch.undo()
        if _sp.run(["which", "ssh"], capture_output=True).returncode != 0:
            with pytest.raises(RuntimeError, match="ssh"):
                pf.forward_port_to_remote("nobody", "host",
                                          remote_port_start=1,
                                          local_port=80, max_retries=0,
                                          settle_s=0.0)
