"""The port's ``LLMServer`` over HTTP held against the JAX package on the
CPU, mirroring ``tests/test_llm_serving.py``'s server tests.

``LlamaConfig.tiny(num_layers=2, max_len=96)`` in f32 with the JAX init
carried into the port (``params_from_reference``).  Every reply's ids
must equal the JAX ``generate`` greedy ids exactly: one request, five
concurrent requests on two slots, streamed, and speculative.  The
serving contract: a tokenizer's prompt is answered, an unparseable
request gets 400 with the loop alive, SLO shedding answers 503 with
``Retry-After``, drain drops nothing and sheds new work, a disconnected
stream and an expired reply window free their slots, an engine failure
answers 500 and the loop serves on, and background warm-up answers
``/readyz`` 503 "warming" then 200.  ``/metrics``, ``/sloz`` and
``/tracez`` for the same traffic carry the JAX ``LLMServer``'s metric
names, labels and JSON keys.  Every engine and API has its own name: the
registries are process-wide.
"""

import json
import re
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.models.llm import warmup as PW
from synapseml_tpu_torch.serving import LLMServer
from synapseml_tpu_torch.telemetry import get_registry
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


@pytest.fixture(scope="module")
def pair():
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=jnp.float32)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=torch.float32)
    jm = J.LlamaModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu"))
    return jm, variables, tm


def _prompts(n, length, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 512, (n, length)).astype(np.int32)


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers)


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _server(tm, name, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    return LLMServer(tm, device="cpu", engine_kwargs={"name": name}, **kw)


def _slow_steps(srv, seconds=0.005):
    """Make every engine step take at least ``seconds`` (the tests of
    windows and disconnects need a decode that outlasts them)."""
    real = srv.engine.step

    def step():
        time.sleep(seconds)
        return real()
    srv.engine.step = step


def _ids(row):
    return [int(t) for t in row]


def test_http_roundtrip_token_exact(pair):
    jm, variables, tm = pair
    ids = _prompts(1, 7, 20)
    ref = J.generate(jm, variables, ids, max_new_tokens=8)[0]
    srv = _server(tm, "pt-http")
    try:
        status, body, _ = _post(srv.url, {"ids": _ids(ids[0]),
                                          "max_new_tokens": 8})
        assert status == 200 and json.loads(body)["ids"] == _ids(ref)
    finally:
        srv.close()


@pytest.mark.parametrize("spec", [0, 4])
def test_concurrent_requests_all_exact(pair, spec):
    """Five requests on two slots: the loop queues, admits as slots free,
    and every reply is exactly greedy — with speculative verify steps
    too (repeated-phrase prompts, so drafts hit)."""
    jm, variables, tm = pair
    n = 5
    rng = np.random.default_rng(21)
    ids = np.stack([np.tile(rng.integers(1, 512, 4), 3)[:9]
                    for _ in range(n)]).astype(np.int32)
    refs = J.generate(jm, variables, ids, max_new_tokens=10)
    srv = _server(tm, f"pt-conc-{spec}", spec_draft_len=spec)
    results = {}

    def call(i):
        results[i] = _post(srv.url, {"ids": _ids(ids[i]),
                                     "max_new_tokens": 10,
                                     "stream": i % 2 == 1})
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i in range(n):
            status, body, _ = results[i]
            assert status == 200
            last = json.loads(body.splitlines()[-1])
            assert last["ids"] == _ids(refs[i])
        if spec:
            assert srv.engine.spec_steps > 0
    finally:
        srv.close()


def test_streaming_tokens_chunked(pair):
    jm, variables, tm = pair
    ids = _prompts(1, 7, 22)
    ref = _ids(J.generate(jm, variables, ids, max_new_tokens=6)[0])
    srv = _server(tm, "pt-stream")
    try:
        status, body, headers = _post(srv.url, {
            "ids": _ids(ids[0]), "max_new_tokens": 6, "stream": True})
        assert status == 200
        assert headers.get("Transfer-Encoding") == "chunked"
        lines = [json.loads(ln) for ln in body.splitlines() if ln]
        assert [ln["token"] for ln in lines[:-1]] == ref
        assert lines[-1] == {"ids": ref, "done": True}
    finally:
        srv.close()


def test_prompt_text_with_tokenizer(pair):
    from synapseml_tpu.models.dl.tokenizer import WordTokenizer as JTok
    from synapseml_tpu.serving import LLMServer as JServer
    from synapseml_tpu_torch.models.dl.tokenizer import WordTokenizer
    jm, variables, tm = pair
    corpus = ["the cat sat on the mat"] * 4
    jsrv = JServer(jm, variables, tokenizer=JTok.fit(corpus, vocab_size=512),
                   n_slots=2, max_len=64, engine_kwargs={"name": "pt-tok-j"})
    srv = _server(tm, "pt-tok",
                  tokenizer=WordTokenizer.fit(corpus, vocab_size=512))
    try:
        req = {"prompt": "the cat", "max_new_tokens": 4}
        status, body, _ = _post(srv.url, req)
        assert status == 200
        out = json.loads(body)
        assert len(out["ids"]) == 4 and isinstance(out["completion"], str)
        assert out == json.loads(_post(jsrv.url, req)[1])
    finally:
        srv.close()
        jsrv.close()


def test_unparseable_request_400_isolated(pair):
    jm, variables, tm = pair
    srv = _server(tm, "pt-400")
    try:
        for bad in ({"nonsense": 1}, {"ids": []},
                    {"session": "s", "resume": True}):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(srv.url, bad)
            assert exc.value.code == 400
            if "resume" in bad:
                # a resume without a journal is a request without ids
                assert b'request needs \\"ids\\"' in exc.value.read()
        ids = _prompts(1, 7, 23)
        ref = J.generate(jm, variables, ids, max_new_tokens=2)[0]
        status, body, _ = _post(srv.url, {"ids": _ids(ids[0]),
                                          "max_new_tokens": 2})
        assert status == 200 and json.loads(body)["ids"] == _ids(ref)
    finally:
        srv.close()


def test_slo_shed_503_with_retry_after(pair):
    """One slot, one long sequence: a queued request whose projected TTFT
    exceeds the SLO answers 503 + Retry-After; the in-flight one is
    unaffected."""
    _, _, tm = pair
    ids = _prompts(2, 7, 24)
    srv = _server(tm, "pt-slo", n_slots=1, max_len=96, ttft_slo_s=0.01)
    _slow_steps(srv)
    results = {}

    def long_call():
        results["long"] = _post(srv.url, {"ids": _ids(ids[0]),
                                          "max_new_tokens": 60})
    try:
        t = threading.Thread(target=long_call)
        t.start()
        deadline = time.monotonic() + 10
        while srv.engine.steps_run < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv.engine.active_count == 1
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"ids": _ids(ids[1]), "max_new_tokens": 4})
        assert exc.value.code == 503
        assert float(exc.value.headers["Retry-After"]) > 0
        t.join(timeout=30)
        assert results["long"][0] == 200
        assert get_registry().get("llm_sheds_total").value(
            api="/generate", reason="slo", tenant="default") >= 1
    finally:
        srv.close()


def test_drain_zero_drop_and_new_work_shed(pair):
    jm, variables, tm = pair
    ids = _prompts(1, 7, 25)
    ref = J.generate(jm, variables, ids, max_new_tokens=40)[0]
    srv = _server(tm, "pt-drain", max_len=96)
    _slow_steps(srv, 0.002)
    results = {}

    def call():
        results["r"] = _post(srv.url, {"ids": _ids(ids[0]),
                                       "max_new_tokens": 40})
    t = threading.Thread(target=call)
    t.start()
    deadline = time.monotonic() + 10
    while srv.engine.active_count == 0 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert srv.engine.active_count == 1
    url = srv.url
    try:
        assert srv.drain(timeout_s=30) is True
        t.join(timeout=30)
        status, body, _ = results["r"]
        assert status == 200 and json.loads(body)["ids"] == _ids(ref)
        with pytest.raises(Exception):
            _post(url, {"ids": [1, 2, 3]}, timeout=2)
    finally:
        srv.close()


def test_drain_sheds_new_requests_with_retry_after(pair):
    """While draining, a new request on an open connection answers 503 +
    Retry-After and /readyz answers 503 "draining"."""
    _, _, tm = pair
    srv = _server(tm, "pt-drain2")
    try:
        srv.server.health.begin_drain()
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"ids": [1, 2, 3], "max_new_tokens": 2})
        assert exc.value.code == 503 and "Retry-After" in exc.value.headers
        status, body, _ = _get(srv.server.url_for("/readyz"))
        assert status == 503 and json.loads(body)["status"] == "draining"
    finally:
        srv.close()


def test_stream_client_disconnect_frees_slot(pair):
    _, _, tm = pair
    ids = _prompts(1, 7, 28)
    srv = _server(tm, "pt-disc", n_slots=1, max_len=96)
    _slow_steps(srv)
    try:
        body = json.dumps({"ids": _ids(ids[0]), "max_new_tokens": 80,
                           "stream": True}).encode()
        host, port = srv.server.address
        s = socket.create_connection((host, port), timeout=10)
        s.sendall((f"POST /generate HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        s.recv(256)                     # the stream is flowing
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        deadline = time.monotonic() + 10
        while srv.engine.active_count and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.engine.active_count == 0
        assert get_registry().get("llm_evictions_total").value(
            engine="pt-disc", reason="cancelled", tenant="default") == 1.0
    finally:
        srv.close()


def test_engine_failure_does_not_kill_loop(pair):
    jm, variables, tm = pair
    ids = _prompts(2, 7, 27)
    srv = _server(tm, "pt-boom")
    try:
        real = srv.engine.step
        state = {"armed": True}

        def boom():
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("kaboom")
            return real()
        srv.engine.step = boom
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"ids": _ids(ids[0]), "max_new_tokens": 5})
        assert exc.value.code == 500 and b"kaboom" in exc.value.read()
        ref = J.generate(jm, variables, ids[1:2], max_new_tokens=4)[0]
        status, body, _ = _post(srv.url, {"ids": _ids(ids[1]),
                                          "max_new_tokens": 4})
        assert status == 200 and json.loads(body)["ids"] == _ids(ref)
    finally:
        srv.close()


def test_expired_reply_window_cancels_slot(pair):
    """A request admitted into a slot whose reply window then expires is
    cancelled out of its slot.  The decode steps wait until the client
    has its 504, so the sequence is still decoding when its window
    ends; the window is long enough that a loaded host admits the
    request before it ends (an expiry in the queue cancels no slot)."""
    _, _, tm = pair
    ids = _prompts(1, 7, 26)
    srv = _server(tm, "pt-exp", n_slots=1, max_len=96,
                  reply_timeout_s=0.5)
    answered = threading.Event()
    real = srv.engine.step

    def step():
        assert answered.wait(30)
        return real()
    srv.engine.step = step
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"ids": _ids(ids[0]), "max_new_tokens": 80})
        answered.set()
        assert exc.value.code == 504
        deadline = time.monotonic() + 5
        while srv.engine.active_count and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.engine.active_count == 0
        assert get_registry().get("llm_evictions_total").value(
            engine="pt-exp", reason="cancelled", tenant="default") == 1.0
    finally:
        answered.set()
        srv.close()


def test_background_warmup_readyz_503_then_200(pair, monkeypatch):
    """``warmup="background"``: the constructor returns at once, /readyz
    answers 503 "warming" (with the plane's snapshot and a Retry-After)
    and a request waits in queue until the plane is warm; then /readyz
    answers 200 and the request is answered exactly."""
    jm, variables, tm = pair
    gate = threading.Event()
    real = PW.program_lattice

    def lattice(engine):
        specs = real(engine)
        run = specs[0].run

        def held(plane):
            assert gate.wait(30)
            return run(plane)
        specs[0].run = held
        return specs
    monkeypatch.setattr(PW, "program_lattice", lattice)
    srv = _server(tm, "pt-warm", warmup="background")
    ids = _prompts(1, 7, 29)
    ref = J.generate(jm, variables, ids, max_new_tokens=5)[0]
    results = {}
    try:
        status, body, headers = _get(srv.server.url_for("/readyz"))
        payload = json.loads(body)
        assert status == 503 and payload["status"] == "warming"
        assert payload["warmup"]["state"] == "warming"
        assert "Retry-After" in headers
        t = threading.Thread(target=lambda: results.setdefault(
            "r", _post(srv.url, {"ids": _ids(ids[0]),
                                 "max_new_tokens": 5})))
        t.start()
        time.sleep(0.1)
        assert "r" not in results and srv.engine.admissions == 0
        gate.set()
        assert srv.engine.compile_plane.wait(60)
        status, body, _ = _get(srv.server.url_for("/readyz"))
        assert status == 200 and json.loads(body)["status"] == "ready"
        t.join(timeout=30)
        assert json.loads(results["r"][1])["ids"] == _ids(ref)
        assert srv.engine.compile_plane.stalls == 0
    finally:
        gate.set()
        srv.close()


def test_tunez_answers_501_and_unported_knobs_raise(pair):
    """``GET /tunez`` is ported: 200 with a snapshot that passes
    ``check_tunez`` and lists the engine's consults, and a prefill pool
    is bound (the name predates the port of the tuning table and of the
    pool)."""
    from synapseml_tpu_torch.telemetry.tunetable import (
        TunePlane, check_tunez, set_tuneplane)
    _, _, tm = pair
    prev = set_tuneplane(TunePlane(directory=None))
    try:
        srv = _server(tm, "pt-tunez")
        try:
            status, body, _ = _get(srv.server.url_for("/tunez"))
            assert status == 200
            snap = json.loads(body)
            check_tunez(snap)
            assert {(c["site"], c["outcome"]) for c in snap["consults"]} \
                >= {("SlotEngine", "disabled")}
            status, body, _ = _get(srv.server.url_for(
                "/tunez?space=llm_bucket_grid"))
            assert status == 200 and {
                c["space"] for c in json.loads(body)["consults"]} == {
                    "llm_bucket_grid"}
            assert _get(srv.server.url_for("/healthz"))[0] == 200
        finally:
            srv.close()
    finally:
        set_tuneplane(prev)
    # the one knob this test once held refused, prefill_pool, is ported:
    # the server binds the pool to its arena and its @phase=prefill plane
    from synapseml_tpu_torch.serving import PrefillPool
    from synapseml_tpu_torch.telemetry.slo import phase_plane_name
    pool = PrefillPool(name="pt-tunez-pool")
    srv = _server(tm, "pt-tunez-pool", api_path="/pt-tunez-pool",
                  kv_arena_bytes=1 << 20, prefill_pool=pool, ttft_slo_s=2.0)
    try:
        assert srv.prefill_pool is pool and pool.arena is srv.kv_arena
        assert pool.slo.name == phase_plane_name("/pt-tunez-pool", "prefill")
        assert pool.slo.snapshot()["slo"]["ttft"]["threshold_s"] == 2.0
    finally:
        srv.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLMServer(tm)


def test_reserved_paths_equal_reference(pair):
    from synapseml_tpu.serving import server as JS
    from synapseml_tpu_torch.serving import server as PS
    assert PS.RESERVED_GET_PATHS == JS.RESERVED_GET_PATHS
    assert (PS.TRACE_HEADER_CANONICAL, PS.TENANT_HEADER_CANONICAL) == (
        JS.TRACE_HEADER_CANONICAL, JS.TENANT_HEADER_CANONICAL)
    srv = _server(pair[2], "pt-paths")
    try:
        for path in PS.RESERVED_GET_PATHS:
            assert srv.server._reserved_handler(path) is not None, path
        assert srv.server._reserved_handler("/generate") is None
    finally:
        srv.close()


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? ')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _families(text, names):
    """Prometheus text → {(family, label keys, labels other than the
    per-server names)} over the samples labelled with one of ``names``.
    The ``backend`` value is left out: ``'auto'`` resolves to the dense
    read in the JAX package off a TPU and to the paged read (K3's plain
    version) in the port."""
    out = set()
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if not m or line.startswith("#"):
            continue
        labels = dict(_LABEL.findall(m.group(2) or ""))
        if not set(labels.values()) & set(names):
            continue
        out.add((m.group(1), tuple(sorted(labels)),
                 tuple(sorted((k, v) for k, v in labels.items()
                              if v not in names
                              and k not in ("le", "backend")))))
    return out


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return type(obj).__name__


def test_observability_matches_reference(pair):
    """The same two requests (one streamed) through the JAX LLMServer and
    the port's: /metrics carries the same families and labels, /sloz the
    same plane JSON keys, /tracez the same timeline events and keys."""
    from synapseml_tpu.serving import LLMServer as JServer
    jm, variables, tm = pair
    ids = _prompts(2, 7, 30)
    views = []
    for side, name in (("j", "pt-obs-j"), ("p", "pt-obs-p")):
        kw = dict(n_slots=2, max_len=64, api_path=f"/{name}",
                  ttft_slo_s=30.0, token_slo_s=10.0,
                  engine_kwargs={"name": name})
        srv = (JServer(jm, variables, **kw) if side == "j"
               else LLMServer(tm, device="cpu", **kw))
        try:
            for i in range(2):
                _post(srv.url, {"ids": _ids(ids[i]), "max_new_tokens": 4,
                                "stream": i == 1})
            srv._loop._slo_export_at = 0.0
            time.sleep(0.05)              # one more tick exports the SLO
            metrics = _get(srv.server.url_for("/metrics"))[1].decode()
            sloz = json.loads(_get(srv.server.url_for("/sloz"))[1])
            tracez = json.loads(_get(srv.server.url_for("/tracez"))[1])
        finally:
            srv.close()
        names = {name, f"/{name}"}
        plane = sloz["planes"][f"/{name}"]
        traces = [tr for tr in tracez["traces"]
                  if tr.get("attrs", {}).get("api") == f"/{name}"
                  or tr.get("api") == f"/{name}"]
        views.append((_families(metrics, names), _keys(plane),
                      sorted(_keys(sloz)), traces))
    (jfam, jplane, jtop, jtr), (pfam, pplane, ptop, ptr) = views
    assert pfam == jfam and len(pfam) > 10
    assert pplane == jplane and ptop == jtop
    assert len(ptr) == len(jtr) == 2
    for a, b in zip(jtr, ptr):
        assert _keys(b) == _keys(a)
        assert [e["name"] for e in b["events"]] == \
            [e["name"] for e in a["events"]]
