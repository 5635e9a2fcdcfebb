"""The port's pipeline servers on the CPU: ``PipelineServer`` over a
fitted model, the continuous (framed) client, ``MultiPipelineServer``'s
named APIs, and the row guard's serving face (a poison record 500s
itself, an unparseable one 400s itself, a guarded model's dropped rows
422 through provenance, a preemption sheds the batch with 503, an OOM
halves it).  One test sends the same requests to the JAX package's
``PipelineServer`` over a GBDT and to the port's over the same booster
carried across as LightGBM text: statuses equal, bodies within the GBDT
parity tolerance.

Every server is closed in ``finally`` and every client call has a
timeout of at most 10 s.
"""

import asyncio
import concurrent.futures
import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from synapseml_tpu_torch.core import Dataset, PipelineModel, Transformer
from synapseml_tpu_torch.core.params import FloatParam, PyObjectParam
from synapseml_tpu_torch.models.gbdt.estimators import (
    GBDTClassificationModel, GBDTClassifier)
from synapseml_tpu_torch.resilience import get_faults
from synapseml_tpu_torch.resilience.faults import PreemptionError
from synapseml_tpu_torch.resilience.rowguard import (isolation_budget,
                                                     reset_safe_batch,
                                                     safe_batch_size)
from synapseml_tpu_torch.serving import (ContinuousClient,
                                         MultiPipelineServer, PipelineServer,
                                         ServingRequest, ServingServer)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

TIMEOUT = 10


def _post(url, body, timeout=TIMEOUT):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _features(req):
    return {"features": np.asarray(req.json()["features"], np.float32)}


@pytest.fixture(scope="module")
def gbdt():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    model = GBDTClassifier(numIterations=8, device="cpu").fit(
        Dataset({"features": list(x), "label": y}))
    return x, y, model


@pytest.fixture
def faults():
    reg = get_faults()
    reg.clear()
    reg.seed(20260803)
    reg.no_sleep = True
    yield reg
    reg.clear()


class _Doubler:
    """Trivial duck-typed model: the tests measure the serving path."""

    def __init__(self, poison=None):
        self.poison = poison

    def transform(self, ds):
        x = np.asarray([float(v) for v in ds["x"]])
        if self.poison is not None and (x == self.poison).any():
            raise ValueError(f"poison record {self.poison}")
        return Dataset({"x": ds["x"], "prediction": 2.0 * x})


class _Scale(Transformer):
    factor = FloatParam(doc="scale", default=2.0)

    def _transform(self, ds):
        return ds.with_column(
            "prediction", np.asarray(ds["x"], np.float64) * self.factor)


class _Udf(Transformer):
    """inputCol x → outputCol prediction through ``udf`` (declares
    inputCol, so the row guard's NaN screen applies)."""
    from synapseml_tpu_torch.core.params import StringParam as _S
    inputCol = _S(doc="input", default="x")
    udf = PyObjectParam(doc="vectorized function")
    del _S

    def _transform(self, ds):
        return ds.with_column("prediction", self.get("udf")(ds["x"]))


def _nan_intolerant(**kw):
    def udf(x):
        x = np.asarray(x, np.float64)
        if not np.isfinite(x).all():
            raise ValueError("non-finite value in batch")
        return x * 2.0
    return _Udf(udf=udf, **kw)


class _Slow(Transformer):
    delay = FloatParam(doc="seconds a batch takes", default=0.25)

    def _transform(self, ds):
        time.sleep(self.delay)
        return ds.with_column("prediction",
                              np.asarray(ds["x"], np.float64))


# --------------------------------------------------------------------------


class TestPipelineServer:
    def test_gbdt_served_equals_transform(self, gbdt):
        x, _, model = gbdt
        ps = PipelineServer(model, _features, output_col="probability",
                            batch_timeout_s=0.05)
        try:
            for i in range(4):
                status, body = _post(ps.url, json.dumps(
                    {"features": x[i].tolist()}).encode())
                assert status == 200
                want = model.transform(Dataset(
                    {"features": [x[i]]}))["probability"][0]
                np.testing.assert_array_equal(
                    json.loads(body)["prediction"], want)
        finally:
            ps.close()

    @pytest.mark.parametrize("workers", [1, 2])
    def test_batched_replies_equal_one_transform(self, gbdt, workers):
        """64 concurrent records through micro-batches (and two worker
        threads calling ``transform`` at once) give what one
        ``transform`` over the same rows gives."""
        x, _, model = gbdt
        want = model.transform(Dataset({"features": list(x[:64])}))
        ps = PipelineServer(model, _features, output_col="rawPrediction",
                            batch_size=8, batch_timeout_s=0.01,
                            num_workers=workers)
        try:
            with concurrent.futures.ThreadPoolExecutor(16) as pool:
                got = list(pool.map(lambda i: _post(ps.url, json.dumps(
                    {"features": x[i].tolist()}).encode()), range(64)))
        finally:
            ps.close()
        assert [s for s, _ in got] == [200] * 64
        for i, (_, body) in enumerate(got):
            np.testing.assert_array_equal(json.loads(body)["prediction"],
                                          want["rawPrediction"][i])
        assert ps._loop.timings["records"] >= 64

    def test_serving_error_returns_500(self):
        class Boom:
            def transform(self, ds):
                raise RuntimeError("kaboom")

        ps = PipelineServer(Boom(), lambda r: {"x": 1.0},
                            batch_timeout_s=0.05)
        try:
            status, body = _post(ps.url, b"{}")
            assert status == 500 and b"kaboom" in body
        finally:
            ps.close()


class TestContinuousServing:
    def _server(self, **kw):
        return PipelineServer(_Doubler(), lambda r: {"x": r.json()["x"]},
                              batch_timeout_s=0.01, **kw)

    def test_frames_ordered_roundtrip(self):
        ps = self._server()
        try:
            host, port = ps.server.address
            with ContinuousClient(host, port, "/",
                                  timeout_s=TIMEOUT) as c:
                replies = c.request_many(
                    [json.dumps({"x": float(i)}).encode()
                     for i in range(200)], window=64)
            assert len(replies) == 200
            for i, (status, body) in enumerate(replies):
                assert status == 200
                assert json.loads(body)["prediction"] == 2.0 * i
            status, body = _post(ps.url, json.dumps({"x": 7.0}).encode())
            assert status == 200 and json.loads(body)["prediction"] == 14.0
        finally:
            ps.close()

    def test_frames_marginal_latency(self):
        """Pipelined records cost a framed read each, far below one HTTP
        exchange.  The bound is loose for a shared host; the measured
        value prints."""
        ps = self._server()
        try:
            host, port = ps.server.address
            with ContinuousClient(host, port, "/",
                                  timeout_s=TIMEOUT) as c:
                c.request(b'{"x": 0.0}')
                n = 512
                t0 = time.perf_counter()
                replies = c.request_many(
                    [json.dumps({"x": float(i)}).encode()
                     for i in range(n)], window=128)
                dt = time.perf_counter() - t0
                t1 = time.perf_counter()
                c.request(b'{"x": 1.0}')
                solo = time.perf_counter() - t1
            assert len(replies) == n
            marginal_ms = dt / n * 1e3
            print(f"\ncontinuous marginal {marginal_ms:.3f} ms/record "
                  f"(solo RTT {solo * 1e3:.2f} ms)")
            assert marginal_ms < 5.0, marginal_ms
        finally:
            ps.close()

    def test_frames_backpressure_and_timeout(self):
        srv = ServingServer(max_queue=2, reply_timeout_s=0.3)
        try:
            host, port = srv.address
            with ContinuousClient(host, port, "/",
                                  timeout_s=TIMEOUT) as c:
                for _ in range(5):
                    c.send(b"{}")
                statuses = [c.recv()[0] for _ in range(5)]
            assert statuses == [504, 504, 503, 503, 503]
        finally:
            srv.close()

    def test_upgrade_unknown_path_404(self):
        srv = ServingServer(api_path="/model")
        try:
            host, port = srv.address
            with pytest.raises(ConnectionError, match="404"):
                ContinuousClient(host, port, "/other", timeout_s=TIMEOUT)
        finally:
            srv.close()

    @pytest.mark.fault
    def test_reconnects_once_and_resends_the_unanswered(self, faults):
        ps = self._server()
        try:
            host, port = ps.server.address
            with ContinuousClient(host, port, "/",
                                  timeout_s=TIMEOUT) as c:
                faults.inject("continuous.recv", "reset", times=1)
                replies = c.request_many(
                    [json.dumps({"x": float(i)}).encode()
                     for i in range(20)], window=8)
            assert [json.loads(b)["prediction"] for _, b in replies] == \
                [2.0 * i for i in range(20)]
        finally:
            ps.close()


class TestMultiPipelineServer:
    def test_two_apis_routed_concurrently(self):
        parse = lambda r: {"x": float(r.json()["x"])}  # noqa: E731
        srv = MultiPipelineServer({
            "/double": {"model": _Scale(factor=2.0), "input_parser": parse},
            "/triple": {"model": _Scale(factor=3.0), "input_parser": parse},
        })
        host, port = srv.server.address
        try:
            async def call(i):
                api = "/double" if i % 2 == 0 else "/triple"
                t0 = time.perf_counter()
                reader, writer = await asyncio.open_connection(host, port)
                body = json.dumps({"x": i}).encode()
                writer.write((f"POST {api} HTTP/1.1\r\nHost: x\r\n"
                              "Content-Type: application/json\r\n"
                              f"Content-Length: {len(body)}\r\n"
                              "Connection: close\r\n\r\n").encode() + body)
                await writer.drain()
                data = await asyncio.wait_for(reader.read(), TIMEOUT)
                writer.close()
                status = int(data.split(b" ", 2)[1])
                payload = json.loads(data.split(b"\r\n\r\n", 1)[1])
                return i, status, payload["prediction"], \
                    time.perf_counter() - t0

            async def wave():
                return await asyncio.gather(*[call(i) for i in range(64)])

            asyncio.run(wave())
            results = asyncio.run(wave())
            for i, status, pred, _ in results:
                assert status == 200
                assert pred == (i * 2.0 if i % 2 == 0 else i * 3.0), i
            lat = sorted(r[3] for r in results)
            print(f"[serving load] n=64 p50={lat[32] * 1e3:.1f}ms "
                  f"p99={lat[63] * 1e3:.1f}ms")
        finally:
            srv.close()

    @pytest.mark.parametrize("case", ["queue_wait", "queue_full"])
    def test_overload_sheds_with_503(self, case):
        spec = {"model": _Slow(delay=0.25 if case == "queue_wait" else 0.3),
                "input_parser": lambda r: {"x": float(r.json()["x"])},
                "batch_size": 1}
        spec.update({"num_workers": 1, "max_queue_wait_s": 0.3}
                    if case == "queue_wait" else {"max_queue": 2})
        srv = MultiPipelineServer({"/slow": spec})
        n = 10 if case == "queue_wait" else 12
        try:
            def call(i):
                t0 = time.perf_counter()
                status, _ = _post(srv.url_for("/slow"),
                                  json.dumps({"x": i}).encode())
                return status, time.perf_counter() - t0

            with concurrent.futures.ThreadPoolExecutor(n) as pool:
                results = list(pool.map(call, range(n)))
            codes = [c for c, _ in results]
            assert 200 in codes and 503 in codes, codes
            if case == "queue_wait":
                assert codes.count(503) >= 4, codes
                assert max(t for _, t in results) < 1.5
        finally:
            srv.close()

    def test_unknown_path_404(self):
        srv = MultiPipelineServer({
            "/a": {"model": _Scale(), "input_parser": lambda r: {"x": 1.0}}})
        try:
            assert _post(srv.url_for("/nope"), b"{}")[0] == 404
            assert _post(srv.url_for("/a"), b"{}")[0] == 200
        finally:
            srv.close()


def _reqs(n):
    return [ServingRequest(id=f"r{i}", method="POST", path="/", headers={},
                           body=b"") for i in range(n)]


def _capture(ps):
    replies = {}
    ps._loop.api.reply = lambda rid, rep: replies.__setitem__(rid, rep)
    return replies


class TestServingIsolation:
    def test_poison_record_500s_only_itself(self):
        ps = PipelineServer(_Doubler(poison=13.0),
                            lambda r: {"x": float(r.json()["x"])},
                            batch_timeout_s=0.05, batch_size=8)
        try:
            results = {}

            def call(i):
                results[i] = _post(ps.url, json.dumps({"x": i}).encode())

            threads = [threading.Thread(target=call, args=(i,))
                       for i in (11, 12, 13, 14)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert results[13][0] == 500 and b"poison" in results[13][1]
            for i in (11, 12, 14):
                status, body = results[i]
                assert status == 200, (i, body)
                assert json.loads(body)["prediction"] == 2.0 * i
        finally:
            ps.close()

    def test_unparseable_record_400s_only_itself(self):
        ps = PipelineServer(_Doubler(),
                            lambda r: {"x": float(r.json()["x"])},
                            batch_timeout_s=0.05)
        try:
            status, body = _post(ps.url, b"{not json")
            assert status == 400 and b"unparseable" in body
            status, body = _post(ps.url, json.dumps({"x": 4}).encode())
            assert status == 200 and json.loads(body)["prediction"] == 8.0
        finally:
            ps.close()

    @pytest.mark.parametrize("mode", ["skip", "quarantine"])
    def test_guarded_model_drops_align_via_provenance(self, mode, tmp_path):
        model = PipelineModel(stages=[_nan_intolerant()], handleInvalid=mode,
                              quarantineDir=str(tmp_path))
        ps = PipelineServer(model, lambda r: {"x": float(r.json()["x"])},
                            batch_timeout_s=0.05)
        replies = _capture(ps)
        try:
            rows = [{"x": float(i)} for i in range(5)]
            rows[2]["x"] = float("nan")
            assert ps._loop._transform_reply(_reqs(5), rows) == 4
            assert replies["r2"].status == 422
            for i in (0, 1, 3, 4):
                assert replies[f"r{i}"].status == 200
                assert json.loads(replies[f"r{i}"].body)["prediction"] \
                    == 2.0 * i
        finally:
            ps.close()

    def test_batch_independent_failure_bounded_isolation(self):
        calls = []

        class _Broken:
            def transform(self, ds):
                calls.append(ds.num_rows)
                raise RuntimeError("model is broken")

        ps = PipelineServer(_Broken(), lambda r: {"x": 1.0},
                            batch_timeout_s=0.05)
        replies = _capture(ps)
        try:
            n = 64
            assert ps._loop._transform_reply(
                _reqs(n), [{"x": float(i)} for i in range(n)]) == 0
            assert len(calls) <= 4 * math.ceil(math.log2(n)) + 16
            assert len(replies) == n
            assert all(r.status == 500 for r in replies.values())
        finally:
            ps.close()

    def test_preemption_sheds_batch_without_bisection(self):
        calls = []

        class _Preempted:
            def transform(self, ds):
                calls.append(ds.num_rows)
                raise PreemptionError("evicted")

        ps = PipelineServer(_Preempted(), lambda r: {"x": 1.0},
                            batch_timeout_s=0.05)
        replies = _capture(ps)
        try:
            assert ps._loop._transform_reply(_reqs(8), [{"x": 1.0}] * 8) == 0
            assert calls == [8]
            assert len(replies) == 8
            assert all(r.status == 503 for r in replies.values())
        finally:
            ps.close()

    @pytest.mark.fault
    def test_oom_bisects_batch_and_remembers_safe_size(self, faults):
        ps = PipelineServer(_Doubler(),
                            lambda r: {"x": float(r.json()["x"])},
                            batch_timeout_s=0.05, batch_size=64)
        faults.inject("oom", "oom", when=lambda c: str(c["key"]).startswith(
            "serving:") and c["batch"] > 2)
        replies = _capture(ps)
        try:
            assert ps._loop._transform_reply(
                _reqs(8), [{"x": float(i)} for i in range(8)]) == 8
            assert all(r.status == 200 for r in replies.values())
            assert safe_batch_size(ps._loop._oom_key, 64) <= 4
        finally:
            reset_safe_batch()
            ps.close()

    @pytest.mark.fault
    @pytest.mark.parametrize("where", ["served_model", "guarded_stage"])
    def test_poison_row_fault_isolates_exactly_its_records(self, faults,
                                                           where):
        """The ``rowguard.poison_row`` site armed on 3 of 64 records.  At
        the served model's boundary (the model consults the site over
        the records' ids) the serving loop's halving answers exactly
        those 3 with 500 within its isolation budget; inside a stage
        under ``handleInvalid="skip"`` the stage's own guard drops them
        and the loop answers them 422 through provenance.  The 61
        others answer 200 either way."""
        poison = {5, 17, 40}
        faults.inject("rowguard.poison_row", "poison",
                      when=lambda c: bool(poison & set(
                          int(r) for r in c["rows"])))
        calls = []

        class _Sited:
            def transform(self, ds):
                calls.append(ds.num_rows)
                get_faults().raise_point("rowguard.poison_row",
                                         stage="served", rows=ds["id"],
                                         n=ds.num_rows)
                return ds.with_column("prediction",
                                      np.asarray(ds["x"], np.float64) * 2)

        model = (_Sited() if where == "served_model" else
                 _Udf(udf=lambda v: np.asarray(v, np.float64) * 2.0,
                      handleInvalid="skip"))
        ps = PipelineServer(model, lambda r: r.json(), batch_timeout_s=0.05)
        replies = _capture(ps)
        try:
            ps._loop._transform_reply(
                _reqs(64), [{"x": float(i), "id": i} for i in range(64)])
            bad = {int(k[1:]) for k, r in replies.items() if r.status != 200}
            assert bad == poison and len(replies) == 64
            want = 500 if where == "served_model" else 422
            assert {replies[f"r{i}"].status for i in poison} == {want}
            for i in set(range(64)) - poison:
                assert json.loads(replies[f"r{i}"].body)["prediction"] \
                    == 2.0 * i
            if where == "served_model":
                assert len(calls) <= isolation_budget(64)
        finally:
            ps.close()


def test_requests_answer_as_the_reference_server(tmp_path):
    """The same requests (clean, unparseable, poison, queue-wait shed,
    unknown path) to the JAX package's PipelineServer over a CPU GBDT and
    to the port's over the same booster (LightGBM text, device="cpu"):
    equal statuses, equal error bodies, margins within 1e-6."""
    from synapseml_tpu.core.dataset import Dataset as JDataset
    from synapseml_tpu.models.gbdt import GBDTClassifier as JGBDT
    from synapseml_tpu.serving import PipelineServer as JPipelineServer

    rng = np.random.default_rng(11)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    jmodel = JGBDT(numIterations=10).fit(JDataset({"features": list(x),
                                                   "label": y}))
    tmodel = GBDTClassificationModel.load_native_model_from_string(
        jmodel.get_model_string(), device="cpu")

    def body(i):
        return json.dumps({"features": x[i].tolist()}).encode()

    seq = ([("/model", body(i)) for i in range(8)]
           + [("/model", b"{not json"),
              ("/model", json.dumps({"features": [1.0, 2.0, 3.0]}).encode()),
              ("/nope", body(0)), ("/shed", body(1))])
    answers = {}
    for name, cls, model in (("jax", JPipelineServer, jmodel),
                             ("torch", PipelineServer, tmodel)):
        main = cls(model, _features, output_col="rawPrediction",
                   api_path="/model", batch_timeout_s=0.01)
        shed = cls(model, _features, output_col="rawPrediction",
                   api_path="/shed", batch_timeout_s=0.01,
                   max_queue_wait_s=0.0)
        try:
            out = []
            for path, b in seq:
                srv = shed if path == "/shed" else main
                out.append(_post(srv.server.url_for(path), b))
            answers[name] = out
        finally:
            main.close()
            shed.close()
    jans, tans = answers["jax"], answers["torch"]
    assert [s for s, _ in tans] == [s for s, _ in jans] == \
        [200] * 8 + [400, 500, 404, 503]
    for (ts, tb), (js, jb) in zip(tans, jans):
        if ts == 200:
            np.testing.assert_allclose(json.loads(tb)["prediction"],
                                       json.loads(jb)["prediction"],
                                       rtol=0, atol=1e-6)
        else:
            assert json.loads(tb) == json.loads(jb)


def test_phase23_runs_small_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 23 end to end at a small size on the CPU
    (a 2-layer BERT classifier, 20,000 CSV rows): every check of 23a-e
    holds, the native parser read the CSV, and nothing raised."""
    import os
    import torch
    import chip_smoke as cs
    from synapseml_tpu_torch.models.onnx import zoo
    sd = cs.random_bert_state_dict(0, vocab_size=500, d_model=64,
                                   num_layers=2, intermediate=256,
                                   num_labels=2)
    payload = zoo.build_bert_classifier(sd, num_layers=2, num_heads=4,
                                        seq_len=16)
    runs = {}
    res = cs.serving_paths(
        0, torch.device("cpu"), "cpu",
        dict(payload=payload, seq=16, vocab=500), runs.__setitem__,
        n_rows=20_000, iters=20, n_lenient=5_000, n_card_cpu=256,
        threads=8, per_thread=32, n_frames=256, n_bert=128, n_nan=400,
        root=str(tmp_path / "p23"))
    assert runs["phase23"]["rows"] == 20_000
    assert res["b"]["parser"] == "native" and res["b"]["quarantined"] == 50
    assert res["a"]["labels_equal"] and res["c"]["walk"]["equal"]
    assert res["e"]["poison_row"]["status_500"] == [7, 30, 51]
    assert res["e"]["preemption"]["transforms"] == 1
    assert not os.path.exists(tmp_path / "p23")
