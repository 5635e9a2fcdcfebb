"""The port's servers on the card.  ``LLMServer``: replies over HTTP from
an engine on the card, against the same server on the CPU at f32
(token-exact), through background warm-up and the CUDA graphs of the
compile plane, with K3 launched on every decode and verify step.
``PipelineServer``: a GBDT fitted on the card served against the same
booster on the CPU, and a real CUDA out-of-memory error halving a served
batch.  Marked ``gpu``: every test skips where no card is present.  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_serving_cuda.py
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models.llm import LlamaConfig, LlamaModel
from synapseml_tpu_torch.serving import LLMServer
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().splitlines()[-1])["ids"]


def _readyz(srv):
    try:
        with urllib.request.urlopen(srv.server.url_for("/readyz"),
                                    timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _serve(srv, prompts, new):
    """Post every prompt concurrently (odd ones streamed) → replies."""
    out = {}

    def call(i):
        out[i] = _post(srv.url, {"ids": [int(t) for t in prompts[i]],
                                 "max_new_tokens": new,
                                 "stream": i % 2 == 1})
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return [out[i] for i in range(len(prompts))]


@pytest.mark.parametrize("spec", [0, 4])
def test_server_on_card_equals_cpu(dev, spec):
    cfg = LlamaConfig.tiny(num_layers=2, max_len=128, dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [np.tile(rng.integers(1, 512, 5), 6)[:n].astype(np.int32)
               for n in (9, 17, 30, 12, 5, 21)]
    replies = {}
    start = LlamaModel(cfg, device="cpu", seed=3).state_dict()
    for where in ("cpu", "cuda"):
        model = LlamaModel(cfg, device=where)
        model.load_state_dict(start)
        srv = LLMServer(model, n_slots=4, max_len=128, device=where,
                        spec_draft_len=spec, warmup="background",
                        engine_kwargs={"name": f"cuda-{where}-{spec}"})
        try:
            assert srv.engine.compile_plane.wait(300)
            assert _readyz(srv) == 200
            launches.reset()
            replies[where] = _serve(srv, prompts, 16)
            if where == "cuda":
                assert launches.total("paged_decode_attention") > 0
                plane = srv.engine.compile_plane
                assert plane.stalls == 0
                assert plane.replays == srv.engine.steps_run > 0
        finally:
            srv.close()
    assert replies["cuda"] == replies["cpu"]


def test_readyz_503_while_warming_on_card(dev):
    cfg = LlamaConfig.tiny(num_layers=2, max_len=256, dtype=torch.bfloat16)
    model = LlamaModel(cfg, device=dev, seed=1)
    t0 = time.perf_counter()
    srv = LLMServer(model, n_slots=8, max_len=256, device="cuda",
                    warmup="background", engine_kwargs={"name": "cuda-warm"})
    try:
        assert time.perf_counter() - t0 < 5.0
        seen = {_readyz(srv)}
        assert srv.engine.compile_plane.wait(300)
        seen.add(_readyz(srv))
        assert 200 in seen
        out = _post(srv.url, {"ids": [1, 2, 3, 4, 5, 6, 7],
                              "max_new_tokens": 8})
        assert len(out) == 8
    finally:
        srv.close()


def test_background_warmup_while_engines_become_garbage(dev):
    """Engines dropped while another plane captures in the background:
    the capture holds (no cyclic collection frees an old engine's graphs
    inside it) and every plane warms."""
    cfg = LlamaConfig.tiny(num_layers=2, max_len=128, dtype=torch.bfloat16)
    model = LlamaModel(cfg, device=dev, seed=2)
    from synapseml_tpu_torch.models.llm import SlotEngine
    eng = None
    for _ in range(3):
        eng = SlotEngine(model, n_slots=4, max_len=128, spec_draft_len=4,
                         warmup="background", device="cuda")
        assert eng.compile_plane.wait(300)
        assert eng.compile_plane.status == "warm"


def test_two_background_planes_warm_together_beside_a_serving_loop(dev):
    """Two servers start together, so their planes capture in the
    background at the same time, while a third, warm server answers
    requests: the captures take turns, both planes warm with no stall,
    and every server's replies equal the warm server's."""
    cfg = LlamaConfig.tiny(num_layers=2, max_len=128, dtype=torch.bfloat16)
    model = LlamaModel(cfg, device=dev, seed=4)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, n).astype(np.int32)
               for n in (6, 11, 19, 8)]
    warm = LLMServer(model, n_slots=4, max_len=128, device="cuda",
                     warmup="sync", engine_kwargs={"name": "cuda-pair-w"})
    servers = []
    try:
        want = _serve(warm, prompts, 12)
        stop = threading.Event()
        seen = []

        def keep_serving():
            while not stop.is_set():
                seen.append(_serve(warm, prompts, 12))
        busy = threading.Thread(target=keep_serving)
        busy.start()
        try:
            for i in range(2):
                servers.append(LLMServer(
                    model, n_slots=4, max_len=128, device="cuda",
                    spec_draft_len=4, warmup="background",
                    engine_kwargs={"name": f"cuda-pair-{i}"}))
            for srv in servers:
                assert srv.engine.compile_plane.wait(300)
        finally:
            stop.set()
            busy.join(timeout=120)
        assert seen and all(s == want for s in seen)
        for srv in servers:
            plane = srv.engine.compile_plane
            assert plane.status == "warm" and plane.error is None
            assert _serve(srv, prompts, 12) == want
            assert plane.stalls == 0
            assert plane.replays == srv.engine.steps_run > 0
    finally:
        for srv in [warm] + servers:
            srv.close()


# --------------------------------------------------------------------------
# the pipeline servers over a model on the card
# --------------------------------------------------------------------------


def _post_raw(url, body, timeout=10):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_pipeline_server_over_a_card_gbdt_equals_cpu(dev):
    """A GBDT fitted on the card (K1/K2) and the same booster carried to
    the CPU as LightGBM text, each under a PipelineServer: the served
    margins agree within the fit's card-vs-CPU tolerance (1e-4), the
    labels are equal, and serving launches no K-kernel."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.gbdt.estimators import (
        GBDTClassificationModel, GBDTClassifier)
    from synapseml_tpu_torch.serving import PipelineServer
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8192, 8)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.normal(size=8192) > 0) * 1.0
    launches.reset()
    card = GBDTClassifier(numIterations=10, device="cuda").fit(
        Dataset({"features": list(x), "label": y}))
    assert launches.total("route_and_hist") > 0
    cpu = GBDTClassificationModel.load_native_model_from_string(
        card.get_model_string(), device="cpu")

    def parse(r):
        return {"features": np.asarray(r.json()["features"], np.float32)}

    bodies = [json.dumps({"features": x[i].tolist()}).encode()
              for i in range(256)]
    got = {}
    launches.reset()
    for where, model in (("cuda", card), ("cpu", cpu)):
        ps = PipelineServer(model, parse, output_col="rawPrediction",
                            batch_size=32, batch_timeout_s=0.01)
        try:
            import concurrent.futures
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                got[where] = list(pool.map(
                    lambda b: _post_raw(ps.url, b), bodies))
        finally:
            ps.close()
    assert not launches.BY_SHAPE
    for (sc, bc), (sp, bp) in zip(got["cuda"], got["cpu"]):
        assert sc == sp == 200
        mc, mp = json.loads(bc)["prediction"], json.loads(bp)["prediction"]
        np.testing.assert_allclose(mc, mp, rtol=0, atol=1e-4)
        assert (mc[1] > 0) == (mp[1] > 0)


def test_real_cuda_oom_halves_the_served_batch(dev):
    """A stage on the card that allocates past the free memory above 12
    records: the first 64-record batch raises a real
    ``torch.OutOfMemoryError``, the loop halves it down to a size that
    fits, every record answers 200, the safe size is remembered in the
    ``rowguard_safe_batch_size`` gauge, and the card works afterwards."""
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.resilience.rowguard import (is_oom_error,
                                                         reset_safe_batch,
                                                         safe_batch_size)
    from synapseml_tpu_torch.serving import PipelineServer, ServingRequest
    from synapseml_tpu_torch.telemetry import get_registry
    torch.cuda.empty_cache()
    per_row = torch.cuda.mem_get_info(dev)[0] // 12
    errors = []

    class Hungry:
        def transform(self, ds):
            try:
                buf = torch.empty(per_row * ds.num_rows, dtype=torch.uint8,
                                  device=dev)
            except Exception as e:
                errors.append(e)
                raise
            x = torch.as_tensor(np.asarray(ds["x"], np.float32), device=dev)
            del buf
            return ds.with_column("prediction", (x * 2).cpu().numpy())

    ps = PipelineServer(Hungry(), lambda r: {"x": 1.0}, batch_size=64,
                        api_path="/hungry")
    replies = {}
    ps._loop.api.reply = lambda rid, rep: replies.__setitem__(rid, rep)
    try:
        reqs = [ServingRequest(id=f"r{i}", method="POST", path="/hungry",
                               headers={}, body=b"") for i in range(64)]
        served = ps._loop._transform_reply(
            reqs, [{"x": float(i)} for i in range(64)])
        assert served == 64
        assert all(replies[f"r{i}"].status == 200 for i in range(64))
        assert [json.loads(replies[f"r{i}"].body)["prediction"]
                for i in range(64)] == [2.0 * i for i in range(64)]
        assert errors and all(isinstance(e, torch.OutOfMemoryError)
                              and is_oom_error(e) for e in errors)
        safe = safe_batch_size(ps._loop._oom_key, 64)
        assert safe <= 12
        assert get_registry().gauge(
            "rowguard_safe_batch_size", "", ("key",)).value(
                key=ps._loop._oom_key) == safe
    finally:
        reset_safe_batch()
        ps.close()
        torch.cuda.empty_cache()
    z = torch.ones(1024, device=dev)
    assert float((z @ z).item()) == 1024.0
