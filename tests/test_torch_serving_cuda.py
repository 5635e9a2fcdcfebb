"""The port's ``LLMServer`` on the card: replies over HTTP from an engine
on the card, against the same server on the CPU at f32 (token-exact),
through background warm-up and the CUDA graphs of the compile plane, with
K3 launched on every decode and verify step.  Marked ``gpu``: every test
skips where no card is present.  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_serving_cuda.py
"""

import json
import threading
import time
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
