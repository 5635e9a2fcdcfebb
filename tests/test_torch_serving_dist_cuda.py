"""Phase 27 of chip_smoke.py in small form on the card: the replicated
serving plane with the decode replicas' K3 on the card.

- 27a's three checks at the tiny f32 shape (``LlamaConfig.tiny(
  num_layers=2, max_len=128)``, 4 slots): disaggregated turns equal the
  colocated server's under the ``ok``, ``corrupt``, ``timeout`` and
  ``fallback`` outcomes, and repin → journal resume on the survivor,
  with K3 launched in every decode server;
- ``exchange_routing_table`` (and the ``distributed_serving_roundtrip``
  contract) over 2 gloo ranks sharing the card, CUDA tensors in the
  gather;
- a prefill worker's engine hands off without a decode step (no K3
  launch during handoffs), the decode server it hands off to launches K3
  while decoding the handed-off prompt, and the worker's engine launches
  K3 when it decodes.

Marked ``gpu``: every test skips where no card is present.  Run on a
machine with a card:

    python -m pytest -m gpu tests/test_torch_serving_dist_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from synapseml_tpu_torch.kernels import launches as L
from synapseml_tpu_torch.parallel import run_on_local_cluster
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

#: each gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 240.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_disaggregated_turns_equal_colocated_on_the_card(tmp_path):
    dev = _card()
    from synapseml_tpu_torch.kernels._build import build_all
    build_all()
    cfg = chip_smoke.p27_config(dict(kind="tiny", num_layers=2,
                                     max_len=128, dtype="float32"))
    r = chip_smoke.p27_exact(0, dev, cfg, str(tmp_path), n_slots=4,
                             prompt_range=(12, 60), n_fresh=6, n_fault=2,
                             new=8)
    assert (r["ok"], r["corrupt"], r["timeout"], r["fallback"]) == \
        (6, 2, 2, 2)
    assert all(r["launches"].values()), r["launches"]


def test_routing_table_over_gloo_ranks_on_the_card():
    _card()
    r0, r1 = run_on_local_cluster(
        "torch_gang_tasks:distributed_serving_roundtrip", 2,
        task_args={"device": "cuda"}, device="cuda", backend="gloo",
        timeout_s=GANG_TIMEOUT_S)
    assert r0["table"] == r1["table"] and len(r0["table"]) == 2
    assert [r["echo"] for r in r0["results"]] == [0, 10]
    want = [["200.0.255.128", 40000], ["201.1.255.129", 40001]]
    assert r0["fake_table"] == r1["fake_table"] == want
    assert r0["timed_out"] and r1["timed_out"]
    assert r0["fake_roles"] == [0, 1]


def test_k3_in_the_decode_server_and_the_workers_engine():
    dev = _card()
    from synapseml_tpu_torch.models.llm import (HostKVArena, LlamaModel,
                                                SlotEngine)
    from synapseml_tpu_torch.serving import PrefillPool, PrefillWorker
    cfg = chip_smoke.p27_config(dict(kind="tiny", num_layers=2,
                                     max_len=128, dtype="float32"))
    model = LlamaModel(cfg, device=dev, seed=0)
    arena = HostKVArena(64 << 20, name="pt-cuda-dsg")
    worker = PrefillWorker(SlotEngine(model, n_slots=2, max_len=128,
                                      device=dev, name="pt-cuda-dsg-pf"))
    pool = PrefillPool([worker], name="pt-cuda-dsg")
    pool.bind("/pt-cuda-dsg", arena)
    dec = SlotEngine(model, n_slots=4, max_len=128, kv_arena=arena,
                     device=dev, name="pt-cuda-dsg")
    p = np.random.default_rng(5).integers(1, cfg.vocab_size, 40)
    ref = SlotEngine(model, n_slots=4, max_len=128, device=dev,
                     name="pt-cuda-dsg-ref")
    r = ref.admit(p, 8)
    want = ref.run_to_completion()[r.slot]
    L.reset()
    assert pool.handoff(p, session="s") == "ok"
    assert L.total("paged_decode_attention") == 0   # prefill only
    r = dec.admit(p, 8)
    assert r.reused_tokens > 0
    np.testing.assert_array_equal(dec.run_to_completion()[r.slot], want)
    decoded = L.total("paged_decode_attention")
    assert decoded > 0
    L.reset()
    r = worker.engine.admit(p, 8)
    np.testing.assert_array_equal(
        worker.engine.run_to_completion()[r.slot], want)
    assert L.total("paged_decode_attention") > 0
