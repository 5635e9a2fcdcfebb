"""Phase 26 of chip_smoke.py in small form on the card: a 2-rank gloo
gang sharing the card, SIGKILLed at a GBDT checkpoint and relaunched at
the same size, gives the fault-free gang's model bit for bit with K2
launched in the resumed attempt; a second gang over the same kernel
build cache loads every library the first built; and a checkpoint of
CUDA tensors (f32 and bf16) comes back on the card, bit-equal.  Marked
``gpu``: every test skips where no card is present.  Run on a machine
with a card:

    python -m pytest -m gpu tests/test_torch_elastic_cuda.py
"""

import pytest
import torch

from synapseml_tpu_torch.core.checkpoint import CheckpointManager
from synapseml_tpu_torch.kernels import _build
from synapseml_tpu_torch.parallel import (GangSupervisor,
                                          run_on_local_cluster)
from synapseml_tpu_torch.resilience import RetryPolicy
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

#: each gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 240.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_gbdt_gang_resume_on_the_card(tmp_path):
    """26a at 20,000 x 8 rows: rank 1 killed after its second checkpoint;
    the relaunched gang's models equal the fault-free gang's (md5 and
    margins), and K2 launches in each rank's resumed attempt."""
    _card()
    args = {"device": "cuda", "n": 20_000, "f": 8, "iters": 5}
    clean = run_on_local_cluster(
        "torch_gang_tasks:gbdt_elastic_digest", 2, task_args=args,
        device="cuda", backend="gloo", timeout_s=GANG_TIMEOUT_S,
        checkpoint_dir=str(tmp_path / "clean"))
    sup = GangSupervisor(
        "torch_gang_tasks:gbdt_elastic_digest", 2, task_args=args,
        device="cuda", backend="gloo", timeout_s=GANG_TIMEOUT_S,
        checkpoint_dir=str(tmp_path / "elastic"),
        retry_policy=RetryPolicy(max_retries=2, base_s=0.01, seed=5),
        env_extra={"SML_FAULTS":
                   "gbdt.checkpoint=kill_rank:rank=1:after=1:times=1"})
    out = sup.run()
    assert sup.restarts >= 1 and sup.last_recovery_s > 0
    for r in out:
        assert r["model_md5"] == clean[0]["model_md5"]
        assert r["margins"] == clean[0]["margins"]
        assert r["launches"]["route_and_hist"] > 0, r["launches"]
        # K1 runs only the refined builds of two-level histograms, which
        # need wide bins (total_bins >= 128) and
        # trainer.TWO_LEVEL_MIN_ROWS (500,000) rows; this fit has
        # max_bin 31 at 20,000 rows.  Phase 26 launches K1 at maxBin 255
        # over 1M rows
        assert r["launches"]["build_hist_nodes"] == 0, r["launches"]


def test_build_cache_hits_on_a_relaunch(tmp_path):
    """The first gang over an empty cache builds each library (misses),
    a second gang over the same directory loads them all (hits) and
    builds nothing."""
    _card()
    cache = str(tmp_path / "kernels")
    (first,), (second,) = (GangSupervisor(
        "torch_gang_tasks:kernel_cache_probe", 1, device="cuda",
        timeout_s=GANG_TIMEOUT_S, compile_cache_dir=cache).run()
        for _ in range(2))
    n = len(_build.SOURCES)
    assert first["build_dir"] == second["build_dir"] == cache
    assert (first["cache_misses"], first["compiles"]) == (n, n)
    assert (second["cache_hits"], second["cache_misses"],
            second["compiles"]) == (n, 0, 0)
    print(f"build {first['build_s']:.2f} s, load {second['build_s']:.4f} s")


def test_checkpoint_round_trip_keeps_cuda_tensors(tmp_path):
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(64, 32, device="cuda", generator=g),
            "h": torch.randn(16, device="cuda", generator=g).to(
                torch.bfloat16),
            "step": 7}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree)
    got = mgr.restore()
    assert got["w"].device == tree["w"].device
    assert got["h"].device == tree["h"].device
    assert got["h"].dtype == torch.bfloat16 and got["step"] == 7
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["h"].view(torch.int16),
                       tree["h"].view(torch.int16))
    on_cpu = mgr.restore(device="cpu")
    assert on_cpu["w"].device.type == "cpu"
    template = {"w": torch.zeros(64, 32, device="cuda"),
                "h": torch.zeros(16, dtype=torch.bfloat16, device="cuda"),
                "step": 0}
    placed = mgr.restore_state_dict(template)
    assert placed["w"].is_cuda and torch.equal(placed["w"], tree["w"])
