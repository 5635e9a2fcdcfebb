"""The parallel layer on the card, phase 25 (a)-(b) and (f) of
chip_smoke.py in small form: a gang of two ranks sharing the card over
gloo gives the rendezvous report naming the card, runs every collective
on CUDA tensors bit-equal to the same op over the CPU (the point-to-point
ops staging through pinned host memory, the others not), and fits one
GBDT on both ranks; one NCCL rank gives its report.  The
feature-parallel grower's node-batched K1 shape (14 features, 256 bins,
16 slots) is bit-equal to its plain version, and a 2-rank
feature-parallel fit on the card splits as the same gang's fit on the
CPU.  Marked ``gpu``: every test skips where no card is present (the
check runs inside the fixture or the test, so every worker collects the
same tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.parallel import run_on_local_cluster
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

#: each gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def gloo_gang():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang shares it")
    return run_on_local_cluster("torch_gang_tasks:card_checks", 2,
                                device="cuda", backend="gloo",
                                timeout_s=GANG_TIMEOUT_S)


@pytest.fixture(scope="module")
def nccl_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return run_on_local_cluster(
        "synapseml_tpu_torch.parallel.selfcheck:cluster_report", 1,
        task_args={"device": "cuda"}, device="cuda", backend="nccl",
        timeout_s=GANG_TIMEOUT_S)[0]


def test_report_names_the_card(gloo_gang):
    kind = torch.cuda.get_device_name(0)
    for r, res in enumerate(gloo_gang):
        rep = res["report"]
        assert (rep["process_index"], rep["backend"]) == (r, "gloo")
        assert rep["device_table"] == [[0, kind], [1, kind]]
        assert rep["psum_local"] == [1.0] and rep["all_gather"] == [0.0, 1.0]


@pytest.mark.parametrize("op", ["psum", "all_gather", "reduce_scatter",
                                "ring_allreduce", "ppermute",
                                "compressed_psum_bf16",
                                "compressed_psum_int8"])
def test_collective_on_card_equals_cpu(gloo_gang, op):
    for res in gloo_gang:
        assert res["equal"][op]
        staged = res["staged"][op]
        # gloo refuses send/recv on device pointers: those stage
        assert (staged > 0) == (op in ("ring_allreduce", "ppermute"))


def test_ranks_fit_one_model(gloo_gang):
    assert gloo_gang[0]["model_md5"] == gloo_gang[1]["model_md5"]


def test_one_nccl_rank_report(nccl_rank):
    kind = torch.cuda.get_device_name(0)
    assert nccl_rank["backend"] == "nccl"
    assert nccl_rank["device_table"] == [[0, kind]]
    assert nccl_rank["psum_local"] == [0.0]


def test_nccl_with_more_ranks_than_cards_raises_before_any_process():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        run_on_local_cluster("m:f", torch.cuda.device_count() + 1,
                             device="cuda", backend="nccl")


@pytest.fixture(scope="module")
def featpar_gang():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang shares it")
    return run_on_local_cluster("torch_gang_tasks:featpar_card_cpu", 2,
                                device="cuda", backend="gloo",
                                timeout_s=GANG_TIMEOUT_S)


def test_featpar_node_batched_k1_equals_plain():
    """K1 at the feature-parallel grower's shape: a rank's 14 features,
    256 bins, 16 slots, over 200,003 rows of slots in [-1, 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from synapseml_tpu_torch.kernels import launches as L
    from synapseml_tpu_torch.models.gbdt import hist as H
    rng = np.random.default_rng(14)
    N, dev = 200_003, torch.device("cuda")
    bins = torch.as_tensor(rng.integers(0, 256, (14, N)).astype(np.int32),
                           device=dev)
    slot = torch.as_tensor(rng.integers(-1, 16, N).astype(np.int32),
                           device=dev)
    g, h = (torch.as_tensor(a, device=dev) for a in (
        rng.normal(size=N).astype(np.float32),
        rng.uniform(0.01, 1.0, N).astype(np.float32)))
    vals, _ = H.prep_hist_vals(g, h, torch.ones(N, device=dev))
    L.reset()
    out = H.build_hist_nodes_limbs(bins, slot, vals, 16, 256)
    key = L.launch_key("build_hist_nodes", F=14, B=256, shift=0, S=16,
                       variant="rows")
    assert L.BY_SHAPE.get(key) == 1
    assert torch.equal(out, H.build_hist_nodes_plain(bins, slot, vals, 16,
                                                     256))


def test_featpar_fit_on_card_equals_cpu_gang(featpar_gang):
    for res in featpar_gang:
        assert res["card"] == res["cpu"]
        assert res["margin_diff"] <= 1e-4
        assert any(k.startswith("build_hist_nodes") and "F=14" in k
                   for k in res["shapes"])
    assert featpar_gang[0]["card"] == featpar_gang[1]["card"]
