"""The parallel layer on the card, phase 25 (a)-(b) of chip_smoke.py in
small form: a gang of two ranks sharing the card over gloo gives the
rendezvous report naming the card, runs every collective on CUDA tensors
bit-equal to the same op over the CPU (the point-to-point ops staging
through pinned host memory, the others not), and fits one GBDT on both
ranks; one NCCL rank gives its report.  Marked ``gpu``: every test skips
where no card is present (the check runs inside the fixture, so every
worker collects the same tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_parallel_cuda.py
"""

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
