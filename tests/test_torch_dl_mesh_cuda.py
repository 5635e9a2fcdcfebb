"""DL training over a gang on the card, phase 28a (i)-(ii) of
chip_smoke.py at the tiny size: two gloo ranks sharing the card train the
tiny MoE encoder (4 experts, capacity factor 0.5, f32, dropout 0) for
five steps on the data mesh (D = 2) and on the (data 1, expert 2) mesh,
each equal to one rank's fit on the card from the same weights and
batches (losses and parameters within 1e-5, IEEE f32 products); and
ResNet-18's BatchNorm over two ranks on the card gives the CPU ranks'
logits, running statistics and input and weight gradients (within 1e-4
of their scale).  Marked ``gpu``: every test skips where no card is
present.  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_dl_mesh_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.models.dl import resnet as PR
from synapseml_tpu_torch.models.dl import transformer as PT
from synapseml_tpu_torch.parallel import run_on_local_cluster

import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

GANG_TIMEOUT_S = 240.0
SPEC = dict(num_classes=3, dropout_rate=0.0, num_experts=4,
            moe_capacity_factor=0.5)
OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
           schedule="cosine", warmup_steps=2, total_steps=5,
           grad_clip_norm=1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gang shares it")
    root = str(tmp_path_factory.mktemp("dl_mesh_cuda"))

    def p(name):
        return os.path.join(root, name)

    m = PT.TextEncoder(PT.TransformerConfig.tiny(dtype=torch.float32,
                                                 **SPEC), device="cpu",
                       seed=0)
    G._save_npz(p("init.npz"), {k: v.numpy()
                                for k, v in m.state_dict().items()})
    rng = np.random.default_rng(1)
    b = {"n": np.asarray(5)}
    for j in range(5):
        b[f"{j}_ids"] = rng.integers(0, 1024, (8, 12)).astype(np.int64)
        b[f"{j}_mask"] = np.ones((8, 12), bool)
        b[f"{j}_labels"] = rng.integers(0, 3, 8).astype(np.int64)
    G._save_npz(p("b.npz"), b)
    base = dict(model="text", cfg=SPEC, init=p("init.npz"),
                batches=p("b.npz"), opt=OPT, steps=5,
                inputs=["ids", "mask"])
    net = PR.make_backbone("resnet18", 2, dtype=torch.float32,
                           device="cpu", seed=0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    G._save_npz(p("bn.npz"), {"x": x, "w": rng.normal(size=(8, 2)).astype(
        np.float32), **{f"init.{k}": v.numpy()
                        for k, v in net.state_dict().items()}})
    out = {}
    for n, dev, cases in (
            (1, "cuda", {"one": dict(base, out=p("one.npz"))}),
            (2, "cuda", {"d2": dict(base, out=p("d2.npz")),
                         "ep": dict(base, ep=2, out=p("ep.npz"))})):
        out[n] = run_on_local_cluster(
            "torch_gang_tasks:dl_mesh_cases", n,
            task_args={"device": dev, "cases": cases}, device=dev,
            backend="gloo", timeout_s=GANG_TIMEOUT_S)[0]
    for dev in ("cuda", "cpu"):
        os.makedirs(p(f"bn_{dev}"), exist_ok=True)
        run_on_local_cluster(
            "torch_gang_tasks:bn_mesh_grads", 2,
            task_args=dict(device=dev, data=p("bn.npz"),
                           backbone="resnet18", classes=2,
                           out=p(f"bn_{dev}")),
            device=dev, backend="gloo", timeout_s=GANG_TIMEOUT_S)
    return root, out


@pytest.mark.parametrize("case", ["d2", "ep"])
def test_two_ranks_on_the_card_equal_one(runs, case):
    root, out = runs
    np.testing.assert_allclose(out[2][case]["losses"], out[1]["one"]["losses"],
                               rtol=1e-5)
    want = G._load_npz(os.path.join(root, "one.npz"))
    got = G._load_npz(os.path.join(root, f"{case}.npz"))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_batchnorm_backward_on_the_card_equals_cpu(runs, rank):
    root, _ = runs
    card = G._load_npz(os.path.join(root, "bn_cuda", f"rank{rank}.npz"))
    cpu = G._load_npz(os.path.join(root, "bn_cpu", f"rank{rank}.npz"))
    assert set(card) == set(cpu)
    for k, v in cpu.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(card[k].astype(np.float64) - v).max()) / scale
        assert err <= 1e-4, (k, err)
