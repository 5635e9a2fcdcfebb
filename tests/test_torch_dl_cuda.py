"""The DL estimators on the card against the same code on the CPU.
Marked ``gpu``: every test skips where no card is present (the check runs
inside the fixture, so every worker collects the same tests).  Run on a
machine with a card:

    python -m pytest -m gpu tests/test_torch_dl_cuda.py

The models draw their weights on the CPU from the seed, so both devices
start from the same weights.  Tolerances: f32 atol 1e-4, with TF32 off
for the comparison (PyTorch lets cuDNN convolutions take TF32 products
by default, ~1e-3 relative); cuBLAS/cuDNN and the CPU's kernels then sum
in other orders, and three adamw steps of lr 1e-3 keep the difference at
~1e-6; bf16 atol = rtol = 5e-2 on logits (each
``Dense`` and convolution rounds to bf16, 2^-8 relative, where the two
devices' f32 sums straddle a rounding boundary).  Dropout masks come from
each device's own generator, so the card-against-CPU steps run at dropout
0 and the card's masks are checked against themselves.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.models.dl import (DeepTextClassifier,
                                           DeepVisionClassifier, DLTrainer,
                                           OptimizerConfig, TextEncoder,
                                           TransformerConfig, make_backbone)
from synapseml_tpu_torch.models.dl import transformer as PT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu

CPU = torch.device("cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _text_steps(d, dtype, remat="none", steps=3, seed=0):
    rng = np.random.default_rng(seed)
    cfg = TransformerConfig.tiny(dtype=dtype, dropout_rate=0.0, remat=remat)
    model = TextEncoder(cfg, device=d, seed=None)
    tr = DLTrainer(model, OptimizerConfig(learning_rate=1e-3,
                                          schedule="cosine", warmup_steps=1,
                                          total_steps=steps,
                                          grad_clip_norm=1.0), d)
    state = tr.init_state(seed)
    step = tr.train_step()
    losses = []
    for _ in range(steps):
        ids = rng.integers(0, 1024, (8, 24)).astype(np.int32)
        mask = np.ones((8, 24), bool)
        mask[::3, 15:] = False
        mask[7] = False
        bi, bm, bl = tr.shard_batch((ids, mask, rng.integers(0, 2, 8)))
        state, m = step(state, (bi, bm), bl, 0)
        losses.append(float(m["loss"]))
    logits = tr.eval_step()(state, (bi, bm))
    return np.array(losses), logits.float().cpu().numpy(), {
        k: v.float().cpu() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_text_steps_on_card_equal_cpu(dev, dtype):
    lc, gc, pc = _text_steps(dev, dtype)
    lh, gh, ph = _text_steps(CPU, dtype)
    tol = (dict(atol=1e-4, rtol=0) if dtype == torch.float32
           else dict(atol=5e-2, rtol=5e-2))
    np.testing.assert_allclose(lc, lh, **tol)
    np.testing.assert_allclose(gc, gh, **tol)
    if dtype == torch.float32:
        for k in ph:
            np.testing.assert_allclose(pc[k].numpy(), ph[k].numpy(),
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_text_remat_on_card_equals_no_remat(dev, policy):
    l0, g0, _ = _text_steps(dev, torch.float32)
    l1, g1, _ = _text_steps(dev, torch.float32, remat=policy)
    np.testing.assert_allclose(l1, l0, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g1, g0, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet18_on_card_equals_cpu(dev, size, train):
    x = np.random.default_rng(size).normal(
        size=(8, size, size, 3)).astype(np.float32)
    out = {}
    for d in (dev, CPU):
        net = make_backbone("resnet18", 3, dtype=torch.float32, device=d,
                            seed=1)
        with torch.no_grad():
            logits = net(torch.from_numpy(x).to(d), train=train)
        net.commit_batch_stats()
        out[d.type] = (logits.cpu().numpy(),
                       {k: v.cpu().numpy() for k, v in net.named_buffers()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)
    for k, v in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k], v, atol=1e-4,
                                   err_msg=k)


def test_resnet_runs_channels_last_on_card(dev):
    net = make_backbone("resnet18", 3, device=dev, seed=0)
    x = torch.randn(4, 32, 32, 3, device=dev)
    seen = []
    hook = net.conv_init.register_forward_hook(
        lambda m, i, o: seen.append(o.is_contiguous(
            memory_format=torch.channels_last)))
    net(x, train=True).sum().backward()
    hook.remove()
    assert seen == [True]


def test_dropout_masks_on_card(dev):
    x = torch.ones(256, 1024, device=dev)
    a = PT.dropout(x, 0.1, PT.mix_seed(3, 7))
    b = PT.dropout(x, 0.1, PT.mix_seed(3, 7))
    assert torch.equal(a, b)
    kept = int((a != 0).sum())
    n = x.numel()
    assert abs(kept - 0.9 * n) < 3 * np.sqrt(n * 0.09)


def test_estimators_learn_on_card(dev):
    rng = np.random.default_rng(0)
    pos = ["good", "great", "excellent", "love", "wonderful"]
    neg = ["bad", "awful", "terrible", "hate", "poor"]
    texts = [" ".join(rng.choice(pos if i % 2 else neg, 5)) for i in range(64)]
    ds = Dataset({"text": texts, "label": (np.arange(64) % 2) * 1.0})
    out = DeepTextClassifier(modelSize="tiny", maxEpochs=8, batchSize=16,
                             learningRate=3e-3, maxTokenLen=16,
                             vocabSize=128, lrSchedule="constant",
                             device="cuda").fit(ds).transform(ds)
    assert (out["prediction"] == ds["label"]).mean() > 0.9
    imgs = rng.normal(size=(32, 16, 16, 3)).astype(np.float32) * 0.1
    labels = np.arange(32) % 2
    imgs[labels == 1, :8] += 1.0
    vds = Dataset({"image": list(imgs), "label": labels * 1.0})
    out = DeepVisionClassifier(backbone="resnet18", maxEpochs=6, batchSize=16,
                               learningRate=1e-2, optimizer="sgd",
                               lrSchedule="constant",
                               device="cuda").fit(vds).transform(vds)
    assert (out["prediction"] == vds["label"]).mean() > 0.9


# -- the MoE FFN (ROADMAP A3.1) ------------------------------------------------

def test_moe_text_steps_on_card_equal_cpu(dev):
    """The tiny encoder with 4 experts on every other block: three adamw
    steps (the aux losses in the objective) on the card against the CPU,
    f32 atol 1e-4 as the dense encoder."""
    runs = {}
    for d in (dev, CPU):
        rng = np.random.default_rng(0)
        cfg = TransformerConfig.tiny(dtype=torch.float32, dropout_rate=0.0,
                                     num_experts=4)
        model = TextEncoder(cfg, device=d, seed=None)
        tr = DLTrainer(model, OptimizerConfig(learning_rate=1e-3,
                                              grad_clip_norm=1.0), d)
        state = tr.init_state(0)
        step = tr.train_step()
        losses = []
        for _ in range(3):
            ids = rng.integers(0, 1024, (16, 32)).astype(np.int32)
            lab = rng.integers(0, 2, 16).astype(np.int32)
            bi, bl = tr.shard_batch((ids, lab))
            state, m = step(state, (bi,), bl, 0)
            losses.append(float(m["loss"]))
        runs[d.type] = (losses, {k: v.cpu() for k, v in
                                 model.state_dict().items()})
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4)
    for k, v in runs["cpu"][1].items():
        np.testing.assert_allclose(runs["cuda"][1][k].numpy(), v.numpy(),
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gather_equals_dense_on_card(dev, dtype):
    """The gather form against the reference's dense form on the card:
    f32 within 1e-5, bf16 within one bf16 ulp of the scale."""
    from synapseml_tpu_torch.models.dl.moe import MoEFFN
    ffn = MoEFFN(8, 64, 128, top_k=2, capacity_factor=0.75, dtype=dtype,
                 device=dev)
    with torch.no_grad():
        ffn.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(4, 32, 64, generator=torch.Generator().manual_seed(1)
                    ).to(dev, dtype)
    with torch.no_grad():
        g, d = ffn(x), ffn(x, dense=True)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    scale = max(1.0, float(d.float().abs().max()))
    assert float((g.float() - d.float()).abs().max()) <= tol * scale
    assert 0.0 < float(ffn.dropped) < 1.0
