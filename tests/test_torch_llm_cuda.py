"""The port's paged decode-attention kernel (K3) against its plain
PyTorch version, and the decode engine on the card against the engine on
the CPU.  Marked ``gpu``: every test skips where no card is present (the
check runs inside the fixture, so every worker collects the same tests).
Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_llm_cuda.py

Tolerances: f32 atol 1e-5 (f32 runs the previous kernel; it and the plain
version both sum in f32, in different orders); bf16 and f16 atol = rtol =
1e-2 on rows with a live key.  There the split kernel computes scores and
the running softmax in f32, but rounds each probability to the compute
type before P V (the port's dense rule), where the plain version keeps P
in f32: each term of P V carries a relative error of at most 2^-8 (bf16),
which averages out over the span, and the output is rounded once more, so
the two differ by a few ulps of the output.  Rows with no live key (a slot
at span 1 in a verify step) have an unspecified output and are not
compared.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models.llm import paged_attn as PA
from synapseml_tpu_torch.models.llm import LlamaConfig, LlamaModel, SlotEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _operands(rng, B, S, H, KV, D, T, dtype, dev):
    shape_q = (B, H, D) if S == 1 else (B, S, H, D)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                               device=dev).to(dtype)
               for s in (shape_q, (B, T, KV, D), (B, T, KV, D)))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("B,H,KV,D,T", [
    (16, 32, 8, 64, 2048), (5, 8, 4, 32, 96), (3, 8, 4, 16, 64),
    (4, 8, 2, 128, 200), (8, 16, 4, 64, 640)])
def test_paged_kernel_equals_plain(dev, dtype, S, B, H, KV, D, T):
    """S = 32 at four or more query heads per kv head gives more query
    rows than one block keeps: the rows spread over several blocks.  The
    spans straddle the split kernel's chunks (C - 1, C, C + 1, 2C + 1 and
    T for C = SPLIT_KEYS, where T allows), and span 1 at S > 1 leaves
    rows with no live key: the live rows must still match, finite."""
    rng = np.random.default_rng(B * T + S)
    C = PA.SPLIT_KEYS
    edges = [1, T] + [c for c in (C - 1, C, C + 1, 2 * C + 1) if c < T]
    spans = np.concatenate([edges, [max(1, T - 1), min(T, 65)],
                            rng.integers(1, T + 1, B)])[:B]
    q, k, v = _operands(rng, B, S, H, KV, D, T, dtype, dev)
    sp = torch.as_tensor(spans.astype(np.int32), device=dev)
    launches.reset()
    out = PA.paged_decode_attention(q, k, v, sp)
    kernel = "previous" if dtype == torch.float32 else "split"
    assert list(launches.BY_SHAPE) == [launches.launch_key(
        "paged_decode_attention", B=B, S=S, H=H, KV=KV, D=D, T=T,
        dtype=PA._DTYPE_NAMES[dtype], variant=kernel)]
    ref = PA.paged_decode_attention_plain(q, k, v, sp)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    if S == 1:
        out, ref = out[:, None], ref[:, None]
    live = (torch.as_tensor(spans, device=dev)[:, None] - (S - 1)
            + torch.arange(S, device=dev)[None]) > 0
    assert bool(torch.isfinite(out[live].float()).all())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=tol, rtol=0 if tol == 1e-5 else tol)


def test_f32_keeps_the_previous_kernel(dev):
    """f32 launches the previous kernel, bit for bit what its own entry
    point gives; bf16 launches the split kernel."""
    rng = np.random.default_rng(7)
    sp = torch.as_tensor([1, 300, 2048, 513], dtype=torch.int32, device=dev)
    for dtype, kernel in ((torch.float32, "previous"),
                          (torch.bfloat16, "split")):
        q, k, v = _operands(rng, 4, 4, 32, 8, 64, 2048, dtype, dev)
        launches.reset()
        out = PA.paged_decode_attention(q, k, v, sp)
        assert [key.endswith(f",variant={kernel}]")
                for key in launches.BY_SHAPE] == [True]
        prev = PA.paged_decode_attention_previous(q, k, v, sp)
        if dtype == torch.float32:
            assert torch.equal(out, prev)
    with pytest.raises(ValueError, match="CUDA kernel"):
        PA.paged_decode_attention_previous(q.cpu(), k.cpu(), v.cpu(),
                                           sp.cpu())


def test_paged_kernel_refuses_what_it_cannot_take(dev):
    rng = np.random.default_rng(0)
    q, k, v = _operands(rng, 2, 1, 8, 4, 48, 32, torch.float32, dev)
    sp = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="d_head"):
        PA.paged_decode_attention(q, k, v, sp)
    q, k, v = _operands(rng, 2, 1, 8, 4, 32, 32, torch.float64, dev)
    with pytest.raises(TypeError):
        PA.paged_decode_attention(q, k, v, sp)
    q, k, v = _operands(rng, 2, 1, 8, 4, 32, 32, torch.float32, dev)
    with pytest.raises(ValueError, match="spans"):
        PA.paged_decode_attention(q, k, v, sp.cpu())


@pytest.mark.parametrize("spec", [0, 4])
def test_engine_on_card_equals_engine_on_cpu(dev, spec):
    cfg = LlamaConfig.tiny(num_layers=2, max_len=96, dtype=torch.float32)
    cpu = LlamaModel(cfg, device="cpu", seed=3)
    card = LlamaModel(cfg, device=dev, seed=3)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(spec)
    prompts = [np.tile(rng.integers(1, 512, 5), 3)[:n].astype(np.int32)
               for n in (9, 15, 12)]
    out = {}
    for d, m in (("cpu", cpu), (dev, card)):
        eng = SlotEngine(m, n_slots=3, max_len=64, spec_draft_len=spec,
                         device=d)
        launches.reset()
        r = [eng.admit(prompts[0], 12), eng.admit(prompts[1], 10)]
        for _ in range(3):
            eng.step()
        r.append(eng.admit(prompts[2], 8))
        eng.run_to_completion()
        out[str(d)] = [eng.generated_ids(x.slot) for x in r]
        if d != "cpu":
            assert launches.total("paged_decode_attention") > 0
    for a, b in zip(out["cpu"], out[str(dev)]):
        np.testing.assert_array_equal(a, b)


def test_auto_engine_takes_wide_verify_at_llama_1b_heads(dev):
    """'auto' at Llama-3.2-1B's heads (32 / 8, d_head 64) with
    spec_draft_len=31 (verify steps up to S = 32: 128 query rows per kv
    head) resolves to the kernel, launches it, and gives the tokens of a
    dense engine on the card.  Vocabulary and MLP are cut to keep it
    small; f32."""
    cfg = LlamaConfig.llama3_1b(num_layers=1, max_len=256, vocab_size=512,
                                d_ff=512, dtype=torch.float32)
    m = LlamaModel(cfg, device=dev, seed=5)
    rng = np.random.default_rng(5)
    prompts = [np.tile(rng.integers(1, 512, 4), 12)[:n].astype(np.int32)
               for n in (40, 23, 31)]
    out = {}
    for backend in ("auto", "dense"):
        eng = SlotEngine(m, n_slots=3, spec_draft_len=31,
                         attention_backend=backend, device=dev)
        assert eng.attention_backend == ("paged" if backend == "auto"
                                         else "dense")
        launches.reset()
        slots = [eng.admit(p, 40).slot for p in prompts]
        eng.run_to_completion()
        out[backend] = [eng.generated_ids(s) for s in slots]
        n = launches.total("paged_decode_attention")
        assert (n > 0) == (backend == "auto")
    for a, b in zip(out["auto"], out["dense"]):
        np.testing.assert_array_equal(a, b)


def test_engine_on_card_refuses_a_layout_the_kernel_lacks(dev):
    """d_head 48 has a paged geometry, so 'auto' resolves to 'paged'; on
    the card the engine raises at construction instead of running the
    plain version in the kernel's place."""
    cfg = LlamaConfig.tiny(num_layers=1, max_len=64, d_model=192,
                           num_heads=4, num_kv_heads=2, dtype=torch.float32)
    m = LlamaModel(cfg, device=dev)
    with pytest.raises(ValueError, match="d_head"):
        SlotEngine(m, n_slots=2, device=dev)
    assert SlotEngine(m, n_slots=2, attention_backend="dense",
                      device=dev).attention_backend == "dense"
