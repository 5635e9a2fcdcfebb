"""The port's paged decode-attention kernel (K3) against its plain
PyTorch version, and the decode engine on the card against the engine on
the CPU, with and without the compile plane's CUDA graphs.  Marked
``gpu``: every test skips where no card is present (the check runs inside
the fixture, so every worker collects the same tests).
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
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.models.llm import paged_attn as PA
from synapseml_tpu_torch.models.llm import LlamaConfig, LlamaModel, SlotEngine
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

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


def _drive(eng, prompts, new=(12, 10, 8)):
    """Two requests, three steps, a third admitted mid-flight, run to the
    end → each request's generated ids."""
    r = [eng.admit(prompts[0], new[0]), eng.admit(prompts[1], new[1])]
    for _ in range(3):
        eng.step()
    r.append(eng.admit(prompts[2], new[2]))
    eng.run_to_completion()
    return [np.asarray(eng.generated_ids(x.slot)) for x in r]


def _card_model(dev, dtype):
    """Llama-3.2-1B heads (32 / 8, d_head 64) at 2 layers, vocabulary and
    MLP cut; random weights in ``dtype``."""
    cfg = P.LlamaConfig.llama3_1b(num_layers=2, max_len=256,
                                  vocab_size=2048, d_ff=1024, dtype=dtype)
    return P.cast_params(P.LlamaModel(cfg, device=dev, seed=2), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_logits_equal_eager_bitwise(dev, dtype):
    """Two engines on one model, one eager and one replaying graphs, fed
    the same steps: decode logits, verify argmaxes and the caches are
    bit-identical."""
    m = _card_model(dev, dtype)
    prompts = [np.tile(np.arange(1, 9), 12)[:n].astype(np.int32)
               for n in (40, 23, 71, 9)]
    engs = [P.SlotEngine(m, n_slots=4, spec_draft_len=7, warmup=w,
                         device=dev) for w in ("off", "sync")]
    for eng in engs:
        for p in prompts:
            eng.admit(p, 60)
    rng = np.random.default_rng(1)
    for it in range(6):
        lengths = engs[0]._decode_step_args()
        for S in (1, 2, 4, 8):
            tokens = rng.integers(1, 2048, (4, S)).astype(np.int32)
            a, b = (e._run_step(tokens, lengths).clone() for e in engs)
            assert torch.equal(a, b), (it, S)
        ev = [e.step() for e in engs]
        assert [(x.slot, x.token) for x in ev[0]] == \
            [(x.slot, x.token) for x in ev[1]]
    for c0, c1 in zip(engs[0].cache, engs[1].cache):
        assert torch.equal(c0["k"], c1["k"]) and torch.equal(c0["v"],
                                                             c1["v"])
    assert engs[1].compile_plane.stalls == 0


@pytest.mark.parametrize("spec", [0, 4])
def test_k3_launches_equal_with_and_without_graphs(dev, spec):
    m = _card_model(dev, torch.bfloat16)
    prompts = [np.tile(np.arange(1, 6), 20)[:n].astype(np.int32)
               for n in (33, 17, 60)]
    counts, outs = [], []
    for w in ("off", "sync"):
        eng = P.SlotEngine(m, n_slots=3, spec_draft_len=spec, warmup=w,
                           device=dev)
        launches.reset()
        outs.append(_drive(eng, prompts, new=(20, 14, 9)))
        counts.append(launches.shapes("paged_decode_attention"))
    assert counts[0] == counts[1] and counts[0]
    assert any(",S=1," in k for k in counts[1])
    if spec:
        assert any(",S=1," not in k for k in counts[1])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_replay_after_reset(dev):
    m = _card_model(dev, torch.float32)
    eng = P.SlotEngine(m, n_slots=3, spec_draft_len=4, warmup="sync",
                       device=dev)
    prompts = [np.tile(np.arange(3, 10), 10)[:n].astype(np.int32)
               for n in (30, 12, 44)]
    first = _drive(eng, prompts)
    ptrs = [c["k"].data_ptr() for c in eng.cache]
    eng.reset()
    assert [c["k"].data_ptr() for c in eng.cache] == ptrs
    again = _drive(eng, prompts)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(b, a)
    plane = eng.compile_plane
    assert plane.stalls == 0 and plane.replays == eng.steps_run
    assert plane.pool_bytes() > 0
