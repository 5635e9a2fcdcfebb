"""The rest of the LLM slice on the card: the int8 engine, the host KV
arena's restore and preempt/resume, and K3's launches under int8.  Marked
``gpu``: every test skips where no card is present.  Run on a machine
with a card:

    python -m pytest -m gpu tests/test_torch_llm_tier_cuda.py
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models import llm as P
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_model(dev, dtype):
    """Llama-3.2-1B heads (32 / 8, d_head 64) at 2 layers, vocabulary and
    MLP cut; random weights in ``dtype``."""
    cfg = P.LlamaConfig.llama3_1b(num_layers=2, max_len=256,
                                  vocab_size=2048, d_ff=1024, dtype=dtype)
    return P.cast_params(P.LlamaModel(cfg, device=dev, seed=3), dtype)


def _prompts():
    return [np.tile(np.arange(2, 9), 12)[:n].astype(np.int32)
            for n in (33, 17, 60)]


def _drive(eng, prompts, new=(20, 14, 9)):
    r = [eng.admit(prompts[0], new[0]), eng.admit(prompts[1], new[1])]
    for _ in range(3):
        eng.step()
    r.append(eng.admit(prompts[2], new[2]))
    eng.run_to_completion()
    return [np.asarray(eng.generated_ids(x.slot)) for x in r]


@pytest.mark.parametrize("spec", [0, 4])
def test_int8_graph_engine_equals_eager(dev, spec):
    q = P.quantize_int8(_card_model(dev, torch.bfloat16))
    assert q.layers[0].attn.q_proj.kernel_q.dtype == torch.int8
    outs = []
    for w in ("off", "sync"):
        eng = P.SlotEngine(q, n_slots=3, spec_draft_len=spec, warmup=w,
                           device=dev)
        outs.append(_drive(eng, _prompts()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert eng.compile_plane.stalls == 0


def test_k3_launches_of_int8_equal_bf16(dev):
    m = _card_model(dev, torch.bfloat16)
    counts = []
    for model in (m, P.quantize_int8(m)):
        eng = P.SlotEngine(model, n_slots=3, warmup="sync", device=dev)
        launches.reset()
        _drive(eng, _prompts())
        counts.append(launches.shapes("paged_decode_attention"))
    assert counts[0] == counts[1] and counts[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arena_restore_and_resume_on_card(dev, dtype):
    """A spilled span restored into a relaunched graph engine continues
    exactly as the engine that spilled it would (the restored K/V are the
    spilled bits); a preempted slot resumed through the arena gives the
    uninterrupted run's tokens."""
    m = _card_model(dev, dtype)
    arena = P.HostKVArena(1 << 28, name=f"card-arena-{dtype}")
    kw = dict(n_slots=2, warmup="sync", kv_arena=arena, device=dev)
    p1 = np.tile(np.arange(5, 16), 6)[:50].astype(np.int32)
    e1 = P.SlotEngine(m, **kw)
    r1 = e1.admit(p1, 12)
    out1 = e1.run_to_completion()[r1.slot]
    assert e1.spill_count == 1 and len(arena) == 1
    p2 = np.concatenate([p1, out1, np.arange(20, 36)]).astype(np.int32)
    # the reference: an engine that kept the span on the device and
    # copies it (bit for bit, the K/V the spill copied)
    ref_eng = P.SlotEngine(m, n_slots=2, warmup="sync", device=dev)
    ref_eng.admit(p1, 12)
    ref_eng.run_to_completion()
    rr2 = ref_eng.admit(p2, 16)
    assert rr2.reused_tokens == len(p1) + 11
    ref2 = ref_eng.run_to_completion()[rr2.slot]
    e2 = P.SlotEngine(m, **kw)
    r2 = e2.admit(p2, 16)
    assert r2.reused_tokens == len(p1) + 11
    np.testing.assert_array_equal(e2.run_to_completion()[r2.slot], ref2)
    assert e2.compile_plane.stalls == 0
    # preempt mid-decode, churn both slots, resume from the arena
    full = P.SlotEngine(m, n_slots=2, warmup="sync", device=dev)
    rf = full.admit(p1, 30)
    want = full.run_to_completion()[rf.slot]
    # (an arena of its own: a restore of p1 from the first arena would
    # prefill its last token in another bucket than the cold run)
    e3 = P.SlotEngine(m, **dict(kw, kv_arena=P.HostKVArena(
        1 << 28, name=f"card-arena-3-{dtype}")))
    r3 = e3.admit(p1, 30)
    for _ in range(7):
        e3.step()
    ticket = e3.preempt(r3.slot)
    e3.admit(np.arange(40, 70, dtype=np.int32), 5)
    e3.admit(np.arange(70, 95, dtype=np.int32), 5)
    e3.run_to_completion()
    slot = e3.resume(ticket)
    e3.run_to_completion()
    np.testing.assert_array_equal(e3.generated_ids(slot), want)
