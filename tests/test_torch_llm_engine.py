"""The port's continuous-batching ``SlotEngine`` held against the JAX
package's dense ``generate`` on the same parameters, on the CPU.

``LlamaConfig.tiny(num_layers=2, max_len=96)`` in f32.  The engine runs
the paged read (``attention_backend='auto'`` resolves to it; on the CPU
the K3 wrapper takes its plain version).  Greedy tokens must equal the
reference's exactly: plain, with mid-flight admission, across tile and
bucket boundaries, and with speculative verify steps.  Prefix reuse and
preempt/resume are held to the dense-path contract the reference states
— tokens exact against a cold engine, prefill logits within atol 1e-5
(the reference's own bitwise pin of these logits does not hold on its
current jax; the port does not copy that pin).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.models import llm as P
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


@pytest.fixture(scope="module")
def pair():
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=jnp.float32)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=96, dtype=torch.float32)
    jm = J.LlamaModel(jcfg)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(params, tcfg, "cpu"))
    return jm, variables, tm


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 512, (n, length)).astype(np.int32)


def _engine(tm, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    return P.SlotEngine(tm, device="cpu", **kw)


def test_greedy_token_exact_vs_reference_generate(pair):
    jm, variables, tm = pair
    ids = _prompts(3, 7)
    ref = J.generate(jm, variables, ids, max_new_tokens=10)
    assert np.array_equal(P.generate(tm, ids, max_new_tokens=10), ref)
    eng = _engine(tm)
    assert eng.attention_backend == "paged"
    slots = {i: eng.admit(ids[i], 10).slot for i in range(3)}
    out = eng.run_to_completion()
    for i in range(3):
        np.testing.assert_array_equal(out[slots[i]], ref[i])


def test_mid_flight_admission_token_exact(pair):
    jm, variables, tm = pair
    ids = _prompts(2, 9, seed=1)
    ref_a = J.generate(jm, variables, ids[0:1], max_new_tokens=14)[0]
    ref_b = J.generate(jm, variables, ids[1:2], max_new_tokens=6)[0]
    eng = _engine(tm)
    ra = eng.admit(ids[0], 14)
    for _ in range(5):
        eng.step()
    rb = eng.admit(ids[1], 6)          # admitted mid-flight
    while eng.active.any():
        eng.step()
    np.testing.assert_array_equal(eng.generated_ids(ra.slot), ref_a)
    np.testing.assert_array_equal(eng.generated_ids(rb.slot), ref_b)


def test_spans_across_tile_and_bucket_boundaries(pair):
    """From span 30 to 70 (the 32-token tile and the one-to-two-tile
    bucket), and a span that runs the cache to its last row."""
    jm, variables, tm = pair
    ids = _prompts(1, 30, seed=7)
    ref = J.generate(jm, variables, ids, max_new_tokens=40)[0]
    eng = _engine(tm, n_slots=2, max_len=96)
    assert eng._paged_geo.tile == 32
    r = eng.admit(ids[0], 40)
    eng.run_to_completion()
    np.testing.assert_array_equal(eng.generated_ids(r.slot), ref)
    ids = _prompts(1, 43, seed=8)
    ref = J.generate(jm, variables, ids, max_new_tokens=20)[0]
    eng = _engine(tm, n_slots=2)
    r = eng.admit(ids[0], 20)          # 43 + 20 + 1 == max_len
    eng.run_to_completion()
    np.testing.assert_array_equal(eng.generated_ids(r.slot), ref)


def test_speculative_verify_token_exact(pair):
    """Repeated-phrase prompts make the n-gram drafter hit, so most steps
    are multi-token verifies (S > 1 through the paged read); every
    committed token is still the reference's greedy token."""
    jm, variables, tm = pair
    base = _prompts(3, 5, seed=11)
    ids = np.tile(base, (1, 4))                 # 20 tokens, period 5
    ref = J.generate(jm, variables, ids, max_new_tokens=16)
    eng = _engine(tm, spec_draft_len=4)
    ra = eng.admit(ids[0], 16)
    rb = eng.admit(ids[1], 16)
    for _ in range(3):
        eng.step()
    rc = eng.admit(ids[2], 16)                 # mid-flight, spec on
    eng.run_to_completion()
    for r, i in ((ra, 0), (rb, 1), (rc, 2)):
        np.testing.assert_array_equal(eng.generated_ids(r.slot), ref[i])
    assert eng.spec_steps > 0 and eng.spec_drafted > 0
    assert eng.steps_run < 3 * 15              # drafts were accepted


def test_prefix_reuse_token_exact_vs_cold_engine(pair):
    jm, variables, tm = pair
    rng = np.random.default_rng(2)
    prefix = rng.integers(1, 512, 16).astype(np.int32)
    p1 = np.concatenate([prefix, rng.integers(1, 512, 6).astype(np.int32)])
    p2 = np.concatenate([prefix, rng.integers(1, 512, 6).astype(np.int32)])
    warm = _engine(tm, min_prefix=8)
    warm.admit(p1, 4)
    warm.run_to_completion()
    r_warm = warm.admit(p2, 4)
    assert r_warm.reused_tokens == 16 and warm.prefix_hits == 1
    cold = _engine(tm, min_prefix=8, attention_backend="dense")
    r_cold = cold.admit(p2, 4)
    np.testing.assert_allclose(r_warm.logits, r_cold.logits, atol=1e-5,
                               rtol=0)
    warm.run_to_completion()
    cold.run_to_completion()
    np.testing.assert_array_equal(warm.generated_ids(r_warm.slot),
                                  cold.generated_ids(r_cold.slot))
    ref = J.generate(jm, variables, p2[None], max_new_tokens=4)[0]
    np.testing.assert_array_equal(warm.generated_ids(r_warm.slot), ref)


def test_preempt_resume_token_exact(pair):
    """A preempted sequence resumes into another slot (a device prefix
    copy of its own retired row) and finishes with the uninterrupted
    sequence's tokens; a ticket whose prefix is indexed nowhere resumes
    by cold prefill, token-exact too."""
    jm, variables, tm = pair
    ids = _prompts(1, 12, seed=5)
    ref = J.generate(jm, variables, ids, max_new_tokens=12)[0]
    eng = _engine(tm, n_slots=3)
    r = eng.admit(ids[0], 12)
    for _ in range(4):
        eng.step()
    assert eng.preempt_slot() == r.slot
    ticket = eng.preempt(r.slot)
    assert not eng.active[r.slot] and ticket["kv_len"] == 16
    eng.admit(_prompts(1, 8, seed=6)[0], 3)   # takes another slot
    slot = eng.resume(ticket)
    assert slot not in (r.slot, None)
    eng.run_to_completion()
    np.testing.assert_array_equal(eng.generated_ids(slot), ref)
    cold = _engine(tm, n_slots=2)
    slot = cold.resume(ticket)
    cold.run_to_completion()
    np.testing.assert_array_equal(cold.generated_ids(slot), ref)


def test_retired_slot_kv_survives_neighbour_steps_bitwise(pair):
    jm, variables, tm = pair
    eng = _engine(tm, n_slots=3, min_prefix=8, spec_draft_len=4)
    r1 = eng.admit(_prompts(1, 14, seed=9)[0], 3)
    eng.run_to_completion()
    before = [(c["k"][r1.slot].clone(), c["v"][r1.slot].clone())
              for c in eng.cache]
    eng.admit(np.tile(_prompts(1, 4, seed=10)[0], 3), 20)
    eng.run_to_completion()                     # plain and verify steps
    assert eng.steps_run > 3
    for c, (k0, v0) in zip(eng.cache, before):
        assert torch.equal(c["k"][r1.slot], k0)
        assert torch.equal(c["v"][r1.slot], v0)


def test_eos_retires_like_reference(pair):
    """A sequence that emits ``eos_id`` retires on it, plain and
    speculative, with the reference's tokens up to it."""
    jm, variables, tm = pair
    ids = _prompts(1, 10, seed=15)
    free = J.generate(jm, variables, ids, max_new_tokens=12)[0]
    eos = int(free[4])
    stop = int(np.flatnonzero(free == eos)[0])
    ref = J.generate(jm, variables, ids, max_new_tokens=12, eos_id=eos)[0]
    np.testing.assert_array_equal(ref[:stop + 1], free[:stop + 1])
    for spec in (0, 4):
        eng = _engine(tm, eos_id=eos, spec_draft_len=spec)
        r = eng.admit(ids[0], 12)
        eng.run_to_completion()
        np.testing.assert_array_equal(eng.generated_ids(r.slot),
                                      free[:stop + 1])


def test_prefix_reuse_is_scoped_by_tenant(pair):
    _, _, tm = pair
    prompt = _prompts(1, 20, seed=16)[0]
    eng = _engine(tm, min_prefix=8)
    eng.admit(prompt, 2, tenant="a")
    eng.run_to_completion()
    assert eng.admit(prompt, 2, tenant="b").reused_tokens == 0
    assert eng.admit(prompt, 2, tenant="a").reused_tokens == 19


def test_cancel_and_reset(pair):
    _, _, tm = pair
    prompt = _prompts(1, 20, seed=17)[0]
    eng = _engine(tm, n_slots=2, min_prefix=8)
    r = eng.admit(prompt, 10)
    eng.step()
    eng.cancel(r.slot)
    assert not eng.active.any() and eng.step() == []
    assert eng.admit(prompt, 2).reused_tokens == 19   # cancelled K/V kept
    eng.reset()
    assert not eng.active.any()
    assert all(not c["k"].any() and not c["v"].any() for c in eng.cache)
    assert eng.admit(prompt, 2).reused_tokens == 0    # nothing cached


def test_byte_ledger_equals_reference_engine(pair):
    jm, variables, tm = pair
    ids = _prompts(2, 9, seed=13)
    totals = {}
    for backend, jax_backend in (("paged", "interpret"),
                                 ("dense", "dense")):
        je = J.SlotEngine(jm, variables, n_slots=4, max_len=64,
                          attention_backend=jax_backend)
        te = _engine(tm, attention_backend=backend)
        for e in (je, te):
            e.admit(ids[0], 6)
            e.admit(ids[1], 6)
            e.run_to_completion()
        assert te.decode_attn_bytes == je.decode_attn_bytes > 0
        totals[backend] = te.decode_attn_bytes
    assert totals["paged"] < totals["dense"]


def test_sampling_reproducible_and_inside_top_k(pair):
    _, _, tm = pair
    rng = np.random.default_rng(12)
    logits = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32))
    top = torch.topk(logits, 5, dim=-1).indices
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        draws.append(P.sample_logits(logits, g, 0.8, 5, 1.0))
    assert torch.equal(draws[0], draws[1])
    assert bool((top == draws[0][:, None].long()).any(dim=1).all())
    nucleus = P.sample_logits(logits, torch.Generator().manual_seed(4),
                              1.0, 0, 0.5)
    assert nucleus.shape == (64,) and nucleus.dtype == torch.int32
    assert torch.equal(P.sample_logits(logits, None, 0.0, 5, 0.9),
                       torch.argmax(logits, -1).int())
    ids = _prompts(2, 7, seed=14)
    outs = []
    for _ in range(2):
        eng = _engine(tm, temperature=0.9, top_k=4, seed=21)
        slots = [eng.admit(ids[i], 8).slot for i in range(2)]
        res = eng.run_to_completion()
        outs.append([res[s] for s in slots])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_unported_options_raise(pair):
    _, _, tm = pair
    # the step profiler is ported: an engine takes one, and refuses an
    # object that is not one before any work
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    prof = StepProfiler("pt-unported-prof")
    assert _engine(tm, step_profiler=prof).step_profiler is prof
    with pytest.raises(TypeError, match="StepProfiler"):
        _engine(tm, step_profiler=object())
    # the host KV arena is ported: an engine takes one
    arena = P.HostKVArena(1 << 20, name="pt-unported-arena")
    assert _engine(tm, kv_arena=arena).kv_arena is arena
    with pytest.raises(ValueError, match="greedy"):
        _engine(tm, spec_draft_len=2, temperature=0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.SlotEngine(tm)
