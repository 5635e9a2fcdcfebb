"""The port's causal-LM fine-tuning held against the JAX package's on the
CPU: the templated corpus, ``causal_lm_loss`` and five adamw steps of a
tiny f32 Llama from the JAX init (``params_from_reference``), then the
JAX package's speculative contrast (``tests/test_llm.py``'s config) run
through the port's ``SlotEngine`` with ``spec_draft_len``.

Tolerances: the loss within 1e-6 (f32 log-softmax, reduction order); the
five steps' losses within 1e-5 relative and every weight within 1e-4 (an
f32 forward and backward in a different reduction order, through adam's
division by the root of the second moment).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu.models.llm import finetune as JF
from synapseml_tpu.models.llm import model as JM
from synapseml_tpu_torch.models import llm as P
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def test_corpus_equals_reference():
    for kw in ({}, {"field_range": (64, 256)},
               {"template": np.array([5, -1, 6, -1, -1, 7])}):
        a = JF.templated_log_corpus(np.random.default_rng(3), 5, 4, **kw)
        b = P.templated_log_corpus(np.random.default_rng(3), 5, 4, **kw)
        assert b.dtype == a.dtype == np.int32
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("masked", [False, True])
def test_causal_lm_loss_equals_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 11, 37)) * 4).astype(np.float32)
    ids = rng.integers(0, 37, (3, 11)).astype(np.int32)
    mask = (rng.random((3, 11)) > 0.3).astype(np.int32) if masked else None
    want = float(JM.causal_lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                                   None if mask is None
                                   else jnp.asarray(mask)))
    got = float(P.causal_lm_loss(torch.from_numpy(logits),
                                 torch.from_numpy(ids),
                                 None if mask is None
                                 else torch.from_numpy(mask)))
    assert got == pytest.approx(want, abs=1e-6, rel=1e-6)


def _pair(cfg_kw):
    jcfg = J.LlamaConfig.tiny(dtype=jnp.float32, **cfg_kw)
    tcfg = P.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    jm = J.LlamaModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu"))
    return jm, variables, tm, tcfg


def test_five_steps_equal_reference():
    jm, variables, tm, tcfg = _pair(dict(num_layers=2, max_len=64))
    rng = np.random.default_rng(1)
    batches = [P.templated_log_corpus(rng, 4, 2) for _ in range(5)]
    init, jstep = JF.make_lm_train_step(jm, 1e-3)
    opt = init(variables)
    jv, jl = variables, []
    for b in batches:
        jv, opt, l = jstep(jv, opt, jnp.asarray(b))
        jl.append(float(l))
    pinit, pstep = P.make_lm_train_step(tm, 1e-3)
    popt = pinit()
    pl = [float(pstep(popt, torch.from_numpy(b))) for b in batches]
    for a, b in zip(jl, pl):
        assert b == pytest.approx(a, rel=1e-5)
    want = P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(jv)), tcfg, "cpu")
    got = tm.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4,
                                   rtol=0, err_msg=k)
    # finetune_lm runs the same step: from the same start, the same loss
    tm2 = P.LlamaModel(tcfg, device="cpu")
    start = P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu")
    trained, final = P.finetune_lm(tm2, iter(batches), learning_rate=1e-3,
                                   variables=start, device="cpu")
    assert final == pytest.approx(pl[-1], rel=1e-6)
    for k, v in got.items():
        np.testing.assert_array_equal(trained[k].numpy(), v.numpy())


def test_finetune_lm_defaults_to_the_card():
    tm = P.LlamaModel(P.LlamaConfig.tiny(num_layers=1, dtype=torch.float32),
                      device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="model is on cpu"):
            P.finetune_lm(tm, [])
    else:
        with pytest.raises(RuntimeError):
            P.finetune_lm(tm, [])


def _tokens_per_step(tm, prompts, new, spec):
    """Greedy ids per prompt and the tokens each slot commits per decode
    step, over every slot-step (the first token comes from the
    prefill)."""
    eng = P.SlotEngine(tm, n_slots=len(prompts), max_len=tm.cfg.max_len,
                       spec_draft_len=spec, device="cpu")
    slots = [eng.admit(p, new).slot for p in prompts]
    slot_steps = committed = 0
    while eng.active.any():
        slot_steps += eng.active_count
        committed += len(eng.step())
    out = np.stack([eng.generated_ids(s) for s in slots])
    return out, committed / slot_steps


def test_speculative_contrast_after_finetune():
    """``tests/test_llm.py``'s target regime on the port: after
    ``finetune_lm`` on the templated corpus, greedy continuations are
    predictable and the engine's drafted verify steps commit more than
    1.5x the tokens per step of the random init, with output exactly the
    plain engine's."""
    def corpus(rng, n, n_rec):
        return P.templated_log_corpus(rng, n, n_rec, field_range=(64, 256))

    _, _, tm, _ = _pair(dict(vocab_size=256, d_model=128, num_layers=2,
                             num_heads=4, num_kv_heads=2, max_len=160))
    rng = np.random.default_rng(0)
    prompts = corpus(rng, 4, 3)
    plain0, _ = _tokens_per_step(tm, prompts, 32, 0)
    spec0, tps0 = _tokens_per_step(tm, prompts, 32, 7)
    np.testing.assert_array_equal(spec0, plain0)
    assert tps0 < 2.0, tps0
    P.finetune_lm(tm, (corpus(rng, 16, 6) for _ in range(150)),
                  learning_rate=1e-3, device="cpu")
    plain, _ = _tokens_per_step(tm, prompts, 32, 0)
    spec, tps = _tokens_per_step(tm, prompts, 32, 7)
    np.testing.assert_array_equal(spec, plain)
    assert tps > 1.5 * tps0, (tps0, tps)
