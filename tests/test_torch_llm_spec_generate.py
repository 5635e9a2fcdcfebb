"""The port's ``generate_speculative`` (prompt-lookup drafts verified
``draft_len`` at a time over the dense cache) held against the JAX
package's on the CPU (mirroring ``tests/test_llm.py``'s speculative
tests).

``LlamaConfig.tiny(num_layers=2, max_len=32)`` in f32, the JAX init
carried into the port.  The tokens equal greedy ``generate``'s (the
port's and the reference's) exactly, on repetitive and random rows at
two draft lengths and with an EOS that lands mid-draft; ``steps``,
``accepted``, ``drafted``, ``tokens_per_step`` and ``acceptance_rate``
equal the reference's; ``block=False`` returns the packed tensor that
``spec_unpack`` reads; the drafter equals the reference's on the same
context; a prompt shorter than the n-gram raises.
"""

import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.models import llm as P
from synapseml_tpu_torch.telemetry import get_registry
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

# the modules (each package's ``generate`` name is the function)
JG = importlib.import_module("synapseml_tpu.models.llm.generate")
PG = importlib.import_module("synapseml_tpu_torch.models.llm.generate")


@pytest.fixture(scope="module")
def pair():
    jcfg = J.LlamaConfig.tiny(num_layers=2, max_len=32, dtype=jnp.float32)
    tcfg = P.LlamaConfig.tiny(num_layers=2, max_len=32, dtype=torch.float32)
    jm = J.LlamaModel(jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((2, 8), jnp.int32))
    tm = P.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(P.params_from_reference(
        jax.tree.map(np.asarray, nn.meta.unbox(variables)), tcfg, "cpu"))
    return jm, variables, tm


def _prompt():
    rng = np.random.default_rng(3)
    base = rng.integers(1, 512, 5)
    prompt = np.concatenate([base, base])[None, :].repeat(3, 0)
    prompt[1] = rng.integers(1, 512, 10)          # a random row
    return prompt.astype(np.int32)


@pytest.mark.parametrize("draft_len", [3, 7])
def test_speculative_equals_greedy_and_reference_stats(pair, draft_len):
    jm, variables, tm = pair
    prompt = _prompt()
    ref = J.generate(jm, variables, prompt, max_new_tokens=12)
    np.testing.assert_array_equal(P.generate(tm, prompt, max_new_tokens=12),
                                  ref)
    out, stats = P.generate_speculative(tm, prompt, max_new_tokens=12,
                                        draft_len=draft_len)
    np.testing.assert_array_equal(out, ref)
    _, jstats = JG.generate_speculative(jm, variables, prompt,
                                        max_new_tokens=12,
                                        draft_len=draft_len)
    assert stats == jstats
    assert stats["steps"] >= 1 and stats["tokens_per_step"] >= 1.0
    reg = get_registry()
    assert reg.get("llm_spec_tokens_per_step").value() == \
        stats["tokens_per_step"]


def test_speculative_eos_matches_greedy(pair):
    jm, variables, tm = pair
    prompt = np.random.default_rng(5).integers(1, 512, (2, 8)).astype(
        np.int32)
    ref = J.generate(jm, variables, prompt, max_new_tokens=10)
    eos = int(ref[0, 3])                           # a mid-stream stop
    ref_e = J.generate(jm, variables, prompt, max_new_tokens=10,
                       eos_id=eos, pad_id=0)
    out_e, stats = P.generate_speculative(tm, prompt, max_new_tokens=10,
                                          eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(out_e, ref_e)
    _, jstats = JG.generate_speculative(jm, variables, prompt,
                                        max_new_tokens=10, eos_id=eos,
                                        pad_id=0)
    assert stats == jstats


def test_block_false_and_spec_unpack(pair):
    _, _, tm = pair
    prompt = _prompt()
    out, stats = P.generate_speculative(tm, prompt, max_new_tokens=9,
                                        draft_len=4)
    packed = P.generate_speculative(tm, prompt, max_new_tokens=9,
                                    draft_len=4, block=False)
    assert isinstance(packed, torch.Tensor) and packed.shape == (3, 14)
    assert packed.dtype == torch.int32
    out2, stats2 = P.spec_unpack(packed, 9, 4)
    np.testing.assert_array_equal(out2, out)
    assert stats2 == stats


def test_ngram_draft_equals_reference():
    rng = np.random.default_rng(9)
    ctx = rng.integers(1, 6, (4, 24)).astype(np.int32)
    cur = np.array([24, 10, 3, 17], np.int32)
    draft = jax.jit(JG._ngram_draft, static_argnums=(2, 3))
    for ngram, k in ((2, 5), (3, 7)):
        jd, jv = draft(jnp.asarray(ctx), jnp.asarray(cur), k, ngram)
        pd, pv = PG._ngram_draft(torch.as_tensor(ctx), torch.as_tensor(cur),
                                 k, ngram)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_short_prompt_and_bad_budget_raise(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="ngram"):
        P.generate_speculative(tm, np.ones((1, 2), np.int32), ngram=3)
    with pytest.raises(ValueError, match="max_new_tokens"):
        P.generate_speculative(tm, np.ones((1, 4), np.int32),
                               max_new_tokens=0)
