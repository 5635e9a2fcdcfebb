"""The port's MoE FFN held against the JAX package's flax ``MoEFFN`` on the
CPU, given the same parameters: the gather form's output, gradients and
load-balance loss, the reference's dense einsum form (the plain version)
against the gather form, top-k ties and capacity drops, the MoE text
encoder, five train steps, and the tiny ``DeepTextClassifier(numExperts=4)``
end to end.

Tolerances: at f32, outputs and the aux loss within 1e-6 of their scale
and gradients within 1e-5 (both sides contract the same values; the
router's matmul and the K-term combine sum in other orders); at bf16,
outputs within 2 bf16 ulps of their scale (2^-7 relative: the experts'
bf16 GEMMs accumulate in other orders); train steps and the estimator
at the dense encoder's tolerances (``tests/test_torch_dl_training.py``,
``tests/test_torch_dl_estimators.py``).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu import Dataset as JDataset
from synapseml_tpu.models.dl import estimators as JE
from synapseml_tpu.models.dl import training as JTr
from synapseml_tpu.models.dl import transformer as JT
from synapseml_tpu.models.dl.moe import MoEFFN as JMoE
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import estimators as PE
from synapseml_tpu_torch.models.dl import training as PTr
from synapseml_tpu_torch.models.dl import transformer as PT
from synapseml_tpu_torch.models.dl.moe import MoEFFN, capacity, route

from test_torch_dl_estimators import (TEXT_KW, _carry_jax_init, _proba,
                                      text_data)
from test_torch_dl_training import (STEPS, TEXT_OPT, _assert_params,
                                    _batches, _run_jax, _run_port,
                                    _text_batch)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

B, S, D, FF, E = 3, 8, 16, 32, 4


def _pair(dtype, tdtype, top_k=2, cf=1.0, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)
    jm = JMoE(num_experts=E, d_ff=FF, top_k=top_k, capacity_factor=cf,
              dtype=dtype)
    v = flax.linen.meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(x, dtype)))
    tm = MoEFFN(E, D, FF, top_k=top_k, capacity_factor=cf, dtype=tdtype,
                device="cpu")
    tm.load_state_dict({k: torch.from_numpy(np.array(v["params"][k]))
                        for k in ("router", "w_up", "w_down")})
    return x, jm, v, tm


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 1.0), (2, 0.5),
                                      (2, 1.25), (3, 2.0)])
@pytest.mark.parametrize("dtype,tdtype,tol", [
    (jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 2**-7)])
def test_moe_equals_flax(dtype, tdtype, tol, top_k, cf):
    x, jm, v, tm = _pair(dtype, tdtype, top_k, cf)
    want, st = jm.apply(v, jnp.asarray(x, dtype), mutable=["losses"])
    for dense in (False, True):
        with torch.no_grad():
            got = tm(torch.from_numpy(x).to(tdtype), dense=dense)
        assert got.dtype == tdtype and got.shape == (B, S, D)
        _close(got.float().numpy(), np.asarray(want, np.float32), tol)
        _close(float(tm.aux_loss), float(st["losses"]["moe_aux"][0]), 1e-6)


def test_moe_gradients_equal_flax():
    x, jm, v, tm = _pair(jnp.float32, torch.float32, 2, 0.75)
    ct = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)

    def jloss(params, xx):
        out, st = jm.apply({"params": params}, xx, mutable=["losses"])
        return jnp.sum(out * ct) + st["losses"]["moe_aux"][0]
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    for dense in (False, True):
        tm.zero_grad()
        xt = torch.from_numpy(x).requires_grad_(True)
        (torch.sum(tm(xt, dense=dense) * torch.from_numpy(ct))
         + tm.aux_loss).backward()
        _close(xt.grad.numpy(), np.asarray(jgx), 1e-5)
        for k in ("router", "w_up", "w_down"):
            _close(getattr(tm, k).grad.numpy(), np.asarray(jg[k]), 1e-5)


@pytest.mark.parametrize("tdtype", [torch.float32, torch.bfloat16])
def test_gather_equals_dense(tdtype):
    """The gather form against the reference's einsum form (the plain
    version) on the same module: outputs within 1e-6 (f32) or one bf16
    ulp of their scale, gradients within 1e-5 (f32)."""
    _, _, _, tm = _pair(jnp.float32, tdtype, 2, 0.75, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, S, D)).astype(np.float32)).to(tdtype)
    outs, grads = [], []
    for dense in (False, True):
        tm.zero_grad()
        xx = x.clone().requires_grad_(True)
        out = tm(xx, dense=dense)
        out.float().square().sum().backward()
        outs.append(out.detach().float().numpy())
        grads.append([xx.grad.float().numpy()]
                     + [getattr(tm, k).grad.numpy()
                        for k in ("router", "w_up", "w_down")])
    tol = 1e-6 if tdtype == torch.float32 else 2**-8
    _close(outs[0], outs[1], tol)
    if tdtype == torch.float32:
        for a, b in zip(*grads):
            _close(a, b, 1e-5)


def test_ties_go_to_the_lower_expert_like_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.1, 0.3, 0.3],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti, _, _ = route(torch.from_numpy(probs), k, 8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_uniform_router_ties_and_drops_equal_flax():
    """A zero router gives every token the same probabilities: every
    choice ties, all tokens pick experts 0 and 1, and the capacity drops
    the later tokens; the output equals flax's."""
    x, jm, v, tm = _pair(jnp.float32, torch.float32, 2, 1.0)
    v["params"]["router"] = np.zeros_like(v["params"]["router"])
    with torch.no_grad():
        tm.router.zero_()
    want, _ = jm.apply(v, jnp.asarray(x), mutable=["losses"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), 1e-6)
    C_ = capacity(1.0, 2, B * S, E)
    assert float(tm.dropped) == pytest.approx(1 - 2 * C_ / (2 * B * S))


def test_slot_major_priority():
    """Every token's first choice takes a slot before any second choice;
    within a choice rank, earlier tokens first (the Switch rule)."""
    probs = torch.tensor([[0.6, 0.4], [0.3, 0.7], [0.55, 0.45]])
    _, idx, pos, keep = route(probs, 2, 2)
    # expert 0: first choices of tokens 0 and 2 (slots 0, 1), then the
    # second choice of token 1 (slot 2, dropped)
    assert idx.tolist() == [[0, 1], [1, 0], [0, 1]]
    assert pos.tolist() == [[0, 1], [0, 2], [1, 2]]
    assert keep.tolist() == [[True, True], [True, False],
                             [True, False]]


def _moe_cfgs():
    jcfg = JT.TransformerConfig.tiny(num_classes=3, dtype=jnp.float32,
                                     dropout_rate=0.0, num_experts=4)
    pcfg = PT.TransformerConfig.tiny(num_classes=3, dtype=torch.float32,
                                     dropout_rate=0.0, num_experts=4)
    return jcfg, pcfg


def test_moe_encoder_equals_flax():
    jcfg, pcfg = _moe_cfgs()
    (ids, mask), _ = _text_batch(np.random.default_rng(4))
    jmod = JT.TextEncoder(jcfg)
    v = flax.linen.meta.unbox(jmod.init(jax.random.PRNGKey(0), ids, mask))
    assert "moe_ffn" in v["params"]["layer_1"]
    assert "moe_ffn" not in v["params"]["layer_0"]
    v = jax.tree.map(np.asarray, v)
    want = jmod.apply(v, ids, mask)
    model = PT.TextEncoder(pcfg, device="cpu", seed=None)
    model.load_state_dict(C.params_from_reference(v, pcfg, "cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got.numpy(), np.asarray(want), 1e-5)
    assert len(model.aux_losses()) == 1


def test_moe_five_steps_equal_jax():
    """Five adamw steps with the aux loss in the objective: losses within
    1e-5 relative, parameters within 1e-5 (the dense encoder's
    tolerances)."""
    jcfg, pcfg = _moe_cfgs()
    batches = _batches(5, STEPS, _text_batch)
    init, jl, final = _run_jax(JT.TextEncoder(jcfg),
                               JTr.OptimizerConfig(**TEXT_OPT), batches)
    pl, sd = _run_port(PT.TextEncoder(pcfg, device="cpu", seed=None),
                       PTr.OptimizerConfig(**TEXT_OPT), batches, init, pcfg)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params(sd, final, 1e-5)
    moved = np.abs(final["params"]["layer_1"]["moe_ffn"]["router"]
                   - init["params"]["layer_1"]["moe_ffn"]["router"]).max()
    assert moved > 1e-5


def test_tiny_moe_estimator_equals_jax(monkeypatch):
    data = text_data(48)
    kw = dict(TEXT_KW, numExperts=4, moeTopK=2)
    _carry_jax_init(monkeypatch, None)
    jm = JE.DeepTextClassifier(numDevices=1, **kw).fit(JDataset(data))
    pm = PE.DeepTextClassifier(device="cpu", **kw).fit(Dataset(data))
    for a, b in zip(jm.modelPayload["history"], pm.modelPayload["history"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    jo = jm.transform(JDataset(data))
    po = pm.transform(Dataset(data))
    np.testing.assert_allclose(_proba(po), _proba(jo), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(po["prediction"], jo["prediction"])
