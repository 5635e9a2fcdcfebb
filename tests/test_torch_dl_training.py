"""The port's DL trainer held against the JAX package's on the CPU: the
learning-rate schedules step by step against optax, the batch order, and
five train steps from the same weights (``convert.params_from_reference``)
on the same batches.

Tolerances:

- schedules: 1e-7 absolute (optax evaluates in f32, the port in Python
  floats; at learning rates ~1e-3 the two differ by ~1e-10);
- five f32 steps (dropout 0): losses within 1e-5 relative and parameters
  within 1e-5 (both sides compute in f32: the forward and backward differ
  by reduction order, ~1e-7, and adamw/sgd update in the same formulas
  in other op orders);
- ``bf16_grad`` with f32 compute: losses within 1e-5 relative; 99.9% of
  the parameters within 1e-5 and every one within 2e-4 (a weight moves
  up to ~2.5e-3 over these five updates).  Both sides cast each gradient
  to bf16 and run the clip and the moment products in bf16 with optax's
  promotion to the f32 moments, so what remains is the f32 gradients'
  reduction order: a gradient a hair from a bf16 rounding boundary rounds
  to a neighbour one ulp (2^-8 relative) away, and momentum that cancels
  gradients of opposite sign amplifies it (the largest difference reached
  on the CPU is 9.4e-5; 12 of 145,155 weights differ by more than 1e-5).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synapseml_tpu.models.dl import precision as JP
from synapseml_tpu.models.dl import resnet as JR
from synapseml_tpu.models.dl import training as JTr
from synapseml_tpu.models.dl import transformer as JT
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import precision as PP
from synapseml_tpu_torch.models.dl import resnet as PR
from synapseml_tpu_torch.models.dl import training as PTr
from synapseml_tpu_torch.models.dl import transformer as PT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

STEPS = 5


# -- schedules and batches ------------------------------------------------------

@pytest.mark.parametrize("schedule,warmup,total", [
    ("constant", 0, 20), ("cosine", 3, 20), ("cosine", 0, 1),
    ("cosine", 5, 5), ("linear", 0, 12), ("linear", 4, 0)])
def test_schedule_matches_optax(schedule, warmup, total):
    """The learning rate of every update, read at the count of updates
    already made, as optax's ``scale_by_learning_rate`` reads it."""
    jcfg = JTr.OptimizerConfig(schedule=schedule, warmup_steps=warmup,
                               total_steps=total, learning_rate=3e-3)
    pcfg = PTr.OptimizerConfig(schedule=schedule, warmup_steps=warmup,
                               total_steps=total, learning_rate=3e-3)
    # optax's sgd without momentum moves a unit-gradient parameter by -lr
    tx = JTr.OptimizerConfig(**{**jcfg.__dict__, "name": "sgd",
                                "momentum": 0.0}).build()
    p = jnp.zeros(())
    st = tx.init(p)
    lr = pcfg.schedule_fn()
    for count in range(total + 6):
        upd, st = tx.update(jnp.ones(()), st, p)
        assert abs(-float(upd) - lr(count)) < 1e-7, count
    if schedule == "cosine":
        assert lr(0) == 0.0


def test_minibatches_are_the_reference_batches():
    for n, bs in ((37, 8), (5, 8), (64, 16)):
        a = list(JTr.iterate_minibatches(n, bs, 1, np.random.default_rng(3)))
        b = list(PTr.iterate_minibatches(n, bs, 1, np.random.default_rng(3)))
        assert len(a) == len(b) == PTr.num_minibatches(n, bs, 1)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# -- five train steps -----------------------------------------------------------

def _batches(seed, n_batches, make):
    rng = np.random.default_rng(seed)
    return [make(rng) for _ in range(n_batches)]


def _text_batch(rng, bs=8, s=12):
    ids = rng.integers(0, 1024, (bs, s)).astype(np.int32)
    mask = np.ones((bs, s), bool)
    mask[::3, 7:] = False
    return (ids, mask), rng.integers(0, 3, bs).astype(np.int32)


def _run_jax(model, opt, batches, precision=None, **kw):
    tr = JTr.DLTrainer(model, opt, JTr.make_dl_mesh(1, 1),
                       precision=precision, **kw)
    state = tr.init_state(0, *batches[0][0])
    init = jax.tree.map(np.asarray, nn.meta.unbox(
        {"params": state.params, **state.extra_vars}))
    step = tr.train_step()
    losses = []
    key = jax.random.PRNGKey(0)
    for inputs, labels in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in inputs),
                        jnp.asarray(labels), key)
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, nn.meta.unbox(
        {"params": state.params, **state.extra_vars}))
    return init, losses, final


def _run_port(model, opt, batches, init, cfg_or_name, precision=None, **kw):
    tr = PTr.DLTrainer(model, opt, "cpu", precision=precision, **kw)
    state = tr.init_state(123)
    model.load_state_dict(C.params_from_reference(init, cfg_or_name, "cpu"))
    step = tr.train_step()
    losses = []
    for inputs, labels in batches:
        state, m = step(state, tr.shard_batch(inputs),
                        torch.from_numpy(labels), 0)
        losses.append(float(m["loss"]))
        assert m["loss"].dtype == torch.float32 and m["accuracy"].ndim == 0
    assert state.step == len(batches)
    return losses, model.state_dict()


def _assert_params(got, want_tree, atol):
    want = {}
    for coll in ("params", "batch_stats"):
        want.update(C.flatten_tree(want_tree.get(coll, {})))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=atol, rtol=0,
                                   err_msg=k)


TEXT_OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
                schedule="cosine", warmup_steps=2, total_steps=STEPS,
                grad_clip_norm=1.0)


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_text_five_steps_equal_jax(name):
    opt = {**TEXT_OPT, "name": name}
    batches = _batches(0, STEPS, _text_batch)
    jcfg = JT.TransformerConfig.tiny(num_classes=3, dtype=jnp.float32,
                                     dropout_rate=0.0)
    init, jl, final = _run_jax(JT.TextEncoder(jcfg),
                               JTr.OptimizerConfig(**opt), batches)
    pcfg = PT.TransformerConfig.tiny(num_classes=3, dtype=torch.float32,
                                     dropout_rate=0.0)
    pl, sd = _run_port(PT.TextEncoder(pcfg, device="cpu", seed=None),
                       PTr.OptimizerConfig(**opt), batches, init, pcfg)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params(sd, final, 1e-5)
    # the first update is at lr(0) = 0 and the last ones moved weights
    assert pl[0] == pytest.approx(jl[0], rel=1e-6)
    assert np.abs(final["params"]["pooler"]["kernel"]
                  - init["params"]["pooler"]["kernel"]).max() > 1e-4


def test_text_bf16_grad_steps_equal_jax():
    """``bf16_grad`` over an f32 model: both cast the gradients to bf16
    and clip and update them in bf16 with optax's promotion (tolerance in
    the module docstring)."""
    batches = _batches(1, STEPS, _text_batch)
    jcfg = JT.TransformerConfig.tiny(num_classes=3, dtype=jnp.float32,
                                     dropout_rate=0.0)
    jpol = JP.PrecisionPolicy("bf16_grad", jnp.float32, jnp.bfloat16)
    init, jl, final = _run_jax(JT.TextEncoder(jcfg),
                               JTr.OptimizerConfig(**TEXT_OPT), batches,
                               precision=jpol)
    pcfg = PT.TransformerConfig.tiny(num_classes=3, dtype=torch.float32,
                                     dropout_rate=0.0)
    ppol = PP.PrecisionPolicy("bf16_grad", torch.float32, torch.bfloat16)
    pl, sd = _run_port(PT.TextEncoder(pcfg, device="cpu", seed=None),
                       PTr.OptimizerConfig(**TEXT_OPT), batches, init, pcfg,
                       precision=ppol)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params(sd, final, 2e-4)
    want = C.flatten_tree(final["params"])
    diff = np.concatenate([np.abs(sd[k].numpy() - v).ravel()
                           for k, v in want.items()])
    assert np.quantile(diff, 0.999) < 1e-5


def test_resnet_sgd_five_steps_equal_jax():
    """sgd with momentum over ResNet-18: losses, parameters and the batch
    statistics each step's forward updates."""
    def batch(rng):
        x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
        return (x,), rng.integers(0, 2, 8).astype(np.int32)

    opt = dict(name="sgd", learning_rate=0.05, momentum=0.9,
               schedule="constant", grad_clip_norm=1.0, total_steps=STEPS)
    batches = _batches(2, STEPS, batch)
    init, jl, final = _run_jax(
        JR.make_backbone("resnet18", 2, dtype=jnp.float32),
        JTr.OptimizerConfig(**opt), batches, has_batch_stats=True,
        train_kwarg="train")
    pl, sd = _run_port(
        PR.make_backbone("resnet18", 2, dtype=torch.float32, device="cpu",
                         seed=None),
        PTr.OptimizerConfig(**opt), batches, init, "resnet18",
        has_batch_stats=True, train_kwarg="train")
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params(sd, final, 1e-5)


def test_clip_scales_only_above_the_norm():
    """optax's clip_by_global_norm: no epsilon, and gradients below the
    norm pass unchanged."""
    opt = PTr.OptimizerConfig(grad_clip_norm=1.0).build(
        torch.nn.Linear(2, 2).parameters())
    small = [torch.tensor([0.3, 0.4])]
    assert torch.equal(opt._clip(small)[0], torch.tensor([0.3, 0.4]))
    big = opt._clip([torch.tensor([3.0, 4.0]), torch.tensor([0.0])])
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.array([3.0, 4.0]), jnp.array([0.0])], None)[0]
    np.testing.assert_allclose(big[0].numpy(), np.asarray(want[0]),
                               rtol=1e-7)


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_clip_equals_optax_bits(dtype, jdtype):
    """Gradients are clipped in their own dtype, bf16 included (the norm
    summed leaf by leaf in bf16), to optax's bits."""
    opt = PTr.OptimizerConfig(grad_clip_norm=1.0).build(
        torch.nn.Linear(2, 2).parameters())
    small = [torch.tensor([0.3, 0.4], dtype=dtype)]
    assert torch.equal(opt._clip(small)[0], small[0])
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=n).astype(np.float32) * 3 for n in (7, 130, 1)]
    big = opt._clip([torch.from_numpy(v).to(dtype) for v in leaves])
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(v, jdtype) for v in leaves], None)[0]
    for got, w in zip(big, want):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w, np.float32))


def test_bf16_grad_rounds_through_bf16_and_keeps_f32():
    g = {"w": torch.tensor([1.0 + 2 ** -10, 3.0]), "i": torch.tensor([1])}
    r = PP.round_to(g, torch.bfloat16)
    assert r["w"].dtype == torch.float32 and torch.equal(r["i"], g["i"])
    assert torch.equal(r["w"], torch.tensor([1.0, 3.0]))
    c = PP.cast_floating(g, torch.bfloat16)
    assert c["w"].dtype == torch.bfloat16 and c["i"].dtype == torch.int64
    assert PP.resolve_precision("bf16_grad").casts_grads
    assert not PP.resolve_precision(None).casts_grads
    assert PP.PRECISION_CODE == JP.PRECISION_CODE
    with pytest.raises(ValueError):
        PP.resolve_precision("fp8")
