"""The GPipe pipeline over a ``pipe`` axis of gloo ranks held against the
JAX package's ``parallel/pipeline.py`` and ``models/dl/pipeline.py`` on
its 8 virtual devices, on the CPU: the five cases of
``tests/test_pipeline_parallel.py`` on the same stacked parameters.

One gang of 4 ranks serves every case
(``tests/torch_gang_tasks.py:pipeline_cases``), each on its own mesh:

- the MLP stages at pipe 4, 8 microbatches (JAX: pipe 4): outputs within
  1e-5 (the reference's rtol and atol);
- their loss gradients at pipe 2 (JAX: pipe 2; the port's data axis of
  2 runs the same pipeline twice): rtol 1e-4, atol 1e-5, the reference's;
- with data parallelism, the microbatch rows sharded over data (JAX:
  data 4 x pipe 2, the port data 2 x pipe 2): outputs within 1e-5;
- the pipelined TextEncoder (4 layers, d 32, f32, dropout off) at pipe 2
  x data 2 (JAX: pipe 2 x data 4), 2 microbatches: the loss within rtol
  5e-5 of JAX's and of the sequential model's, every gradient leaf
  within rtol 2e-3 / atol 1e-5 of JAX's (the reference's bounds);
- split and merge: the identity on a state dict, and the stacked leaves
  equal to JAX's ``split_encoder_stages`` of the same weights.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from synapseml_tpu.models.dl import TextEncoder as JTextEncoder
from synapseml_tpu.models.dl import TransformerConfig as JConfig
from synapseml_tpu.models.dl.pipeline import (
    merge_encoder_stages as j_merge, pp_train_loss as j_pp_train_loss,
    split_encoder_stages as j_split)
from synapseml_tpu.parallel.mesh import DATA_AXIS, PIPE_AXIS, make_mesh
from synapseml_tpu.parallel.pipeline import (pipeline_apply as j_apply,
                                             pipeline_loss as j_loss,
                                             stack_stage_params as j_stack)
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import pipeline as PP
from synapseml_tpu_torch.parallel import run_on_local_cluster

import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

GANG_TIMEOUT_S = 240.0
ENC = dict(vocab_size=128, max_len=16, num_layers=4, num_heads=2,
           d_model=32, d_ff=64, num_classes=3, dropout_rate=0.0)


def _mlp(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stages(seed, n_stages, d):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(scale=0.3, size=(d, d)).astype(np.float32),
             "b": rng.normal(scale=0.1, size=(d,)).astype(np.float32)}
            for _ in range(n_stages)], rng


def _run_apply(stacked, x, mesh, x_spec):
    fn = jax.jit(jax.shard_map(lambda p, xx: j_apply(_mlp, p, xx),
                               mesh=mesh, in_specs=(P(PIPE_AXIS), x_spec),
                               out_specs=x_spec, check_vma=False))
    return np.asarray(fn(stacked, x))


class _Refs:
    def __init__(self, root):
        self.root = root
        self.jax, cases = {}, {}
        # (1) sequential match: pipe 4, M 8, mb 4, d 16
        per, rng = _stages(0, 4, 16)
        x = rng.normal(size=(8, 4, 16)).astype(np.float32)
        self.jax["seq"] = _run_apply(j_stack(per), x,
                                     make_mesh({PIPE_AXIS: 4}), P())
        cases["seq"] = self._save("seq", per, x, mesh={"pipe": 4})
        # (2) gradients: pipe 2, M 4, mb 2, d 8
        per, rng = _stages(1, 2, 8)
        x = rng.normal(size=(4, 2, 8)).astype(np.float32)
        y = rng.normal(size=(4, 2, 8)).astype(np.float32)
        smapped = jax.shard_map(
            lambda p, xx: j_loss(_mlp, p, xx,
                                 lambda out: jnp.mean((out - y) ** 2)),
            mesh=make_mesh({PIPE_AXIS: 2}), in_specs=(P(PIPE_AXIS), P()),
            out_specs=P(), check_vma=False)
        g = jax.jit(jax.grad(smapped))(j_stack(per), x)
        self.jax["grads"] = {k: np.asarray(v) for k, v in g.items()}
        self.jax["grads_loss"] = float(jax.jit(smapped)(j_stack(per), x))
        cases["grads"] = self._save("grads", per, x, y=y,
                                    mesh={"data": 2, "pipe": 2})
        # (3) with data parallelism: M 4, mb 8, d 8, rows over data
        per, rng = _stages(2, 2, 8)
        x = rng.normal(size=(4, 8, 8)).astype(np.float32)
        self.jax["data"] = _run_apply(
            j_stack(per), x, make_mesh({DATA_AXIS: 4, PIPE_AXIS: 2}),
            P(None, DATA_AXIS))
        cases["data"] = self._save("data", per, x, shard_x=True,
                                   mesh={"data": 2, "pipe": 2})
        # (4) the pipelined TextEncoder
        self.encoder(root)
        self.ranks = run_on_local_cluster(
            "torch_gang_tasks:pipeline_cases", 4,
            task_args=dict(device="cpu", cases=cases,
                           encoder=self.enc_case),
            device="cpu", timeout_s=GANG_TIMEOUT_S)
        self.port = {name: G._load_npz(c["out"]) for name, c in cases.items()}
        self.port_enc = G._load_npz(self.enc_case["out"])

    def _save(self, name, per, x, y=None, shard_x=False, mesh=None):
        z = {"w": np.stack([p["w"] for p in per]),
             "b": np.stack([p["b"] for p in per]), "x": x}
        if y is not None:
            z["y"] = y
        G._save_npz(self._p(f"{name}.npz"), z)
        return dict(data=self._p(f"{name}.npz"), mesh=mesh, shard_x=shard_x,
                    out=self._p(f"{name}_out.npz"))

    def encoder(self, root):
        cfg = JConfig(dtype=jnp.float32, **ENC)
        model = JTextEncoder(cfg)
        rng = np.random.default_rng(0)
        B, S = 16, 16
        ids = rng.integers(0, 128, (B, S)).astype(np.int32)
        mask = np.ones((B, S), bool)
        labels = rng.integers(0, 3, B).astype(np.int32)
        variables = nn.meta.unbox(model.init(jax.random.PRNGKey(0),
                                             jnp.asarray(ids[:2])))

        def seq_loss(v):
            logits = model.apply(v, jnp.asarray(ids), jnp.asarray(mask), True)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            return -jnp.mean(jnp.take_along_axis(
                logp, jnp.asarray(labels)[:, None], 1)[:, 0])

        self.jax["enc_seq_loss"] = float(seq_loss(variables))
        outer, stacked = j_split(variables, 2)
        loss_fn = j_pp_train_loss(cfg, make_mesh({PIPE_AXIS: 2,
                                                  DATA_AXIS: 4}),
                                  num_microbatches=2)
        l_pp, (g_outer, g_stacked) = jax.value_and_grad(
            loss_fn, argnums=(0, 1))(outer, stacked, jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(labels))
        self.jax["enc_loss"] = float(l_pp)
        self.jax["enc_grads"] = C.flatten_tree(jax.tree.map(
            np.asarray, j_merge(g_outer, g_stacked))["params"])
        self.jax["enc_stacked"] = C.flatten_tree(
            jax.tree.map(np.asarray, stacked))
        self.jax["enc_vars"] = jax.tree.map(np.asarray, variables)
        sd = C.params_from_reference(self.jax["enc_vars"],
                                     G._text_cfg(ENC), "cpu")
        G._save_npz(self._p("enc_init.npz"),
                    {k: v.numpy() for k, v in sd.items()})
        G._save_npz(self._p("enc_batch.npz"),
                    dict(ids=ids, mask=mask, labels=labels))
        self.enc_case = dict(cfg=ENC, init=self._p("enc_init.npz"),
                             batch=self._p("enc_batch.npz"),
                             mesh={"pipe": 2, "data": 2}, microbatches=2,
                             out=self._p("enc_out.npz"))

    def _p(self, name):
        return os.path.join(self.root, name)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return _Refs(str(tmp_path_factory.mktemp("pipe")))


def test_pipeline_matches_sequential(refs):
    np.testing.assert_allclose(refs.port["seq"]["out"], refs.jax["seq"],
                               rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_equal_jax(refs):
    """The backward through the inverse permutation gives the JAX
    pipeline's stage gradients (and the same loss on every rank)."""
    for k in ("w", "b"):
        np.testing.assert_allclose(refs.port["grads"][f"g_{k}"],
                                   refs.jax["grads"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    losses = [r["losses"]["grads"] for r in refs.ranks]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], refs.jax["grads_loss"], rtol=1e-5)


def test_pipeline_with_data_parallel(refs):
    np.testing.assert_allclose(refs.port["data"]["out"], refs.jax["data"],
                               rtol=1e-5, atol=1e-5)


def test_transformer_pp_matches_jax_and_sequential(refs):
    got = refs.port_enc
    np.testing.assert_allclose(float(got["loss"]), refs.jax["enc_loss"],
                               rtol=5e-5)
    np.testing.assert_allclose(float(got["loss"]), refs.jax["enc_seq_loss"],
                               rtol=5e-5)
    merged = PP.merge_encoder_stages(
        {k[6:]: torch.from_numpy(v) for k, v in got.items()
         if k.startswith("outer.")},
        {k[8:]: torch.from_numpy(v) for k, v in got.items()
         if k.startswith("stacked.")})
    want = refs.jax["enc_grads"]
    assert set(merged) == set(want)
    for k, v in want.items():
        g = merged[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, v, rtol=2e-3, atol=1e-5, err_msg=k)


def test_split_merge_round_trip(refs):
    """split ∘ merge is the identity on a TextEncoder state dict, and the
    stacked leaves are JAX's ``split_encoder_stages`` of the same
    weights."""
    sd = C.params_from_reference(refs.jax["enc_vars"], G._text_cfg(ENC),
                                 "cpu")
    outer, stacked = PP.split_encoder_stages(sd, 2)
    merged = PP.merge_encoder_stages(outer, stacked)
    assert set(merged) == set(sd)
    for k, v in sd.items():
        assert torch.equal(merged[k], v), k
    want = refs.jax["enc_stacked"]
    assert set(stacked) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(stacked[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        PP.split_encoder_stages(sd, 3)
