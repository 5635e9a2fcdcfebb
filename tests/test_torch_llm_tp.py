"""The Llama decoder over a ``model`` axis of gloo ranks (the Megatron
layout of the reference's ``LLM_LOGICAL_RULES``) held against the JAX
package's sharded decoder on its 8 virtual devices, on the CPU.

The reference's ``tests/test_llm.py`` tiny model (2 layers, 8 heads, 4
key-value heads, vocab 512): JAX places its parameters on a (data 2,
model 4) mesh by the logical rules; the port runs one gang of 2 ranks
(``model`` 2, ``tests/torch_gang_tasks.py:llm_tp``), each rank holding
its shard of the same weights (``load_full_state_dict``):

- bf16 compute (f32 parameters, as the reference holds them), untied
  head: logits within 8e-3 absolute of JAX's sharded forward, two bf16
  steps at the logits' scale (~0.78): both sides round to bf16 at every
  projection, and JAX's own sharded and replicated bf16 forwards differ
  by 5.5e-3 here, the port's one process and JAX's replicated by
  3.9e-3; and within 1e-6 of the port's one-process bf16 model (the
  row-parallel sums run in f32 and round where one process rounds);
- int8 weights (``quantize_int8`` of the JAX model, tied: ``QuantEmbed``
  vocab-parallel), f32 compute: logits within 1e-5 of JAX's sharded int8
  forward (``tests/test_torch_llm_int8.py``'s bound);
- f32, untied: greedy ``generate`` of 5 tokens on both ranks equal to
  JAX's replicated ``generate`` (the reference's
  ``test_tp_sharded_generation``), and each rank caches 2 of the 4
  key-value heads.
"""

import dataclasses
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from synapseml_tpu.models import llm as J
from synapseml_tpu_torch.models import llm as PL
from synapseml_tpu_torch.parallel import run_on_local_cluster

import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

GANG_TIMEOUT_S = 240.0
TINY = dict(num_layers=2, max_len=32)


def _sharded_forward(model, variables, ids):
    """The reference's TP forward: leaves placed by LLM_LOGICAL_RULES on a
    (data 2, model 4) mesh of the virtual devices."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))

    def put(leaf):
        if isinstance(leaf, nn.Partitioned):
            spec = nn.logical_to_mesh_axes(leaf.names,
                                           rules=J.LLM_LOGICAL_RULES)
            return leaf.replace_boxed(jax.device_put(
                leaf.value, NamedSharding(mesh, spec)))
        return leaf

    sharded = jax.tree.map(put, variables,
                           is_leaf=lambda x: isinstance(x, nn.Partitioned))
    batch = jax.device_put(jnp.asarray(ids),
                           NamedSharding(mesh, P("data", None)))
    out = jax.jit(lambda v, x: model.apply(v, x))(sharded, batch)
    assert "model" in str(out.sharding)
    return np.asarray(out)


class _Refs:
    def __init__(self, root):
        self.root = root
        rng = np.random.default_rng(0)
        self.ids = rng.integers(1, 512, (2, 16)).astype(np.int32)
        self.prompt = np.random.default_rng(3).integers(
            1, 512, (2, 5)).astype(np.int32)
        self.jax, states, cfgs = {}, {}, {}
        f32 = J.LlamaConfig.tiny(dtype=jnp.float32, **TINY)
        jm = J.LlamaModel(f32)
        variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(self.ids))
        plain = jax.tree.map(np.asarray, nn.meta.unbox(variables))
        # bf16 compute on the same f32 parameters
        jb = J.LlamaModel(dataclasses.replace(f32, dtype=jnp.bfloat16))
        self.jax["bf16"] = _sharded_forward(jb, variables, self.ids)
        self._state("bf16", plain, dict(TINY, dtype="bfloat16"), states,
                    cfgs)
        # int8, tied
        tied = dataclasses.replace(f32, tie_embeddings=True)
        jt = J.LlamaModel(tied)
        tv = jt.init(jax.random.PRNGKey(1), jnp.asarray(self.ids))
        jq = J.quantize_int8(tv)
        jqm = J.LlamaModel(dataclasses.replace(tied, weight_quant="int8"))
        self.jax["int8"] = _sharded_forward(jqm, jq, self.ids)
        self._state("int8", jax.tree.map(np.asarray, nn.meta.unbox(jq)),
                    dict(TINY, dtype="float32", tie_embeddings=True,
                         weight_quant="int8"), states, cfgs)
        # f32 generate
        self.jax["tokens"] = np.asarray(J.generate(
            jm, variables, self.prompt, max_new_tokens=5))
        self._state("f32", plain, dict(TINY, dtype="float32"), states, cfgs)
        self.ranks = run_on_local_cluster(
            "torch_gang_tasks:llm_tp", 2,
            task_args=dict(device="cpu", states=states, cfgs=cfgs,
                           ids=self.ids.tolist(), generate=True,
                           prompt=self.prompt.tolist(), new=5,
                           out=self._p("out.npz")),
            device="cpu", timeout_s=GANG_TIMEOUT_S)
        self.port = G._load_npz(self._p("out.npz"))
        # the port's one-process bf16 model on the same weights
        cfg = PL.LlamaConfig.tiny(dtype=torch.bfloat16, **TINY)
        one = PL.LlamaModel(cfg, device="cpu")
        one.load_state_dict(PL.params_from_reference(plain, cfg, "cpu"))
        with torch.no_grad():
            self.one_bf16 = one(torch.from_numpy(self.ids)).numpy()

    def _state(self, name, tree, cfg, states, cfgs):
        spec = dict(cfg)
        dtype = getattr(torch, spec.pop("dtype"))
        pcfg = PL.LlamaConfig.tiny(dtype=dtype, **spec)
        sd = PL.params_from_reference(tree, pcfg, "cpu")
        G._save_npz(self._p(f"{name}.npz"),
                    {k: v.numpy() for k, v in sd.items()})
        states[name] = self._p(f"{name}.npz")
        cfgs[name] = cfg

    def _p(self, name):
        return os.path.join(self.root, name)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return _Refs(str(tmp_path_factory.mktemp("llm_tp")))


def test_bf16_tp_forward_equals_jax_sharded_forward(refs):
    np.testing.assert_allclose(refs.port["bf16.logits"], refs.jax["bf16"],
                               atol=8e-3, rtol=0)
    np.testing.assert_allclose(refs.port["bf16.logits"], refs.one_bf16,
                               atol=1e-6, rtol=0)


def test_int8_tp_forward_equals_jax_sharded_forward(refs):
    np.testing.assert_allclose(refs.port["int8.logits"], refs.jax["int8"],
                               atol=1e-5, rtol=0)


def test_tp_generate_equals_jax_replicated_generate(refs):
    np.testing.assert_array_equal(refs.port["f32.tokens"],
                                  refs.jax["tokens"])
    # every rank sampled the same tokens from the gathered logits
    assert len({r["digests"]["f32"] for r in refs.ranks}) == 1
    assert int(refs.port["f32.kv_heads"]) == 2


def test_shard_specs_follow_the_logical_rules():
    """The port's split of every leaf is the reference's: the dim that
    LLM_LOGICAL_RULES puts on ``model`` (heads, kv, mlp, vocab)."""
    cfg = J.LlamaConfig.tiny(dtype=jnp.float32, **TINY)
    variables = J.LlamaModel(cfg).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 4), jnp.int32))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables, is_leaf=lambda x: isinstance(x, nn.Partitioned)):
        spec = nn.logical_to_mesh_axes(leaf.names, rules=J.LLM_LOGICAL_RULES)
        dims = [d for d, a in enumerate(spec) if a == "model"]
        keys = [str(getattr(p, "key", p)) for p in path][1:]
        want[".".join(keys).replace("layer_", "layers.", 1)] = dims
    pcfg = PL.LlamaConfig.tiny(dtype=torch.float32, **TINY)
    sd = PL.params_from_reference(jax.tree.map(
        np.asarray, nn.meta.unbox(variables)), pcfg, "cpu")
    got = PL.tp_shard_specs(sd.keys())
    assert set(sd) == set(want)
    for k in sd:
        assert [d for _, d in got.get(k, [])] == want[k], k


@pytest.mark.parametrize("index", [0, 1])
def test_reference_tree_converts_into_one_ranks_shard(index):
    """``params_from_reference(..., mesh=)`` and ``shard_state_dict`` cut
    a whole tree (the int8 tied one too) into rank ``index``'s shard,
    which a model built on that mesh loads."""
    cfg = J.LlamaConfig.tiny(dtype=jnp.float32, tie_embeddings=True, **TINY)
    v = J.LlamaModel(cfg).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))
    for tree, quant in ((v, "none"), (J.quantize_int8(v), "int8")):
        tree = jax.tree.map(np.asarray, nn.meta.unbox(tree))
        pcfg = PL.LlamaConfig.tiny(dtype=torch.float32, tie_embeddings=True,
                                   weight_quant=quant, **TINY)
        mesh = G.OneRankOf(model=(2, index))
        whole = PL.params_from_reference(tree, pcfg, "cpu")
        shard = PL.params_from_reference(tree, pcfg, "cpu", mesh=mesh)
        assert shard.keys() == PL.shard_state_dict(whole, mesh).keys()
        model = PL.LlamaModel(pcfg, device="cpu", mesh=mesh)
        model.load_state_dict(shard)
        for k, t in PL.shard_state_dict(whole, mesh).items():
            assert torch.equal(shard[k], t), k
        assert model.layers[0].attn.kv_heads == 2
