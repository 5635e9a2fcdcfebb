"""DL training steps over a gang of ranks held against the JAX package's
mesh on the CPU (the MoE layer, BatchNorm and the estimators over ranks:
``tests/test_torch_dl_mesh_layers.py``).

The JAX side runs its mesh over the conftest's virtual devices; the port
side runs gloo ranks through ``tests/torch_gang_tasks.py`` (one gang of 2
ranks and one of 4 serve every case: ``dl_mesh_cases``).  Inputs come
from seeded numpy and the port starts from the JAX trainer's initial
weights (``convert.params_from_reference``): the tiny text encoder with
4 experts (one MoE block) at f32 with dropout 0 and capacity factor 0.5,
so the capacity drops choices on every step.

Tolerances:

- five steps of the data mesh at D = 2 and 4, the (data 2, expert 2)
  mesh, ``zero1`` (against the JAX replicated step, which the JAX
  package pins its zero1 to) and ResNet-18's BatchNorm over D = 2
  against the JAX mesh's step: losses within 1e-5 relative, parameters (and batch
  statistics) within 1e-5 (the dense encoder's one-card tolerances,
  ``tests/test_torch_dl_training.py``: f32 on both sides, other
  reduction orders);
- ``zero1`` against the replicated step: losses within 1e-4 relative
  (the JAX package's own pin); a rank holds 1/D of the moment bytes;
- with dropout 0.1 (the port's own masks, which the JAX package does not
  draw), the data mesh at D = 2 against the port's one-process step:
  losses within 1e-5 relative, parameters within 1e-5 (each rank draws
  its rows of the one-process masks);
- int8 and bf16 with error feedback, with and without ``sharded_update``:
  the loss after 12 steps within 0.05 of the f32 sync's (the JAX
  package's bound, tests/test_collectives_compression.py);
- ``sharded_update`` at ``compression="none"`` against
  ``replicated_update``: parameters within 2e-5 relative / 2e-6
  absolute, losses within 1e-5 (the JAX package's pin).
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models.dl import resnet as JR
from synapseml_tpu.models.dl import training as JTr
from synapseml_tpu.models.dl import transformer as JT
from synapseml_tpu.parallel.mesh import dp_ep_mesh
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import transformer as PT
from synapseml_tpu_torch.parallel import run_on_local_cluster

import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

STEPS = 5
CODEC_STEPS = 12
GANG_TIMEOUT_S = 240.0
SPEC = dict(num_classes=3, dropout_rate=0.0, num_experts=4,
            moe_capacity_factor=0.5)
DENSE = dict(num_classes=3, dropout_rate=0.0)
OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
           schedule="cosine", warmup_steps=2, total_steps=STEPS,
           grad_clip_norm=1.0)
CODEC_OPT = dict(name="adamw", learning_rate=3e-3, weight_decay=0.01,
                 schedule="constant", total_steps=CODEC_STEPS,
                 grad_clip_norm=1.0)
CODECS = {
    "int8_ef": dict(compression="int8", error_feedback=True, min_size=64),
    "int8_ef_sharded": dict(compression="int8", error_feedback=True,
                            sharded_update=True, min_size=64),
    "bf16_ef": dict(compression="bf16", error_feedback=True, min_size=64),
    "bf16_ef_sharded": dict(compression="bf16", error_feedback=True,
                            sharded_update=True, min_size=64),
}


def _text_batches(seed, n, bs=8, s=12):
    rng = np.random.default_rng(seed)
    out = {"n": np.asarray(n)}
    for j in range(n):
        out[f"{j}_ids"] = rng.integers(0, 1024, (bs, s)).astype(np.int32)
        mask = np.ones((bs, s), bool)
        mask[::3, 7:] = False
        out[f"{j}_mask"] = mask
        out[f"{j}_labels"] = rng.integers(0, 3, bs).astype(np.int32)
    return out


def _vision_batches(seed, n, bs=8):
    rng = np.random.default_rng(seed)
    out = {"n": np.asarray(n)}
    for j in range(n):
        out[f"{j}_x"] = rng.normal(size=(bs, 16, 16, 3)).astype(np.float32)
        out[f"{j}_labels"] = rng.integers(0, 2, bs).astype(np.int32)
    return out


def _jax_run(model, opt, mesh, batches, names, steps, **kw):
    """The JAX trainer over ``mesh`` → (initial variables, losses, final
    variables)."""
    tr = JTr.DLTrainer(model, JTr.OptimizerConfig(**opt), mesh, **kw)
    first = [jnp.asarray(batches[f"0_{k}"]) for k in names]
    state = tr.init_state(0, *first)
    init = jax.tree.map(np.asarray, nn.meta.unbox(
        {"params": state.params, **state.extra_vars}))
    step = tr.train_step()
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(steps):
        j = i % int(batches["n"])
        arrays = tr.shard_batch(tuple(batches[f"{j}_{k}"] for k in names)
                                + (batches[f"{j}_labels"],))
        state, m = step(state, tuple(arrays[:-1]), arrays[-1], key)
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, nn.meta.unbox(
        {"params": state.params, **state.extra_vars}))
    return init, losses, final


def _flat_vars(tree):
    out = {}
    for coll in ("params", "batch_stats"):
        out.update(C.flatten_tree(tree.get(coll, {})))
    return out


def _jcfg(spec):
    return JT.TransformerConfig.tiny(dtype=jnp.float32, **spec)


class _Refs:
    """Every JAX reference and every port gang result of this module,
    computed once."""

    def __init__(self, root):
        self.root = root
        self.jax = {}
        self.cases2, self.cases4 = {}, {}
        text = _text_batches(0, STEPS)
        G._save_npz(self._p("text.npz"), text)
        devs = jax.devices()
        # the data mesh at D = 2 and 4 and the expert mesh
        for name, mesh, cases in (
                ("d2", JTr.make_dl_mesh(1, 2), self.cases2),
                ("d4", JTr.make_dl_mesh(1, 4), self.cases4),
                ("ep22", dp_ep_mesh(2, devs[:4]), self.cases4)):
            init, losses, final = _jax_run(
                JT.TextEncoder(_jcfg(SPEC)), OPT, mesh, text,
                ("ids", "mask"), STEPS)
            self.jax[name] = (losses, final)
            self._init(name, init, PT.TransformerConfig.tiny(
                dtype=torch.float32, **SPEC))
            cases[name] = dict(
                model="text", cfg=SPEC, batches=self._p("text.npz"),
                inputs=["ids", "mask"], opt=OPT, steps=STEPS,
                init=self._p(f"{name}_init.npz"),
                out=self._p(f"{name}_out.npz"),
                ep=2 if name == "ep22" else 1)
        # zero1 from d2's weights: the JAX package's zero1 equals its
        # replicated step (its own pin), so both hold against d2's
        self.jax["zero1"] = self.jax["d2"]
        self.cases2["zero1"] = dict(self.cases2["d2"], zero1=True,
                                    out=self._p("zero1_out.npz"))
        # sharded update = replicated update at compression "none", and
        # both = the JAX mesh's (GSPMD) step
        init, losses, final = _jax_run(
            JT.TextEncoder(_jcfg(DENSE)), OPT, JTr.make_dl_mesh(1, 2), text,
            ("ids", "mask"), STEPS)
        self.jax["sharded_none"] = (losses, final)
        self._init("dense", init, PT.TransformerConfig.tiny(
            dtype=torch.float32, **DENSE))
        dense = dict(model="text", cfg=DENSE, batches=self._p("text.npz"),
                     inputs=["ids", "mask"], opt=OPT, steps=STEPS,
                     init=self._p("dense_init.npz"))
        for name, cc in (("sharded_none", dict(sharded_update=True,
                                               min_size=64)),
                         ("replicated_none", dict(manual=True,
                                                  min_size=64))):
            self.cases2[name] = dict(dense, collective=cc,
                                     out=self._p(f"{name}_out.npz"))
        # the codecs over 12 steps against the f32 sync
        _, losses, _ = _jax_run(
            JT.TextEncoder(_jcfg(DENSE)), CODEC_OPT, JTr.make_dl_mesh(1, 2),
            text, ("ids", "mask"), CODEC_STEPS)
        self.jax["f32_sync"] = losses
        codec = dict(dense, opt=CODEC_OPT, steps=CODEC_STEPS)
        self.cases2["f32_sync"] = codec
        for name, cc in CODECS.items():
            self.cases2[name] = dict(codec, collective=cc)
        # ResNet-18 over D = 2: five sgd steps
        vis = _vision_batches(2, STEPS)
        G._save_npz(self._p("vision.npz"), vis)
        vopt = dict(name="sgd", learning_rate=0.05, momentum=0.9,
                    schedule="constant", grad_clip_norm=1.0,
                    total_steps=STEPS)
        init, losses, final = _jax_run(
            JR.make_backbone("resnet18", 2, dtype=jnp.float32), vopt,
            JTr.make_dl_mesh(1, 2), vis, ("x",), STEPS,
            has_batch_stats=True, train_kwarg="train")
        self.jax["resnet"] = (losses, final)
        self._init("resnet", init, "resnet18")
        self.cases2["resnet"] = dict(
            model="resnet18", classes=2, batches=self._p("vision.npz"),
            inputs=["x"], opt=vopt, steps=STEPS,
            init=self._p("resnet_init.npz"), out=self._p("resnet_out.npz"))
        # dropout on: the data mesh at D = 2 against the port's one
        # process (the cases' batches have 8 rows: 4 a rank)
        drop = dict(self.cases2["d2"], cfg=dict(SPEC, dropout_rate=0.1),
                    out=self._p("dropout_d2_out.npz"))
        self.cases2["dropout_d2"] = drop
        self.alone = G._trainer_run(dict(drop, out=self._p(
            "dropout_alone_out.npz")), None, torch.device("cpu"))
        self.port2, self.port4 = self._gangs()

    def _p(self, name):
        return os.path.join(self.root, name)

    def _init(self, name, init, cfg):
        sd = C.params_from_reference(init, cfg, "cpu")
        G._save_npz(self._p(f"{name}_init.npz"),
                    {k: v.numpy() for k, v in sd.items()})

    def _gangs(self):
        res = {}
        for n, cases in ((2, self.cases2), (4, self.cases4)):
            res[n] = run_on_local_cluster(
                "torch_gang_tasks:dl_mesh_cases", n,
                task_args={"device": "cpu", "cases": cases}, device="cpu",
                timeout_s=GANG_TIMEOUT_S)
        return res[2], res[4]

    def port_case(self, name):
        cases = self.port2[0] if name in self.cases2 else self.port4[0]
        return cases[name]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return _Refs(str(tmp_path_factory.mktemp("dl_mesh")))


def _assert_vars(path, final, atol):
    got = G._load_npz(path)
    want = _flat_vars(final)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["d2", "d4", "ep22", "zero1"])
def test_mesh_five_steps_equal_jax_mesh(refs, name):
    """Five steps over the port's ranks against the JAX mesh's: the data
    mesh at D = 2 and 4, the (data 2, expert 2) mesh, and zero1."""
    losses, final = refs.jax[name]
    port = refs.port_case(name)
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-5)
    _assert_vars(refs.cases2.get(name, refs.cases4.get(name))["out"],
                 final, 1e-5)


@pytest.mark.parametrize("name", ["d2", "d4", "ep22", "zero1"])
def test_capacity_drops_in_the_mesh_cases(refs, name):
    """The mesh cases' MoE drops choices on every step (capacity factor
    0.5), so the global capacity and positions decide the outputs."""
    dropped = refs.port_case(name)["dropped"]
    assert len(dropped) == STEPS and min(dropped) > 0.2


def test_zero1_matches_replicated_and_shards_moments(refs):
    z, r = refs.port_case("zero1"), refs.port_case("d2")
    np.testing.assert_allclose(z["losses"], r["losses"], rtol=1e-4)
    # a rank holds half the moment bytes (the flat stream pads < D values)
    assert abs(z["moment_bytes"] * 2 - r["moment_bytes"]) <= 2 * 2 * 4


def test_sharded_update_equals_replicated_update(refs):
    s = G._load_npz(refs.cases2["sharded_none"]["out"])
    r = G._load_npz(refs.cases2["replicated_none"]["out"])
    for k in r:
        np.testing.assert_allclose(s[k], r[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)
    np.testing.assert_allclose(refs.port_case("sharded_none")["losses"],
                               refs.port_case("replicated_none")["losses"],
                               atol=1e-5)
    losses, final = refs.jax["sharded_none"]
    np.testing.assert_allclose(refs.port_case("sharded_none")["losses"],
                               losses, rtol=1e-5)
    _assert_vars(refs.cases2["sharded_none"]["out"], final, 1e-5)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_codec_with_error_feedback_tracks_f32_sync(refs, name):
    port = refs.port_case(name)
    f32 = refs.port_case("f32_sync")["losses"]
    np.testing.assert_allclose(f32, refs.jax["f32_sync"], rtol=1e-5)
    assert abs(port["losses"][-1] - f32[-1]) < 0.05
    assert abs(port["losses"][-1] - refs.jax["f32_sync"][-1]) < 0.05
    assert port["losses"][-1] < port["losses"][0]
    # error feedback: each rank carries one f32 residual a parameter
    assert port["residual_bytes"] > 0
    if "sharded" in name:
        assert port["moment_bytes"] * 2 <= \
            refs.port_case("f32_sync")["moment_bytes"] + 2 * 256 * 4 * 2


def test_resnet_over_two_ranks_equals_jax_mesh(refs):
    losses, final = refs.jax["resnet"]
    np.testing.assert_allclose(refs.port_case("resnet")["losses"], losses,
                               rtol=1e-5)
    _assert_vars(refs.cases2["resnet"]["out"], final, 1e-5)


def test_dropout_over_two_ranks_equals_one_process(refs):
    """Dropout on: each rank draws its rows of the one-process masks, so
    the D = 2 step equals the port's one-process step."""
    port, alone = refs.port_case("dropout_d2"), refs.alone
    np.testing.assert_allclose(port["losses"], alone["losses"], rtol=1e-5)
    assert port["losses"] != refs.port_case("d2")["losses"]
    got = G._load_npz(refs.cases2["dropout_d2"]["out"])
    want = G._load_npz(refs.cases2["dropout_d2"]["out"].replace(
        "dropout_d2_out", "dropout_alone_out"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
