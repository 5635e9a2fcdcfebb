"""The MoE layer, BatchNorm and the DL estimators over a gang of ranks
held against the JAX package's mesh on the CPU (the trainer's steps:
``tests/test_torch_dl_mesh.py``).

The JAX side runs its mesh over the conftest's virtual devices; the port
side runs gloo ranks through ``tests/torch_gang_tasks.py`` (one gang of 2
ranks and one of 4 serve every case: ``run_many``).  Inputs come from
seeded numpy and the port starts from the JAX side's initial weights
(``convert.params_from_reference``).

Tolerances:

- the MoE layer on the (data 2, expert 2) mesh against the JAX layer at
  ``dp_ep_mesh(2)`` over 4 devices: outputs, the aux loss and every
  gradient within 1e-5 of their scale, with the capacity dropping and
  with the uniform router's ties;
- ResNet BatchNorm at D = 2 against the JAX global batch: logits,
  running statistics, input and weight gradients within 1e-4 of their
  scale (f32 convolutions summed in other orders);
- the estimators over the ranks (``numDevices``, ``expertParallelism``)
  against the JAX estimators on the same number of devices (the one-card
  estimator tests' tolerances): each epoch's loss within 1e-4 relative,
  the fitted variables within 1e-4 and the text model's probabilities
  within 1e-4; every rank returns the same variables bit for bit.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from synapseml_tpu import Dataset as JDataset
from synapseml_tpu.models.dl import estimators as JE
from synapseml_tpu.models.dl import resnet as JR
from synapseml_tpu.models.dl import training as JTr
from synapseml_tpu.models.dl.moe import MoEFFN as JMoE
from synapseml_tpu.parallel.mesh import batch_sharding, dp_ep_mesh
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import transformer as PT
from synapseml_tpu_torch.parallel import run_on_local_cluster

from test_torch_dl_estimators import text_data, vision_data
import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

GANG_TIMEOUT_S = 240.0
TEXT_FIT = dict(modelSize="tiny", maxEpochs=2, batchSize=16,
                learningRate=3e-3, maxTokenLen=16, vocabSize=128,
                dropoutRate=0.0, precision="f32")
VISION_FIT = dict(backbone="resnet18", maxEpochs=2, batchSize=8,
                  learningRate=1e-2, optimizer="sgd", precision="f32",
                  lrSchedule="constant")


class _Refs:
    """Every JAX reference and every port gang result of this module,
    computed once."""

    def __init__(self, root):
        self.root = root
        self.moe = self._moe_refs()
        self.bn = self._bn_refs()
        self.fits = self._fit_refs()
        self.port2, self.port4 = self._gangs()

    def _p(self, name):
        return os.path.join(self.root, name)

    # -- the MoE layer on dp_ep_mesh(2) -----------------------------------
    def _moe_refs(self):
        mesh = dp_ep_mesh(2, jax.devices()[:4])
        rules = JTr.usable_rules(mesh)
        out = {}
        for name, (cf, zero_router) in {"drops": (0.5, False),
                                        "ties": (1.0, True)}.items():
            rng = np.random.default_rng(11)
            x = rng.normal(size=(4, 6, 16)).astype(np.float32)
            w = rng.normal(size=(4, 6, 16)).astype(np.float32)
            m = JMoE(num_experts=4, d_ff=32, top_k=2, capacity_factor=cf,
                     dtype=jnp.float32)
            with mesh, nn.logical_axis_rules(rules):
                v = nn.meta.unbox(m.init(jax.random.PRNGKey(3),
                                         jnp.asarray(x)))
            p = jax.tree.map(np.asarray, v["params"])
            if zero_router:
                p["router"] = np.zeros_like(p["router"])

            def loss(params, xx):
                o, upd = m.apply({"params": params}, xx,
                                 mutable=["losses"])
                aux = upd["losses"]["moe_aux"][0]
                return jnp.sum(o * w) + aux, (o, aux)

            with mesh, nn.logical_axis_rules(rules):
                xs = jax.device_put(x, batch_sharding(mesh, 3))
                (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(p, xs)
            G._save_npz(self._p(f"moe_{name}.npz"),
                        {"x": x, "w": w, **p})
            out[name] = dict(out=np.asarray(o), aux=float(aux),
                             x_grad=np.asarray(gx),
                             **{f"g_{k}": np.asarray(g)
                                for k, g in gp.items()})
        return out

    # -- BatchNorm over the data axis ------------------------------------------
    def _bn_refs(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
        w = rng.normal(size=(8, 2)).astype(np.float32)
        m = JR.make_backbone("resnet18", 2, dtype=jnp.float32)
        v = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(1), x,
                                            train=False))
        mesh = JTr.make_dl_mesh(1, 2)

        def loss(params, xx):
            logits, upd = m.apply({"params": params,
                                   "batch_stats": v["batch_stats"]}, xx,
                                  train=True, mutable=["batch_stats"])
            return jnp.sum(logits * w), (logits, upd["batch_stats"])

        with mesh:
            xs = jax.device_put(x, batch_sharding(mesh, 4))
            (_, (logits, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(v["params"], xs)
        sd = C.params_from_reference(v, "resnet18", "cpu")
        G._save_npz(self._p("bn.npz"), {
            "x": x, "w": w, **{f"init.{k}": t.numpy()
                               for k, t in sd.items()}})
        return dict(logits=np.asarray(logits), x_grad=np.asarray(gx),
                    grads=C.flatten_tree(jax.tree.map(np.asarray, gp)),
                    stats=C.flatten_tree(jax.tree.map(np.asarray, stats)))

    # -- the estimators -----------------------------------------------------------
    def _fit_refs(self):
        """JAX estimator fits on 2 and 4 devices (their initial weights
        captured for the port's ranks) → per case the history and
        probabilities, plus the port gang task's arguments."""
        text = text_data(48)
        G._save_npz(self._p("fit_text.npz"),
                    {"text": np.asarray(text["text"]),
                     "label": text["label"]})
        vis = vision_data(32)
        G._save_npz(self._p("fit_vision.npz"),
                    {"image": np.stack(vis["image"]),
                     "label": vis["label"]})
        out = {}
        for name, cls, data, kw, nd, cfg in (
                ("text_d2", JE.DeepTextClassifier, text, TEXT_FIT, 2, None),
                ("text_ep", JE.DeepTextClassifier, text,
                 dict(TEXT_FIT, numExperts=4, expertParallelism=2), 4,
                 None),
                ("vision_d2", JE.DeepVisionClassifier, vis, VISION_FIT, 2,
                 "resnet18")):
            captured = {}
            orig = JTr.DLTrainer.init_state

            def capture(self, *a, orig=orig, captured=captured):
                state = orig(self, *a)
                captured["vars"] = jax.tree.map(np.asarray, nn.meta.unbox(
                    {"params": state.params, **state.extra_vars}))
                return state

            JTr.DLTrainer.init_state = capture
            try:
                jm = cls(numDevices=nd, **kw).fit(JDataset(data))
            finally:
                JTr.DLTrainer.init_state = orig
            pcfg = cfg or PT.TransformerConfig(
                **{f: getattr(jm.modelPayload["config"], f)
                   for f in ("vocab_size", "max_len", "num_layers",
                             "num_heads", "d_model", "d_ff",
                             "num_classes", "num_experts")})
            sd = C.params_from_reference(captured["vars"], pcfg, "cpu")
            G._save_npz(self._p(f"{name}_fit_init.npz"),
                        {k: t.numpy() for k, t in sd.items()})
            jout = jm.transform(JDataset(data))
            out[name] = dict(
                nd=nd, history=jm.modelPayload["history"],
                variables=jm.modelPayload["variables"],
                proba=np.stack(list(jout["probability"])),
                task=dict(kind="text" if cls is JE.DeepTextClassifier
                          else "vision",
                          data=self._p("fit_text.npz" if cls is
                                       JE.DeepTextClassifier
                                       else "fit_vision.npz"),
                          init=self._p(f"{name}_fit_init.npz"), kw=kw,
                          out=self._p(f"{name}_fit_out.npz")))
        return out

    def _gangs(self):
        res = {}
        for n in (2, 4):
            if n == 4:
                tasks = [["moe_mesh_grads", {"ep": 2, "cases": {
                    name: dict(data=self._p(f"moe_{name}.npz"), top_k=2,
                               cf=0.5 if name == "drops" else 1.0,
                               out=self._mkdir(f"moe_{name}"))
                    for name in self.moe}}]]
            else:
                tasks = [["bn_mesh_grads", dict(
                    data=self._p("bn.npz"), backbone="resnet18",
                    classes=2, out=self._mkdir("bn"))]]
            fits = [f for f in self.fits.values() if f["nd"] == n]
            tasks += [["dl_fit", f["task"]] for f in fits]
            res[n] = run_on_local_cluster(
                "torch_gang_tasks:run_many", n,
                task_args={"device": "cpu", "tasks": tasks}, device="cpu",
                timeout_s=GANG_TIMEOUT_S)
        return res[2], res[4]

    def _mkdir(self, name):
        d = self._p(name)
        os.makedirs(d, exist_ok=True)
        return d


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return _Refs(str(tmp_path_factory.mktemp("dl_mesh_layers")))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("case", ["drops", "ties"])
def test_moe_on_expert_mesh_equals_jax(refs, case):
    """The (data 2, expert 2) ranks' outputs, aux loss and gradients
    against the JAX layer on dp_ep_mesh(2) over 4 devices."""
    want = refs.moe[case]
    ranks = [G._load_npz(f) for f in
             sorted(r[0]["files"][case] for r in refs.port4)]
    out = np.zeros_like(want["out"])
    x_grad = np.zeros_like(want["x_grad"])
    for r in ranks:
        lo, hi = r["rows"]
        out[lo:hi] = r["out"]
        x_grad[lo:hi] = r["x_grad"]
        _close(r["aux"], want["aux"], 1e-6, "aux")
        _close(r["g_router"], want["g_router"], 1e-5, "router")
        e = int(r["expert_lo"])
        for k in ("w_up", "w_down"):
            _close(r[f"g_{k}"], want[f"g_{k}"][e:e + 2], 1e-5, k)
    _close(out, want["out"], 1e-5, "out")
    _close(x_grad, want["x_grad"], 1e-5, "x")
    if case == "drops":
        assert float(ranks[0]["dropped"]) > 0.0
    else:
        # every token picks experts 0 and 1: half the (token, choice)
        # pairs exceed the capacity of the global batch
        assert float(ranks[0]["dropped"]) == pytest.approx(0.5)


@pytest.mark.parametrize("what", ["logits", "stats", "x_grad", "grads"])
def test_batchnorm_over_the_data_axis_equals_jax(refs, what):
    """BatchNorm over two ranks: the forward, the running statistics and
    both the input and the weight gradients (the backward's all-reduce
    of Σdy and Σdy·x̂) equal the JAX global batch's."""
    want = refs.bn
    ranks = [G._load_npz(r[0]["file"]) for r in refs.port2]
    if what in ("logits", "x_grad"):
        key = "logits" if what == "logits" else "x_grad"
        got = np.concatenate([r[key] for r in ranks])
        _close(got, want[key], 1e-4, what)
    elif what == "stats":
        for r in ranks:
            for k, v in want["stats"].items():
                _close(r[f"s.{k}"], v, 1e-4, k)
    else:
        for r in ranks:
            for k, v in want["grads"].items():
                _close(r[f"g.{k}"], v, 1e-4, k)


@pytest.mark.parametrize("name", ["text_d2", "text_ep", "vision_d2"])
def test_estimator_over_ranks_equals_jax(refs, name):
    """DeepTextClassifier(numDevices=2), the expert-parallel classifier on
    4 ranks (data 2 x expert 2) and DeepVisionClassifier(numDevices=2)
    against the JAX estimators on as many devices: every rank returns
    the same model."""
    want = refs.fits[name]
    gang = refs.port2 if want["nd"] == 2 else refs.port4
    fits = [f for f in refs.fits.values() if f["nd"] == want["nd"]]
    pos = 1 + [f is want for f in fits].index(True)
    results = [r[pos] for r in gang]
    assert len({r["variables_md5"] for r in results}) == 1
    for a, b in zip(want["history"], results[0]["history"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    got = G._load_npz(want["task"]["out"])
    flat = {}
    for coll in ("params", "batch_stats"):
        flat.update(C.flatten_tree(want["variables"].get(coll, {})))
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=0, err_msg=k)
    if want["task"]["kind"] == "text":
        # the vision model scores in bf16 (its default compute dtype), the
        # text model in its fit's f32
        np.testing.assert_allclose(results[0]["proba"], want["proba"],
                                   atol=1e-4, rtol=0)
