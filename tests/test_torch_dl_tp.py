"""Tensor parallelism of the DL text encoder over a ``model`` axis of gloo
ranks held against the JAX package's (data, model) mesh on its 8 virtual
devices, and against the port's one-process fit, on the CPU.

One gang of 4 ranks and one of 2 serve every case
(``tests/torch_gang_tasks.py``: ``dl_mesh_cases``, ``tp_grads``,
``dl_fit``, ``bert_tp_import``; ``run_many`` runs several in one gang):

- the JAX package's ``test_tp_matches_dp_training`` setup (the tiny
  config in bf16 with dropout 0.1, 16 x 16 ids, adamw 1e-3, 5 steps) at
  tp = 2: the losses within the reference's rtol 2e-2 of the JAX tp = 2
  run (the two packages draw different dropout masks), and within 1e-5
  of the port's one-process run (the same masks: each rank draws the
  whole mask and keeps its heads);
- a data 2 x model 2 fit at 4 ranks of the tiny encoder with 4 experts
  (one MoE block, capacity factor 0.5: the MoE under tp = 2), f32,
  dropout 0, the clip at 0.05 (it clips every step): losses within 1e-5
  relative and parameters within 1e-5 of the JAX mesh's; with dropout
  0.1, the same mesh against the port's one process (1e-5);
- ``zero1`` over (data 2, model 2) and over (data 2, expert 2) against
  the JAX package's replicated step on the same mesh (its own pin:
  zero1 equals the replicated step) within 1e-5, each rank holding half
  of its blocks' moment bytes;
- one step's gradients at tp = 2 (and data 2 x model 2): the replicated
  leaves' gradients equal on every ``model`` rank, the whole gradients
  within 1e-6 of one process, and the clip's global norm (sharded
  leaves summed over ``model`` once, replicated leaves once) within
  1e-6 relative of the one-process norm;
- a step checkpoint of a data 2 x model 2 fit resumed at tp = 1 on one
  process and at data 2 on two ranks: both within 1e-5 of the
  uninterrupted one-process fit;
- module 6's rules: ``DeepVisionClassifier(modelParallelism=2)`` trains
  data-parallel (the same weights as ``modelParallelism=1``), and
  ``expertParallelism=2`` ignores ``modelParallelism`` (the same weights
  as without it), as the reference does;
- an HF BERT checkpoint imported into a tp = 2 shard: each rank's
  leaves are its shard of the JAX package's import under ``make_dl_mesh
  (2)``, split along the dim that JAX's sharding puts on ``model``; the
  column-parallel layers' biases, which the reference leaves whole
  (flax's ``Dense`` partitions its kernel only) and GSPMD slices at the
  add, the port holds as its rank's slice.
"""

import os
import shutil

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models.dl import training as JTr
from synapseml_tpu.models.dl import transformer as JT
from synapseml_tpu.parallel.mesh import dp_ep_mesh
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import estimators as PE
from synapseml_tpu_torch.parallel import run_on_local_cluster

import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

STEPS = 5
GANG_TIMEOUT_S = 300.0
#: the reference's test_tp_matches_dp_training: tiny, bf16, dropout 0.1
TP_SPEC = dict(num_classes=2, dtype="bfloat16")
TP_OPT = dict(name="adamw", learning_rate=1e-3)
#: the mesh cases: the tiny encoder with 4 experts, f32
SPEC = dict(num_classes=3, dropout_rate=0.0, num_experts=4,
            moe_capacity_factor=0.5)
OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
           schedule="cosine", warmup_steps=2, total_steps=STEPS,
           grad_clip_norm=0.05)
FIT = dict(modelSize="tiny", maxTokenLen=16, vocabSize=64, batchSize=16,
           seed=3, lrSchedule="constant", dropoutRate=0.0, precision="f32")


def _jax_run(model, opt, mesh, batches, steps, **kw):
    """The JAX trainer over ``mesh`` → (initial variables, losses, final
    variables)."""
    tr = JTr.DLTrainer(model, JTr.OptimizerConfig(**opt), mesh, **kw)
    state = tr.init_state(0, jnp.asarray(batches["0_ids"]),
                          jnp.asarray(batches["0_mask"]))
    init = jax.tree.map(np.asarray, nn.meta.unbox(
        {"params": state.params, **state.extra_vars}))
    step = tr.train_step()
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(steps):
        j = i % int(batches["n"])
        arrays = tr.shard_batch((batches[f"{j}_ids"], batches[f"{j}_mask"],
                                 batches[f"{j}_labels"]))
        state, m = step(state, tuple(arrays[:2]), arrays[2], key)
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, nn.meta.unbox({"params": state.params}))
    return init, losses, final


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


def _jcfg(spec):
    spec = dict(spec)
    dtype = {"bfloat16": jnp.bfloat16}.get(spec.pop("dtype", None),
                                            jnp.float32)
    return JT.TransformerConfig.tiny(dtype=dtype, **spec)


def _texts(n=64):
    rng = np.random.default_rng(0)
    texts = [("good great fine nice " if y else "bad awful poor sad ")
             + f"t{i % 7}" for i, y in enumerate(rng.integers(0, 2, n))]
    return texts, np.array([t.startswith("good") for t in texts], float)


def _images(n=16):
    rng = np.random.default_rng(1)
    return (rng.normal(size=(n, 16, 16, 3)).astype(np.float32),
            rng.integers(0, 2, n).astype(float))


class _Refs:
    """Every JAX reference and every port gang result of this module,
    computed once."""

    def __init__(self, root):
        self.root = root
        self.jax = {}
        cases2, cases4 = {}, {}
        # (1) the reference's TP training parity setup
        rng = np.random.default_rng(0)
        tp_batch = {"n": np.asarray(1),
                    "0_ids": rng.integers(0, 1024, (16, 16)).astype(np.int32),
                    "0_mask": np.ones((16, 16), bool),
                    "0_labels": rng.integers(0, 2, 16).astype(np.int32)}
        G._save_npz(self._p("tp_batch.npz"), tp_batch)
        init, losses, _ = _jax_run(JT.TextEncoder(_jcfg(TP_SPEC)), TP_OPT,
                                   JTr.make_dl_mesh(tp=2), tp_batch, STEPS)
        self.jax["tp2"] = losses
        self._init("tp2", init, TP_SPEC)
        tp2 = dict(model="text", cfg=TP_SPEC, batches=self._p("tp_batch.npz"),
                   inputs=["ids", "mask"], opt=TP_OPT, steps=STEPS,
                   init=self._p("tp2_init.npz"), tp=2)
        cases2["tp2"] = tp2
        self.alone_tp2 = G._trainer_run(tp2, None, torch.device("cpu"))
        # (2) data 2 x model 2 with the MoE block, and zero1 over it
        text = _text_batches(0, STEPS)
        G._save_npz(self._p("text.npz"), text)
        devs = jax.devices()
        for name, mesh in (("d2m2", JTr.make_dl_mesh(2, 4)),
                           ("ep22", dp_ep_mesh(2, devs[:4]))):
            init, losses, final = _jax_run(JT.TextEncoder(_jcfg(SPEC)), OPT,
                                           mesh, text, STEPS)
            self.jax[name] = (losses, final)
            self._init(name, init, SPEC)
        base = dict(model="text", cfg=SPEC, batches=self._p("text.npz"),
                    inputs=["ids", "mask"], opt=OPT, steps=STEPS)
        d2m2 = dict(base, init=self._p("d2m2_init.npz"), tp=2)
        cases4["d2m2"] = dict(d2m2, out=self._p("d2m2_out.npz"))
        cases4["d2m2_zero1"] = dict(d2m2, zero1=True,
                                    out=self._p("d2m2_zero1_out.npz"))
        cases4["ep22_zero1"] = dict(base, init=self._p("ep22_init.npz"),
                                    ep=2, zero1=True,
                                    out=self._p("ep22_zero1_out.npz"))
        drop = dict(d2m2, cfg=dict(SPEC, dropout_rate=0.1),
                    out=self._p("drop_out.npz"))
        cases4["d2m2_dropout"] = drop
        self.alone_drop = G._trainer_run(
            dict(drop, out=self._p("drop_alone_out.npz")), None,
            torch.device("cpu"))
        # (3) one step's gradients at tp 2 and data 2 x model 2
        grads = dict(cfg=SPEC, init=self._p("d2m2_init.npz"),
                     batch=self._p("grad_batch.npz"), tp=2)
        gb = _text_batches(7, 1)
        G._save_npz(self._p("grad_batch.npz"),
                    {k[2:]: v for k, v in gb.items() if k != "n"})
        # (4) checkpoints and the estimator rules
        texts, labels = _texts()
        G._save_npz(self._p("texts.npz"), {"text": np.asarray(texts),
                                           "label": labels})
        imgs, ilabels = _images()
        G._save_npz(self._p("images.npz"), {"image": imgs,
                                            "label": ilabels})
        ckpt = os.path.join(root, "ckpt_tp")
        self.four = run_on_local_cluster(
            "torch_gang_tasks:run_many", 4, task_args=dict(
                device="cpu", tasks=[
                    ["dl_mesh_cases", dict(cases=cases4)],
                    ["tp_grads", dict(grads, out=self._p("g4.npz"))],
                    ["dl_fit", dict(kind="text", data=self._p("texts.npz"),
                                    ckpt=ckpt, kw=dict(
                                        FIT, maxEpochs=1,
                                        modelParallelism=2))]]),
            device="cpu", timeout_s=GANG_TIMEOUT_S)
        shutil.copytree(ckpt, ckpt + "_d2")
        # (5) the HF BERT checkpoint into a tp 2 shard
        self.bert_jax = self._bert()
        os.makedirs(self._p("bert"), exist_ok=True)
        text_kw = dict(FIT, maxEpochs=1, numExperts=4)
        self.two = run_on_local_cluster(
            "torch_gang_tasks:run_many", 2, task_args=dict(
                device="cpu", tasks=[
                    ["dl_mesh_cases", dict(cases=cases2)],
                    ["tp_grads", dict(grads, out=self._p("g2.npz"))],
                    ["dl_fit", dict(kind="text", data=self._p("texts.npz"),
                                    ckpt=ckpt + "_d2",
                                    out=self._p("resumed_d2.npz"),
                                    kw=dict(FIT, maxEpochs=2))],
                    ["dl_fit", dict(kind="vision",
                                    data=self._p("images.npz"), kw=dict(
                                        backbone="resnet18", batchSize=8,
                                        maxEpochs=1, precision="f32",
                                        modelParallelism=2))],
                    ["dl_fit", dict(kind="vision",
                                    data=self._p("images.npz"), kw=dict(
                                        backbone="resnet18", batchSize=8,
                                        maxEpochs=1, precision="f32"))],
                    ["dl_fit", dict(kind="text", data=self._p("texts.npz"),
                                    kw=dict(text_kw, expertParallelism=2,
                                            modelParallelism=2))],
                    ["dl_fit", dict(kind="text", data=self._p("texts.npz"),
                                    kw=dict(text_kw, expertParallelism=2))],
                    ["bert_tp_import", dict(
                        tp=2, cfg=BERT_CFG, hf=self._p("hf.npz"),
                        out=self._p("bert"))]]),
            device="cpu", timeout_s=GANG_TIMEOUT_S)
        # the one-process fits: resumed from the tp checkpoint, and whole
        ds = Dataset({"text": texts, "label": labels})
        self.resumed_one = PE.DeepTextClassifier(
            device="cpu", numDevices=1, checkpointDir=ckpt,
            checkpointInterval=1, maxEpochs=2, **FIT).fit(ds)
        self.whole_one = PE.DeepTextClassifier(
            device="cpu", numDevices=1, maxEpochs=2, **FIT).fit(ds)
        self.grads_one = self._one_grads(grads)

    def _one_grads(self, grads):
        """One process's gradients and global norm of the grads case."""
        from synapseml_tpu_torch.models.dl import training as PTr
        from synapseml_tpu_torch.models.dl import transformer as PT
        model = PT.TextEncoder(G._text_cfg(SPEC), device="cpu", seed=None)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               G._load_npz(grads["init"]).items()})
        z = G._load_npz(grads["batch"])
        logits = model(torch.from_numpy(z["ids"]), torch.from_numpy(z["mask"]))
        PTr.softmax_cross_entropy(logits, torch.from_numpy(
            z["labels"])).backward()
        g = {k: p.grad.numpy() for k, p in model.named_parameters()}
        return g, float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                    for v in g.values())))

    def _bert(self):
        """The HF BERT checkpoint and the JAX package's import of it under
        ``make_dl_mesh(2)``: per leaf, its whole value and the dims its
        sharding puts on ``model``."""
        from transformers import BertConfig, BertForSequenceClassification
        from synapseml_tpu.models.dl.checkpoints import import_bert
        hcfg = BertConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=64, num_labels=3,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
        torch.manual_seed(0)
        hf = BertForSequenceClassification(hcfg).eval()
        sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
        G._save_npz(self._p("hf.npz"), sd)
        cfg = JT.TransformerConfig(
            vocab_size=120, max_len=64, num_layers=2, num_heads=4,
            d_model=32, d_ff=64, num_classes=3, dtype=jnp.float32,
            dropout_rate=0.0)
        tr = JTr.DLTrainer(JT.TextEncoder(cfg),
                           JTr.OptimizerConfig(learning_rate=1e-4),
                           JTr.make_dl_mesh(2))
        state = tr.init_state(0, np.zeros((8, 10), np.int64),
                              np.ones((8, 10), bool))
        imported = import_bert(state.params, sd, num_layers=2)
        out = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(imported):
            key = ".".join(str(p.key) for p in path if hasattr(p, "key"))
            spec = list(leaf.sharding.spec) + [None] * leaf.ndim
            out[key] = (np.asarray(leaf),
                        [d for d in range(leaf.ndim) if spec[d] == "model"])
        return out

    def _p(self, name):
        return os.path.join(self.root, name)

    def _init(self, name, init, spec):
        sd = C.params_from_reference(init, G._text_cfg(spec), "cpu")
        G._save_npz(self._p(f"{name}_init.npz"),
                    {k: v.numpy() for k, v in sd.items()})


BERT_CFG = dict(vocab_size=120, max_len=64, num_layers=2, num_heads=4,
                d_model=32, d_ff=64, num_classes=3, dtype="float32",
                dropout_rate=0.0)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return _Refs(str(tmp_path_factory.mktemp("dl_tp")))


def _assert_vars(path, final, atol):
    got = G._load_npz(path)
    want = C.flatten_tree(final["params"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=0, err_msg=k)


def test_tp2_matches_jax_tp2_and_one_process(refs):
    """The reference's TP parity setup: port tp = 2 against JAX tp = 2
    (rtol 2e-2, its own bound) and against the port's one process (the
    same dropout masks)."""
    port = refs.two[0][0]["tp2"]["losses"]
    np.testing.assert_allclose(port, refs.jax["tp2"], rtol=2e-2)
    np.testing.assert_allclose(port, refs.alone_tp2["losses"], rtol=1e-5)
    assert refs.two[1][0]["tp2"]["losses"] == port


@pytest.mark.parametrize("name", ["d2m2", "d2m2_zero1"])
def test_data2_model2_equals_jax_mesh(refs, name):
    losses, final = refs.jax["d2m2"]
    port = refs.four[0][0][name]
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-5)
    _assert_vars(refs._p(f"{name}_out.npz"), final, 1e-5)


def test_zero1_over_data_expert_equals_jax_mesh(refs):
    losses, final = refs.jax["ep22"]
    np.testing.assert_allclose(refs.four[0][0]["ep22_zero1"]["losses"],
                               losses, rtol=1e-5)
    _assert_vars(refs._p("ep22_zero1_out.npz"), final, 1e-5)


@pytest.mark.parametrize("name", ["d2m2_zero1", "ep22_zero1"])
def test_zero1_shards_each_ranks_blocks(refs, name):
    """A rank's moments are half its blocks' (the data axis is 2); the
    blocks are half the model's on a model or expert axis of 2."""
    z = refs.four[0][0][name]["moment_bytes"]
    full = refs.alone_drop["moment_bytes"]      # one process, every leaf
    assert z < full / 2
    if name == "d2m2_zero1":
        r = refs.four[0][0]["d2m2"]["moment_bytes"]
        assert abs(z * 2 - r) <= 2 * 2 * 4


def test_dropout_over_data2_model2_equals_one_process(refs):
    """Each rank draws the whole batch's mask at every site and keeps its
    rows (and at the probabilities, its heads)."""
    port = refs.four[0][0]["d2m2_dropout"]["losses"]
    np.testing.assert_allclose(port, refs.alone_drop["losses"], rtol=1e-5)
    assert port != refs.four[0][0]["d2m2"]["losses"]
    got = G._load_npz(refs._p("drop_out.npz"))
    want = G._load_npz(refs._p("drop_alone_out.npz"))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
def test_gradients_and_clip_norm_over_the_model_axis(refs, ranks):
    res = (refs.two if ranks == 2 else refs.four)[0][1]
    want, norm = refs.grads_one
    got = G._load_npz(refs._p(f"g{ranks}.npz"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)
    for r in (refs.two if ranks == 2 else refs.four):
        rec = r[1]
        assert rec["replicated_gap"] == 0.0
        assert rec["n_sharded"] > 0
        np.testing.assert_allclose(rec["norm"], norm, rtol=1e-6)
    assert res["norm"] > OPT["grad_clip_norm"]      # the clip acts


@pytest.mark.parametrize("where", ["one_process", "data2"])
def test_tp_checkpoint_resumes_at_another_shape(refs, where):
    """The data 2 x model 2 fit's checkpoint after its first epoch,
    resumed for the second at tp = 1: on one process (a resize, 2 data
    shards to 1) and on two ranks (data 2, no resize): both end where the
    uninterrupted one-process fit ends."""
    whole = refs.whole_one.modelPayload["variables"]
    if where == "one_process":
        got = refs.resumed_one.modelPayload["variables"]
    else:
        rec = refs.two[0][2]
        assert rec["resize_notes"] == []            # data 2 -> data 2
        assert rec["variables_md5"] == refs.two[1][2]["variables_md5"]
        got = G._load_npz(refs._p("resumed_d2.npz"))
    assert set(got) == set(whole)
    for k, v in whole.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


def test_vision_model_parallelism_trains_data_parallel(refs):
    tp, plain = refs.two[0][3], refs.two[0][4]
    assert tp["world"] == 2
    assert tp["variables_md5"] == plain["variables_md5"]


def test_expert_parallelism_ignores_model_parallelism(refs):
    tp, plain = refs.two[0][5], refs.two[0][6]
    assert tp["variables_md5"] == plain["variables_md5"]


def test_bert_import_into_a_tp_shard_equals_jax(refs):
    files = refs.two
    for r in range(2):
        rec = files[r][7]
        got = G._load_npz(os.path.join(refs._p("bert"), f"rank{r}.npz"))
        idx = rec["model_index"]
        checked = 0
        for k, (whole, dims) in refs.bert_jax.items():
            port_dims = [d for _, d in rec["specs"].get(k, [])]
            column_bias = k.endswith((".query.bias", ".key.bias",
                                      ".value.bias", ".ffn_up.bias"))
            assert port_dims == ([0] if column_bias else dims), k
            want = whole
            for d in port_dims:
                per = whole.shape[d] // 2
                want = np.take(want, range(idx * per, (idx + 1) * per),
                               axis=d)
            np.testing.assert_array_equal(got[k], want, err_msg=k)
            checked += bool(dims)
        assert checked > 10


def test_model_parallelism_refusals():
    """tp must divide the group's ranks (one here), before any work;
    a codec needs a pure data mesh."""
    texts, labels = _texts(8)
    ds = Dataset({"text": texts, "label": labels})
    with pytest.raises(ValueError, match="the group has 1 rank"):
        PE.DeepTextClassifier(device="cpu", modelParallelism=2,
                              **FIT).fit(ds)
    with pytest.raises(ValueError, match="pure data mesh"):
        PE.DeepTextClassifier(device="cpu", modelParallelism=2,
                              collectiveCompression="int8", **FIT).fit(ds)


@pytest.mark.parametrize("index", [0, 1])
def test_reference_tree_converts_into_one_ranks_shard(index):
    """``convert.params_from_reference(..., mesh=)`` gives the state dict
    of a TextEncoder built on that mesh: each leaf this rank's block of
    the whole tree's."""
    from synapseml_tpu_torch.models.dl import transformer as PT
    jm = JT.TextEncoder(_jcfg(SPEC))
    tree = jax.tree.map(np.asarray, nn.meta.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))))
    cfg = G._text_cfg(SPEC)
    mesh = G.OneRankOf(data=(1, 0), model=(2, index))
    whole = C.params_from_reference(tree, cfg, "cpu")
    shard = C.params_from_reference(tree, cfg, "cpu", mesh=mesh)
    model = PT.TextEncoder(cfg, device="cpu", seed=None, mesh=mesh)
    model.load_state_dict(shard)
    specs = model.shard_specs()
    assert len(specs) > 10
    for k, v in whole.items():
        want = v
        for _, dim in specs.get(k, []):
            per = v.shape[dim] // 2
            want = want.narrow(dim, index * per, per)
        assert torch.equal(shard[k], want), k
