"""The port's DL estimators held against the JAX package's on the CPU:
fit → transform from the same initial weights (the JAX fit's init carried
into the port's ``init_state``), the tasks of ``tests/test_dl.py`` learned
by the port alone, labels other than {0, 1}, save → load, the validation
history, OOM-adaptive scoring, HF BERT checkpoints (safetensors and torch
pickles, single files and sharded) and the refusals of what is not ported.

Tolerances: the fits run at ``precision="f32"`` with dropout 0, so both
sides train in f32 on the same batches (the same numpy generator) and
differ by reduction order only: losses within 1e-4 relative, trained
weights within 1e-4, text probabilities within 1e-4.  The vision model
scores at bf16 on both sides (the reference's transform builds the
backbone at its default bf16, whatever the fit's precision): there every
convolution's output rounds to bf16 (2^-8 relative), logits of magnitude
~1 differ by up to ~1e-2 where the two sides' f32 sums straddle a
rounding boundary, so the transform's probabilities are held within 5e-3
and the trained weights' f32 forward within 1e-4.
"""

import json

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

import synapseml_tpu.models.dl.training as JTr
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu.models.dl import checkpoints as JC
from synapseml_tpu.models.dl import estimators as JE
from synapseml_tpu_torch.core import Dataset, Pipeline
from synapseml_tpu_torch.core.pipeline import load_stage
from synapseml_tpu_torch.models.dl import checkpoints as PC
from synapseml_tpu_torch.models.dl import convert as C
from synapseml_tpu_torch.models.dl import estimators as PE
from synapseml_tpu_torch.models.dl import training as PTr
from synapseml_tpu_torch.models.dl import transformer as PT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def text_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    pos_words = ["good", "great", "excellent", "love", "wonderful"]
    neg_words = ["bad", "awful", "terrible", "hate", "poor"]
    texts, labels = [], []
    for i in range(n):
        y = i % 2
        words = rng.choice(pos_words if y else neg_words, 5)
        filler = rng.choice(["the", "a", "movie", "was", "it"], 3)
        texts.append(" ".join(np.concatenate([words, filler])))
        labels.append(float(y))
    return {"text": texts, "label": np.asarray(labels)}


def vision_data(n=32):
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(n, 16, 16, 3)).astype(np.float32) * 0.1
    labels = np.arange(n) % 2
    imgs[labels == 1, :8] += 1.0          # class-1 marker
    return {"image": list(imgs), "label": labels.astype(np.float64)}


def _proba(out):
    return np.stack(list(out["probability"]))


def _carry_jax_init(monkeypatch, name):
    """Capture the JAX fit's initial variables and load them into the
    port's ``init_state``."""
    captured = {}
    orig_j = JTr.DLTrainer.init_state

    def capture(self, *a):
        state = orig_j(self, *a)
        captured["vars"] = jax.tree.map(np.asarray, nn.meta.unbox(
            {"params": state.params, **state.extra_vars}))
        return state

    orig_p = PTr.DLTrainer.init_state

    def carry(self, seed):
        state = orig_p(self, seed)
        cfg = getattr(self.model, "cfg", name)
        self.model.load_state_dict(C.params_from_reference(
            captured["vars"], cfg, "cpu"))
        return state

    monkeypatch.setattr(JTr.DLTrainer, "init_state", capture)
    monkeypatch.setattr(PTr.DLTrainer, "init_state", carry)


TEXT_KW = dict(modelSize="tiny", maxEpochs=2, batchSize=16,
               learningRate=3e-3, maxTokenLen=16, vocabSize=128,
               dropoutRate=0.0, precision="f32")


def test_text_fit_transform_equals_jax(monkeypatch):
    data = text_data(48)
    _carry_jax_init(monkeypatch, None)
    jm = JE.DeepTextClassifier(numDevices=1, **TEXT_KW).fit(JDataset(data))
    pm = PE.DeepTextClassifier(device="cpu", **TEXT_KW).fit(Dataset(data))
    jh, ph = jm.modelPayload["history"], pm.modelPayload["history"]
    for a, b in zip(jh, ph):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    jo = jm.transform(JDataset(data))
    po = pm.transform(Dataset(data))
    np.testing.assert_allclose(_proba(po), _proba(jo), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(po["prediction"], jo["prediction"])


VISION_KW = dict(backbone="resnet18", maxEpochs=2, batchSize=16,
                 learningRate=1e-2, optimizer="sgd", lrSchedule="constant",
                 precision="f32")


def test_vision_fit_transform_equals_jax(monkeypatch):
    data = vision_data(32)
    _carry_jax_init(monkeypatch, "resnet18")
    jm = JE.DeepVisionClassifier(numDevices=1, **VISION_KW).fit(
        JDataset(data))
    pm = PE.DeepVisionClassifier(device="cpu", **VISION_KW).fit(
        Dataset(data))
    for a, b in zip(jm.modelPayload["history"], pm.modelPayload["history"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
    want = jm.modelPayload["variables"]
    got = pm.modelPayload["variables"]
    for coll in ("params", "batch_stats"):
        for k, v in C.flatten_tree(want[coll]).items():
            np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=0,
                                       err_msg=k)
    x = np.stack(data["image"])
    jlogits = JE.make_backbone("resnet18", 2, dtype=jax.numpy.float32).apply(
        want, x, train=False)
    pnet = PE.make_backbone("resnet18", 2, dtype=torch.float32,
                            device="cpu", seed=None)
    pnet.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()})
    with torch.no_grad():
        plogits = pnet(torch.from_numpy(x), train=False)
    e = np.exp(np.asarray(jlogits))
    np.testing.assert_allclose(
        torch.softmax(plogits, -1).numpy(), e / e.sum(-1, keepdims=True),
        atol=1e-4, rtol=0)
    jo = jm.transform(JDataset(data))
    po = pm.transform(Dataset(data))
    np.testing.assert_allclose(_proba(po), _proba(jo), atol=5e-3, rtol=0)
    np.testing.assert_array_equal(po["prediction"], jo["prediction"])



# -- the default bf16 policy: a strided convolution's weight gradient -----------
#
# PyTorch's CPU bf16 convolution leaves the weight gradient of a tap that only
# reads implicit padding unwritten: a stride-2 3x3 convolution over a 1x1 map
# (ResNetBlock_6 at 16x16 images) returned uninitialized memory there, so the
# bf16 fit's margin swung with the allocator and the thread count.  The port's
# ``Conv`` pads strided inputs explicitly.  Both tests run at 1 and 3 threads.

@pytest.mark.parametrize("threads", [1, 3])
def test_strided_conv_weight_grad_is_written(threads):
    from synapseml_tpu_torch.models.dl.resnet import Conv
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        g = torch.Generator().manual_seed(0)
        conv = Conv(64, 128, (3, 3), (2, 2), torch.bfloat16, "cpu")
        with torch.no_grad():
            conv.kernel.copy_(torch.randn(conv.kernel.shape, generator=g)
                              * 0.05)
        for _ in range(4):
            x = torch.randn(16, 64, 1, 1, generator=g).to(torch.bfloat16)
            x = x.contiguous(memory_format=torch.channels_last)
            y = conv(x)
            dy = torch.randn(y.shape, generator=g).to(torch.bfloat16)
            conv.kernel.grad = None
            y.backward(dy)
            kd = conv.kernel.detach().double().requires_grad_(True)
            yd = torch.nn.functional.conv2d(
                x.double(), kd.permute(3, 2, 0, 1), None, 2, 1)
            want, = torch.autograd.grad(yd, (kd,), dy.double())
            got = conv.kernel.grad.double()
            # taps that only read padding get exactly 0; the centre tap is
            # a bf16 product sum (2^-8 relative)
            assert torch.isfinite(got).all()
            assert (got - want).abs().max() <= 1e-2 * want.abs().max()
    finally:
        torch.set_num_threads(prev)


BF16_VISION_KW = dict(backbone="resnet18", maxEpochs=6, batchSize=16,
                      learningRate=1e-2, optimizer="sgd",
                      lrSchedule="constant")


@pytest.fixture(scope="module")
def jax_vision_bf16():
    """The JAX fit of ``test_port_vision_classifier_learns``'s task at the
    default bf16 policy, with its initial variables."""
    data = vision_data(32)
    captured = {}
    orig = JTr.DLTrainer.init_state

    def capture(self, *a):
        state = orig(self, *a)
        captured["vars"] = jax.tree.map(np.asarray, nn.meta.unbox(
            {"params": state.params, **state.extra_vars}))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTr.DLTrainer, "init_state", capture)
        jm = JE.DeepVisionClassifier(numDevices=1, **BF16_VISION_KW).fit(
            JDataset(data))
    return data, captured["vars"], jm


@pytest.mark.parametrize("threads", [1, 3])
def test_vision_bf16_fit_follows_jax(monkeypatch, jax_vision_bf16, threads):
    """From the JAX fit's initial variables, the port's bf16 fit follows
    the JAX bf16 fit at every thread count: both round every convolution
    to bf16, so they part by bf16 rounding only (epoch losses within
    5e-3, trained parameters within 1e-2, probabilities within 2e-2; the
    garbage gradient moved the second epoch's loss by 0.09)."""
    data, init, jm = jax_vision_bf16
    orig = PTr.DLTrainer.init_state

    def carry(self, seed):
        state = orig(self, seed)
        self.model.load_state_dict(C.params_from_reference(
            init, "resnet18", "cpu"))
        return state

    monkeypatch.setattr(PTr.DLTrainer, "init_state", carry)
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        pm = PE.DeepVisionClassifier(device="cpu", **BF16_VISION_KW).fit(
            Dataset(data))
        po = pm.transform(Dataset(data))
    finally:
        torch.set_num_threads(prev)
    for a, b in zip(jm.modelPayload["history"], pm.modelPayload["history"]):
        assert b["loss"] == pytest.approx(a["loss"], abs=5e-3)
    got = pm.modelPayload["variables"]
    for k, v in C.flatten_tree(jm.modelPayload["variables"]["params"]).items():
        np.testing.assert_allclose(got[k], v, atol=1e-2, rtol=0, err_msg=k)
    jo = jm.transform(JDataset(data))
    np.testing.assert_allclose(_proba(po), _proba(jo), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(po["prediction"], jo["prediction"])


# -- the port alone -------------------------------------------------------------

@pytest.fixture(scope="module")
def text_model():
    """The JAX test's task (tests/test_dl.py): 8 epochs of the tiny
    encoder, through a Pipeline."""
    ds = Dataset(text_data(64))
    clf = PE.DeepTextClassifier(modelSize="tiny", maxEpochs=8, batchSize=16,
                                learningRate=3e-3, maxTokenLen=16,
                                vocabSize=128, lrSchedule="constant",
                                validationFraction=0.25, device="cpu")
    return ds, Pipeline([clf]).fit(ds).get_or_default("stages")[0]


def test_port_text_classifier_learns(text_model):
    ds, model = text_model
    out = model.transform(ds)
    assert (out["prediction"] == ds["label"]).mean() > 0.9
    np.testing.assert_allclose(_proba(out).sum(1), 1.0, rtol=1e-5)


def test_port_text_validation_history(text_model):
    _, model = text_model
    hist = model.modelPayload["history"]
    assert len(hist) == 8
    assert all(set(h) == {"loss", "accuracy", "val_accuracy"} for h in hist)
    assert hist[-1]["val_accuracy"] > 0.9


def test_port_text_save_load(text_model, tmp_path):
    ds, model = text_model
    model.save(str(tmp_path / "m"))
    loaded = load_stage(str(tmp_path / "m"))
    assert isinstance(loaded, PE.DeepTextModel)
    np.testing.assert_array_equal(_proba(loaded.transform(ds)),
                                  _proba(model.transform(ds)))


def test_port_text_labels_other_than_01():
    data = text_data(32)
    data["label"] = data["label"] * 3 + 2            # labels {2, 5}
    out = PE.DeepTextClassifier(modelSize="tiny", maxEpochs=4, batchSize=16,
                                learningRate=3e-3, maxTokenLen=16,
                                vocabSize=128, device="cpu").fit(
        Dataset(data)).transform(Dataset(data))
    assert set(np.unique(out["prediction"])) <= {2.0, 5.0}


@pytest.fixture(scope="module")
def vision_model():
    ds = Dataset(vision_data(32))
    clf = PE.DeepVisionClassifier(backbone="resnet18", maxEpochs=6,
                                  batchSize=16, learningRate=1e-2,
                                  optimizer="sgd", lrSchedule="constant",
                                  device="cpu")
    return ds, clf.fit(ds)


def test_port_vision_classifier_learns(vision_model):
    ds, model = vision_model
    out = model.transform(ds)
    assert (out["prediction"] == ds["label"]).mean() > 0.9


def test_port_vision_save_load_and_labels(vision_model, tmp_path):
    ds, model = vision_model
    model.save(str(tmp_path / "v"))
    loaded = load_stage(str(tmp_path / "v"))
    np.testing.assert_array_equal(_proba(loaded.transform(ds)),
                                  _proba(model.transform(ds)))
    data = vision_data(16)
    data["label"] = data["label"] * 4 - 1            # labels {-1, 3}
    out = PE.DeepVisionClassifier(backbone="resnet18", maxEpochs=1,
                                  batchSize=8, device="cpu").fit(
        Dataset(data)).transform(Dataset(data))
    assert set(np.unique(out["prediction"])) <= {-1.0, 3.0}


def test_transform_halves_the_batch_on_oom(monkeypatch, text_model):
    """An out-of-memory error halves the chunk and reruns; the size that
    worked is remembered for the model's shape."""
    ds, model = text_model
    want = _proba(model.transform(ds))
    real = PT.TextEncoder.forward
    seen = []

    def forward(self, ids, *a, **kw):
        seen.append(ids.shape[0])
        if ids.shape[0] > 4:
            raise torch.OutOfMemoryError("fake: out of memory")
        return real(self, ids, *a, **kw)

    monkeypatch.setattr(PE, "_safe_batch", {})
    monkeypatch.setattr(PT.TextEncoder, "forward", forward)
    np.testing.assert_allclose(_proba(model.transform(ds)), want, atol=1e-6)
    assert seen[:3] == [16, 8, 4] and set(seen[2:]) == {4}
    assert list(PE._safe_batch.values()) == [4]
    seen.clear()
    model.transform(ds)
    assert set(seen) == {4}


# -- HF BERT checkpoints ----------------------------------------------------------

def _hf_bert(rng, vocab, L=2, d=16, heads=2, ff=32, max_pos=32, classes=2):
    w = {}

    def t(name, *shape):
        w[name] = (rng.normal(size=shape) * 0.05).astype(np.float32)

    t("bert.embeddings.word_embeddings.weight", vocab, d)
    t("bert.embeddings.position_embeddings.weight", max_pos, d)
    t("bert.embeddings.token_type_embeddings.weight", 2, d)
    w["bert.embeddings.LayerNorm.weight"] = np.ones(d, np.float32)
    w["bert.embeddings.LayerNorm.bias"] = np.zeros(d, np.float32)
    for i in range(L):
        p = f"bert.encoder.layer.{i}."
        for n in ("attention.self.query", "attention.self.key",
                  "attention.self.value", "attention.output.dense"):
            t(p + n + ".weight", d, d)
            t(p + n + ".bias", d)
        t(p + "intermediate.dense.weight", ff, d)
        t(p + "intermediate.dense.bias", ff)
        t(p + "output.dense.weight", d, ff)
        t(p + "output.dense.bias", d)
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            w[p + n + ".weight"] = (1 + rng.normal(size=d) * 0.1
                                    ).astype(np.float32)
            t(p + n + ".bias", d)
    t("bert.pooler.dense.weight", d, d)
    t("bert.pooler.dense.bias", d)
    t("classifier.weight", classes, d)
    t("classifier.bias", classes)
    cfg = {"vocab_size": vocab, "hidden_size": d, "num_hidden_layers": L,
           "num_attention_heads": heads, "intermediate_size": ff,
           "max_position_embeddings": max_pos, "do_lower_case": True}
    return w, cfg


VOCAB = ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "good", "great", "excellent",
         "love", "wonderful", "bad", "awful", "terrible", "hate", "poor",
         "the", "a", "movie", "was", "it", "##s"]


@pytest.fixture(scope="module")
def bert_dirs(tmp_path_factory):
    """One checkpoint written as model.safetensors, as pytorch_model.bin
    and as a two-shard safetensors index."""
    from safetensors.numpy import save_file
    w, cfg = _hf_bert(np.random.default_rng(0), len(VOCAB))
    out = {}
    for kind in ("safetensors", "bin", "sharded"):
        d = tmp_path_factory.mktemp(kind)
        (d / "config.json").write_text(json.dumps(cfg))
        (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
        if kind == "safetensors":
            save_file(w, str(d / "model.safetensors"))
        elif kind == "bin":
            torch.save({k: torch.from_numpy(v) for k, v in w.items()},
                       str(d / "pytorch_model.bin"))
        else:
            names = sorted(w)
            shards = {"a.safetensors": names[::2], "b.safetensors": names[1::2]}
            for f, keys in shards.items():
                save_file({k: w[k] for k in keys}, str(d / f))
            (d / "model.safetensors.index.json").write_text(json.dumps(
                {"weight_map": {k: f for f, ks in shards.items()
                                for k in ks}}))
        out[kind] = str(d)
    return w, out


@pytest.mark.parametrize("kind", ["safetensors", "bin", "sharded"])
def test_read_checkpoint_equals_jax(bert_dirs, kind):
    w, dirs = bert_dirs
    got = PC.read_checkpoint(dirs[kind])
    want = JC.read_checkpoint(dirs[kind])
    assert set(got) == set(want) == set(w)
    for k in w:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_safetensors_reader_widens_bf16(tmp_path):
    """A mixed-dtype file against ``safetensors.numpy`` (and the JAX
    package's reader): BF16 widens to f32 with the same values; F16, F64
    and I64 come back as written."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file
    rng = np.random.default_rng(1)
    tensors = {"bf": torch.from_numpy(rng.normal(size=(3, 5)).astype(
        np.float32)).to(torch.bfloat16),
        "h": torch.from_numpy(rng.normal(size=7).astype(np.float16)),
        "d": torch.from_numpy(rng.normal(size=(2, 2))),
        "i": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = str(tmp_path / "mixed.safetensors")
    save_file(tensors, path)
    got = PC.read_checkpoint(path)
    for want in (load_file(path), JC.read_checkpoint(path)):
        for k in tensors:
            wk = np.asarray(want[k])
            if k == "bf":
                assert got[k].dtype == np.float32
                wk = wk.astype(np.float32)
            assert got[k].dtype == wk.dtype, k
            np.testing.assert_array_equal(got[k], wk)
    np.testing.assert_array_equal(got["bf"], tensors["bf"].float().numpy())


def test_msgpack_checkpoint_is_refused(tmp_path):
    """The port reads flax msgpack files itself
    (``tests/test_torch_dl_msgpack.py``); one that is not a complete
    msgpack object is refused with a ``ValueError`` naming msgpack."""
    path = tmp_path / "flax_model.msgpack"
    path.write_bytes(b"\x80")                   # a complete, empty map
    assert PC.read_checkpoint(str(tmp_path)) == {}
    path.write_bytes(b"\x81")                   # a map missing its entry
    with pytest.raises(ValueError, match="msgpack"):
        PC.read_checkpoint(str(tmp_path))


def test_import_bert_equals_jax(bert_dirs):
    w, dirs = bert_dirs
    tok, jcfg = JE._bert_checkpoint_assets(dirs["safetensors"], 0.0)
    ptok, pcfg = PE._bert_checkpoint_assets(dirs["safetensors"], 0.0)
    assert ptok.to_dict() == tok.to_dict()
    jm = JE.TextEncoder(jcfg)
    ids = np.ones((1, 4), np.int32)
    params = jm.init(jax.random.PRNGKey(0), ids)["params"]
    want = jax.tree.map(np.asarray, nn.meta.unbox(
        JC.import_bert(params, dirs["safetensors"], jcfg.num_layers)))
    pm = PT.TextEncoder(pcfg, device="cpu", seed=0)
    got = PC.import_bert(pm.state_dict(), dirs["bin"], pcfg.num_layers)
    for k, v in C.flatten_tree(want).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_fit_from_bert_checkpoint_equals_jax(bert_dirs):
    """A fine-tune from the checkpoint: every weight comes from the file
    (the head too, its shape matching), so both fits start equal."""
    _, dirs = bert_dirs
    data = text_data(32)
    kw = dict(checkpoint=dirs["safetensors"], maxEpochs=1, batchSize=16,
              learningRate=1e-3, maxTokenLen=12, dropoutRate=0.0,
              precision="f32")
    jo = JE.DeepTextClassifier(numDevices=1, **kw).fit(
        JDataset(data)).transform(JDataset(data))
    po = PE.DeepTextClassifier(device="cpu", **kw).fit(
        Dataset(data)).transform(Dataset(data))
    np.testing.assert_allclose(_proba(po), _proba(jo), atol=1e-4, rtol=0)


# -- refusals ---------------------------------------------------------------------

#: what a knob does on one process without a process group: refuse before
#: any work (an exception type and its message), or pass the checks and
#: start the fit's work (WORKS: the mesh knobs are ported, and on one rank
#: zero1, a codec and a mesh fit's checkpoint train)
WORKS = "works"
COMMON_REFUSALS = [
    # numDevices counts the ranks of the process group: 2 here, where the
    # group is this one process, is a ValueError naming its size
    ("numDevices", 2, (ValueError, "the group has 1 rank")),
    ("zero1", True, WORKS), ("collectiveCompression", "int8", WORKS),
    # a checkpoint a 2-shard mesh fit wrote resumes, re-sharded, at one
    ("checkpointDir", "mesh-checkpoint", WORKS),
    ("checkpointManager", "mesh-checkpoint", WORKS),
    # the step profiler is ported: an object that is not one is refused
    # before any work, with a TypeError
    ("stepProfiler", object(), (TypeError, "StepProfiler")),
]
REFUSALS = ([("text",) + r for r in COMMON_REFUSALS]
            + [("vision",) + r for r in COMMON_REFUSALS]
            # tensor parallelism is ported: tp = 2 does not divide the
            # group's one rank (a ValueError naming its size, as
            # numDevices=2's); the vision classifier trains data-parallel
            # whatever modelParallelism says, as the reference's does
            + [("text", "modelParallelism", 2,
                (ValueError, "the group has 1 rank")),
               ("vision", "modelParallelism", 2, WORKS)]
            + [("text", "numExperts", 8,
                (ValueError, "expertParallelism=2 needs a gang")),
               ("text", "expertParallelism", 2,
                (ValueError, "requires numExperts > 0"))])


@pytest.mark.parametrize("cls,knob,value,item", REFUSALS,
                         ids=[f"{c}-{k}" for c, k, _, _ in REFUSALS])
def test_unported_knobs_refuse_before_any_work(monkeypatch, tmp_path, cls,
                                               knob, value, item):
    ds = Dataset(text_data(4) if cls == "text" else vision_data(4))
    if value == "mesh-checkpoint":
        from synapseml_tpu_torch.core.checkpoint import CheckpointManager
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(3, {"x": np.zeros(1)}, metrics={"shards": 2.0})
        value = mgr if knob == "checkpointManager" else mgr.directory

    def no_work(*a, **k):
        raise AssertionError("work started before the refusal")

    monkeypatch.setattr(PE.WordTokenizer, "fit", no_work)
    monkeypatch.setattr(PE.np, "stack", no_work)
    est = (PE.DeepTextClassifier(device="cpu") if cls == "text"
           else PE.DeepVisionClassifier(device="cpu"))
    est.set(knob, value)
    if knob == "numExperts":
        # the MoE FFN trains on one card; an expert mesh needs a gang
        est.set("expertParallelism", 2)
    if item == WORKS:
        with pytest.raises(AssertionError, match="work started"):
            est.fit(ds)
        return
    exc, match = item
    with pytest.raises(exc, match=match):
        est.fit(ds)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ds = Dataset(text_data(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.DeepTextClassifier(modelSize="tiny").fit(ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.DeepVisionClassifier(backbone="resnet18").fit(
            Dataset(vision_data(4)))
