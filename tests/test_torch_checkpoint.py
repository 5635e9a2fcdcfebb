"""The port's step checkpoints (``synapseml_tpu_torch.core.checkpoint``)
against the JAX package's, and their consumers, on the CPU.

- ``CheckpointManager``: the cases of tests/test_checkpoint.py's
  ``TestCheckpointManager`` on the port, with a bf16 tensor leaf and
  tensors kept on their device; a ``preempt`` at
  ``checkpoint.save.pre_publish`` leaves no visible step.
- Across packages: a pytree of dicts and lists of numpy arrays written by
  the JAX manager restores positionally in the port bit-equal, and the
  reverse, metrics included.
- DL resume (tests/test_checkpoint.py's ``TestDLResume`` on one device):
  resnet18 at 16x16, 48 rows, batch 16, 3 epochs against 1 epoch and a
  resume; a tiny ``DeepTextClassifier`` the same way; probabilities
  within the JAX test's ``rtol=1e-4, atol=1e-5`` (they come out equal
  here); the config guard refuses a changed ``batchSize``.
- GBDT through a ``CheckpointManager``: the trees equal a
  ``checkpointDir`` fit's, and a resume from the manager's directory
  equals the uninterrupted fit.
"""

import os

import numpy as np
import pytest
import torch

from synapseml_tpu.core.checkpoint import CheckpointManager as JManager
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.core.checkpoint import CheckpointManager
from synapseml_tpu_torch.resilience import PreemptionError, get_faults
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


# -- the manager ------------------------------------------------------------------

def _roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": np.arange(5), "nested": {"b": np.eye(3, dtype=np.float32)},
            "scalar": np.float32(2.5)}
    mgr.save(10, tree, metrics={"loss": 0.5})
    got = mgr.restore()
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["nested"]["b"], tree["nested"]["b"])
    assert got["scalar"] == np.float32(2.5)
    assert mgr.metrics(10)["loss"] == 0.5


def _latest_and_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": np.full(3, s)})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    np.testing.assert_array_equal(mgr.restore()["x"], np.full(3, 4))


def _restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=0)
    mgr.save(1, {"x": np.ones(2)})
    mgr.save(2, {"x": np.ones(2) * 2})
    np.testing.assert_array_equal(mgr.restore(1)["x"], np.ones(2))


def _no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore()


def _atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"x": np.ones(4)})
    assert [e for e in os.listdir(tmp_path)
            if e.startswith(".tmp_ckpt_")] == []


def _positional_restore_with_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": np.arange(4, dtype=np.float32), "step": np.int32(3)})
    got = mgr.restore_state_dict({"w": np.zeros(4, np.float32),
                                  "step": np.int32(0)})
    np.testing.assert_array_equal(got["w"], np.arange(4, dtype=np.float32))
    assert got["step"] == 3


def _bf16_and_tensor_leaves(tmp_path):
    """A bf16 tensor goes to disk as its uint16 bits and comes back bf16,
    bit-equal; tensors, tuples, lists and None keep their structure."""
    mgr = CheckpointManager(str(tmp_path))
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 5, generator=g).to(torch.bfloat16)
    tree = {"w": w, "pair": (torch.arange(3), [np.ones(2), None]),
            "count": 5}
    mgr.save(1, tree)
    got = mgr.restore()
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert isinstance(got["pair"], tuple) and got["pair"][1][1] is None
    assert torch.equal(got["pair"][0], torch.arange(3))
    assert got["count"] == 5
    # positionally into a template: the template's dtype and device
    t = mgr.restore_state_dict({"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                                "pair": (torch.zeros(3, dtype=torch.int64),
                                         [np.zeros(2), None]),
                                "count": 0})
    assert torch.equal(t["w"].view(torch.int16), w.view(torch.int16))
    # the JAX manager reads the bits, named in the side-car
    raw = JManager(str(tmp_path)).restore_state_dict(
        {"w": 0, "pair": [0, [0, None]], "count": 0})
    np.testing.assert_array_equal(raw["w"], w.view(torch.int16).numpy()
                                  .view(np.uint16))


@pytest.mark.parametrize("case", [
    _roundtrip, _latest_and_prune, _restore_specific_step,
    _no_checkpoint_raises, _atomic_no_partial_dirs,
    _positional_restore_with_template, _bf16_and_tensor_leaves],
    ids=lambda f: f.__name__.lstrip("_"))
def test_checkpoint_manager(case, tmp_path):
    case(tmp_path)


def test_preempt_before_publish_leaves_no_step(tmp_path):
    faults = get_faults()
    faults.clear()
    faults.inject("checkpoint.save.pre_publish", "preempt", times=1)
    try:
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(PreemptionError):
            mgr.save(1, {"x": np.ones(3)})
        assert mgr.all_steps() == [] and mgr.latest_step() is None
        assert os.listdir(tmp_path) == []
        mgr.save(2, {"x": np.ones(3)})
        assert mgr.all_steps() == [2]
    finally:
        faults.clear()


# -- across packages ---------------------------------------------------------------

def _pytree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                       "b": rng.normal(size=3)},
            "layers": [rng.integers(0, 9, 5).astype(np.int32),
                       {"g": rng.normal(size=(2, 2)).astype(np.float32)}],
            "step": np.int64(11)}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return np.zeros_like(tree)


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    tree = _pytree(1)
    JManager(str(tmp_path)).save(4, tree, metrics={"loss": 0.25})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4 and mgr.metrics(4) == {"loss": 0.25}
    _assert_tree_equal(mgr.restore_state_dict(_zeros_like(tree)), tree)
    with pytest.raises(TypeError, match="restore_state_dict"):
        mgr.restore()


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    tree = _pytree(2)
    CheckpointManager(str(tmp_path)).save(6, tree, metrics={"acc": 0.75})
    jm = JManager(str(tmp_path))
    assert jm.latest_step() == 6 and jm.metrics(6) == {"acc": 0.75}
    _assert_tree_equal(jm.restore_state_dict(_zeros_like(tree)), tree)
    _assert_tree_equal(CheckpointManager(str(tmp_path)).restore(), tree)


# -- DL resume ---------------------------------------------------------------------

def _vision_ds(rng, n=48):
    imgs = np.empty(n, dtype=object)
    for i in range(n):
        imgs[i] = rng.normal(size=(16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.float64)
    return Dataset({"image": imgs, "label": labels})


def _probs(model, ds):
    return np.stack(list(model.transform(ds)["probability"]))


def test_dl_vision_resume_matches_uninterrupted(tmp_path):
    from synapseml_tpu_torch.models.dl import DeepVisionClassifier
    ds = _vision_ds(np.random.default_rng(0))
    kw = dict(backbone="resnet18", batchSize=16, learningRate=1e-3,
              seed=7, lrSchedule="constant", validationFraction=0.0,
              device="cpu")
    full = DeepVisionClassifier(maxEpochs=3, **kw).fit(ds)
    ck = str(tmp_path / "ck")
    DeepVisionClassifier(maxEpochs=1, **kw, checkpointDir=ck,
                         checkpointInterval=1).fit(ds)
    assert CheckpointManager(ck).latest_step() == 3   # 48 / 16 a epoch
    res = DeepVisionClassifier(maxEpochs=3, **kw, checkpointDir=ck,
                               checkpointInterval=1).fit(ds)
    assert CheckpointManager(ck).latest_step() == 9
    assert len(res.modelPayload["history"]) == 2      # epochs 2 and 3 ran
    np.testing.assert_allclose(_probs(full, ds), _probs(res, ds),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="batchSize"):
        DeepVisionClassifier(maxEpochs=4, **{**kw, "batchSize": 8},
                             checkpointDir=ck, checkpointInterval=1).fit(ds)


def test_dl_text_resume_through_a_manager(tmp_path):
    """A tiny text classifier (dropout on: its masks follow the restored
    step) resumed through a CheckpointManager equals the uninterrupted
    fit; a checkpoint a mesh fit wrote (shards 2) resumes at one rank,
    the resize noted."""
    from synapseml_tpu_torch.models.dl import DeepTextClassifier
    rng = np.random.default_rng(3)
    words = ["good", "great", "fine", "bad", "poor", "sad", "t1", "t2"]
    labels = rng.integers(0, 2, 40)
    texts = [" ".join(rng.choice(words[:3] if y else words[3:6], 3))
             + f" t{i % 2 + 1}" for i, y in enumerate(labels)]
    ds = Dataset({"text": np.array(texts, dtype=object),
                  "label": labels.astype(np.float64)})
    kw = dict(modelSize="tiny", maxTokenLen=8, vocabSize=32, batchSize=8,
              seed=3, lrSchedule="constant", learningRate=1e-3,
              device="cpu")
    full = DeepTextClassifier(maxEpochs=2, **kw).fit(ds)
    mgr = CheckpointManager(str(tmp_path / "text"), max_to_keep=2)
    DeepTextClassifier(maxEpochs=1, **kw, checkpointManager=mgr,
                       checkpointInterval=2).fit(ds)
    assert mgr.all_steps() == [2, 4]
    res = DeepTextClassifier(maxEpochs=2, **kw, checkpointManager=mgr,
                             checkpointInterval=2).fit(ds)
    assert mgr.latest_step() == 10
    np.testing.assert_allclose(_probs(full, ds), _probs(res, ds),
                               rtol=1e-4, atol=1e-5)
    cfg = dict(mgr.metrics(10), shards=2.0)
    mgr.save(10, mgr.restore(10), metrics=cfg)
    from synapseml_tpu_torch.resilience import get_faults
    faults = get_faults()
    faults.clear()
    faults.record_calls = True
    try:
        more = DeepTextClassifier(maxEpochs=3, **kw, checkpointManager=mgr,
                                  checkpointInterval=2).fit(ds)
        notes = [dict(c) for c in faults.calls_for("dl.resize_resume")]
    finally:
        faults.clear()
    assert notes == [{"saved": 2, "current": 1}]
    assert mgr.latest_step() == 14    # steps 11-15 ran, every 2nd saved
    assert len(more.modelPayload["history"]) == 1


# -- GBDT through a manager --------------------------------------------------------

def test_gbdt_checkpoint_manager_equals_checkpoint_dir(tmp_path):
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=600) > 0).astype(
        np.float64)
    ds = Dataset({"features": list(X), "label": y})
    kw = dict(numIterations=6, numLeaves=7, minDataInLeaf=5, device="cpu",
              checkpointInterval=2)
    by_dir = GBDTClassifier(**kw, checkpointDir=str(tmp_path / "d")).fit(ds)
    mgr = CheckpointManager(str(tmp_path / "m"))
    by_mgr = GBDTClassifier(**kw, checkpointManager=mgr).fit(ds)
    assert by_mgr.get_model_string() == by_dir.get_model_string()
    assert sorted(os.listdir(mgr.directory)) == [
        "iter_00000002.json", "iter_00000004.json", "iter_00000006.json"]
    # a half fit into a fresh manager, then a resume through it
    half = CheckpointManager(str(tmp_path / "h"))
    GBDTClassifier(**{**kw, "numIterations": 4},
                   checkpointManager=half).fit(ds)
    resumed = GBDTClassifier(**kw, checkpointManager=half).fit(ds)
    assert resumed.get_model_string() == by_dir.get_model_string()
