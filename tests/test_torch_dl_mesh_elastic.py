"""Step checkpoints of a DL fit over a gang of ranks, resumed at the same
size and across a resize, a fit that loses a rank under
``GangSupervisor``, and the step profiler's cost capture over a mesh.

The port's ``tests/torch_gang_tasks.py`` runs the fits on gloo ranks on
the CPU (``dl_fit``, ``gbdt_capture``; ``run_many`` serves several from
one gang).  The DL fit is the JAX package's resize acceptance
(``tests/test_gang.py::test_dl_int8_ef_sharded_checkpoint_resumes_across_
resize``): the tiny text classifier on 96 rows at batch 24 (divisible by
4 and by 3, so the data order is the same at either size), int8 with
error feedback and the sharded update, a checkpoint every step, dropout
on (its masks follow the restored step).

- A 2-rank fit stopped after one epoch and resumed for the second
  equals the uninterrupted 2-rank fit bit for bit, and so does an
  expert-parallel fit (data 1 x expert 2, 4 experts, no codec).
- A 4-rank checkpoint resumed by two 3-rank gangs: both resumes are
  bit-identical, the loss continues (within 0.05 of where the 4-rank
  fit stopped, the JAX package's bound), the resize is noted (4 → 3) and
  a codec toggle against the checkpoint still raises.
- Rank 1 of a 2-rank fit dies after its third checkpoint in every attempt:
  the supervisor shrinks the gang to one rank, which resumes the 2-rank
  checkpoint (noted 2 → 1) and finishes the fit.
- The cost capture over a 2-rank mesh (GBDT and DL): every rank captures
  the same cost, and the fit equals the uncaptured fit.
"""

import os
import shutil

import numpy as np
import pytest

from synapseml_tpu_torch.parallel import (GangSupervisor,
                                          run_on_local_cluster)
from synapseml_tpu_torch.resilience import RetryPolicy

import torch_gang_tasks as G
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

GANG_TIMEOUT_S = 180.0
CC = dict(compression="int8", error_feedback=True, sharded_update=True,
          min_size=64)
FIT = dict(modelSize="tiny", maxTokenLen=16, vocabSize=64, batchSize=24,
           seed=3, lrSchedule="constant", collective=CC)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dl_elastic")
    rng = np.random.default_rng(0)
    texts = [("good great fine nice " if y else "bad awful poor sad ")
             + f"t{i % 7}" for i, y in enumerate(rng.integers(0, 2, 96))]
    labels = np.array([t.startswith("good") for t in texts], float)
    path = str(root / "texts.npz")
    G._save_npz(path, {"text": np.asarray(texts), "label": labels})
    return root, path


def _fit(path, epochs, ckpt=None, **kw):
    args = dict(kind="text", data=path, kw=dict(FIT, maxEpochs=epochs))
    if ckpt is not None:
        args["ckpt"] = str(ckpt)
    args.update(kw)
    return ["dl_fit", args]


@pytest.fixture(scope="module")
def two_rank(data):
    """One 2-rank gang: the uninterrupted fit, the one-epoch fit and its
    resume, the DL fit with and without the cost capture, the GBDT
    capture, and the expert-parallel fit's three (uninterrupted, one
    epoch, resumed)."""
    root, path = data
    plain = dict(kind="text", data=path,
                 kw=dict(FIT, maxEpochs=1, collective=None))
    expert = dict(FIT, collective=None, numExperts=4, expertParallelism=2)
    tasks = [_fit(path, 2, root / "full"), _fit(path, 1, root / "half"),
             _fit(path, 2, root / "half"), ["dl_fit", plain],
             ["dl_fit", dict(plain, profile=True)],
             ["gbdt_capture", {"n": 600}],
             _fit(path, 2, root / "ep_full", kw=dict(expert, maxEpochs=2)),
             _fit(path, 1, root / "ep_half", kw=dict(expert, maxEpochs=1)),
             _fit(path, 2, root / "ep_half", kw=dict(expert, maxEpochs=2))]
    return run_on_local_cluster("torch_gang_tasks:run_many", 2,
                                task_args={"device": "cpu", "tasks": tasks},
                                device="cpu", timeout_s=GANG_TIMEOUT_S)


def test_same_size_resume_is_bit_exact(two_rank):
    for rank in two_rank:
        full, half, resumed = rank[0], rank[1], rank[2]
        assert len(half["history"]) == 1 and len(resumed["history"]) == 1
        assert resumed["variables_md5"] == full["variables_md5"]
        assert resumed["history"] == full["history"][1:]
        assert resumed["resize_notes"] == []
    assert two_rank[0][2]["variables_md5"] == two_rank[1][2]["variables_md5"]


def test_expert_mesh_resume_is_bit_exact(two_rank):
    """The (data 1, expert 2) fit's checkpoint holds the whole model and
    its moments (each expert's gathered over the expert axis) and each
    rank resumes its slice: the resumed fit equals the uninterrupted."""
    for rank in two_rank:
        full, half, resumed = rank[6], rank[7], rank[8]
        assert len(half["history"]) == 1
        assert resumed["variables_md5"] == full["variables_md5"]
        assert resumed["history"] == full["history"][1:]
    assert two_rank[0][8]["variables_md5"] == two_rank[1][8]["variables_md5"]


@pytest.mark.parametrize("kind", ["gbdt", "dl"])
def test_cost_capture_over_a_mesh(two_rank, kind):
    """Every rank captures the same step's cost together; the captured
    fit equals the uncaptured one."""
    if kind == "gbdt":
        recs = [r[5] for r in two_rank]
        for r in recs:
            assert r["captured"] == r["plain"]
            assert r["cost"] is not None and r["cost"]["flops"] > 0
        assert recs[0]["cost"] == recs[1]["cost"]
        return
    plain = [r[3] for r in two_rank]
    captured = [r[4] for r in two_rank]
    for p, c in zip(plain, captured):
        assert c["variables_md5"] == p["variables_md5"]
        cost = c["costs"]["dl_text_step"]
        assert cost is not None and cost["flops"] > 0
    assert captured[0]["costs"] == captured[1]["costs"]


def test_resize_resume_is_deterministic_and_continues(data):
    root, path = data
    d4 = root / "d4"
    (four,) = run_on_local_cluster(
        "torch_gang_tasks:run_many", 4,
        task_args={"device": "cpu", "tasks": [_fit(path, 1, d4)]},
        device="cpu", timeout_s=GANG_TIMEOUT_S)[:1]
    loss4 = four[0]["history"][-1]["loss"]
    a, b = root / "a", root / "b"
    shutil.copytree(d4, a)
    shutil.copytree(d4, b)
    three = run_on_local_cluster(
        "torch_gang_tasks:run_many", 3,
        task_args={"device": "cpu", "tasks": [
            _fit(path, 2, a), _fit(path, 2, b, toggle="none")]},
        device="cpu", timeout_s=GANG_TIMEOUT_S)
    for rank in three:
        ra, rb = rank
        assert ra["world"] == 3
        assert ra["history"] == rb["history"]          # deterministic
        assert ra["variables_md5"] == rb["variables_md5"]
        assert len(ra["history"]) == 1                 # epoch 2 ran
        assert ra["history"][0]["loss"] < loss4 + 0.05  # continues
        assert ra["resize_notes"] == [{"saved": 4, "current": 3}]
        assert "compression" in rb["toggle_error"]
    assert len({r[0]["variables_md5"] for r in three}) == 1


def test_lost_rank_shrinks_and_resumes_under_supervisor(data, tmp_path):
    _, path = data
    sup = GangSupervisor(
        "torch_gang_tasks:dl_fit", 2, device="cpu",
        task_args=dict(kind="text", data=path, kw=dict(FIT, maxEpochs=2)),
        timeout_s=GANG_TIMEOUT_S, checkpoint_dir=str(tmp_path / "ckpt"),
        heartbeat_interval_s=0.5, hang_intervals=6.0, min_ranks=1,
        shrink_after=2,
        retry_policy=RetryPolicy(max_retries=4, base_s=0.01, seed=3),
        env_extra={"SML_FAULTS": "dl.checkpoint=kill_rank:rank=1:after=2"})
    out = sup.run()
    assert len(out) == 1 and sup.world_size == 1
    assert out[0]["world"] == 1
    assert [(e["from"], e["to"]) for e in sup.resize_history] == [(2, 1)]
    assert out[0]["resize_notes"] == [{"saved": 2, "current": 1}]
    # the last epoch ran at one rank from the 2-rank checkpoint
    assert len(out[0]["history"]) >= 1
    assert np.isfinite(out[0]["history"][-1]["loss"])
    assert sorted(os.listdir(tmp_path / "ckpt"))
