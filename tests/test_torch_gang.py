"""The port's parallel layer across real processes on the CPU: gangs of
gloo ranks launched by ``run_on_local_cluster``, four launches in all.

- 2 ranks: the rendezvous report and the data-parallel GBDT (both ranks'
  models equal; against the JAX package's 2-device mesh fit the first
  split and tree count are equal and the holdout AUC within 0.005, the
  slice's tolerance, since the JAX CPU fit histograms f32 by scatter;
  each rank's bag masks are the JAX package's ``fold_in(key, rank)``
  draws).
- 4 ranks: every collective against numpy; ``compressed_psum`` against a
  numpy statement of the reference's arithmetic (bit-equal over a 2-rank
  axis); the planner's routes against the flat psum.
- 1 rank: a fit over the group bit-equal to the fit without one, and a
  hung collective raising ``CollectiveTimeout`` in time.
- 2 ranks, one killed mid-fit: ``WorkerFailure`` naming it, with a
  post-mortem bundle.
"""

import base64
import hashlib

import jax
import ml_dtypes
import numpy as np
import pytest

from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu.models.gbdt.metrics import auc
from synapseml_tpu.parallel import data_parallel_mesh as jmesh
from synapseml_tpu_torch.parallel import (GangSupervisor, WorkerFailure,
                                          run_on_local_cluster)
from torch_gang_tasks import binary_data, rank_values
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

#: every gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 120.0


def _gang(task, n, **kw):
    return run_on_local_cluster(f"torch_gang_tasks:{task}", n,
                                task_args={"device": "cpu"}, device="cpu",
                                timeout_s=GANG_TIMEOUT_S, **kw)


@pytest.fixture(scope="module")
def fits():
    return _gang("gbdt_fits", 2)


@pytest.fixture(scope="module")
def colls():
    return _gang("collectives_check", 4)


@pytest.fixture(scope="module")
def one_rank():
    return _gang("one_rank_checks", 1)[0]


# -- 2 ranks: report and data-parallel GBDT ------------------------------------

def test_two_rank_cluster_report(fits):
    reps = [r["report"] for r in fits]
    assert [r["process_index"] for r in reps] == [0, 1]
    for r in reps:
        assert r["process_count"] == 2 and r["backend"] == "gloo"
        assert r["device_table"] == [[0, "cpu"], [1, "cpu"]]
        assert r["psum_local"] == [r["psum_expected"]] == [1.0]
        assert r["all_gather"] == [0.0, 1.0]
        assert r["placement"] == {str(p): p // 6 for p in range(12)}
    assert reps[0]["placement"] == reps[1]["placement"]


def test_two_rank_fit_gives_one_model_on_every_rank(fits):
    assert fits[0]["model_md5"] == fits[1]["model_md5"]
    assert fits[0]["holdout_margin"] == fits[1]["holdout_margin"]
    assert fits[0]["bagged_md5"] == fits[1]["bagged_md5"]


def test_two_rank_fit_matches_jax_mesh_fit(fits):
    X, y = binary_data(n=2000)
    Xh, yh = binary_data(n=1000, seed=11)
    cfg = JConfig(objective="binary", num_iterations=6, num_leaves=15,
                  min_data_in_leaf=5)
    jb, _ = jtrain(X, y, cfg, mesh=jmesh(2))
    t0 = jb.trees[0]
    assert fits[0]["first_split"] == [int(t0.split_feature[0]),
                                      float(t0.threshold[0])]
    assert fits[0]["num_trees"] == jb.num_trees
    a_port = auc(yh, np.asarray(fits[0]["holdout_margin"]))
    a_jax = auc(yh, np.asarray(jb.predict_margin(Xh)))
    assert abs(a_port - a_jax) <= 0.005, (a_port, a_jax)


def test_bagged_ranks_draw_the_jax_fold_in_masks(fits):
    """Each rank's mask for iteration i: uniform(fold_in(fold_in(
    PRNGKey(bagging_seed), i), rank), (rows per rank,)) < fraction."""
    per = 1000
    for rank, r in enumerate(fits):
        assert len(r["bag_masks"]) == 3
        for it, b64 in enumerate(r["bag_masks"]):
            got = np.unpackbits(np.frombuffer(base64.b64decode(b64),
                                              np.uint8))[:per]
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(3), it), rank)
            want = np.asarray(jax.random.uniform(key, (per,)) < 0.7)
            np.testing.assert_array_equal(got.astype(bool), want)


# -- 4 ranks: the collectives ---------------------------------------------------

@pytest.mark.parametrize("check", [
    "psum_close", "ring_close", "tree_bucketed_ok", "all_gather_ok",
    "reduce_scatter_ok", "ring_shift_ok", "all_to_all_ok", "pmax_ok",
    "pmin_ok", "pmean_ok", "barrier_ok", "allreduce_fn_ok", "hier_close"])
def test_collectives_on_four_ranks(colls, check):
    assert [r[check] for r in colls] == [True] * 4
    assert len({r["psum_same_everywhere"] for r in colls}) == 1


def test_planner_routes_agree_with_flat(colls):
    """ring / tree / hierarchical at each codec give the flat route's sum
    (a tree under int8 ships f32, so it is held to f32), replicated bit
    for bit on every rank."""
    for strategy in ("ring", "tree", "hierarchical"):
        for codec in ("none", "bf16", "int8"):
            key = f"route_{strategy}_{codec}"
            assert len({r[key + "_digest"] for r in colls}) == 1, key
            if (strategy, codec) not in (("tree", "int8"),
                                         ("hierarchical", "int8")):
                assert all(r[key] for r in colls), key
    assert colls[0]["route_tree_int8_digest"] == \
        colls[0]["route_tree_none_digest"]


# the numpy statement of the reference's compressed_psum arithmetic
# (synapseml_tpu/parallel/compression.py:300-475)

def _np_int8_encode(flat, chunk):
    xc = flat.reshape(-1, chunk)
    finite = np.isfinite(xc)
    amax = np.where(finite, np.abs(xc), np.float32(0)).max(axis=1)
    scale = (amax / np.float32(127.0)).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    q = np.clip(np.rint(xc / safe[:, None]), -127, 127).astype(np.int8)
    scale = np.where(finite.all(axis=1), scale, np.float32(np.nan))
    return q, scale.astype(np.float32)


def _np_int8_decode(q, s):
    return (q.astype(np.float32) * s[:, None]).reshape(-1)


def _np_compressed_psum(xs, codec, chunk=256):
    """xs: every rank's (n, C) f32 values in rank order."""
    n = len(xs)
    if codec == "bf16":
        acc = xs[0].astype(ml_dtypes.bfloat16)
        for x in xs[1:]:
            acc = (acc.astype(np.float32) + x.astype(ml_dtypes.bfloat16)
                   .astype(np.float32)).astype(ml_dtypes.bfloat16)
        return acc.astype(np.float32)
    shape = xs[0].shape
    C = shape[-1]

    def layout(x):
        moved = np.moveaxis(x, -1, 0).reshape(C, -1)
        per = moved.shape[1]
        per_p = -(-per // chunk) * chunk
        moved = np.pad(moved, ((0, 0), (0, per_p - per)))
        flat = moved.reshape(-1)
        size = flat.shape[0]
        unit = n * chunk
        return np.pad(flat, (0, -(-size // unit) * unit - size)), per, per_p

    flats = [layout(x)[0] for x in xs]
    _, per, per_p = layout(xs[0])
    size = C * per_p
    shard = flats[0].shape[0] // n
    total = []
    for r in range(n):                      # rank r's shard of the sum
        acc = None
        for j in range(n):
            q, s = _np_int8_encode(flats[j], chunk)
            part = _np_int8_decode(q, s)[r * shard:(r + 1) * shard]
            acc = part if acc is None else (acc + part).astype(np.float32)
        total.append(_np_int8_decode(*_np_int8_encode(acc, chunk)))
    total = np.concatenate(total)[:size]
    out = total.reshape(C, per_p)[:, :per]
    return np.moveaxis(out.reshape((C,) + shape[:-1]), 0, -1)


def _digest(a: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compressed_psum_bit_equal_at_two_ranks(colls, codec):
    """Over the 2 x 2 mesh's 2-rank 'inner' axis, compressed_psum is the
    numpy statement bit for bit on both ranks of each pair."""
    for r in colls:
        pair = [q["rank"] for q in colls
                if q["outer_index"] == r["outer_index"]]
        want = _np_compressed_psum([rank_values(p, 4096) for p in pair],
                                   codec)
        assert r[f"inner_{codec}"] == _digest(want.astype(np.float32))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compressed_psum_on_four_ranks(colls, codec):
    """Over all four ranks: replicated bit for bit, int8 bit-equal to
    the statement (its shard sums run in rank order), bf16 within its
    rounding (gloo's four-rank add order is its own)."""
    xs = [rank_values(r, 4096) for r in range(4)]
    want = _np_compressed_psum(xs, codec)
    assert len({r[f"compressed_{codec}"] for r in colls}) == 1
    if codec == "int8":
        assert colls[0][f"compressed_{codec}"] == _digest(
            want.astype(np.float32))
    else:
        assert colls[0][f"compressed_{codec}_err"] < 2 ** -6


# -- 1 rank: the group fit and the watchdog -------------------------------------

def test_one_rank_group_fit_is_bit_equal(one_rank):
    assert one_rank["equal"] is True


def test_histogram_all_reduces_feed_the_step_profiler(one_rank):
    """Every all-reduce of a profiled mesh fit lands in the open step's
    collective segment (``observe_collective``)."""
    assert one_rank["profiled_collective_bytes"] > 0
    assert one_rank["profiled_collective_s"] > 0


def test_hung_collective_raises_collective_timeout(one_rank):
    assert one_rank["raised"] == "CollectiveTimeout"
    assert "'psum'" in one_rank["message"]
    assert 1.0 <= one_rank["elapsed_s"] <= 1.0 + 5.0


# -- a dead rank ------------------------------------------------------------------

def test_rank_dying_mid_fit_gives_worker_failure(tmp_path):
    sup = GangSupervisor(
        "torch_gang_tasks:fit_until_killed", 2, device="cpu",
        timeout_s=GANG_TIMEOUT_S, observability_dir=str(tmp_path),
        env_extra={"SML_FAULTS":
                   "collective.dispatch=kill_rank:rank=1:after=5"})
    with pytest.raises(WorkerFailure) as ei:
        sup.run()
    causes = ei.value.causes
    assert 1 in causes and causes[1].startswith("exit -9"), causes
    assert sup.last_postmortem is not None
    import json
    with open(sup.last_postmortem) as f:
        bundle = json.load(f)
    assert bundle["causes"]["1"].startswith("exit -9")
    assert sup.plane is not None and sup.plane.batches(1) >= 1
