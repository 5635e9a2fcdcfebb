"""Distributed lambdarank across real processes on the CPU: one
module-scoped gang of 2 gloo ranks (``tests/torch_gang_tasks.py:
gbdt_rank_modes``).

- ``pack_groups_for_shards`` bit-equal to the JAX package's.
- Each rank's lambdas from ``make_lambdarank_objective_sharded`` (float64,
  rounded to float32 as the fit rounds them) against the JAX package's
  sharded objective (float32) under ``shard_map`` on the same slabs:
  rtol 1e-5, atol 1e-6, the one-device ranking tests' tolerance.
- The ranker over the gang in each parallelism mode under the contract
  of the JAX package's test (tests/test_gbdt.py:810-842): NDCG@5 beats
  random scores by 0.1 and stays within 0.05 of the one-process ranker;
  feature_parallel (rows replicated, the plain objective on every rank)
  grows the one-process depthwise ranker's trees bit for bit.
- A streamed ranker over the gang (the source's binned columns packed
  on the device) equals the in-memory one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from synapseml_tpu.models.gbdt import ranking as jranking
from synapseml_tpu.parallel import data_parallel_mesh as jmesh
from synapseml_tpu_torch.io.colstore import write_matrix
from synapseml_tpu_torch.models.gbdt import ranking as tranking
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
from synapseml_tpu_torch.models.gbdt.metrics import ndcg_at
from synapseml_tpu_torch.parallel import run_on_local_cluster
from torch_gang_tasks import RANK_KW, rank_task, tree_digest
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

#: the gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 120.0
MODES = ("data_parallel", "voting_parallel", "feature_parallel")


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    X, y, _ = rank_task()
    path = str(tmp_path_factory.mktemp("rank") / "rank.smlc")
    write_matrix(path, np.concatenate([X, y[:, None].astype(np.float32)],
                                      axis=1))
    return run_on_local_cluster(
        "torch_gang_tasks:gbdt_rank_modes", 2,
        task_args={"device": "cpu", "modes": list(MODES), "stream": path},
        device="cpu", timeout_s=GANG_TIMEOUT_S)


@pytest.mark.parametrize("sizes,shards,unit", [
    (np.random.default_rng(6).integers(4, 14, 48), 2, 1),
    (np.random.default_rng(7).integers(1, 300, 40), 4, 1),
    (np.array([5, 5, 5, 5, 9, 1, 130]), 3, 8),
])
def test_pack_groups_for_shards_bit_equal_to_jax(sizes, shards, unit):
    got = tranking.pack_groups_for_shards(sizes, shards, unit)
    want = jranking.pack_groups_for_shards(sizes, shards, unit)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sharded_lambdas_match_jax(gang):
    X, y, sizes = rank_task()
    perm, sq, smask, L = jranking.pack_groups_for_shards(sizes, 2)
    real = perm >= 0
    ys = (y[np.maximum(perm, 0)] * real).astype(np.float32)
    ws = real.astype(np.float32)
    scores = np.concatenate([np.random.default_rng(3 + r).normal(size=L)
                             for r in range(2)]).astype(np.float32)
    obj = jranking.make_lambdarank_objective_sharded(sq, smask, L, "data")
    fn = jax.jit(jax.shard_map(obj, mesh=jmesh(2), in_specs=P("data"),
                               out_specs=P("data"), check_vma=False))
    jg, jh = (np.asarray(a) for a in fn(jnp.asarray(scores), jnp.asarray(ys),
                                         jnp.asarray(ws)))
    for r, res in enumerate(gang):
        g, h = (np.asarray(a, np.float32) for a in res["lambdas"])
        np.testing.assert_allclose(g, jg[r * L:(r + 1) * L], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(h, jh[r * L:(r + 1) * L], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", MODES + ("streamed",))
def test_ranks_return_one_ranker(gang, mode):
    assert gang[0][mode] == gang[1][mode]


@pytest.mark.parametrize("mode", MODES)
def test_ranker_modes_meet_the_jax_contract(gang, mode):
    X, y, sizes = rank_task()
    one, _ = ttrain(X, y, BoostingConfig(**RANK_KW), group=sizes,
                    device="cpu")
    ndcg = ndcg_at(5)
    s1 = ndcg(y, one.predict_margin(X, device="cpu"), sizes)
    sp = ndcg(y, np.asarray(gang[0][mode]["margin"]), sizes)
    s_rand = ndcg(y, np.random.default_rng(6).normal(size=len(y)), sizes)
    assert sp > s_rand + 0.1
    assert sp > s1 - 0.05, (s1, sp)
    if mode == "feature_parallel":
        assert gang[0][mode]["digest"] == tree_digest(one)


def test_streamed_distributed_ranker_equals_in_memory(gang):
    assert gang[0]["streamed"]["digest"] == gang[0]["data_parallel"]["digest"]
