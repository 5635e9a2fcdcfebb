"""The online learners' mesh across real processes on the CPU: one
module-scoped gang of 2 gloo ranks (``tests/torch_gang_tasks.py:
online_mesh``) runs ``train_sgd(mesh=...)`` at each sync schedule (0: a
weighted average at the end of each pass, 2 passes; 1: every batch's
gradient averaged; 4: an average after every chunk of 4 blocks) and
``OnlineSGDClassifier(mesh=...)``.  Every rank returns the same state,
and each state is within 1e-5 of the JAX package's
``train_sgd(mesh=data_parallel_mesh(2))`` on the same rows, every field
held to 1e-5 times its largest magnitude (at least 1): the rule of the
single-device tests (tests/test_torch_online_sgd.py), whose step the
ranks run.

The one difference is the example count ``t`` after a sync (ROADMAP
queue C): the JAX package sets it to the sum of the ranks' counts,
each of which already holds the previous total, so it doubles at every
sync on two ranks; the port keeps the examples seen.  ``t`` weighs each
rank in the next average, so after two syncs the averages agree only
where the ranks' examples since the last one weigh the same: "sync4"
takes 1,024 rows of weight 1 (no pad rows) for that reason, and
"many_syncs" (140 syncs)
shows the JAX package's count overflowing to inf and its state turning
NaN where the port's stays finite.
"""

import numpy as np
import pytest

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.models.online import OnlineSGDClassifier as JClf
from synapseml_tpu.models.online import sgd as jsgd
from synapseml_tpu.parallel import data_parallel_mesh as jmesh
from synapseml_tpu_torch.parallel import run_on_local_cluster
from torch_gang_tasks import ONLINE_FITS, online_data
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

#: the gang's own limit, far below pytest's faulthandler_timeout
GANG_TIMEOUT_S = 120.0
TOL = 1e-5


@pytest.fixture(scope="module")
def gang():
    return run_on_local_cluster("torch_gang_tasks:online_mesh", 2,
                                task_args={"device": "cpu"}, device="cpu",
                                timeout_s=GANG_TIMEOUT_S)


def _close(got: dict, want) -> None:
    for f in jsgd.SGDState._fields:
        w = np.asarray(getattr(want, f))
        scale = max(1.0, float(np.max(np.abs(w))))
        np.testing.assert_allclose(np.asarray(got[f], np.float32), w, rtol=0,
                                   atol=TOL * scale, err_msg=f)


@pytest.mark.parametrize("name", list(ONLINE_FITS) + ["estimator"])
def test_ranks_hold_one_state(gang, name):
    assert gang[0][name] == gang[1][name]


@pytest.mark.parametrize("name", ["sync0", "sync1", "sync4"])
def test_mesh_state_matches_jax(gang, name):
    kw, n, weighted = ONLINE_FITS[name]
    x, y, sw = online_data(n)
    sw = sw if weighted else np.ones(n, np.float32)
    want, stats = jsgd.train_sgd(x, y, jsgd.SGDConfig(**kw),
                                 sample_weight=sw, mesh=jmesh(2))
    got = gang[0][name]
    passes = kw.get("num_passes", 1)
    seen = np.float32(sw.sum()) * passes
    assert got["state"]["t"] == pytest.approx(seen, rel=1e-6)
    assert got["stats"]["examples"] == got["state"]["t"]
    # the JAX package's count: the examples seen after one sync, more
    # after more
    k = kw["sync_every_batches"]
    syncs = passes * (1 if k <= 1 else n // 2 // kw["batch_size"] // k)
    assert (float(want.t) == pytest.approx(seen, rel=1e-6)) == (syncs == 1)
    _close({**got["state"], "t": float(want.t)}, want)
    assert got["stats"]["average_loss"] == pytest.approx(
        stats["average_loss"], rel=1e-5)


def test_many_syncs_keep_the_count_where_jax_overflows(gang):
    """140 syncs a pass on two ranks: the JAX package's count passes
    f32's range near the 128th and its state turns NaN; the port's
    count is the examples' weight and its state finite."""
    kw, n, _ = ONLINE_FITS["many_syncs"]
    x, y, sw = online_data(n)
    want, _ = jsgd.train_sgd(x, y, jsgd.SGDConfig(**kw), sample_weight=sw,
                             mesh=jmesh(2))
    assert not np.isfinite(float(want.t))
    assert np.isnan(np.asarray(want.w)).all()
    got = gang[0]["many_syncs"]["state"]
    assert got["t"] == pytest.approx(float(sw.sum()), rel=1e-6)
    assert all(np.isfinite(np.asarray(got[f])).all() for f in got)


def test_classifier_over_the_mesh_matches_jax(gang):
    x, y, _ = online_data()
    ds = JDataset({"features": list(x), "label": (y > 0).astype(np.float32)})
    m = JClf(mesh=jmesh(2), batchSize=16).fit(ds)
    _close(gang[0]["estimator"], m.state)
