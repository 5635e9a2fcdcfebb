"""The port's exact KNN (``synapseml_tpu_torch.nn``) against the JAX
package's on the CPU.

The index holds deliberate ties: every point appears twice, some queries
are index points, and a block of rows sits on a lattice where many
distances are equal.  Both packages keep, among equal distances, the
lower index first (``lax.top_k`` on the negated distance; a stable sort
in the port).  Tolerances: matched values (the indices) equal, distances
within 1e-6 relative (reading: <= 2e-16, both refine the winners in
float64 from float32 differences).
"""

import numpy as np
import pytest
import torch

import synapseml_tpu.nn as JN
import synapseml_tpu_torch.nn as TN
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu_torch.core import Dataset as TDataset
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _data(seed=0, n=150, d=6):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n // 2, d)).astype(np.float32)
    lattice = np.round(rng.uniform(-2, 2, (n // 4, d))).astype(np.float32)
    index = np.concatenate([base, base, lattice])        # duplicates
    queries = np.concatenate([index[::7], np.round(
        rng.uniform(-2, 2, (12, d))).astype(np.float32)])
    labels = np.array(["red", "green", "blue"], dtype=object)[
        np.arange(len(index)) % 3]
    return index, queries, labels


def _matches(out):
    return [[(m["value"], m["distance"], m.get("label")) for m in row]
            for row in out["output"]]


def _compare(want, got):
    assert len(want) == len(got)
    for w_row, g_row in zip(want, got):
        assert [m[0] for m in g_row] == [m[0] for m in w_row]
        assert [m[2] for m in g_row] == [m[2] for m in w_row]
        np.testing.assert_allclose([m[1] for m in g_row],
                                   [m[1] for m in w_row], rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("k,leaf", [(5, 16), (12, 1024), (40, 33)])
def test_knn_matches_jax_with_ties(k, leaf):
    index, queries, _ = _data()
    vals = np.arange(len(index)) * 10
    outs = []
    for N, D, kw in ((JN, JDataset, {}), (TN, TDataset, {"device": "cpu"})):
        m = N.KNN(k=k, leafSize=leaf, **kw).fit(
            D({"features": list(index), "values": vals}))
        outs.append(_matches(m.transform(D({"features": list(queries)}))))
    _compare(*outs)
    # query 0 is index row 0, whose duplicate is row 75: both at 0, in
    # index order
    assert [m[:2] for m in outs[1][0][:2]] == [(0, 0.0), (750, 0.0)]


@pytest.mark.parametrize("leaf", [8, 64])
def test_conditional_knn_matches_jax(leaf):
    index, queries, labels = _data(1)
    rng = np.random.default_rng(3)
    cond = [list(rng.choice(["red", "green", "blue", "none"], size=c,
                            replace=False))
            for c in rng.integers(1, 3, len(queries))]
    cond[0] = ["none"]                       # no eligible row at all
    outs = []
    for N, D, kw in ((JN, JDataset, {}), (TN, TDataset, {"device": "cpu"})):
        m = N.ConditionalKNN(k=6, leafSize=leaf, **kw).fit(
            D({"features": list(index), "labels": labels}))
        q = D({"features": list(queries), "conditioner": cond})
        outs.append(_matches(m.transform(q)))
    _compare(*outs)
    assert outs[1][0] == []


def test_ball_tree_matches_jax():
    index, queries, _ = _data(2)
    jt = JN.BallTree(index, tile=32)
    tt = TN.BallTree(index, tile=32, device="cpu")
    jd, ji = jt.query(queries, k=7)
    td, ti = tt.query(queries, k=7)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-12)
    assert tt.query_point(index[3], k=2) == [
        (v, pytest.approx(d, rel=1e-6, abs=1e-12))
        for v, d in jt.query_point(index[3], k=2)]


def test_scan_merge_keeps_lower_index_among_ties():
    """The running merge on its own: all-equal distances keep the first
    k indices in index order, across tiles."""
    from synapseml_tpu_torch.nn.knn import _topk_scan
    x = torch.ones((50, 3))
    q = torch.zeros((2, 3))
    d, i = _topk_scan(q, x, 7, 8)
    assert i.tolist() == [list(range(7))] * 2
    assert torch.all(d == 3.0)


def test_knn_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.KNN().fit(TDataset({"features": [np.zeros(2, np.float32)]}))
