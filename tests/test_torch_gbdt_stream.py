"""Streamed ingestion in the port held against the JAX package on the
CPU: the SMLC/SMLS readers and writers, streamed fits against the JAX
package's streamed fits and against the port's own in-memory fits, warm
starts from a source, and the host memory of a streamed fit.

A streamed fit bins with a mapper fit on ``sample_rows`` (the in-memory
fit's draw) and writes each chunk's bins straight into its columns of
the device matrix, so it grows the in-memory fit's trees exactly on
numeric data.  Against the JAX package the fits agree to the histogram
quantization: every tree splits on the same features at the same bins
or at a tied bin of the same partition (:func:`_same_splits`), and
margins agree within 1e-4.
"""

import os
import tracemalloc

import numpy as np
import pytest

from synapseml_tpu.io import colstore as jcs
from synapseml_tpu.models.gbdt import BoostingConfig as JConfig
from synapseml_tpu.models.gbdt import train as jtrain
from synapseml_tpu_torch.io import colstore as tcs
from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig
from synapseml_tpu_torch.models.gbdt.booster import train as ttrain
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _dense(n=3000, F=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[::31, 5] = np.nan
    y = (2 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return X, y, w


def _onehot(n=3000, seed=1):
    """Four dense columns and 4 one-hot blocks of 8 levels (sparse)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    c = rng.integers(0, 8, (n, 4))
    oh = np.zeros((n, 32), np.float32)
    oh[np.arange(n)[:, None], np.arange(4) * 8 + c] = 1.0
    y = (dense[:, 0] + (c[:, 0] < 3) - (c[:, 1] == 2) * 1.5
         + rng.normal(scale=0.5, size=n) > 0.3).astype(np.float32)
    return np.concatenate([dense, oh], axis=1), y


def _categorical(n=3000, seed=2):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 12, n)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    y = (np.isin(c, [0, 3, 5, 7, 10]) * 2.0 + dense[:, 0]
         + rng.normal(scale=0.5, size=n) > 1.0).astype(np.float32)
    return np.column_stack([c.astype(np.float32), dense]), y


def _write(tmp_path, kind, X, y, w=None, module=tcs):
    """A store of ``kind`` written by ``module`` (port or JAX): the
    features, then the label (and weight) column; CSR carries them."""
    if kind == "csr":
        p = str(tmp_path / f"{module.__name__.split('.')[0]}.smls")
        module.write_csr(p, *module.dense_to_csr(X), X.shape[1], labels=y,
                         weights=w)
        return p
    p = str(tmp_path / f"{module.__name__.split('.')[0]}_{kind}.smlc")
    cols = [X, y[:, None]] + ([w[:, None]] if w is not None else [])
    module.write_matrix(p, np.concatenate(cols, axis=1), dtype=kind)
    return p


def _source(module, kind, path, F, weighted, chunk_rows):
    if kind == "csr":
        return module.SparseChunkedSource(path, chunk_rows=chunk_rows)
    return module.ChunkedColumnSource(
        path, label_col=F, weight_col=F + 1 if weighted else None,
        chunk_rows=chunk_rows)


@pytest.mark.parametrize("kind", ["f32", "bf16", "csr"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reader_reads_the_other_package_chunk_for_chunk(tmp_path, kind,
                                                        writer):
    """Each package's reader reads a store written by either package:
    chunks, labels, weights, samples and shards equal, and the writers'
    bytes equal."""
    X, y, w = _dense(n=1000)
    pj = _write(tmp_path, kind, X, y, w, jcs)
    pt = _write(tmp_path, kind, X, y, w, tcs)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    path = pj if writer == "jax" else pt
    F = X.shape[1]
    srcs = [_source(m, kind, path, F, True, 333) for m in (tcs, jcs)]
    for (xa, ya, wa), (xb, yb, wb) in zip(srcs[0].iter_chunks(),
                                          srcs[1].iter_chunks()):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(wa, wb)
    assert len(list(srcs[0].iter_chunks())) == 4
    for fn in ("read_labels", "read_weights"):
        np.testing.assert_array_equal(getattr(srcs[0], fn)(),
                                      getattr(srcs[1], fn)())
    np.testing.assert_array_equal(srcs[0].sample_rows(100, 3),
                                  srcs[1].sample_rows(100, 3))
    a, b = srcs[0].shard(1, 3), srcs[1].shard(1, 3)
    assert (a.num_rows, a.num_features) == (b.num_rows, b.num_features)
    np.testing.assert_array_equal(next(a.iter_chunks())[0],
                                  next(b.iter_chunks())[0])


def test_csv_to_colstore_names_a6(tmp_path):
    """ROADMAP A6's ``csv_to_colstore`` (no longer refused): a CSV becomes
    the same SMLC bytes as the JAX package's, and streams back equal."""
    X = np.random.default_rng(4).normal(size=(300, 5)).astype(np.float32)
    csv = tmp_path / "x.csv"
    np.savetxt(csv, X, delimiter=",", fmt="%.9g",
               header="a,b,c,d,e", comments="")
    t, j = str(tmp_path / "t.smlc"), str(tmp_path / "j.smlc")
    assert tcs.csv_to_colstore(str(csv), t) == (300, list("abcde"))
    jcs.csv_to_colstore(str(csv), j)
    assert open(t, "rb").read() == open(j, "rb").read()
    src = tcs.ChunkedColumnSource(t, label_col=4, chunk_rows=77)
    np.testing.assert_array_equal(
        np.concatenate([c[0] for c in src.iter_chunks()]), X[:, :4])
    np.testing.assert_array_equal(src.read_labels(), X[:, 4])


def _node_rows(tree, bins):
    """Each node's training rows (bool (M, n)), routed in bin space."""
    n = len(bins)
    node = np.zeros(n, np.int64)
    out = np.zeros((len(tree.split_feature), n), bool)
    for _ in range(len(tree.split_feature)):
        out[node, np.arange(n)] = True
        f = tree.split_feature[node]
        go = bins[np.arange(n), np.maximum(f, 0)] <= tree.split_bin[node]
        node = np.where(f < 0, node,
                        np.where(go, tree.left_child[node],
                                 tree.right_child[node]))
    return out


def _same_splits(tb, jb, X):
    """Split features and children equal node for node; split bins equal
    too, or else two thresholds of one partition: no training row of
    the node has a bin between them.  Such bins are gain ties (empty
    bins in between), and the two packages add the histograms' f32
    prefix sums over different values (f32 scatter sums against int8
    limb sums), so the last bit picks among them."""
    assert tb.num_trees == jb.num_trees
    bins = tb.bin_mapper.transform(X)
    for ta, tj in zip(tb.trees, jb.trees):
        n = int(tj.num_nodes)
        assert int(ta.num_nodes) == n
        for f in ("split_feature", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(ta, f)[:n],
                                          np.asarray(getattr(tj, f))[:n],
                                          err_msg=f)
        jbin = np.asarray(tj.split_bin)[:n]
        rows = _node_rows(ta, bins)
        for k in np.nonzero(ta.split_bin[:n] != jbin)[0]:
            lo, hi = sorted((int(ta.split_bin[k]), int(jbin[k])))
            xb = bins[rows[k], ta.split_feature[k]]
            assert not np.any((xb > lo) & (xb <= hi)), (k, lo, hi)


CASES = {
    "dense": dict(objective="binary"),
    "sparse_efb": dict(objective="binary", enable_bundle=True),
    "categorical": dict(objective="binary", categorical_feature=[0]),
}


def _case(tmp_path, case, module):
    if case == "dense":
        X, y, _ = _dense()
        path = _write(tmp_path, "f32", X, y, None, module)
        src = module.ChunkedColumnSource(path, label_col=X.shape[1],
                                         chunk_rows=777)
    elif case == "sparse_efb":
        X, y = _onehot()
        path = _write(tmp_path, "csr", X, y, None, module)
        src = module.SparseChunkedSource(path, chunk_rows=700)
    else:
        X, y = _categorical()
        path = _write(tmp_path, "f32", X, y, None, module)
        src = module.ChunkedColumnSource(path, label_col=X.shape[1],
                                         chunk_rows=1000)
    return X, y, src


KW = dict(num_iterations=4, num_leaves=15, min_data_in_leaf=5,
          bin_sample_count=2000)


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_fit_matches_jax_streamed_fit(tmp_path, case):
    """The same file streamed through both packages: split features and
    bins equal tree for tree, margins within 1e-4."""
    X, _, src_t = _case(tmp_path, case, tcs)
    _, _, src_j = _case(tmp_path, case, jcs)
    tb, _ = ttrain(src_t, None, BoostingConfig(**KW, **CASES[case]),
                   device="cpu")
    jb, _ = jtrain(src_j, None, JConfig(**KW, **CASES[case]))
    _same_splits(tb, jb, X)
    np.testing.assert_allclose(tb.predict_margin(X, device="cpu"),
                               jb.predict_margin(X), rtol=0, atol=1e-4)
    if case == "sparse_efb":
        assert tb.bundler.num_bundles == jb.bundler.num_bundles < X.shape[1]
        np.testing.assert_array_equal(tb.bundler.bundle_of,
                                      jb.bundler.bundle_of)
    if case == "categorical":
        # streamed categorical bins are ordered by value, as in the JAX
        # package (the sample carries no labels)
        vals, bins = tb.bin_mapper.cat_features[0]
        np.testing.assert_array_equal(bins, np.arange(1, len(vals) + 1))


@pytest.mark.parametrize("case", ["dense", "weighted", "sparse_efb",
                                  "lambdarank"])
def test_streamed_fit_equals_in_memory_fit(tmp_path, case):
    """tests/test_colstore_streaming.py's property on the port: a
    streamed fit grows the in-memory fit's trees, margins equal."""
    kw = dict(KW)
    group = None
    if case == "sparse_efb":
        X, y = _onehot()
        w = None
        src = tcs.SparseChunkedSource(_write(tmp_path, "csr", X, y),
                                      chunk_rows=999)
        kw["enable_bundle"] = True
    else:
        X, y, w = _dense()
        if case != "weighted":
            w = None
        src = tcs.ChunkedColumnSource(_write(tmp_path, "f32", X, y, w),
                                      label_col=X.shape[1],
                                      weight_col=(X.shape[1] + 1
                                                  if w is not None else None),
                                      chunk_rows=513)
        if case == "lambdarank":
            group = np.full(len(X) // 20, 20)
            y = np.digitize(X[:, 0] + X[:, 1], [-1, 0, 1]).astype(np.float32)
            src = tcs.ChunkedColumnSource(_write(tmp_path, "f32", X, y),
                                          label_col=X.shape[1],
                                          chunk_rows=513)
            kw["objective"] = "lambdarank"
    kw.setdefault("objective", "binary")
    streamed, _ = ttrain(src, None, BoostingConfig(**kw), group=group,
                         device="cpu")
    mem, _ = ttrain(X, y, BoostingConfig(**kw), sample_weight=w,
                    group=group, device="cpu")
    for a, b in zip(streamed.trees, mem.trees):
        for f in ("split_feature", "split_bin", "leaf_value"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(streamed.predict_margin(X, device="cpu"),
                                  mem.predict_margin(X, device="cpu"))


def test_warm_start_from_a_source(tmp_path):
    """``init_model`` with a source replays the carried margin chunk by
    chunk: the continued fit equals the in-memory continued fit."""
    X, y, _ = _dense()
    src = tcs.ChunkedColumnSource(_write(tmp_path, "f32", X, y),
                                  label_col=X.shape[1], chunk_rows=600)
    cfg = BoostingConfig(objective="binary", **{**KW, "num_iterations": 3})
    first, _ = ttrain(X, y, cfg, device="cpu")
    s, _ = ttrain(src, None, cfg, init_model=first, device="cpu")
    m, _ = ttrain(X, y, cfg, init_model=first, device="cpu")
    assert s.num_trees == m.num_trees == 6
    for a, b in zip(s.trees, m.trees):
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    np.testing.assert_array_equal(s.predict_margin(X, device="cpu"),
                                  m.predict_margin(X, device="cpu"))


def test_source_without_labels_needs_y(tmp_path):
    X, y, _ = _dense(n=200)
    p = str(tmp_path / "x.smlc")
    tcs.write_matrix(p, X)
    with pytest.raises(ValueError, match="label_col"):
        ttrain(tcs.ChunkedColumnSource(p), None, BoostingConfig(),
               device="cpu")
    b, _ = ttrain(tcs.ChunkedColumnSource(p), y,
                  BoostingConfig(objective="binary", num_iterations=1),
                  device="cpu")
    assert b.num_trees == 1


def test_streamed_fit_host_memory_is_o_chunk(tmp_path):
    """The traced host allocations of a streamed fit stay below a
    quarter of the raw feature bytes: O(chunk + sample) plus the label
    and score vectors; the matrix exists only binned, on the device."""
    rng = np.random.default_rng(4)
    n, F = 40_000, 100
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=n) > 0).astype(np.float32)
    p = str(tmp_path / "big.smlc")
    tcs.write_matrix(p, np.concatenate([X, y[:, None]], axis=1))
    raw = X.nbytes
    del X
    src = tcs.ChunkedColumnSource(p, label_col=F, chunk_rows=2048)
    tracemalloc.start()
    try:
        b, _ = ttrain(src, None, BoostingConfig(
            objective="binary", num_iterations=2, num_leaves=7,
            bin_sample_count=2000), device="cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert b.num_trees == 2
    assert peak < raw / 4, (peak, raw)
    os.remove(p)
