"""The port's CSV ingest against the JAX package's on the same files:
``Dataset.from_csv`` strict (the native multithreaded parser, and its
``numpy.genfromtxt`` fallback) and permissive (skip / quarantine with
line numbers), permissive ``Dataset.from_rows``, and
``io.colstore.csv_to_colstore``, whose files must be byte-equal."""

import numpy as np
import pytest

import synapseml_tpu.io.colstore as jcs
from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.resilience.rowguard import Quarantine as JQuarantine
import synapseml_tpu_torch.io.colstore as tcs
from synapseml_tpu_torch import native
from synapseml_tpu_torch.core.dataset import Dataset as TDataset
from synapseml_tpu_torch.resilience.rowguard import Quarantine as TQuarantine
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

#: name → file text: header or none, duplicate names, empty fields,
#: ragged lines, unparseable fields, an all-NaN column, CRLF endings,
#: blank lines, scientific notation and spaces around fields
FILES = {
    "header": "a,b,c\n1,2,3\n4.5,-6,7e-3\n",
    "no_header": "1,2,3\n4,5,6\n7,8,9\n",
    "duplicate_names": "x,x,y,x\n1,2,3,4\n5,6,7,8\n",
    "empty_fields": "a,b,c\n1,,3\n,5,\n7,8,9\n",
    "ragged": "a,b,c\n1,2,3\n4,5\n6,7,8,9\n10,11,12\n",
    "unparseable": "a,b\n1,2\noops,4\n5,6\n",
    "all_nan_column": "a,b\n1,\n2,\n3,\n",
    "crlf_blank_lines": "a,b\r\n1,2\r\n\r\n3,4\r\n\n5,6\r\n",
    "spaces_scientific": "a, b\n 1.5e2 , -2E-3\n\t3 ,4\n",
}


def _write(tmp_path, name):
    p = tmp_path / f"{name}.csv"
    p.write_text(FILES[name])
    return str(p)


def _same(jds, tds):
    assert tds.columns == jds.columns
    for c in jds.columns:
        assert tds[c].dtype == jds[c].dtype == np.float32, c
        np.testing.assert_array_equal(tds[c], jds[c], err_msg=c)
    np.testing.assert_array_equal(tds.source_index, jds.source_index)


@pytest.mark.parametrize("name", sorted(FILES))
def test_strict_from_csv_equals_reference(tmp_path, name):
    path = _write(tmp_path, name)
    before = native.CSV_PARSES["native"]
    _same(JDataset.from_csv(path), TDataset.from_csv(path))
    assert native.CSV_PARSES["native"] == before + 1


@pytest.mark.parametrize("name", ["header", "no_header", "duplicate_names",
                                  "empty_fields", "unparseable",
                                  "all_nan_column"])
def test_genfromtxt_fallback_gives_the_same_matrix(tmp_path, name,
                                                   monkeypatch):
    path = _write(tmp_path, name)
    want = TDataset.from_csv(path)
    monkeypatch.setattr(native, "_loader", lambda: None)
    before = native.CSV_PARSES["genfromtxt"]
    _same(want, TDataset.from_csv(path))
    assert native.CSV_PARSES["genfromtxt"] == before + 1


@pytest.mark.parametrize("mode", ["skip", "quarantine"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_permissive_from_csv_equals_reference(tmp_path, name, mode):
    path = _write(tmp_path, name)
    got = {}
    for pkg, D, Q in (("jax", JDataset, JQuarantine),
                      ("torch", TDataset, TQuarantine)):
        store = Q(str(tmp_path / f"q_{pkg}"))
        try:
            ds = D.from_csv(path, handle_invalid=mode, quarantine=store)
        except ValueError as e:
            got[pkg] = ("ValueError", str(e).replace(path, "<path>"))
            continue
        raw = store.rows("Dataset.from_csv")
        got[pkg] = (ds, None if raw is None else
                    (list(raw["raw"]), raw.source_index.tolist(),
                     sorted((r.row_index, r.error_message) for r in
                            store.records("Dataset.from_csv"))))
    if isinstance(got["jax"][0], str):
        assert got["torch"] == got["jax"]
        return
    _same(got["jax"][0], got["torch"][0])
    if mode == "quarantine":
        assert got["torch"][1] == got["jax"][1]


def test_all_nan_column_is_reported(tmp_path, caplog):
    import logging
    path = _write(tmp_path, "all_nan_column")
    with caplog.at_level(logging.WARNING, logger="synapseml_tpu_torch"):
        ds = TDataset.from_csv(path, handle_invalid="skip")
    assert ds.num_rows == 3
    assert "all-NaN" in caplog.text and "'b'" in caplog.text


def test_large_file_round_trips_float32_exactly(tmp_path):
    """Many rows over every parser thread, written with 9 significant
    digits (enough for any float32): the parse gives the matrix back bit
    for bit, and equals the JAX package's parse."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(20_003, 6)).astype(np.float32)
    X[::97, 2] *= 1e-30
    X[::89, 4] *= 1e30
    path = str(tmp_path / "big.csv")
    np.savetxt(path, X, delimiter=",", fmt="%.9g",
               header=",".join(f"f{j}" for j in range(6)), comments="")
    mat, names = native.read_csv_matrix(path, n_threads=5)
    assert names == [f"f{j}" for j in range(6)]
    np.testing.assert_array_equal(mat, X)
    _same(JDataset.from_csv(path), TDataset.from_csv(path))


@pytest.mark.parametrize("name", ["header", "no_header", "duplicate_names",
                                  "empty_fields", "ragged",
                                  "crlf_blank_lines"])
def test_csv_to_colstore_byte_equal(tmp_path, name):
    path = _write(tmp_path, name)
    jp, tp = str(tmp_path / "j.smlc"), str(tmp_path / "t.smlc")
    assert tcs.csv_to_colstore(path, tp) == jcs.csv_to_colstore(path, jp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    mat = tcs.read_matrix(tp)
    np.testing.assert_array_equal(mat, native.read_csv_matrix(path)[0])
    src = tcs.ChunkedColumnSource(tp, chunk_rows=2)
    np.testing.assert_array_equal(
        np.concatenate([c[0] for c in src.iter_chunks()]), mat)


@pytest.mark.parametrize("rows", [
    [{"x": 1, "y": 2}, {"x": 3}, {"x": 4, "y": 5, "z": 6}, {"x": 7, "y": 8}],
    [None, {"x": 1.0}, "junk", {"x": 2.0}],
    [{"a": [1, 2]}, {"b": 1}, {"a": [3]}],
])
@pytest.mark.parametrize("mode", ["skip", "quarantine"])
def test_permissive_from_rows_equals_reference(tmp_path, rows, mode):
    outs = {}
    for pkg, D, Q in (("jax", JDataset, JQuarantine),
                      ("torch", TDataset, TQuarantine)):
        store = Q(str(tmp_path / pkg))
        ds = D.from_rows(rows, handle_invalid=mode, quarantine=store)
        raw = store.rows("Dataset.from_rows")
        outs[pkg] = (ds.columns, [list(map(repr, ds[c])) for c in ds.columns],
                     ds.source_index.tolist(),
                     None if raw is None else (list(raw["raw"]),
                                               raw.source_index.tolist()))
    assert outs["torch"] == outs["jax"]
    if mode == "skip":
        assert outs["torch"][3] is None
