"""The port's PowerBI sink and model downloader against the JAX
package's, on the CPU.

Each test runs the same call in both packages against one recording
mock server (``torch_service_mocks``): the recorded requests (method,
path, query, body bytes, headers other than ``User-Agent``) must be
equal, and so must what the call returns or raises.  Then it checks what
the JAX package's own test (``tests/test_io_files.py``) checks, on the
port.  No test leaves 127.0.0.1.
"""

import hashlib
import json
import os
from dataclasses import asdict

import numpy as np
import pytest

import synapseml_tpu as jx
import synapseml_tpu.downloader as jx_dl
import synapseml_tpu.io as jx_io
import synapseml_tpu_torch as pt
import synapseml_tpu_torch.downloader as pt_dl
import synapseml_tpu_torch.io as pt_io
from torch_service_mocks import MockServices, canonical

PACKAGES = {"jax": (jx, jx_io, jx_dl), "torch": (pt, pt_io, pt_dl)}


@pytest.fixture(scope="module")
def mock():
    m = MockServices()
    yield m
    m.close()


def write_both(mock, cols, options=None, path="/push"):
    """``PowerBIWriter.write`` in each package → (the port's batches, its
    requests, the exception each raised).  Posts may arrive in any order
    when ``concurrency`` > 1, so both sides are compared sorted."""
    batches, reqs, errs = {}, {}, {}
    for name, (pkg, io, _) in PACKAGES.items():
        mock.take()
        mock.pbi_batches.clear()
        try:
            io.PowerBIWriter.write(pkg.Dataset(dict(cols)), mock.url + path,
                                   options)
            errs[name] = None
        except Exception as e:               # compared across packages
            errs[name] = (type(e).__name__, str(e),
                          getattr(e, "status_code", None))
        batches[name] = sorted(mock.pbi_batches, key=json.dumps)
        reqs[name] = canonical(mock.take())
    assert reqs["jax"] == reqs["torch"]
    assert batches["jax"] == batches["torch"]
    assert errs["jax"] == errs["torch"]
    return batches["torch"], reqs["torch"], errs["torch"]


class TestPowerBIWriter:
    def test_fixed_batches(self, mock):
        mock.pbi_fail = False
        batches, reqs, err = write_both(
            mock, {"x": np.arange(5), "label": np.array(list("abcde"))},
            {"batchSize": "2"})
        assert err is None
        assert sorted(len(b) for b in batches) == [1, 2, 2]
        rows = [r for b in batches for r in b]
        assert {r["label"] for r in rows} == set("abcde")
        assert all(isinstance(r["x"], int) for r in rows)
        assert all(r["headers"]["Content-Type"] == "application/json"
                   for r in reqs)

    def test_error_raises(self, mock):
        mock.pbi_fail = True
        try:
            _, _, err = write_both(mock, {"x": np.arange(2)})
        finally:
            mock.pbi_fail = False
        assert err[0] == "PowerBIResponseError" and err[2] == 400
        with pytest.raises(pt_io.PowerBIResponseError):
            mock.pbi_fail = True
            try:
                pt_io.PowerBIWriter.write(pt.Dataset({"x": np.arange(2)}),
                                          mock.url + "/push")
            finally:
                mock.pbi_fail = False

    def test_unknown_option_rejected(self, mock):
        _, reqs, err = write_both(mock, {"x": np.arange(2)}, {"bogus": "1"})
        assert err[0] == "ValueError" and "not applicable" in err[1]
        assert reqs == []

    def test_seeded_rows_every_row_once(self, mock):
        """Float, int and string columns from a seed, 4 posts at once: the
        sink gets each row once, with equal values."""
        rng = np.random.default_rng(26)
        n = 257
        cols = {"id": np.arange(n), "p": rng.random(n),
                "f32": rng.normal(size=n).astype(np.float32),
                "tag": rng.choice(np.array(["a", "b", "c"]), n)}
        batches, _, err = write_both(
            mock, cols, {"batchSize": "50", "concurrency": "4"})
        assert err is None
        rows = sorted((r for b in batches for r in b),
                      key=lambda r: r["id"])
        assert [r["id"] for r in rows] == list(range(n))
        assert [r["p"] for r in rows] == cols["p"].tolist()
        assert [r["f32"] for r in rows] == cols["f32"].tolist()
        assert [r["tag"] for r in rows] == cols["tag"].tolist()

    def test_dynamic_minibatcher_follows_partitions(self, mock):
        def cols():
            return {"x": np.arange(10)}
        sizes = {}
        for name, (pkg, io, _) in PACKAGES.items():
            ds = pkg.Dataset(cols()).repartition(3)
            mock.take()
            mock.pbi_batches.clear()
            io.PowerBIWriter.write(ds, mock.url + "/push",
                                   {"minibatcher": "dynamic",
                                    "maxBatchSize": "3"})
            sizes[name] = [len(b) for b in mock.pbi_batches]
        assert sizes["jax"] == sizes["torch"]
        assert sum(sizes["torch"]) == 10 and max(sizes["torch"]) <= 3


class TestModelDownloader:
    def _serve(self, mock, files: dict) -> str:
        mock.files.clear()
        mock.files.update(files)
        return mock.url + "/files"

    def _both(self, mock, tmp_path, fn):
        """``fn(downloader_module, cache_dir, name)`` in each package with
        its own cache → (results, port's requests)."""
        out, reqs = {}, {}
        for name, (_, _, dl) in PACKAGES.items():
            mock.take()
            try:
                out[name] = fn(dl, str(tmp_path / f"cache_{name}"), name)
            except Exception as e:           # compared across packages
                out[name] = (type(e).__name__, str(e))
            reqs[name] = mock.take()
        assert reqs["jax"] == reqs["torch"]
        return out, reqs["torch"]

    def test_download_verify_and_cache(self, mock, tmp_path):
        blob = b"MODELBYTES" * 100
        url = self._serve(mock, {
            "resnet.onnx": blob,
            "manifest.json": json.dumps([{
                "name": "ResNet50", "uri": "resnet.onnx",
                "hash": hashlib.sha256(blob).hexdigest(),
                "size": len(blob)}]).encode()})

        def fn(dl, cache, _):
            d = dl.ModelDownloader(cache, url)
            remote = [m.name for m in d.remoteModels()]
            got = d.downloadByName("ResNet50")
            local = list(dl.ModelDownloader(cache).localModels())
            return (remote, open(got.uri, "rb").read(),
                    os.path.basename(got.uri),
                    [asdict(m) for m in local])
        out, reqs = self._both(mock, tmp_path, fn)
        assert out["jax"] == out["torch"]
        remote, data, base, local = out["torch"]
        assert remote == ["ResNet50"] and data == blob
        assert base == "resnet.onnx"
        assert [m["name"] for m in local] == ["ResNet50"]
        assert [r["path"] for r in reqs] == ["/files/manifest.json"] * 2 + \
            ["/files/resnet.onnx"]

    def test_hash_mismatch_rejected(self, mock, tmp_path):
        url = self._serve(mock, {
            "m.bin": b"evil",
            "manifest.json": json.dumps(
                [{"name": "m", "uri": "m.bin", "hash": "0" * 64}]).encode()})

        def fn(dl, cache, _):
            dl.ModelDownloader(cache, url).downloadByName("m")
        out, _ = self._both(mock, tmp_path, fn)
        assert out["jax"] == out["torch"]
        assert out["torch"][0] == "ValueError"
        assert "hash mismatch" in out["torch"][1]
        assert not os.path.exists(tmp_path / "cache_torch" / "m.bin")

    def test_download_models_and_cache_hit(self, mock, tmp_path):
        """``downloadModels`` fetches every manifest entry; a second call
        finds the verified files in the cache and fetches only the
        manifest."""
        blobs = {f"m{i}.bin": bytes([i]) * (100 + i) for i in range(3)}
        url = self._serve(mock, {**blobs, "manifest.json": json.dumps([
            {"name": k[:-4], "uri": k,
             "hash": hashlib.sha256(v).hexdigest(), "size": len(v)}
            for k, v in blobs.items()]).encode()})

        def fn(dl, cache, _):
            d = dl.ModelDownloader(cache, url)
            first = [os.path.basename(m.uri) for m in d.downloadModels()]
            second = [os.path.basename(m.uri) for m in d.downloadModels()]
            return first, second
        out, reqs = self._both(mock, tmp_path, fn)
        assert out["jax"] == out["torch"]
        assert out["torch"][0] == out["torch"][1] == sorted(blobs)
        assert [r["path"] for r in reqs].count("/files/manifest.json") == 2
        assert len(reqs) == 2 + len(blobs)

    def test_local_directory_server(self, tmp_path):
        """``server_url`` as a local directory: no HTTP at all."""
        src = tmp_path / "srv"
        src.mkdir()
        (src / "w.bin").write_bytes(b"weights")
        (src / "manifest.json").write_text(json.dumps([{
            "name": "w", "uri": "w.bin",
            "hash": hashlib.sha256(b"weights").hexdigest()}]))
        got = pt_dl.ModelDownloader(str(tmp_path / "c"),
                                    str(src)).downloadByName("w")
        assert open(got.uri, "rb").read() == b"weights"
        assert repr(got).startswith("ModelSchema<name: w")
