"""The port's binary and image file readers (``io/binary.py``,
``io/image.py``) under the contracts ``tests/test_io_files.py`` holds the
JAX package's to, and each read equal to the JAX package's (paths, bytes,
decoded pixels and schema columns exactly)."""

import os
import zipfile

import numpy as np
import pytest

from synapseml_tpu.io import BinaryFileReader as JReader
from synapseml_tpu.io import read_images as j_read_images
from synapseml_tpu_torch.io import (BinaryFileReader, decode_image,
                                    read_binary_files, read_images)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


@pytest.fixture()
def file_tree(tmp_path):
    (tmp_path / "a.bin").write_bytes(b"alpha")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "b.bin").write_bytes(b"beta")
    with zipfile.ZipFile(tmp_path / "c.zip", "w") as zf:
        zf.writestr("inner/x.txt", b"xray")
        zf.writestr("y.txt", b"yankee")
    return tmp_path


@pytest.fixture()
def image_dir(tmp_path):
    from PIL import Image
    rgb = np.zeros((4, 6, 3), np.uint8)
    rgb[..., 0] = 255  # pure red
    Image.fromarray(rgb).save(tmp_path / "red.png")
    Image.fromarray(np.uint8(np.arange(16).reshape(4, 4) * 15),
                    mode="L").save(tmp_path / "gray.png")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (5, 7, 4), dtype=np.uint8),
                    mode="RGBA").save(tmp_path / "noise.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
        tmp_path / "photo.jpg", quality=90)
    (tmp_path / "junk.jpg").write_bytes(b"not an image")
    (tmp_path / "notes.txt").write_bytes(b"skipped: not an image name")
    return tmp_path


class TestBinaryFileReader:
    def test_flat_read(self, file_tree):
        ds = BinaryFileReader.read(str(file_tree), inspect_zip=False)
        by_path = {os.path.basename(p): b
                   for p, b in zip(ds["path"], ds["bytes"])}
        assert by_path["a.bin"] == b"alpha"
        assert "b.bin" not in by_path  # not recursive

    def test_recursive_and_zip_inspection(self, file_tree):
        ds = BinaryFileReader.read(str(file_tree), recursive=True)
        paths = [str(p) for p in ds["path"]]
        assert any(p.endswith("sub/b.bin") or p.endswith("sub\\b.bin")
                   for p in paths)
        assert any(p.endswith("c.zip/inner/x.txt") for p in paths)
        blob = dict(zip(paths, ds["bytes"]))
        zp = [p for p in paths if p.endswith("c.zip/y.txt")][0]
        assert blob[zp] == b"yankee"

    def test_subsample_deterministic(self, file_tree):
        a = BinaryFileReader.read(str(file_tree), recursive=True,
                                  sample_ratio=0.5, seed=7)
        b = BinaryFileReader.read(str(file_tree), recursive=True,
                                  sample_ratio=0.5, seed=7)
        assert list(a["path"]) == list(b["path"])
        full = BinaryFileReader.read(str(file_tree), recursive=True)
        assert a.num_rows <= full.num_rows

    def test_module_reader_is_the_class_reader(self, file_tree):
        a = read_binary_files(str(file_tree), recursive=True)
        b = BinaryFileReader.read(str(file_tree), recursive=True)
        assert list(a["path"]) == list(b["path"])
        assert list(a["bytes"]) == list(b["bytes"])


@pytest.mark.parametrize("kw", [
    dict(), dict(recursive=True), dict(recursive=True, inspect_zip=False),
    dict(recursive=True, sample_ratio=0.5, seed=3),
    dict(recursive=True, sample_ratio=0.3, seed=11)])
def test_binary_read_equals_jax(file_tree, kw):
    t = BinaryFileReader.read(str(file_tree), **kw)
    j = JReader.read(str(file_tree), **kw)
    assert t.columns == j.columns
    assert list(t["path"]) == list(j["path"])
    assert list(t["bytes"]) == list(j["bytes"])


class TestReadImages:
    def test_decode_shapes_and_bgr(self, image_dir):
        ds = read_images(str(image_dir))
        assert ds.num_rows == 4  # junk dropped, txt not an image name
        rows = {os.path.basename(str(p)): i
                for i, p in enumerate(ds["path"])}
        i = rows["red.png"]
        assert (ds["height"][i], ds["width"][i],
                ds["nChannels"][i]) == (4, 6, 3)
        # BGR order: red lands in channel 2
        assert ds["data"][i][0, 0, 2] == 255
        assert ds["data"][i][0, 0, 0] == 0
        g = rows["gray.png"]
        assert ds["nChannels"][g] == 1
        assert ds["mode"][g] == 0

    def test_keep_failures(self, tmp_path):
        (tmp_path / "junk.jpg").write_bytes(b"not an image")
        ds = read_images(str(tmp_path), drop_image_failures=False)
        assert ds.num_rows == 1
        assert ds["mode"][0] == -1
        assert ds["data"][0] is None

    def test_decode_rejects_garbage(self):
        assert decode_image(b"\x00\x01garbage") is None


@pytest.mark.parametrize("drop", [True, False])
def test_read_images_equals_jax(image_dir, drop):
    t = read_images(str(image_dir), drop_image_failures=drop)
    j = j_read_images(str(image_dir), drop_image_failures=drop)
    assert t.columns == j.columns
    for c in ("path", "height", "width", "nChannels", "mode"):
        np.testing.assert_array_equal(t[c], j[c], err_msg=c)
    for a, b in zip(t["data"], j["data"]):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
