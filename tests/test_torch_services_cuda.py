"""The service clients feeding stages on the card, against the same
stages on the CPU.  Marked ``gpu``: every test skips where no card is
present (the check runs inside the fixture, so every worker collects the
same tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_services_cuda.py

- ``OpenAIEmbedding`` against the recording mock (``torch_service_mocks``,
  127.0.0.1) → ``KNN(k=10)`` on the card: neighbour ids equal the CPU's.
  The texts come ten a topic, and the mock puts a topic's texts near
  one center (``embedding_of``): each text's ten nearest are its
  topic's, far nearer than any other text, so the ids that win do not
  hang on the last bits of the two devices' float32 distances.
- ``ModelDownloader`` fetches an ONNX model from the mock (sha256
  checked) → ``ONNXModel`` on the card: outputs within 1e-5 of the CPU's
  over the outputs' scale (the f32 limit ``chip_smoke.py``'s phase 21a
  holds the small CNN to).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.downloader import ModelDownloader
from synapseml_tpu_torch.models.onnx import GraphBuilder, ONNXModel
from synapseml_tpu_torch.nn import KNN
from synapseml_tpu_torch.services import OpenAIEmbedding
from torch_service_mocks import MockServices
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def mock():
    m = MockServices(embed_dim=256, seed=7)
    yield m
    m.close()


def small_cnn(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    b = GraphBuilder("cnn")
    x = b.input("image", (None, 3, 16, 16))
    h = b.node("Conv", [x, b.initializer(
        "w1", (rng.normal(size=(8, 3, 3, 3)) * 0.3).astype(np.float32)),
        b.initializer("b1", rng.normal(size=8).astype(np.float32))],
        kernel_shape=[3, 3], pads=[1, 1, 1, 1])
    h = b.node("Relu", [h])
    h = b.node("Flatten", [b.node("GlobalAveragePool", [h])], axis=1)
    b.output(b.node("Gemm", [h, b.initializer(
        "wf", rng.normal(size=(5, 8)).astype(np.float32)), b.initializer(
        "bf", rng.normal(size=5).astype(np.float32))], transB=1,
        outputs=["logits"]))
    return b.build()


def test_embeddings_to_knn_card_equals_cpu(dev, mock):
    rng = np.random.default_rng(0)
    texts = np.array([f"topic {i // 10} doc {i} {w}" for i, w in enumerate(
        rng.integers(0, 1 << 30, 500))])
    emb = OpenAIEmbedding(url=mock.url + "/embeddings",
                          concurrency=8).transform(Dataset({"text": texts}))
    assert all(e is None for e in emb["errors"])
    ds = Dataset({"features": list(emb["output"]),
                  "values": np.arange(len(texts))})
    ids = {}
    for d in (dev, "cpu"):
        model = KNN(k=10, device=d).fit(ds)
        out = model.transform(ds)
        ids[d] = [[m["value"] for m in row] for row in out["output"]]
    assert ids[dev] == ids["cpu"]
    assert all(row[0] == i and {j // 10 for j in row} == {i // 10}
               for i, row in enumerate(ids["cpu"]))


def test_downloaded_onnx_card_equals_cpu(dev, mock, tmp_path):
    payload = small_cnn(3)
    mock.files.update({
        "cnn.onnx": payload,
        "manifest.json": json.dumps([{
            "name": "cnn", "uri": "cnn.onnx",
            "hash": hashlib.sha256(payload).hexdigest(),
            "size": len(payload)}]).encode()})
    got = ModelDownloader(str(tmp_path), mock.url + "/files") \
        .downloadByName("cnn")
    images = np.random.default_rng(1).normal(
        size=(64, 3, 16, 16)).astype(np.float32)
    ds = Dataset({"image": list(images)})
    out = {}
    for d in (dev, "cpu"):
        m = ONNXModel(got.uri, feedDict={"image": "image"}, device=d)
        out[d] = np.stack(list(m.transform(ds)["logits"]))
    scale = max(1.0, float(np.abs(out["cpu"]).max()))
    assert np.abs(out[dev] - out["cpu"]).max() / scale <= 1e-5
