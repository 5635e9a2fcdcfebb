"""The tuning plane's kernel knobs on the card: every ``(fpb, tile)``
candidate of ``gbdt_hist_geometry`` gives K1/K2 histograms equal to the
plain version's (exact int32 sums), both K3 variants of
``paged_attn_variant`` stay within K3's tolerance of the plain version at
S = 1, 2, 4 and 8 in bf16 and f16, a table's winner reaches the launches
and ``roofline.capture`` of a step that launches K2 counts the kernel's
operand and result bytes.  Marked ``gpu``: every test skips where no card
is present (the check runs inside the fixture, so every worker collects
the same tests).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_tuning_cuda.py

Tolerances: K1/K2 exact (int32 limb sums do not depend on the order);
K3 bf16 and f16 atol = rtol = 1e-2, the reason stated in
``tests/test_torch_llm_cuda.py``.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.kernels import launches
from synapseml_tpu_torch.models.gbdt import hist as H
from synapseml_tpu_torch.models.llm import paged_attn as PA
from synapseml_tpu_torch.telemetry import roofline
from synapseml_tpu_torch.telemetry import tunetable as TT
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _vals(rng, N, dev):
    g = torch.as_tensor(rng.normal(size=N).astype(np.float32), device=dev)
    h = torch.as_tensor((rng.random(N) + 0.1).astype(np.float32), device=dev)
    return H.prep_hist_vals(g, h, torch.ones_like(g))[0]


def _wave(rng, dev, N, F, S, B):
    i32 = torch.int32
    node_id = torch.as_tensor(rng.integers(0, 2 * S, N).astype(np.int32),
                              device=dev)
    leaf = torch.arange(S, dtype=i32, device=dev) * 2
    feat = torch.as_tensor(rng.integers(0, F, S).astype(np.int32),
                           device=dev)
    t1 = torch.as_tensor(rng.integers(0, B, S).astype(np.int32), device=dev)
    rlo = torch.full((S,), -1, dtype=i32, device=dev)
    rhi = torch.full((S,), B, dtype=i32, device=dev)
    dflt = torch.as_tensor(rng.integers(0, 2, S).astype(np.int32),
                           device=dev)
    l_id = torch.arange(S, dtype=i32, device=dev) * 2 + 2 * S
    return node_id, leaf, feat, t1, rlo, rhi, dflt, l_id, l_id + 1


@pytest.mark.parametrize("F,B,S", [(28, 256, 16), (28, 32, 16),
                                   (8, 256, 1), (28, 256, 1)])
def test_every_hist_candidate_equals_plain(dev, monkeypatch, F, B, S):
    """K1 with each candidate forced; K2 with each candidate as the
    launch geometry of its coarse and refined feature sets."""
    rng = np.random.default_rng(F * B + S)
    N = 200_003
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    slot = torch.as_tensor(rng.integers(-1, S, N).astype(np.int32),
                           device=dev)
    vals = _vals(rng, N, dev)
    want = H.build_hist_nodes_plain(bins, slot, vals, S, B)
    wave = _wave(rng, dev, N, F, S, B)
    K = min(4, F)
    feat_k = torch.as_tensor(rng.permutation(F)[:K].astype(np.int32),
                             device=dev)
    want2 = H.route_and_hist_ids_plain(bins, *wave[:2], wave[2], *wave[3:],
                                       vals, S, B, 0, feat_k)
    cands = H.rows_geometry_candidates(F, B, S)
    assert cands
    for g in cands:
        got = H.build_hist_nodes_limbs(bins, slot, vals, S, B, geometry=g)
        assert torch.equal(got, want), g
        monkeypatch.setattr(H, "launch_geometry",
                            lambda nf, w, s, d, g=g: g if H.rows_geometry_ok(
                                nf, w, s, *g) else H.rows_geometry(
                                    nf, w, s)[:2])
        got2 = H.route_and_hist_ids_limbs(bins, *wave[:2], wave[2],
                                          *wave[3:], vals, S, B, 0, feat_k)
        for a, b in zip(got2, want2):
            assert torch.equal(a, b), g
        monkeypatch.undo()


def test_a_loaded_winner_reaches_the_launch(dev, tmp_path):
    rng = np.random.default_rng(7)
    F, B, S, N = 28, 256, 16, 100_000
    plane = TT.TunePlane(directory=str(tmp_path))
    fpb, tile = H.rows_geometry_candidates(F, B, S)[0]
    plane.record(H.HIST_GEOMETRY_SPACE, H.hist_geometry_key(F, B, S),
                 {"fpb": fpb, "tile": tile}, measured_ms=0.1, trials=1,
                 device=dev)
    prev = TT.set_tuneplane(plane)
    try:
        bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                               device=dev)
        slot = torch.as_tensor(rng.integers(-1, S, N).astype(np.int32),
                               device=dev)
        vals = _vals(rng, N, dev)
        got = H.build_hist_nodes_limbs(bins, slot, vals, S, B)
        key = launches.launch_key("build_hist_nodes", F=F, B=B, shift=0,
                                  S=S, variant="rows")
        assert H.LAUNCH_GEOMETRY[key] == (fpb, tile)
        assert torch.equal(got, H.build_hist_nodes_plain(bins, slot, vals,
                                                         S, B))
        assert plane.snapshot()["consults"][-1]["outcome"] == "loaded"
    finally:
        TT.set_tuneplane(prev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("B,Hh,KV,D,T", [(16, 32, 8, 64, 2048),
                                         (8, 16, 4, 64, 256)])
def test_both_variants_equal_plain(dev, dtype, S, B, Hh, KV, D, T):
    rng = np.random.default_rng(B + S)
    shape_q = (B, Hh, D) if S == 1 else (B, S, Hh, D)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                               device=dev).to(dtype)
               for s in (shape_q, (B, T, KV, D), (B, T, KV, D)))
    spans = torch.as_tensor(rng.integers(S, T + 1, B).astype(np.int32),
                            device=dev)
    want = PA.paged_decode_attention_plain(q, k, v, spans).float()
    for variant, key in (("split", "split"), ("single", "previous")):
        launches.reset()
        got = PA.paged_decode_attention(q, k, v, spans, variant=variant)
        torch.cuda.synchronize()
        assert [kk.endswith(f",variant={key}]") for kk in launches.BY_SHAPE
                ] == [True]
        torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)


def test_capture_counts_the_k2_bytes(dev):
    rng = np.random.default_rng(3)
    F, B, S, N, K = 28, 256, 16, 100_000, 8
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    wave = _wave(rng, dev, N, F, S, B)
    vals = _vals(rng, N, dev)
    feat_k = torch.as_tensor(rng.permutation(F)[:K].astype(np.int32),
                             device=dev)
    Bh = H.coarse_bins(B, 3)

    def step():
        return H.route_and_hist_ids_limbs(bins, *wave[:2], wave[2],
                                          *wave[3:], vals, S, B, 3, feat_k)
    cost = roofline.capture(step)
    k2 = {o["name"]: o["mbytes"] for o in cost["top_ops"]}["route_and_hist"]
    # bins, node ids, the (8, S) params, the split and refined rows read
    # by id, the limbs, the new ids and both histograms
    want = (4 * F * N + 4 * N + 4 * 8 * S + 4 * (S + K) * N + 8 * N
            + 4 * N + 4 * F * Bh * S * 8 + 4 * K * B * S * 8)
    assert k2 * 1e6 == pytest.approx(want)
    assert cost["bytes_accessed"] >= want
