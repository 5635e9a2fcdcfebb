"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--rows 1000000] [--iters 5]

1. Prints the software and the card (name and power limit from
   ``nvidia-smi``), and builds every CUDA kernel of the port from the
   sources in this checkout (one ``nvcc`` per source, all at once).
2. For each kernel, at the shapes the default fit gives it, holds the
   kernel against its plain PyTorch version on the same inputs on the
   card: int32 limb histograms bit-identical and new node ids identical.
   Times the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (CUDA events after warm-up), and
   computes the least time the card could take from the bytes moved.
3. Fits the same small problem on the card and on the CPU: split
   features must agree and margins within 1e-4.
4. Drives the main path, ``Pipeline([GBDTClassifier(...)]).fit`` then
   ``transform``, at 1M rows x 28 features: once at the default
   ``maxBin=255`` (two-level histograms: both kernels) and once at
   ``maxBin=63`` (the fused kernel alone).  Kernel launch counts are
   reset just before and read just after each fit; every kernel of the
   path must have launched, and the holdout AUC must exceed 0.8.
5. Profiles one more default fit with ``torch.profiler``: device time by
   kernel and the device's busy share of the fit's wall clock.

Prints the kernels' JSON line, then the card's name and power limit,
then ``{"ok": true, "device": {...}}`` as the last line.  Any failed
check raises, and the script exits nonzero without that line.  Without
a card it exits 1 before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: non-tensor-core 32-bit operations/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: int, nops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the 32-bit rate."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = nops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def gbdt_labels(rng, X):
    """bench.py's label concept for train and holdout."""
    return (X[:, 0] * 2 - X[:, 1] + X[:, 2] * X[:, 3]
            + rng.normal(scale=0.5, size=len(X)) > 0).astype(np.float64)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def vals_for(rng, N, dev):
    from synapseml_tpu_torch.models.gbdt.hist import prep_hist_vals
    grad = torch.as_tensor(rng.normal(size=N).astype(np.float32), device=dev)
    hess = torch.as_tensor((rng.random(N) * 0.25).astype(np.float32),
                           device=dev)
    mask = torch.ones(N, dtype=torch.float32, device=dev)
    return prep_hist_vals(grad.to(torch.bfloat16), hess.to(torch.bfloat16),
                          mask)


def k2_case(rng, dev, N, F, S, B, shift, K):
    """One mid-tree wave (S pending leaves among 2S node ids) or, with
    S=1, a tree's root pass (every row in leaf 0, split all-left)."""
    from synapseml_tpu_torch.models.gbdt import hist as H
    i32 = torch.int32
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    vals, _ = vals_for(rng, N, dev)
    root = S == 1
    if root:
        node_id = torch.zeros(N, dtype=i32, device=dev)
        leaf = torch.zeros(1, dtype=i32, device=dev)
        sel = bins[:1]
        t1 = torch.full((1,), B, dtype=i32, device=dev)
        l_id = torch.zeros(1, dtype=i32, device=dev)
        r_id = l_id
    else:
        node_id = torch.as_tensor(rng.integers(0, 2 * S, N).astype(np.int32),
                                  device=dev)
        leaf = torch.arange(S, dtype=i32, device=dev) * 2 + 1
        feat = torch.as_tensor(rng.integers(0, F, S), device=dev)
        sel = bins.index_select(0, feat).contiguous()
        t1 = torch.as_tensor(rng.integers(0, B, S).astype(np.int32),
                             device=dev)
        l_id = torch.arange(S, dtype=i32, device=dev) * 2 + 2 * S
        r_id = l_id + 1
    rlo, rhi, dflt = (torch.full((S,), v, dtype=i32, device=dev)
                      for v in (-1, B, 1))
    sel_k = bins[:K].contiguous() if K else None
    args = (bins, node_id, leaf, sel, t1, rlo, rhi, dflt, l_id, r_id,
            vals, S, B, shift, sel_k)
    out_k = H.route_and_hist_limbs(*args)
    out_p = H.route_and_hist_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(out_k[0], out_p[0]):
        raise AssertionError("route_and_hist: new node ids differ")
    err = 0
    for a, b in zip(out_k[1:], out_p[1:]):
        if (a is None) != (b is None):
            raise AssertionError("route_and_hist: outputs differ in kind")
        if a is not None:
            err = max(err, int((a.long() - b.long()).abs().max()))
    if err:
        raise AssertionError(f"route_and_hist: limb sums differ by {err}")
    Bh = H.coarse_bins(B, shift) if shift else B
    # reads: bins, node id, each row's ONE split bin (the kernel reads
    # sel[j] only for the slot whose leaf holds the row; at the root, sel
    # is bins' first row, already counted), limbs, the refined rows and
    # the split table; writes: new ids and the histograms (8 int32 lanes)
    sel_bytes = 0 if root else N * 4
    nbytes = (F * N * 4 + N * 4 + sel_bytes + N * 8 + K * N * 4 + 7 * S * 4
              + N * 4 + F * Bh * S * 32 + K * B * S * 32)
    b_ms, b_by = bound(nbytes, N * (F + K) * 7 + N * 4)
    return dict(
        ms=cuda_ms(lambda: H.route_and_hist_limbs(*args)),
        plain_ms=cuda_ms(lambda: H.route_and_hist_plain(*args), iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        bytes=nbytes)


def k1_case(rng, dev, N, F, S, B, shift):
    """The two-level root's fine build (S=1, K refined rows) or a
    node-batched build (S slots)."""
    from synapseml_tpu_torch.models.gbdt import hist as H
    bins = torch.as_tensor(rng.integers(0, B, (F, N)).astype(np.int32),
                           device=dev)
    slot = torch.as_tensor(rng.integers(-1, S, N).astype(np.int32),
                           device=dev)
    vals, _ = vals_for(rng, N, dev)
    args = (bins, slot, vals, S, B, shift)
    out_k = H.build_hist_nodes_limbs(*args)
    out_p = H.build_hist_nodes_plain(*args)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max())
    if err:
        raise AssertionError(f"build_hist_nodes: limb sums differ by {err}")
    # the library yardstick: one index_add_ over precomputed flat
    # (feature, bin, slot) ids, rows without a slot sent to a dump row
    Bh = H.coarse_bins(B, shift) if shift else B
    ok = slot >= 0
    ids = torch.where(ok[None, :],
                      (torch.arange(F, device=dev)[:, None] * Bh
                       + (bins.long() >> shift)) * S + slot.long()[None, :],
                      F * Bh * S).reshape(-1)
    src = vals.int()[None].expand(F, N, 8).reshape(-1, 8).contiguous()
    acc = torch.zeros((F * Bh * S + 1, 8), dtype=torch.int32, device=dev)
    lib = acc.clone().index_add_(0, ids, src)[:-1].view(F, Bh, S, 8)
    if not torch.equal(lib, out_k):
        raise AssertionError("build_hist_nodes: index_add_ yardstick "
                             "disagrees")
    nbytes = F * N * 4 + N * 4 + N * 8 + F * Bh * S * 32
    b_ms, b_by = bound(nbytes, N * F * 7)
    return dict(
        ms=cuda_ms(lambda: H.build_hist_nodes_limbs(*args)),
        plain_ms=cuda_ms(lambda: H.build_hist_nodes_plain(*args), iters=3),
        library_ms=cuda_ms(lambda: acc.clone().index_add_(0, ids, src)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err, bytes=nbytes)


# --------------------------------------------------------------------------
# phases 3 to 5: the main path
# --------------------------------------------------------------------------

def card_vs_cpu(X, y, Xh, two_level: str):
    """The same fit through ``train`` on the card and on the CPU: → the
    largest margin difference on ``Xh``; raises if any tree splits on
    another feature or bin, or (two-level on) K1 never ran on the card."""
    from synapseml_tpu_torch.models.gbdt import hist as H
    from synapseml_tpu_torch.models.gbdt.booster import BoostingConfig, train
    cfg = BoostingConfig(num_iterations=2, two_level_hist=two_level)
    res = {}
    for d in ("cuda", "cpu"):
        H.reset_launch_counts()
        booster, _ = train(X, y, cfg, device=d)
        if d == "cuda" and (H.LAUNCHES["route_and_hist"] == 0 or (
                two_level == "on" and H.LAUNCHES["build_hist_nodes"] == 0)):
            raise AssertionError(f"two_level={two_level}: a kernel never ran "
                                 f"on the card: {H.LAUNCHES}")
        res[d] = (booster, booster.predict_margin(Xh, device="cpu"))
    for tc, tp in zip(res["cuda"][0].trees, res["cpu"][0].trees):
        n = int(tc.num_nodes)
        if int(tp.num_nodes) != n or not (
                np.array_equal(tc.split_feature[:n], tp.split_feature[:n])
                and np.array_equal(tc.split_bin[:n], tp.split_bin[:n])):
            raise AssertionError(f"two_level={two_level}: card and CPU "
                                 "trees split differently")
    return float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])))


def fit_path(X, y, Xh, yh, max_bin, iters, device="cuda"):
    from synapseml_tpu_torch.core import Dataset, Pipeline
    from synapseml_tpu_torch.models.gbdt import hist as H
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    ds = Dataset({"features": list(X), "label": y})
    hold = Dataset({"features": list(Xh), "label": yh})
    H.reset_launch_counts()
    t0 = time.perf_counter()
    model = Pipeline(stages=[GBDTClassifier(
        numIterations=iters, maxBin=max_bin, device=device)]).fit(ds)
    if device == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(H.LAUNCHES)
    shapes = dict(H.LAUNCHES_BY_SHAPE)
    t0 = time.perf_counter()
    out = model.transform(hold)
    transform_s = time.perf_counter() - t0
    proba = np.stack(out["probability"])
    if proba.shape != (len(Xh), 2) or not np.all(np.isfinite(proba)):
        raise AssertionError(f"transform gave {proba.shape} / non-finite")
    if set(out.columns) != {"features", "label", "rawPrediction",
                            "probability", "prediction"}:
        raise AssertionError(f"transform columns {out.columns}")
    gbdt = model.get_or_default("stages")[0]
    m = gbdt.training_measures
    return dict(fit_s=fit_s, train_s=m.training_s,
                s_per_iter=m.seconds_per_iteration(),
                binning_s=m.binning_s, transform_s=transform_s,
                auc=float(auc(yh, proba[:, 1])), launches=launches,
                shapes=shapes,
                two_level=gbdt.booster.config.two_level_hist), gbdt


def profile_fit(X, y, iters: int) -> dict:
    """Device time by kernel over one default fit, from ``torch.profiler``
    (which adds host overhead to the fit it watches): → {wall_s,
    binning_s, train_s, kernel_s, busy_share, top: [[name, ms, calls],
    ...]}."""
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
    ds = Dataset({"features": list(X), "label": y})
    est = GBDTClassifier(numIterations=iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = est.fit(ds).training_measures
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kern) / 1e6
    return dict(wall_s=wall, binning_s=m.binning_s, train_s=m.training_s,
                kernel_s=total, busy_share=total / wall,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                     for e in kern[:10]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: this script runs the port on a card")
        return 1
    from synapseml_tpu_torch.kernels._build import build_all
    from synapseml_tpu_torch.models.gbdt import hist as H

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"device {name} | {card}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for lib, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {lib}: {line.strip()}")

    # -- 2. kernels at the main path's shapes --------------------------------
    rng = np.random.default_rng(args.seed)
    N, F, S, K = args.rows, 28, 16, 8
    src = "synapseml_tpu_torch/csrc/gbdt_hist.cu"
    refs = {"route_and_hist": "synapseml_tpu/models/gbdt/pallas_hist.py:526",
            "build_hist_nodes": "synapseml_tpu/models/gbdt/pallas_hist.py:317"}
    # (kernel, shape, the main-path fit (maxBin) that launches it): each
    # tree's root pass runs K2 at one slot, every other wave at S slots;
    # K1 builds the two-level root's K refined rows
    shapes = [
        ("route_and_hist", dict(F=F, B=64, shift=0, K=0, S=1), 63),
        ("route_and_hist", dict(F=F, B=64, shift=0, K=0, S=S), 63),
        ("route_and_hist", dict(F=F, B=256, shift=3, K=0, S=1), 255),
        ("route_and_hist", dict(F=F, B=256, shift=3, K=K, S=S), 255),
        ("build_hist_nodes", dict(F=K, B=256, shift=0, S=1), 255),
        # the node-batched shape lossguide growth gives K1: checked and
        # timed, but no fit of this path launches it
        ("build_hist_nodes", dict(F=F, B=64, shift=0, S=S), None),
    ]
    cases = []
    for kern, dims, fit in shapes:
        case = k2_case if kern == "route_and_hist" else k1_case
        r = case(rng, dev, N, **dims)
        key = H.launch_key(kern, **dims)
        log(f"{key}: identical to plain; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bytes']} B)")
        cases.append((key, kern, fit, r))

    # -- data: bench.py's task at full width, and a holdout -----------------
    drng = np.random.default_rng(args.seed)
    X = drng.normal(size=(N, F)).astype(np.float32)
    y = gbdt_labels(drng, X)
    Xh = drng.normal(size=(100_000, F)).astype(np.float32)
    yh = gbdt_labels(drng, Xh)
    # -- 3. the card against the CPU --------------------------------------
    # two-level forced on (K1, coarse+refine K2 and the two-level split
    # pick, as the default fit runs them at 1M rows) and off (plain K2);
    # this also loads the CUDA modules the fit uses, so the main path
    # below is timed in a warm process
    n_small = 65_536
    for tl in ("on", "off"):
        diff = card_vs_cpu(X[:n_small], y[:n_small], Xh[:4096], tl)
        if diff > 1e-4:
            raise AssertionError(f"two_level={tl}: card and CPU margins "
                                 f"differ by {diff}")
        log(f"card vs CPU, two_level={tl}: same splits, margins within "
            f"{diff:.3g}")

    # -- 4. the main path at full width ------------------------------------
    # counts are reset just before and read just after each fit
    paths = {}
    for max_bin in (255, 63):
        r, _ = fit_path(X, y, Xh, yh, max_bin, args.iters)
        log(f"fit maxBin={max_bin}: {json.dumps(r)}")
        for key, _, fit, _ in cases:
            if fit == max_bin and r["shapes"].get(key, 0) <= 0:
                raise AssertionError(f"maxBin={max_bin}: {key} never "
                                     "launched on the main path")
        if r["auc"] <= 0.8:
            raise AssertionError(f"maxBin={max_bin}: holdout AUC "
                                 f"{r['auc']}")
        paths[max_bin] = r

    # -- 5. where the time goes --------------------------------------------
    log(f"profile maxBin=255: {json.dumps(profile_fit(X, y, 2))}")

    # -- results -----------------------------------------------------------
    # each shape's launches in the one fit that runs it
    kernels = []
    for key, kern, fit, r in cases:
        if fit is None:
            continue
        kernels.append(dict(
            name=key, route="cuda", source=src, replaces=refs[kern],
            launches=paths[fit]["shapes"][key],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
