"""Gang tasks for the port's parallel-layer tests.

Each function runs on every rank of a gang that
``synapseml_tpu_torch.parallel.run_on_local_cluster`` launched (one
process per rank, a ``torch.distributed`` group already formed) and
returns a JSON-serializable result.  The module imports torch and the
port only, so the card's gangs (tests/test_torch_parallel_cuda.py) run
it too; the CPU tests hold the results against numpy and the JAX
package.
"""

import base64
import hashlib
import time

import numpy as np
import torch

from synapseml_tpu_torch.parallel import collectives as C
from synapseml_tpu_torch.parallel import compression as Z
from synapseml_tpu_torch.parallel.mesh import (DATA_AXIS, ProcessMesh,
                                               data_parallel_mesh)


def binary_data(n=2000, f=12, seed=7):
    """tests/mp_tasks.py's binary task."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logits = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (logits + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def rank_values(rank: int, n: int, seed: int = 0) -> np.ndarray:
    """The seeded f32 values rank ``rank`` contributes: a histogram-like
    (n, 3) block whose channels differ by orders of magnitude."""
    rng = np.random.default_rng(seed + 1000 * rank)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:, 1] = np.abs(v[:, 1]) * 8
    v[:, 2] = np.round(np.abs(v[:, 2]) * 300)
    return v


def _digest(t) -> str:
    a = np.ascontiguousarray(t.detach().cpu().numpy())
    return hashlib.md5(a.tobytes()).hexdigest()


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _rel_err(got, exact) -> float:
    """Largest error over each channel's largest magnitude."""
    g = got.detach().cpu().numpy().astype(np.float64)
    return float((np.abs(g - exact) / np.abs(exact).max(axis=0)).max())


def collectives_check(args):
    """Every collective on this rank, against numpy or against another
    route to the same sum (→ booleans and raw bytes for the test)."""
    args = args or {}
    dev = args.get("device", "cpu")
    n_vals = int(args.get("n", 4096))
    mesh = data_parallel_mesh(device=dev)
    n, me = mesh.axis_size(), mesh.axis_index()
    x = torch.as_tensor(rank_values(me, n_vals), device=mesh.device)
    want = sum(rank_values(r, n_vals).astype(np.float64) for r in range(n))
    out = {"rank": me, "world": n}
    flat = C.psum(x, mesh)
    out["psum_close"] = bool(np.allclose(flat.cpu().numpy(), want,
                                         rtol=1e-6, atol=1e-4))
    out["psum_same_everywhere"] = _digest(flat)
    out["ring_close"] = bool(np.allclose(
        C.ring_allreduce(x, mesh).cpu().numpy(), want, rtol=1e-6,
        atol=1e-4))
    tree = {"a": x, "b": x[:7, 0].clone(),
            "c": torch.arange(5, device=mesh.device, dtype=torch.int64)}
    red = C.tree_psum_bucketed(tree, mesh, bucket_bytes=1 << 10)
    out["tree_bucketed_ok"] = bool(
        np.allclose(red["a"].cpu().numpy(), want, rtol=1e-6, atol=1e-4)
        and np.allclose(red["b"].cpu().numpy(), want[:7, 0], rtol=1e-6,
                        atol=1e-4)
        and torch.equal(red["c"].cpu(), torch.arange(5) * n))
    g = C.all_gather(x[:4], mesh)
    out["all_gather_ok"] = bool(np.array_equal(
        g.cpu().numpy(), np.stack([rank_values(r, n_vals)[:4]
                                   for r in range(n)])))
    rs = C.reduce_scatter(x, mesh)
    per = n_vals // n
    out["reduce_scatter_ok"] = bool(np.allclose(
        rs.cpu().numpy(), want[me * per:(me + 1) * per], rtol=1e-6,
        atol=1e-4))
    shifted = C.ring_shift(x[:2], mesh)
    out["ring_shift_ok"] = bool(np.array_equal(
        shifted.cpu().numpy(), rank_values((me - 1) % n, n_vals)[:2]))
    a2a = C.all_to_all(torch.full((n, 2), float(me), device=mesh.device),
                       mesh)
    out["all_to_all_ok"] = bool(np.array_equal(
        a2a.cpu().numpy(), np.repeat(np.arange(n, dtype=np.float32)[:, None],
                                     2, 1)))
    out["pmax_ok"] = float(C.pmax(torch.tensor([float(me)],
                                               device=mesh.device),
                                  mesh)) == n - 1
    out["pmin_ok"] = float(C.pmin(torch.tensor([float(me)],
                                               device=mesh.device),
                                  mesh)) == 0
    out["pmean_ok"] = float(C.pmean(torch.tensor([float(me)],
                                                 device=mesh.device),
                                    mesh)) == (n - 1) / 2
    out["barrier_ok"] = C.barrier(7, mesh) == 7
    fn = C.allreduce_fn(mesh)
    out["allreduce_fn_ok"] = bool(np.allclose(
        fn(torch.stack([x, x])).cpu().numpy(), 2 * want, rtol=1e-6,
        atol=1e-3))
    # the codecs over the whole axis: digests for the numpy statement
    for codec in ("bf16", "int8"):
        cfg = Z.CollectiveConfig(compression=codec, strategy="flat")
        r = Z.compressed_psum(x, mesh, DATA_AXIS, cfg)
        out[f"compressed_{codec}"] = _digest(r)
        out[f"compressed_{codec}_err"] = _rel_err(r, want)
    out["staged_bytes"] = mesh.staged_bytes
    if n == 4:
        out.update(_two_axis_checks(x, mesh.device, n_vals))
    return out


def _two_axis_checks(x, dev, n_vals):
    """On a 2 x 2 mesh: hierarchical_psum against the flat psum, the
    codecs over a 2-rank axis (bit-equal to the numpy statement), and
    the planner's ring / tree / hierarchical routes against flat."""
    from synapseml_tpu_torch.parallel import planner as Pl
    m2 = ProcessMesh({"outer": 2, "inner": 2}, device=dev)
    world = data_parallel_mesh(device=dev)
    out = {}
    flat = C.psum(x, world)
    hier = C.hierarchical_psum(x, m2, "inner", "outer")
    out["hier_close"] = bool(np.allclose(hier.cpu().numpy(),
                                         flat.cpu().numpy(), rtol=1e-6,
                                         atol=1e-4))
    out["inner_index"] = m2.axis_index("inner")
    out["outer_index"] = m2.axis_index("outer")
    for codec in ("bf16", "int8"):
        cfg = Z.CollectiveConfig(compression=codec, strategy="flat")
        r = Z.compressed_psum(x, m2, "inner", cfg)
        out[f"inner_{codec}"] = _digest(r)
    prev = Pl.set_planner(Pl.CollectivePlanner(
        Pl.TopologySpec(n_hosts=2, devices_per_host=2)))
    try:
        for strategy in ("ring", "tree", "hierarchical"):
            for codec in ("none", "bf16", "int8"):
                cfg = Z.CollectiveConfig(compression=codec,
                                         strategy=strategy)
                r = Pl.planned_psum(x, world, DATA_AXIS, cfg)
                ref = Z.compressed_psum(x, world, DATA_AXIS, Z.CollectiveConfig(
                    compression=codec, strategy="flat"))
                tol = 1e-4 if codec == "none" else 0.05
                out[f"route_{strategy}_{codec}"] = bool(np.allclose(
                    r.cpu().numpy(), ref.cpu().numpy(), rtol=tol,
                    atol=tol * 40))
                out[f"route_{strategy}_{codec}_digest"] = _digest(r)
    finally:
        Pl.set_planner(prev)
    return out


def gbdt_fits(args):
    """The data-parallel GBDT on this gang: the rendezvous report, an
    unbagged fit (model md5, first split, holdout margins), and a bagged
    fit whose per-rank bag masks are recorded as drawn."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.parallel.selfcheck import cluster_report
    args = args or {}
    dev = args.get("device", "cpu")
    out = {"report": cluster_report({"device": dev})}
    X, y = binary_data(n=int(args.get("n", 2000)))
    Xh, yh = binary_data(n=1000, seed=11)
    mesh = data_parallel_mesh(device=dev)
    cfg = B.BoostingConfig(objective="binary", num_iterations=6,
                           num_leaves=15, min_data_in_leaf=5)
    t0 = time.perf_counter()
    booster, _ = B.train(X, y, cfg, mesh=mesh, device=dev)
    out["fit_s"] = time.perf_counter() - t0
    text = booster.to_string()
    out["model_md5"] = hashlib.md5(text.encode()).hexdigest()
    out["num_trees"] = booster.num_trees
    t = booster.trees[0]
    out["first_split"] = [int(t.split_feature[0]), float(t.threshold[0])]
    out["holdout_margin"] = [float(v) for v in
                             booster.predict_margin(Xh, device=dev)]
    # bagged: record the masks the fit draws on this rank
    drawn = []
    orig = B.bag_mask

    def recording(key, n, fraction, device):
        m = orig(key, n, fraction, device)
        drawn.append(np.packbits(m.cpu().numpy() > 0))
        return m

    B.bag_mask = recording
    try:
        bcfg = B.BoostingConfig(objective="binary", num_iterations=3,
                                num_leaves=15, min_data_in_leaf=5,
                                bagging_fraction=0.7, bagging_freq=1)
        bagged, _ = B.train(X, y, bcfg, mesh=mesh, device=dev)
    finally:
        B.bag_mask = orig
    out["bagged_md5"] = hashlib.md5(bagged.to_string().encode()).hexdigest()
    out["bag_masks"] = [_b64(m) for m in drawn]
    return out


def one_rank_checks(args):
    """On a 1-rank group: a fit over the group equals the fit without
    one, bit for bit; then a hung collective raises CollectiveTimeout."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.resilience.faults import get_faults
    args = args or {}
    dev = args.get("device", "cpu")
    X, y = binary_data(n=int(args.get("n", 2000)))
    cfg = B.BoostingConfig(objective="binary", num_iterations=6,
                           num_leaves=15, min_data_in_leaf=5)
    alone, _ = B.train(X, y, cfg, device=dev)
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    mesh = data_parallel_mesh(device=dev)
    prof = StepProfiler("gang_fit")
    grouped, _ = B.train(X, y, cfg, mesh=mesh, step_profiler=prof,
                         device=dev)
    out = {"equal": alone.to_string() == grouped.to_string(),
           "md5": hashlib.md5(grouped.to_string().encode()).hexdigest(),
           "profiled_collective_bytes": prof.collective_bytes,
           "profiled_collective_s": prof.collective_by_strategy.get("flat",
                                                                    0.0)}
    timeout = float(args.get("timeout_s", 1.0))
    get_faults().inject("collective.dispatch", "hang", times=1)
    t0 = time.perf_counter()
    try:
        C.psum(torch.ones(4, device=mesh.device), mesh, timeout_s=timeout)
        out["raised"] = None
    except C.CollectiveTimeout as e:
        out["raised"] = type(e).__name__
        out["message"] = str(e)
    out["elapsed_s"] = time.perf_counter() - t0
    get_faults().clear()
    return out


def fit_until_killed(args):
    """A 2-rank fit; an armed ``kill_rank`` fault kills one rank
    mid-fit (the test expects the gang to fail)."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    X, y = binary_data(n=2000)
    cfg = B.BoostingConfig(objective="binary", num_iterations=6,
                           num_leaves=15, min_data_in_leaf=5)
    mesh = data_parallel_mesh(device="cpu")
    B.train(X, y, cfg, mesh=mesh, device="cpu")
    return {"finished": True}


def card_checks(args):
    """On a gang sharing the card over gloo: the rendezvous report, each
    collective on CUDA tensors against the same op over the CPU (same
    group, same values: bit-equal, with the staged host bytes), and a
    small data-parallel fit's model md5."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.parallel.selfcheck import cluster_report
    out = {"report": cluster_report({"device": "cuda"})}
    card = data_parallel_mesh(device="cuda")
    host = data_parallel_mesh(device="cpu")
    x = rank_values(card.rank, 4096)
    flat = {c: Z.CollectiveConfig(compression=c, strategy="flat")
            for c in ("bf16", "int8")}
    ops = {
        "psum": lambda m, t: C.psum(t, m),
        "all_gather": lambda m, t: C.all_gather(t, m),
        "reduce_scatter": lambda m, t: C.reduce_scatter(t, m),
        "ring_allreduce": lambda m, t: C.ring_allreduce(t, m),
        "ppermute": lambda m, t: C.ring_shift(t, m),
        "compressed_psum_bf16": lambda m, t: Z.compressed_psum(
            t, m, DATA_AXIS, flat["bf16"]),
        "compressed_psum_int8": lambda m, t: Z.compressed_psum(
            t, m, DATA_AXIS, flat["int8"]),
    }
    out["equal"], out["staged"] = {}, {}
    for name, op in ops.items():
        before = card.staged_bytes
        got = op(card, torch.as_tensor(x, device=card.device)).cpu()
        out["staged"][name] = card.staged_bytes - before
        out["equal"][name] = (got.numpy().tobytes()
                              == op(host, torch.as_tensor(x)).numpy()
                              .tobytes())
    X, y = binary_data(n=2000)
    cfg = B.BoostingConfig(objective="binary", num_iterations=4,
                           num_leaves=15, min_data_in_leaf=5)
    booster, _ = B.train(X, y, cfg, mesh=card, device=card.device)
    out["model_md5"] = hashlib.md5(booster.to_string().encode()).hexdigest()
    return out


# -- voting- and feature-parallel GBDT, distributed lambdarank, online -------

def modes_data(n=2000, f=11, seed=2):
    """tests/test_gbdt.py's feature-parallel task (F=11: the feature
    padding over 2 and 4 ranks)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (2 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def sparse_data(n=2000, f=12, seed=11):
    """Mostly-exclusive sparse features (tests/test_gbdt.py's EFB task):
    bundling really merges columns."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, f), np.float32)
    owner = rng.integers(0, f // 4, n)
    for j in range(f):
        rows = owner == (j % (f // 4))
        X[rows, j] = rng.normal(size=rows.sum())
    y = (X.sum(axis=1) + rng.normal(scale=0.3, size=n) > 0).astype(
        np.float32)
    return X, y


def vote_hists(rank, F=12, B=16, seed=5):
    """Rank ``rank``'s local (2, F, B, 3) node histograms for the voting
    pick: every feature's bins hold the same rows (equal per-feature
    totals), gradients signed, hessians and counts positive."""
    rng = np.random.default_rng(seed + 100 * rank)
    h = np.zeros((2, F, B, 3), np.float32)
    rows = rng.integers(0, B, size=(2, F, 300))
    g = rng.normal(size=(2, 300)).astype(np.float32) + 0.3 * rank
    hs = rng.uniform(0.1, 1.0, size=(2, 300)).astype(np.float32)
    for node in range(2):
        for f in range(F):
            for r in range(300):
                b = rows[node, f, r]
                h[node, f, b] += (g[node, r], hs[node, r], 1.0)
    return h


#: the fits of the parallel-modes gangs: name → (BoostingConfig kwargs,
#: data); every fit has its one-process and JAX counterparts in the tests
MODE_FITS = {
    "vote": (dict(parallelism="voting_parallel", top_k=6,
                  num_iterations=8, num_leaves=15), "binary"),
    "vote_all": (dict(parallelism="voting_parallel", top_k=12,
                      num_iterations=4, num_leaves=7), "binary"),
    "dp_lossguide": (dict(growth_policy="lossguide", num_iterations=4,
                          num_leaves=7), "binary"),
    "fp": (dict(parallelism="feature_parallel", num_iterations=8,
                num_leaves=15), "modes"),
    "fp_efb_lossguide": (dict(parallelism="feature_parallel",
                              enable_bundle=True, growth_policy="lossguide",
                              num_iterations=5, num_leaves=15), "sparse"),
    "fp_dart_mono": (dict(parallelism="feature_parallel",
                          boosting_type="dart", drop_rate=0.3, skip_drop=0.2,
                          seed=13, monotone_constraints=[1, -1] + [0] * 9,
                          monotone_constraints_method="intermediate",
                          num_iterations=8, num_leaves=15), "modes"),
}


def mode_data(kind):
    if kind == "binary":
        return binary_data(n=2000)
    if kind == "sparse":
        return sparse_data()
    return modes_data()


def tree_digest(booster, values: bool = True) -> str:
    """md5 of every tree's structure (split features, bins, thresholds,
    children) and, with ``values``, its leaf values (the nodes in use)."""
    h = hashlib.md5()
    for t in booster.trees:
        n = int(t.num_nodes)
        fields = [t.split_feature, t.split_bin, t.threshold, t.left_child,
                  t.right_child] + ([t.leaf_value] if values else [])
        for a in fields:
            h.update(np.ascontiguousarray(np.asarray(a)[:n]).tobytes())
    return h.hexdigest()


def _fit_record(booster, Xh) -> dict:
    t = booster.trees[0]
    return dict(digest=tree_digest(booster),
                splits=tree_digest(booster, values=False),
                num_trees=booster.num_trees,
                first_split=[int(t.split_feature[0]), float(t.threshold[0])],
                split_features=[int(f) for tr in booster.trees
                                for f in tr.split_feature[:int(tr.num_nodes)]],
                margin=[float(v) for v in
                        booster.predict_margin(Xh, device="cpu")])


def gbdt_modes(args):
    """The voting pick on seeded per-rank histograms, the fits of
    ``args["fits"]`` (``MODE_FITS`` names) over this gang, and the
    estimators' ``parallelism`` / ``topK`` / ``numShards`` (2 ranks)."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.models.gbdt.trainer import (GrowthParams,
                                                         _best_split_voting)
    args = args or {}
    dev = args.get("device", "cpu")
    mesh = data_parallel_mesh(device=dev)
    out = {"rank": mesh.rank}
    if args.get("pick", False):
        local = torch.as_tensor(vote_hists(mesh.rank), device=mesh.device)
        tot = C.psum(local[:, 0].sum(dim=1), mesh)           # (2, 3)
        p = GrowthParams(min_data_in_leaf=3.0, total_bins=16, voting_k=3)
        nb = torch.full((12,), 16, dtype=torch.int32, device=mesh.device)
        fm = torch.ones(12, dtype=torch.bool, device=mesh.device)
        res = _best_split_voting(
            local, tot[:, 0], tot[:, 1], tot[:, 2], nb, fm,
            torch.zeros(2, dtype=torch.int32, device=mesh.device), p,
            lambda t: C.psum(t, mesh))
        out["pick"] = [[float(v) for v in r] for r in res]
        out["pick_tot"] = tot.tolist()
    for name in args.get("fits", []):
        kw, kind = MODE_FITS[name]
        X, y = mode_data(kind)
        Xh = X[:512]
        cfg = B.BoostingConfig(objective="binary", min_data_in_leaf=5, **kw)
        booster, _ = B.train(X, y, cfg, mesh=mesh, device=dev)
        out[name] = _fit_record(booster, Xh)
    if args.get("estimators", False):
        from synapseml_tpu_torch.core import Dataset
        from synapseml_tpu_torch.models.gbdt.estimators import (
            GBDTClassifier, GBDTRegressor)
        X, y = binary_data(n=1500)
        ds = Dataset({"features": list(X), "label": y})
        est = {}
        for name, e in (
                ("clf_fp", GBDTClassifier(
                    parallelism="feature_parallel", numShards=0,
                    numIterations=6, numLeaves=15, minDataInLeaf=5,
                    device=dev)),
                ("clf_vote", GBDTClassifier(
                    parallelism="voting_parallel", topK=4, numShards=2,
                    numIterations=6, numLeaves=15, minDataInLeaf=5,
                    device=dev)),
                ("reg_fp_local", GBDTRegressor(
                    parallelism="feature_parallel", numShards=1,
                    numIterations=6, numLeaves=15, minDataInLeaf=5,
                    device=dev))):
            m = e.fit(ds)
            col = "probability" if "clf" in name else "prediction"
            pred = np.stack(m.transform(ds)[col]) if "clf" in name \
                else np.asarray(m.transform(ds)[col])
            pred = pred[:, 1] if pred.ndim == 2 else pred
            est[name] = dict(digest=tree_digest(m.booster),
                             pred=[float(v) for v in pred[:200]],
                             parallelism=m.booster.config.parallelism,
                             top_k=m.booster.config.top_k)
        out["estimators"] = est
    return out


#: tests/test_gbdt.py's ranking task (Q=48 groups of 4-13 rows, F=5)
def rank_task(seed=6, Q=48, F=5):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(4, 14, Q)
    n = int(sizes.sum())
    X = rng.normal(size=(n, F)).astype(np.float32)
    rel = np.clip(X[:, 0] * 2 + rng.normal(scale=0.3, size=n), -2, 2)
    y = np.digitize(rel, [-0.5, 0.5, 1.2]).astype(np.float64)
    return X, y, sizes


RANK_KW = dict(objective="lambdarank", num_iterations=15, num_leaves=7,
               learning_rate=0.2, min_data_in_leaf=3)


def gbdt_rank_modes(args):
    """Distributed lambdarank on this gang: each rank's sharded lambdas
    at seeded scores, the ranker fit in each parallelism mode, and a
    streamed fit (``args["stream"]``: a colstore of the same task with
    the label as its last column) against the in-memory one."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.models.gbdt.ranking import (
        make_lambdarank_objective_sharded, pack_groups_for_shards)
    args = args or {}
    dev = args.get("device", "cpu")
    mesh = data_parallel_mesh(device=dev)
    n_ranks, me = mesh.axis_size(), mesh.rank
    X, y, sizes = rank_task()
    out = {"rank": me}
    perm, sq, smask, L = pack_groups_for_shards(sizes, n_ranks)
    real = perm >= 0
    pc = np.maximum(perm, 0)
    ys = (y[pc] * real).astype(np.float32)[me * L:(me + 1) * L]
    ws = real.astype(np.float32)[me * L:(me + 1) * L]
    scores = np.random.default_rng(3 + me).normal(size=L)
    obj = make_lambdarank_objective_sharded(sq, smask, L, me, device=dev)
    g, h = B._grad_hess(obj, torch.as_tensor(scores, dtype=torch.float32,
                                             device=mesh.device),
                        torch.as_tensor(ys, device=mesh.device),
                        torch.as_tensor(ws, device=mesh.device))
    out["lambdas"] = [g.cpu().tolist(), h.cpu().tolist()]
    for mode in args.get("modes", []):
        cfg = B.BoostingConfig(parallelism=mode, top_k=3, **RANK_KW)
        booster, _ = B.train(X, y, cfg, group=sizes, mesh=mesh, device=dev)
        out[mode] = dict(digest=tree_digest(booster),
                         margin=[float(v) for v in booster.predict_margin(
                             X, device="cpu")])
    if args.get("stream"):
        from synapseml_tpu_torch.io.colstore import ChunkedColumnSource
        cfg = B.BoostingConfig(**RANK_KW)
        src = ChunkedColumnSource(args["stream"], label_col=X.shape[1],
                                  chunk_rows=97)
        booster, _ = B.train(src, None, cfg, group=sizes, mesh=mesh,
                             device=dev)
        out["streamed"] = dict(digest=tree_digest(booster),
                               margin=[float(v) for v in
                                       booster.predict_margin(X,
                                                              device="cpu")])
    return out


def online_data(n=1000, d=16, seed=21):
    """A logistic task for the online learners' mesh (labels +-1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 3] *= 40.0                        # a wide column: normalization
    w = rng.normal(size=d).astype(np.float32)
    y = np.where(x @ w / np.sqrt(d) + rng.normal(scale=0.3, size=n) > 0,
                 1.0, -1.0).astype(np.float32)
    sw = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y, sw


#: the online mesh fits: name → (SGDConfig kwargs, rows, whether rows
#: carry sample weights).  1,000 rows leave rank 1 24 pad rows; "sync4"
#: takes 1,024 rows of weight 1 (each rank's chunks weigh the same: see
#: tests/test_torch_online_mesh.py) and "many_syncs" syncs 140 times
ONLINE_FITS = {
    "sync0": (dict(loss="logistic", batch_size=16, num_passes=2,
                   sync_every_batches=0), 1000, True),
    "sync1": (dict(loss="logistic", batch_size=16, sync_every_batches=1),
              1000, True),
    "sync4": (dict(loss="squared", batch_size=16, sync_every_batches=4,
                   l1=1e-4), 1024, False),
    "many_syncs": (dict(loss="logistic", batch_size=2,
                        sync_every_batches=2), 1120, True),
}


def online_mesh(args):
    """``train_sgd(mesh=...)`` at each sync schedule, and the classifier
    over the mesh → each state as lists."""
    from synapseml_tpu_torch.models.online import sgd as S
    args = args or {}
    dev = args.get("device", "cpu")
    mesh = data_parallel_mesh(device=dev)
    out = {"rank": mesh.rank}
    for name, (kw, n, weighted) in ONLINE_FITS.items():
        x, y, sw = online_data(n)
        state, stats = S.train_sgd(x, y, S.SGDConfig(**kw),
                                   sample_weight=sw if weighted else None,
                                   mesh=mesh, device=dev)
        out[name] = dict(state={k: v.tolist() for k, v in
                                S.state_to_numpy(state).items()},
                         stats=stats)
    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.online import OnlineSGDClassifier
    x, y, _ = online_data()
    ds = Dataset({"features": list(x), "label": (y > 0).astype(np.float32)})
    m = OnlineSGDClassifier(mesh=mesh, batchSize=16, device=dev).fit(ds)
    out["estimator"] = {k: v.tolist() for k, v in
                        S.state_to_numpy(m.state).items()}
    return out


def featpar_card_cpu(args):
    """On a gang sharing the card over gloo: a feature-parallel fit over
    the card and the same fit over the CPU on the same group → their
    split digests and the largest margin difference on 4,096 rows."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    card = data_parallel_mesh(device="cuda")
    host = data_parallel_mesh(device="cpu")
    X, y = modes_data(n=20_000, f=28, seed=3)
    cfg = B.BoostingConfig(objective="binary",
                           parallelism="feature_parallel", num_iterations=4,
                           num_leaves=15, min_data_in_leaf=5)
    from synapseml_tpu_torch.kernels import launches as L
    L.reset()
    bc, _ = B.train(X, y, cfg, mesh=card, device=card.device)
    shapes = {k: v for k, v in L.BY_SHAPE.items()}
    bp, _ = B.train(X, y, cfg, mesh=host, device="cpu")
    diff = np.abs(bc.predict_margin(X[:4096], device="cpu")
                  - bp.predict_margin(X[:4096], device="cpu")).max()
    return dict(card=tree_digest(bc, values=False),
                cpu=tree_digest(bp, values=False), margin_diff=float(diff),
                shapes=shapes)


# -- elastic resume (tests/test_torch_elastic.py) ---------------------------------

def counter_state(seed: int, steps: int) -> int:
    """``elastic_counter``'s final state, computed without a gang."""
    state = int(seed)
    for _ in range(steps):
        state = (state * 6364136223846793005 + 1442695040888963407) \
            % (1 << 63)
    return state


def elastic_counter(args):
    """tests/mp_tasks.py's ``elastic_counter`` on the port: a
    deterministic integer recurrence that checkpoints every step into
    ``SMLTPU_CKPT_DIR/rank<r>`` through the port's CheckpointManager,
    beats the step and passes the ``mp.step`` kill point; a relaunch
    restores the newest step and continues, so the final state equals
    the fault-free one at any world size."""
    import os

    import torch.distributed as dist

    from synapseml_tpu_torch.core.checkpoint import CheckpointManager
    from synapseml_tpu_torch.parallel.heartbeat import beat
    from synapseml_tpu_torch.resilience import get_faults
    args = args or {}
    steps = int(args.get("steps", 8))
    step_sleep_s = float(args.get("step_sleep_s", 0.0))
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    ckpt_dir = os.environ.get("SMLTPU_CKPT_DIR") or args.get("ckpt_dir")
    mgr = (CheckpointManager(os.path.join(ckpt_dir, f"rank{rank}"),
                             max_to_keep=3) if ckpt_dir else None)
    state = np.int64(int(args.get("seed", 1)))
    start = 0
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            state = np.int64(mgr.restore(latest)["state"])
            start = latest + 1
            beat(step=latest)           # the restored durable position
    for step in range(start, steps):
        state = np.int64((int(state) * 6364136223846793005
                          + 1442695040888963407) % (1 << 63))
        if mgr is not None:
            mgr.save(step, {"state": np.asarray(state)})
        beat(step=step)
        get_faults().kill_point("mp.step", step=step, rank=rank)
        if step_sleep_s > 0:
            time.sleep(step_sleep_s)
    return {"rank": rank, "state": int(state), "resumed_from": start,
            "steps_run": steps - start, "world_size": world}


def gbdt_elastic_digest(args):
    """tests/mp_tasks.py's ``gbdt_elastic_digest`` on the port: a
    data-parallel fit over the gang that checkpoints every iteration
    into ``SMLTPU_CKPT_DIR``; → the model string's md5, margins on 8
    rows, the holdout AUC on a fresh draw, and this rank's
    ``gbdt.resize_resume`` notes."""
    import os

    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.models.gbdt.metrics import auc
    from synapseml_tpu_torch.resilience import get_faults
    args = args or {}
    dev = args.get("device", "cpu")
    f = int(args.get("f", 8))
    X, y = binary_data(n=int(args.get("n", 400)), f=f)
    mesh = data_parallel_mesh(device=dev)
    faults = get_faults()
    faults.record_calls = True

    def cfg(iters, codec):
        return B.BoostingConfig(objective="binary", num_iterations=iters,
                                num_leaves=7, min_data_in_leaf=5, max_bin=31,
                                collective_compression=codec)

    ckpt_dir = os.environ.get("SMLTPU_CKPT_DIR") or args.get("ckpt_dir")
    codec = args.get("compression", "none")
    from synapseml_tpu_torch.kernels import launches as L
    L.reset()
    booster, _ = B.train(X, y, cfg(int(args.get("iters", 4)), codec),
                         mesh=mesh, checkpoint_dir=ckpt_dir,
                         checkpoint_interval=1, device=mesh.device)
    launched = {k: L.total(k) for k in ("build_hist_nodes",
                                        "route_and_hist")}
    Xh, yh = binary_data(n=300, f=f, seed=99)
    out = {"rank": mesh.rank, "world_size": mesh.world_size,
           "launches": launched,
           "model_md5": hashlib.md5(
               booster.to_string().encode()).hexdigest(),
           "num_trees": booster.num_trees,
           "margins": [float(m) for m in booster.predict_margin(X[:8])],
           "holdout_auc": float(auc(yh, booster.predict_margin(Xh))),
           "resize_notes": [dict(c) for c in
                            faults.calls_for("gbdt.resize_resume")]}
    toggle = args.get("toggle_codec")
    if toggle is not None:
        # a codec toggle against the same checkpoint still refuses
        try:
            B.train(X, y, cfg(int(args.get("iters", 4)) + 1, toggle),
                    mesh=mesh, checkpoint_dir=ckpt_dir,
                    checkpoint_interval=1, device=mesh.device)
            out["toggle_error"] = None
        except ValueError as e:
            out["toggle_error"] = str(e)
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.parallel import compilecache
    out["compile_cache_env"] = os.environ.get(compilecache.COMPILE_CACHE_ENV)
    out["compile_cache_dir"] = compilecache.compilation_cache_dir()
    out["build_dir"] = str(_build.build_dir())
    from synapseml_tpu_torch.telemetry import tunetable
    out["tune_table_env"] = os.environ.get(tunetable.TUNE_TABLE_ENV)
    out["tune_plane_dir"] = tunetable.get_tuneplane().directory
    return out


def kernel_cache_probe(args):
    """Build (or find) every kernel library through the gang's build
    cache → the build directory and this process's hits and misses."""
    from synapseml_tpu_torch.kernels import _build
    from synapseml_tpu_torch.parallel.compilecache import cache_stats
    t0 = time.perf_counter()
    _build.build_all()
    return {"build_dir": str(_build.build_dir()),
            "build_s": time.perf_counter() - t0, **cache_stats()}


def distributed_serving_roundtrip(args):
    """tests/mp_tasks.py's task on the port: each rank starts a
    ``DistributedServingServer`` with an echo loop; rank 0 routes one
    request to EVERY rank through the gathered routing table.  Also
    gathers a second table of made-up addresses at or above 128.0.0.0
    (one role a rank) through ``exchange_routing_table`` under a
    timeout, times the first gather, and shows a wedged gather raising
    ``CollectiveTimeout`` at its timeout."""
    import json
    import threading
    import urllib.request

    from synapseml_tpu_torch.serving import (DistributedServingServer,
                                             ServingReply,
                                             exchange_routing_table)

    device = args.get("device", "cuda")
    mesh = data_parallel_mesh(device=device)
    rank = mesh.rank
    t0 = time.perf_counter()
    srv = DistributedServingServer(device=device,
                                   gather_timeout_s=60.0,
                                   role="prefill" if rank == 1 else "decode")
    gather_s = time.perf_counter() - t0
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            for req in srv.get_batch(max_rows=8, timeout_s=0.05):
                srv.reply(req.id, ServingReply(200, json.dumps(
                    {"rank": rank, "echo": req.json()["x"]}).encode()))

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    C.barrier(None, mesh)                # every rank's listener is up
    results = []
    if rank == 0:
        for r in range(len(srv.routing_table)):
            body = json.dumps({"x": r * 10}).encode()
            rep = urllib.request.urlopen(urllib.request.Request(
                srv.url_for_rank(r), data=body), timeout=10).read()
            results.append(json.loads(rep))
    C.barrier(None, mesh)                # replies done before any closes
    stop.set()
    t.join(timeout=5)
    srv.close()
    fake = (f"{200 + rank}.{rank}.255.{128 + rank}", 40000 + rank)
    table, roles = exchange_routing_table(*fake, timeout_s=60.0,
                                          role=rank % 2, device=device)
    # a gather whose dispatch wedges (a lost peer's shape) is bounded by
    # its timeout: the hang fires before the collective starts, so the
    # group stays usable
    from synapseml_tpu_torch.parallel import CollectiveTimeout
    from synapseml_tpu_torch.resilience import get_faults
    get_faults().inject("collective.dispatch", "hang", times=1)
    try:
        exchange_routing_table(*fake, timeout_s=0.3, device=device)
        timed_out = False
    except CollectiveTimeout:
        timed_out = True
    finally:
        get_faults().clear()
    C.barrier(None, mesh)
    return {"rank": rank, "router": srv.router.name,
            "table": [[h, p] for h, p in srv.routing_table],
            "roles": srv.routing_roles, "results": results,
            "fake_table": [[h, p] for h, p in table], "fake_roles": roles,
            "gather_s": gather_s, "timed_out": timed_out}


def llm_serving_gang(args):
    """Phase 27b of chip_smoke.py on this rank (the LLM servers behind a
    router over the gathered table; see ``chip_smoke.phase27_gang``)."""
    import chip_smoke
    return chip_smoke.phase27_gang(args)


# -- DL training over the gang (tests/test_torch_dl_mesh*.py) ---------------------

def _dl_mesh(dev, ep=1, tp=1):
    from synapseml_tpu_torch.parallel.mesh import dp_ep_mesh, dp_tp_mesh
    if tp > 1:
        return dp_tp_mesh(tp, device=dev)
    return dp_ep_mesh(ep, device=dev) if ep > 1 else \
        data_parallel_mesh(device=dev)


def _text_cfg(spec):
    """The tiny text config with ``spec``'s fields (``dtype`` a torch
    dtype's name; f32 unless it says otherwise)."""
    import dataclasses

    from synapseml_tpu_torch.models.dl import transformer as PT
    spec = dict(spec)
    spec["dtype"] = getattr(torch, spec.pop("dtype", "float32"))
    return dataclasses.replace(PT.TransformerConfig.tiny(), **spec)


def _load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _save_npz(path, tree):
    np.savez(path, **{k: np.asarray(v) for k, v in tree.items()})


def _trainer_run(case, mesh, dev):
    """One trainer case over ``mesh`` (None: this process alone): the
    model from ``case["init"]`` (a full state dict), ``case["steps"]``
    steps on the global batches of ``case["batches"]`` (this rank's rows
    of each) → losses, this rank's moment bytes, and the whole model's
    final state (rank 0 writes it to ``case["out"]``)."""
    from synapseml_tpu_torch.models.dl import resnet as PR
    from synapseml_tpu_torch.models.dl import training as PTr
    from synapseml_tpu_torch.models.dl import transformer as PT
    from synapseml_tpu_torch.parallel.compression import CollectiveConfig
    init = _load_npz(case["init"])
    batches = _load_npz(case["batches"])
    opt = PTr.OptimizerConfig(**case["opt"])
    cc = case.get("collective")
    cc = CollectiveConfig(**cc) if cc else None
    if case["model"] == "text":
        model = PT.TextEncoder(_text_cfg(case["cfg"]), device=dev, seed=None,
                               mesh=mesh)
        kw = {}
    else:
        model = PR.make_backbone(case["model"], num_classes=case["classes"],
                                 dtype=torch.float32, device=dev, seed=None,
                                 mesh=mesh)
        kw = dict(has_batch_stats=True, train_kwarg="train")
    tr = PTr.DLTrainer(model, opt, dev, mesh=mesh,
                       zero1=bool(case.get("zero1")), collective=cc,
                       precision=case.get("precision"), **kw)
    state = tr.init_state(123)
    sd = {k: torch.from_numpy(v) for k, v in init.items()}
    if hasattr(model, "load_full_state_dict"):
        model.load_full_state_dict(sd)
    else:
        model.load_state_dict(sd)
    step = tr.train_step()
    losses, dropped = [], []
    moe = [m for m in model.modules() if hasattr(m, "dropped")]
    n_steps = int(case["steps"])
    for i in range(n_steps):
        j = i % int(batches["n"])
        arrays = [batches[f"{j}_{k}"] for k in case["inputs"]]
        labels = batches[f"{j}_labels"]
        rows = tr.local_rows(np.arange(len(labels)))
        state, m = step(state, tr.shard_batch([a[rows] for a in arrays]),
                        tr.shard_batch([labels[rows]])[0], 0)
        losses.append(float(m["loss"]))
        dropped += [float(f.dropped) for f in moe]
    full = PTr._host
    sd = (model.full_state_dict() if hasattr(model, "full_state_dict")
          else model.state_dict())
    if (mesh is None or mesh.rank == 0) and case.get("out"):
        _save_npz(case["out"], {k: full(v) for k, v in sd.items()})
    return {"losses": losses, "dropped": dropped,
            "moment_bytes": state.opt.moment_bytes(),
            "residual_bytes": sum(r.numel() * 4 for r in state.residuals)
            if state.residuals is not None else 0}


def dl_mesh_cases(args):
    """Run every trainer case of ``args["cases"]`` on this gang (each on
    its own mesh: ``ep`` > 1 builds the (data, expert) mesh, ``tp`` > 1
    the (data, model) mesh) → per case, :func:`_trainer_run`'s record."""
    dev = args.get("device", "cpu")
    if dev == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, case in args["cases"].items():
        mesh = _dl_mesh(dev, int(case.get("ep", 1)), int(case.get("tp", 1)))
        out[name] = _trainer_run(case, mesh, mesh.device)
    return out


def moe_mesh_grads(args):
    """A lone MoE FFN on the (data, expert) mesh: this rank's rows of the
    global ``x`` through the layer, objective ``Σ out·w + aux`` of the
    rows, backward.  Rank ``r`` writes ``args["out"]/rank<r>.npz``: its
    output rows and their input gradient, the router gradient and its
    experts' gradients summed over ``data`` (the global objective's
    gradients), and the aux loss and dropped share."""
    import os

    from synapseml_tpu_torch.models.dl.moe import MoEFFN
    from synapseml_tpu_torch.parallel.mesh import DATA_AXIS
    dev = args.get("device", "cpu")
    mesh = _dl_mesh(dev, int(args["ep"]))
    res = {}
    for name, case in args["cases"].items():
        z = _load_npz(case["data"])
        E, D, FF = z["w_up"].shape
        m = MoEFFN(E, D, FF, top_k=int(case["top_k"]),
                   capacity_factor=float(case["cf"]), dtype=torch.float32,
                   device=mesh.device, mesh=mesh)
        lo = m.expert_lo
        with torch.no_grad():
            m.router.copy_(torch.from_numpy(z["router"]))
            m.w_up.copy_(torch.from_numpy(z["w_up"][lo:lo + m.local_experts]))
            m.w_down.copy_(torch.from_numpy(
                z["w_down"][lo:lo + m.local_experts]))
        B = z["x"].shape[0]
        d, n = mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS)
        rows = slice(d * B // n, (d + 1) * B // n)
        x = torch.from_numpy(z["x"][rows]).requires_grad_(True)
        w = torch.from_numpy(z["w"][rows])
        out = m(x, rows=(rows.start, B))
        ((out * w).sum() + m.aux_loss).backward()
        grads = {k: C.psum(getattr(m, k).grad, mesh, DATA_AXIS)
                 for k in ("router", "w_up", "w_down")}
        path = os.path.join(case["out"], f"rank{mesh.rank}.npz")
        _save_npz(path, {"out": out.detach().numpy(),
                         "x_grad": x.grad.numpy(),
                         "aux": m.aux_loss.detach().numpy(),
                         "dropped": m.dropped.numpy(),
                         "rows": np.asarray([rows.start, rows.stop]),
                         "expert_lo": np.asarray(lo),
                         **{f"g_{k}": v.numpy() for k, v in grads.items()}})
        res[name] = path
    return {"rank": mesh.rank, "files": res}


def bn_mesh_grads(args):
    """A ResNet on the data mesh in training mode: this rank's rows
    forward (BatchNorm over the global batch), objective ``Σ logits·w``
    of the rows, backward.  Rank ``r`` writes ``args["out"]``'s
    ``rank<r>.npz``: its logits and input gradient, every parameter's
    gradient summed over ``data`` and the new running statistics."""
    import os

    from synapseml_tpu_torch.models.dl import resnet as PR
    from synapseml_tpu_torch.parallel.mesh import DATA_AXIS
    dev = args.get("device", "cpu")
    if dev == "cuda":
        # IEEE f32 convolutions, to hold the card against the CPU
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = _dl_mesh(dev)
    z = _load_npz(args["data"])
    model = PR.make_backbone(args["backbone"], num_classes=args["classes"],
                             dtype=torch.float32, device=mesh.device,
                             seed=None, mesh=mesh)
    model.load_state_dict({k[5:]: torch.from_numpy(v) for k, v in z.items()
                           if k.startswith("init.")})
    B = z["x"].shape[0]
    d, n = mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS)
    rows = slice(d * B // n, (d + 1) * B // n)
    x = torch.from_numpy(z["x"][rows]).to(mesh.device).requires_grad_(True)
    logits = model(x, train=True)
    (logits * torch.from_numpy(z["w"][rows]).to(mesh.device)).sum() \
        .backward()
    model.commit_batch_stats()
    rec = {"logits": logits.detach(), "x_grad": x.grad}
    for k, p in model.named_parameters():
        rec[f"g.{k}"] = C.psum(p.grad, mesh, DATA_AXIS)
    for k, b in model.named_buffers():
        rec[f"s.{k}"] = b
    path = os.path.join(args["out"], f"rank{mesh.rank}.npz")
    _save_npz(path, {k: v.detach().cpu().numpy() for k, v in rec.items()})
    return {"rank": mesh.rank, "file": path}


def dl_fit(args):
    """``DeepTextClassifier`` / ``DeepVisionClassifier`` over the gang
    (``numDevices=0``) with ``args["kw"]``, from the initial weights of
    ``args["init"]`` when given (each rank loads its slice), with step
    checkpoints in ``SMLTPU_CKPT_DIR`` (or ``args["ckpt"]``) when set →
    the history, the probabilities on the fit's rows, the
    ``dl.resize_resume`` notes, and a codec toggle's refusal."""
    import os

    from synapseml_tpu_torch.core import Dataset
    from synapseml_tpu_torch.models.dl import estimators as PE
    from synapseml_tpu_torch.models.dl import training as PTr
    from synapseml_tpu_torch.resilience import get_faults
    import torch.distributed as dist
    faults = get_faults()
    faults.record_calls = True
    kind = args["kind"]
    data = _load_npz(args["data"])
    if kind == "text":
        ds = Dataset({"text": [str(t) for t in data["text"]],
                      "label": data["label"]})
        cls = PE.DeepTextClassifier
    else:
        ds = Dataset({"image": list(data["image"]), "label": data["label"]})
        cls = PE.DeepVisionClassifier
    if args.get("init"):
        init = {k: torch.from_numpy(v)
                for k, v in _load_npz(args["init"]).items()}
        orig = PTr.DLTrainer.init_state

        def carry(self, seed):
            state = orig(self, seed)
            m = self.model
            (m.load_full_state_dict if hasattr(m, "load_full_state_dict")
             else m.load_state_dict)(init)
            return state

        PTr.DLTrainer.init_state = carry
    kw = dict(args["kw"])
    cc = kw.pop("collective", None)
    if cc is not None:
        from synapseml_tpu_torch.parallel.compression import CollectiveConfig
        kw["collectiveCompression"] = CollectiveConfig(**cc)
    ckpt = os.environ.get("SMLTPU_CKPT_DIR") or args.get("ckpt")
    if ckpt:
        kw.update(checkpointDir=ckpt, checkpointInterval=1)
    if args.get("profile"):
        from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
        kw["stepProfiler"] = StepProfiler(f"dl{dist.get_rank()}",
                                          capture_xla=True)
    try:
        model = cls(device=args.get("device", "cpu"), **kw).fit(ds)
    finally:
        if args.get("init"):
            PTr.DLTrainer.init_state = orig
    variables = model.modelPayload["variables"]
    if args.get("out") and dist.get_rank() == 0:
        _save_npz(args["out"], variables)
    digest = hashlib.md5()
    for k in sorted(variables):
        digest.update(np.ascontiguousarray(variables[k]).tobytes())
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "variables_md5": digest.hexdigest(),
           "history": model.modelPayload["history"],
           "proba": np.stack(list(model.transform(ds)["probability"]))
           .tolist(),
           "resize_notes": [dict(c) for c in
                            faults.calls_for("dl.resize_resume")]}
    if args.get("profile"):
        cost = kw["stepProfiler"].costs
        out["costs"] = {k: (None if v is None else
                            {m: v[m] for m in ("flops", "bytes_accessed")})
                        for k, v in cost.items()}
    if args.get("toggle") and ckpt:
        try:
            cls(device=args.get("device", "cpu"),
                **{**kw, "collectiveCompression": args["toggle"],
                   "maxEpochs": kw["maxEpochs"] + 1}).fit(ds)
            out["toggle_error"] = None
        except ValueError as e:
            out["toggle_error"] = str(e)
    return out


def gbdt_capture(args):
    """A data-parallel GBDT fit over the gang with and without the step
    profiler's cost capture → the two model strings' md5s and the
    captured cost (the same on every rank)."""
    from synapseml_tpu_torch.models.gbdt import booster as B
    from synapseml_tpu_torch.telemetry.gangplane import StepProfiler
    dev = args.get("device", "cpu")
    X, y = binary_data(n=int(args.get("n", 600)), f=8)
    mesh = data_parallel_mesh(device=dev)
    cfg = B.BoostingConfig(objective="binary", num_iterations=3,
                           num_leaves=7, min_data_in_leaf=5, max_bin=31)
    plain, _ = B.train(X, y, cfg, mesh=mesh, device=mesh.device)
    prof = StepProfiler(f"gbdt{mesh.rank}", capture_xla=True)
    captured, _ = B.train(X, y, cfg, mesh=mesh, device=mesh.device,
                          step_profiler=prof)
    cost = prof.costs.get("gbdt_step")
    return {"rank": mesh.rank,
            "plain": hashlib.md5(plain.to_string().encode()).hexdigest(),
            "captured": hashlib.md5(
                captured.to_string().encode()).hexdigest(),
            "cost": None if cost is None else
            {k: cost[k] for k in ("flops", "bytes_accessed")}}


def run_many(args):
    """Run ``args["tasks"]`` (``[name, task_args]`` pairs of this
    module's tasks) in order in this gang → their results, so one gang
    start serves several checks."""
    return [globals()[name](dict(task_args, device=args.get("device", "cpu")))
            for name, task_args in args["tasks"]]


# -- model parallelism over the gang (tests/test_torch_*_tp.py, ring, pipe) ----

def tp_grads(args):
    """One forward/backward of the tiny encoder over a (data, model) mesh
    from the whole weights of ``args["init"]`` on this rank's rows of
    ``args["batch"]`` → the largest difference of each replicated
    leaf's gradient between the ``model`` ranks, the whole gradients
    (sharded leaves gathered, summed over ``data``; rank 0 writes them
    to ``args["out"]``) and the clip's global norm as the trainer's hook
    completes it from this rank's leaves."""
    from synapseml_tpu_torch.models.dl import training as PTr
    from synapseml_tpu_torch.models.dl import transformer as PT
    from synapseml_tpu_torch.parallel.mesh import MODEL_AXIS
    dev = args.get("device", "cpu")
    mesh = _dl_mesh(dev, tp=int(args["tp"]))
    cfg = _text_cfg(args["cfg"])
    model = PT.TextEncoder(cfg, device=mesh.device, seed=None, mesh=mesh)
    model.load_full_state_dict({k: torch.from_numpy(v) for k, v in
                                _load_npz(args["init"]).items()})
    z = _load_npz(args["batch"])
    tr = PTr.DLTrainer(model, PTr.OptimizerConfig(grad_clip_norm=1.0),
                       mesh.device, mesh=mesh)
    state = tr.init_state(0)
    model.load_full_state_dict({k: torch.from_numpy(v) for k, v in
                                _load_npz(args["init"]).items()})
    rows = tr.local_rows(np.arange(len(z["labels"])))
    ids, mask, labels = tr.shard_batch([z["ids"][rows], z["mask"][rows],
                                        z["labels"][rows]])
    B = len(rows)
    kw = {}
    if tr.data_size > 1:
        kw["rows"] = (tr.data_index * B, tr.data_size * B)
    logits = model(ids, mask, **kw)
    loss = PTr.softmax_cross_entropy(logits, labels) / tr.data_size
    loss.backward()
    specs = model.shard_specs()
    replicated_gap = 0.0
    for k, p in model.named_parameters():
        if k not in specs:
            every = C.all_gather(p.grad, mesh, MODEL_AXIS)
            replicated_gap = max(replicated_gap, float(
                (every - every[0]).abs().max()))
    grads = {k: p.grad for k, p in model.named_parameters()}
    if tr.data_size > 1:
        grads = {k: C.psum(g, mesh, DATA_AXIS) for k, g in grads.items()}
    whole = PT.gather_full(grads, specs, mesh)
    sums = list(torch._foreach_norm(torch._foreach_mul(
        list(grads.values()), list(grads.values())), 1))
    norm = float(torch.sqrt(torch.stack(state.opt.leaf_sums(sums)).sum()))
    if mesh.rank == 0:
        _save_npz(args["out"], {k: v.detach().numpy()
                                for k, v in whole.items()})
    return {"rank": mesh.rank, "replicated_gap": replicated_gap,
            "norm": norm, "n_sharded": len(specs)}


def llm_tp(args):
    """The tiny Llama over a ``model`` axis of every rank from the whole
    state dicts of ``args["states"]`` (name → npz path, with the config
    fields in ``args["cfgs"]``): each model's logits on ``args["ids"]``,
    and with ``generate`` set, its greedy tokens → rank 0 writes
    ``args["out"]``; every rank returns its tokens' digest."""
    from synapseml_tpu_torch.models import llm as P
    from synapseml_tpu_torch.parallel.mesh import MODEL_AXIS
    dev = args.get("device", "cpu")
    mesh = ProcessMesh({MODEL_AXIS: -1}, device=dev)
    ids = torch.as_tensor(np.asarray(args["ids"], np.int32),
                          device=mesh.device)
    out, digests = {}, {}
    for name, path in args["states"].items():
        spec = dict(args["cfgs"][name])
        dtype = getattr(torch, spec.pop("dtype"))
        cfg = P.LlamaConfig.tiny(dtype=dtype, **spec)
        model = P.LlamaModel(cfg, device=mesh.device, mesh=mesh)
        sd = {k: torch.from_numpy(v) for k, v in _load_npz(path).items()}
        model.load_full_state_dict(sd)
        with torch.no_grad():
            out[f"{name}.logits"] = model(ids).cpu().numpy()
        out[f"{name}.kv_heads"] = np.asarray(model.layers[0].attn.kv_heads)
        if args.get("generate"):
            toks = P.generate(model, np.asarray(args["prompt"], np.int32),
                              max_new_tokens=int(args["new"]))
            out[f"{name}.tokens"] = toks
            digests[name] = _digest(torch.from_numpy(toks))
    if mesh.rank == 0:
        _save_npz(args["out"], out)
    return {"rank": mesh.rank, "digests": digests}


def ring_cases(args):
    """Ring attention over a (data, seq) mesh of every rank: per case of
    ``args["cases"]`` (an npz of global ``q``, ``k``, ``v``, ``mask`` and
    the loss weights ``w``) this rank's block through ``ring_attention``,
    the loss ``Σ out·w`` of the block and its backward; the blocks of the
    output and of the q/k/v gradients all-gathered → rank 0 writes them
    to the case's ``out``.  ``args["encoder"]``: the tiny encoder with
    ``use_ring_attention`` from whole weights, its embeddings and logits
    on the rank's block (gathered the same way)."""
    from synapseml_tpu_torch.models.dl import transformer as PT
    from synapseml_tpu_torch.models.dl.ring_attention import (ring_attention,
                                                              shard_blocks)
    from synapseml_tpu_torch.parallel.mesh import SEQ_AXIS
    dev = args.get("device", "cpu")
    mesh = ProcessMesh({DATA_AXIS: int(args["data"]), SEQ_AXIS: -1},
                       device=dev)

    def gather(t):
        # (B_l, S_l, ...) blocks → the global (B, S, ...) on every rank
        t = C.all_gather(t.contiguous(), mesh, SEQ_AXIS)
        t = torch.cat(list(t.unbind(0)), dim=1)
        t = C.all_gather(t.contiguous(), mesh, DATA_AXIS)
        return torch.cat(list(t.unbind(0)), dim=0)

    res = {}
    for name, case in args["cases"].items():
        z = _load_npz(case["data"])
        q, k, v = [shard_blocks(z[n], mesh).requires_grad_(True)
                   for n in ("q", "k", "v")]
        mask = shard_blocks(z["mask"], mesh)
        w = shard_blocks(z["w"], mesh)
        out = ring_attention(q, k, v, mask, mesh)
        (out * w).sum().backward()
        rec = {"out": gather(out.detach()), "dq": gather(q.grad),
               "dk": gather(k.grad), "dv": gather(v.grad)}
        if mesh.rank == 0:
            _save_npz(case["out"], {n: t.numpy() for n, t in rec.items()})
        res[name] = case["out"]
    enc = args.get("encoder")
    if enc:
        # the ring alone, then the ring over (data, seq, model) with the
        # weights sharded over model as well
        from synapseml_tpu_torch.parallel.mesh import dp_sp_tp_mesh
        cfg = _text_cfg(dict(enc["cfg"], use_ring_attention=True))
        z = _load_npz(enc["batch"])
        whole = {k: torch.from_numpy(v) for k, v in
                 _load_npz(enc["init"]).items()}
        for name, m in (("encoder", mesh),
                        ("encoder_tp", dp_sp_tp_mesh(
                            mesh.axis_size(SEQ_AXIS) // 2, 2, device=dev))):
            model = PT.TextEncoder(cfg, device=m.device, seed=None, mesh=m)
            model.load_full_state_dict(whole)
            ids, mask = shard_blocks(z["ids"], m), shard_blocks(z["mask"], m)
            with torch.no_grad():
                emb = model(ids, mask, return_embeddings=True)
                logits = model(ids, mask)
            parts = C.all_gather(emb.contiguous(), m, SEQ_AXIS)
            emb = torch.cat(list(parts.unbind(0)), dim=1)
            emb = torch.cat(list(C.all_gather(emb.contiguous(), m,
                                              DATA_AXIS).unbind(0)))
            logits = torch.cat(list(C.all_gather(logits, m,
                                                 DATA_AXIS).unbind(0)))
            out_path = enc["out"].replace("enc_out", f"{name}_out")
            if m.rank == 0:
                _save_npz(out_path, {"emb": emb.numpy(),
                                     "logits": logits.numpy()})
            res[name] = out_path
    return {"rank": mesh.rank, "files": res}


def _mlp_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_cases(args):
    """The GPipe schedule over every rank: per case of ``args["cases"]``
    (``mesh``: axis sizes; an npz of stacked ``w``/``b``, microbatches
    ``x`` and, for a loss, targets ``y``) the MLP stages' outputs or the
    loss and this rank's stage gradients; ``args["encoder"]``: the
    pipelined text encoder's loss and gradients from whole weights →
    rank 0 writes each case's ``out`` (stage gradients gathered over
    ``pipe``); every rank returns its losses."""
    from synapseml_tpu_torch.models.dl import pipeline as PP
    from synapseml_tpu_torch.models.dl import transformer as PT
    from synapseml_tpu_torch.parallel import pipeline as PL
    from synapseml_tpu_torch.parallel.mesh import PIPE_AXIS
    dev = args.get("device", "cpu")
    res = {}
    for name, case in args["cases"].items():
        mesh = ProcessMesh(dict(case["mesh"]), device=dev)
        z = _load_npz(case["data"])
        stacked = {n: torch.from_numpy(z[n]).to(mesh.device)
                   for n in ("w", "b")}
        local = {n: t.clone().requires_grad_(True) for n, t in
                 PL.local_stage(stacked, mesh).items()}
        x = torch.from_numpy(z["x"]).to(mesh.device)
        if case.get("shard_x"):
            d, n = mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS)
            per = x.shape[1] // n
            x = x[:, d * per:(d + 1) * per]
        rec = {}
        if "y" in z:
            y = torch.from_numpy(z["y"]).to(mesh.device)
            loss = PL.pipeline_loss(_mlp_stage, local, x,
                                    lambda out: ((out - y) ** 2).mean(),
                                    mesh)
            loss.backward()
            for n, t in local.items():
                g = C.all_gather(t.grad, mesh, PIPE_AXIS)
                rec[f"g_{n}"] = torch.cat(list(g.unbind(0)))
            res[name] = float(loss)
        else:
            out = PL.pipeline_apply(_mlp_stage, local, x, mesh)
            if case.get("shard_x"):
                out = torch.cat(list(C.all_gather(
                    out.contiguous(), mesh, DATA_AXIS).unbind(0)), dim=1)
            rec["out"] = out
        if mesh.rank == 0:
            _save_npz(case["out"], {n: t.detach().numpy()
                                    for n, t in rec.items()})
    enc = args.get("encoder")
    if enc:
        mesh = ProcessMesh(dict(enc["mesh"]), device=dev)
        cfg = _text_cfg(enc["cfg"])
        whole = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in _load_npz(enc["init"]).items()}
        outer, stacked = PP.split_encoder_stages(whole, mesh.axis_size(
            PIPE_AXIS))
        outer = {k: v.clone().requires_grad_(True) for k, v in outer.items()}
        local = {k: v.clone().requires_grad_(True) for k, v in
                 PL.local_stage(stacked, mesh).items()}
        z = _load_npz(enc["batch"])
        d, n = mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS)
        per = len(z["labels"]) // n
        rows = slice(d * per, (d + 1) * per)
        ids, mask, labels = [torch.from_numpy(z[k][rows]).to(mesh.device)
                             for k in ("ids", "mask", "labels")]
        loss_fn = PP.pp_train_loss(cfg, mesh, int(enc["microbatches"]))
        loss = loss_fn(outer, local, ids, mask, labels)
        loss.backward()
        rec = {f"outer.{k}": v.grad for k, v in outer.items()}
        for k, v in local.items():
            g = C.all_gather(v.grad, mesh, PIPE_AXIS)
            rec[f"stacked.{k}"] = torch.cat(list(g.unbind(0)))
        rec["loss"] = loss.detach()
        if mesh.rank == 0:
            _save_npz(enc["out"], {k: t.detach().numpy()
                                   for k, t in rec.items()})
        res["encoder"] = float(loss)
    import torch.distributed as dist
    return {"rank": dist.get_rank(), "losses": res}


def bert_tp_import(args):
    """An HF BERT checkpoint (``args["hf"]``, a flat npz) imported into
    the tiny f32 encoder over a ``model`` axis of every rank: the whole
    state gathered, ``import_bert`` spliced into it, this rank's shard
    loaded → rank ``r`` writes its local state dict to
    ``args["out"]/rank<r>.npz``; returns its shard specs."""
    import os

    from synapseml_tpu_torch.models.dl import transformer as PT
    from synapseml_tpu_torch.models.dl.checkpoints import import_bert
    dev = args.get("device", "cpu")
    mesh = _dl_mesh(dev, tp=int(args["tp"]))
    cfg = _text_cfg(args["cfg"])
    model = PT.TextEncoder(cfg, device=mesh.device, seed=0, mesh=mesh)
    hf = _load_npz(args["hf"])
    model.load_full_state_dict(import_bert(model.full_state_dict(), hf,
                                           num_layers=cfg.num_layers))
    _save_npz(os.path.join(args["out"], f"rank{mesh.rank}.npz"),
              {k: v.detach().cpu().numpy()
               for k, v in model.state_dict().items()})
    return {"rank": mesh.rank, "model_index": mesh.axis_index("model"),
            "specs": {k: [list(s) for s in v]
                      for k, v in model.shard_specs().items()}}



class OneRankOf:
    """The mesh interface a model's layout reads (axis sizes and this
    rank's index on each), for one rank, without a process group:
    ``OneRankOf(model=(2, 1))`` is rank 1 of a model axis of 2."""

    def __init__(self, **axes):
        self.shape = {k: v[0] for k, v in axes.items()}
        self._index = {k: v[1] for k, v in axes.items()}

    def axis_size(self, axis):
        return self.shape[axis]

    def axis_index(self, axis):
        return self._index[axis]
