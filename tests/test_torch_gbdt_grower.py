"""The port's depthwise grower held against the JAX package's, with the JAX
grower on its Pallas kernels in interpret mode on the CPU.

Both growers quantize gradients to the same int8 limbs and sum them
exactly, reconstruct with the same f32 operations, and take prefix sums
in the same pairwise order (the port reproduces ``lax.associative_scan``).
The node's total is the one sum whose order differs (XLA's reduction
against the port's pairwise scan), so split choices can only differ on a
near-exact tie: routing and tree structure compare exactly, leaf and node
values to 1e-4 (the tolerance the JAX package holds its own two growers
to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.models.gbdt import trainer as jt
from synapseml_tpu_torch.models.gbdt import trainer as tt
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _setup(seed, N, F, B, masked=False):
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, B, (F, N)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    hess = (np.abs(grad) * 0.5 + 0.2).astype(np.float32)
    rv = np.ones(N, np.float32)
    fmask = np.ones(F, bool)
    if masked:
        rv = (rng.random(N) < 0.9).astype(np.float32)
        fmask[[1, 4]] = False
    ub = np.sort(rng.normal(size=(F, B - 1)).astype(np.float32), axis=1)
    nb = rng.integers(B // 2, B + 1, F).astype(np.int32)
    return bins_t, grad, hess, rv, fmask, ub, nb


CASES = {
    # tests/test_gbdt.py's interpret-parity setup: the 5th wave fills the
    # 31-leaf budget and takes the route-only shortcut
    "plain_route_only": (dict(N=8192, F=9, B=64), dict(
        num_leaves=31, min_data_in_leaf=5.0, total_bins=64), False, False),
    # tests/test_gbdt_two_level.py's setup: coarse fused + fine-K refine
    "two_level": (dict(N=8192, F=9, B=256), dict(
        num_leaves=31, min_data_in_leaf=5.0, total_bins=256,
        two_level="on", refine_k=4), False, False),
    # bf16 ingest, masked rows and features, L1/L2, a depth cap
    "bf16_masked_regularized": (dict(N=6000, F=9, B=64, masked=True), dict(
        num_leaves=20, min_data_in_leaf=10.0, total_bins=64, lambda_l1=0.5,
        lambda_l2=1.0, max_depth=4), True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grower_matches_jax_interpret(case):
    shape, pkw, bf16, masked = CASES[case]
    shape = dict(shape)
    shape.pop("masked", None)
    bins_t, grad, hess, rv, fmask, ub, nb = _setup(5, **shape,
                                                   masked=masked)
    S = jt.default_n_slots(pkw["num_leaves"])
    jg, jh_ = jnp.asarray(grad), jnp.asarray(hess)
    tg, th_ = torch.from_numpy(grad), torch.from_numpy(hess)
    if bf16:
        jg, jh_ = jg.astype(jnp.bfloat16), jh_.astype(jnp.bfloat16)
        tg, th_ = tg.to(torch.bfloat16), th_.to(torch.bfloat16)
    # the Pallas kernels take whole chunks: the JAX side gets zero-weight
    # pad rows, as its train() pads them, while the port's kernels take
    # the ragged row count as it is
    N = bins_t.shape[1]
    pad = (-N) % 8192
    t_j, nid_j = jt.grow_tree_depthwise(
        jnp.pad(jnp.asarray(bins_t), ((0, 0), (0, pad))),
        jnp.pad(jg, (0, pad)), jnp.pad(jh_, (0, pad)),
        jnp.pad(jnp.asarray(rv), (0, pad)), jnp.asarray(fmask),
        jnp.asarray(ub), jnp.asarray(nb), 0.1, p=jt.GrowthParams(**pkw),
        use_pallas="interpret", n_slots=S)
    nid_j = np.asarray(nid_j)[:N]
    t_t, nid_t = tt.grow_tree_depthwise(
        torch.from_numpy(bins_t), tg, th_, torch.from_numpy(rv),
        torch.from_numpy(fmask), torch.from_numpy(ub), torch.from_numpy(nb),
        0.1, tt.GrowthParams(**pkw), n_slots=S)
    n = int(t_j.num_nodes)
    assert int(t_t.num_nodes) == n and n > 1
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_j))
    for f in ("split_feature", "split_bin", "left_child", "right_child",
              "threshold", "default_left", "missing_zero"):
        np.testing.assert_array_equal(getattr(t_t, f).numpy()[:n],
                                      np.asarray(getattr(t_j, f))[:n],
                                      err_msg=f)
    for f in ("leaf_value", "node_value", "node_count", "split_gain"):
        np.testing.assert_allclose(getattr(t_t, f).numpy()[:n],
                                   np.asarray(getattr(t_j, f))[:n],
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_prefix_sum_matches_associative_scan():
    """Bit-identical to ``lax.associative_scan(jnp.add, ...)`` at every
    length the growers use, odd ones included."""
    from jax import lax
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 32, 63, 64, 255, 256):
        x = (rng.normal(size=(3, 5, n))
             * rng.uniform(0.1, 1e4, (3, 5, 1))).astype(np.float32)
        j = np.asarray(lax.associative_scan(jnp.add, jnp.asarray(x),
                                            axis=-1))
        np.testing.assert_array_equal(tt._prefix_sum(torch.from_numpy(x))
                                      .numpy(), j)


def test_topk_ties_go_to_lower_index():
    from jax import lax
    x = np.array([1.0, 3.0, -np.inf, 3.0, 2.0, -np.inf, 3.0, -np.inf],
                 np.float32)
    jv, ji = lax.top_k(jnp.asarray(x), 6)
    tv, ti = tt._topk_index(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_predict_raw_features_matches_jax():
    """Traversal of grown trees on raw features, NaN rows included."""
    bins_t, grad, hess, rv, fmask, ub, nb = _setup(7, N=4096, F=6, B=64)
    p = tt.GrowthParams(num_leaves=15, min_data_in_leaf=5.0, total_bins=64)
    trees = []
    for lr in (0.1, 0.3):
        t, _ = tt.grow_tree_depthwise(
            torch.from_numpy(bins_t), torch.from_numpy(grad),
            torch.from_numpy(hess), torch.from_numpy(rv),
            torch.from_numpy(fmask), torch.from_numpy(ub),
            torch.from_numpy(nb), lr, p, n_slots=tt.default_n_slots(15))
        trees.append(t)
    X = np.random.default_rng(1).normal(size=(500, 6)).astype(np.float32)
    X[::17, 2] = np.nan
    depth = max(tt.tree_depth(t) for t in trees)
    st = tt.stack_trees(trees)
    tot_t, lv_t = tt.predict_raw_features(torch.from_numpy(X), st, depth)
    jst = jt.Tree(*[jnp.asarray(a.numpy()) for a in st])
    tot_j, lv_j = jt.predict_raw_features(jnp.asarray(X), jst, depth)
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    np.testing.assert_array_equal(tot_t.numpy(), np.asarray(tot_j))
