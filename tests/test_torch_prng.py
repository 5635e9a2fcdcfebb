"""The port's threefry draws (``models/gbdt/prng.py``) held bit for bit
against ``jax.random`` on the CPU, for the keys the boosting loop draws
its row samples from: the bagging key ``fold_in(PRNGKey(bagging_seed),
it // freq)``, GOSS's ``PRNGKey(seed * 100003 + it)`` and its per-class
``fold_in(key, k)``, at odd and even lengths; and the bagging mask and
GOSS weights built on them against the JAX package's formulas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu_torch.models.gbdt import prng
from synapseml_tpu_torch.models.gbdt.booster import bag_mask, goss_weights
import torch_workers  # noqa: F401  (shares the cores among xdist workers)

LENGTHS = (1, 7, 1000, 65_539)


def _keys(kind: str, seed: int, it: int):
    """(jax key, port key) of one of the boosting loop's formulas."""
    if kind == "bag":
        return (jax.random.fold_in(jax.random.PRNGKey(seed), it // 2),
                prng.fold_in(prng.prng_key(seed), it // 2))
    goss = (seed * 100003 + it) & 0xffffffff
    jk, tk = jax.random.PRNGKey(goss), prng.prng_key(goss)
    if kind == "goss_class":
        return jax.random.fold_in(jk, 2), prng.fold_in(tk, 2)
    return jk, tk


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["bag", "goss", "goss_class"])
def test_uniform_bit_identical(kind, n):
    for seed, it in ((3, 0), (7, 5), (42, 123), (40_000, 77_777)):
        jk, tk = _keys(kind, seed, it)
        assert tuple(np.asarray(jk).tolist()) == tk
        j = np.asarray(jax.random.uniform(jk, (n,)))
        t = prng.uniform(tk, n, "cpu").numpy()
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 3, 2**31 - 1, 2**31, 0xffffffff])
def test_prng_key_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(jk).tolist()) == prng.prng_key(seed)
    for data in (0, 1, 17, 2**31 + 5):
        assert (tuple(np.asarray(jax.random.fold_in(jk, data)).tolist())
                == prng.fold_in(prng.prng_key(seed), data))


def test_random_bits_match_jax_bits():
    jk, tk = _keys("bag", 3, 4)
    j = np.asarray(jax.random.bits(jk, (4097,), jnp.uint32))
    np.testing.assert_array_equal(
        prng.random_bits(tk, 4097, "cpu").numpy().astype(np.uint32), j)


@pytest.mark.parametrize("n", LENGTHS)
def test_bag_mask_matches_jax(n):
    """The JAX package's draw: ``uniform(bag_key, (N,)) < fraction``."""
    for fraction in (0.5, 0.8, 0.9):
        jk, tk = _keys("bag", 3, 9)
        j = np.asarray((jax.random.uniform(jk, (n,)) < fraction)
                       .astype(jnp.float32))
        t = bag_mask(tk, n, fraction, torch.device("cpu")).numpy()
        np.testing.assert_array_equal(t, j)


def _goss_weights_jax(g_abs, bag, key, top_rate, other_rate):
    """A copy of the JAX package's ``goss_weights`` (``booster.py``),
    which lives inside its step factory."""
    n = g_abs.shape[0]
    n_real = jnp.sum((bag > 0).astype(jnp.int32))
    k = jnp.maximum(1, (n_real.astype(jnp.float32) * top_rate)
                    .astype(jnp.int32))
    sorted_desc = -jnp.sort(-(g_abs * (bag > 0)))
    thresh = sorted_desc[jnp.minimum(k - 1, n - 1)]
    topset = g_abs >= thresh
    rest_keep = jax.random.uniform(key, (n,)) < other_rate
    amp = (1.0 - top_rate) / jnp.maximum(other_rate, 1e-6)
    return jnp.where(topset, 1.0, jnp.where(rest_keep, amp, 0.0)) * bag


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("bagged", [False, True])
def test_goss_weights_match_jax(n, bagged):
    rng = np.random.default_rng(n)
    g = np.abs(rng.normal(size=n)).astype(np.float32)
    g[: n // 3] = np.round(g[: n // 3], 1)          # ties at the threshold
    bag = ((rng.random(n) < 0.8) if bagged else np.ones(n)).astype(
        np.float32)
    jk, tk = _keys("goss", 7, 3)
    for top, other in ((0.2, 0.1), (0.3, 0.05)):
        j = np.asarray(_goss_weights_jax(jnp.asarray(g), jnp.asarray(bag),
                                         jk, top, other))
        t = goss_weights(torch.from_numpy(g), torch.from_numpy(bag), tk,
                         top, other).numpy()
        np.testing.assert_array_equal(t, j)
