"""The port's cyber package (``synapseml_tpu_torch.cyber``) against the JAX
package's on the CPU.

ALS starts from the JAX package's initial factors: ``0.1 * normal`` on the
halves of ``split(PRNGKey(seed))``, drawn by the port's threefry copy
(``models/gbdt/prng.py``).  The split keys are equal bit for bit; the
normal draws are within 4 ulps (reading: <= 3 ulps, on ~1% of the
elements: the erfinv polynomial is XLA's, the ``log1p`` under it is
torch's).  Then 25 alternating f32 ridge solves on each side.
Tolerances: anomaly scores (standardized) within 1e-4 of max(1, |score|)
(reading: implicit CF 4.6e-5 absolute on O(1) scores and 3.4e-6
relative on a cross-clique score of ~37, explicit CF 1.3e-6); the factors themselves within 1e-4 of their scale; the
indexers, scalers and complement sampling are copies and give equal
outputs.
"""

import jax
import numpy as np
import pytest
import torch

import synapseml_tpu.cyber as JC
import synapseml_tpu_torch.cyber as TC
from synapseml_tpu import Dataset as JDataset
from synapseml_tpu_torch.core import Dataset as TDataset
from synapseml_tpu_torch.cyber import access_anomaly as TA
from synapseml_tpu_torch.models.gbdt import prng
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _access(seed=0, n=300, tenants=("t0", "t1")):
    """Two cliques of users and resources per tenant, plus a few
    cross-clique accesses and repeated pairs."""
    rng = np.random.default_rng(seed)
    rows = {"tenant": [], "user": [], "res": [], "likelihood": []}
    for t in tenants:
        for i in range(n // len(tenants)):
            c = int(rng.integers(0, 2)) if rng.random() > 0.05 else 2
            u = f"u{c % 2}_{rng.integers(0, 9)}"
            r = f"r{(c // 2 + c) % 2}_{rng.integers(0, 7)}"
            rows["tenant"].append(t)
            rows["user"].append(u)
            rows["res"].append(r)
            rows["likelihood"].append(float(rng.integers(1, 20)))
    return {k: np.array(v) if k != "likelihood" else np.array(v, np.float64)
            for k, v in rows.items()}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1234])
def test_initial_factors_equal_jax(seed):
    jk = jax.random.split(jax.random.PRNGKey(seed))
    keys = prng.split(prng.prng_key(seed))
    assert [tuple(int(v) for v in np.asarray(k)) for k in jk] == keys
    u0, v0 = TA._init_factors(300, 120, 10, seed, "cpu")
    for key, got, n in ((jk[0], u0, 300), (jk[1], v0, 120)):
        z = np.asarray(jax.random.normal(key, (n, 10)))
        assert _ulps(prng.normal(keys[0] if n == 300 else keys[1], (n, 10),
                                 "cpu").numpy(), z).max() <= 4
        np.testing.assert_allclose(got.numpy(), 0.1 * z, rtol=0, atol=2e-7)


def test_gram_product_equals_the_einsum():
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.uniform(0, 2, (7, 11)), dtype=torch.float32)
    wt = torch.as_tensor(rng.uniform(0, 2, (7, 11)), dtype=torch.float32)
    other = torch.as_tensor(rng.normal(size=(11, 3)), dtype=torch.float32)
    eye = 0.5 * torch.eye(3)
    gram = torch.einsum("nm,mk,ml->nkl", w, other, other) + eye
    want = torch.linalg.solve(gram, (wt @ other)[..., None])[..., 0]
    torch.testing.assert_close(TA._solve_side(w, wt, other, eye), want,
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def fitted():
    data = _access()
    out = {}
    for name, kw in (("implicit", {}), ("explicit", {"applyImplicitCf": False,
                                                      "seed": 5})):
        jm = JC.AccessAnomaly(**kw).fit(JDataset(dict(data)))
        tm = TC.AccessAnomaly(device="cpu", **kw).fit(TDataset(dict(data)))
        out[name] = (jm, tm, data)
    return out


@pytest.mark.parametrize("name", ["implicit", "explicit"])
def test_access_anomaly_matches_jax(fitted, name):
    jm, tm, data = fitted[name]
    probe = _access(9, 80)
    probe["user"][:2] = "nobody"                          # NaN
    for k in data:
        probe[k] = np.concatenate([data[k][:40], probe[k]])
    want = jm.transform(JDataset(dict(probe)))["anomaly_score"]
    got = tm.transform(TDataset(dict(probe)))["anomaly_score"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    for t in ("t0", "t1"):
        ju, tu = jm.get("userVectors")[t], tm.get("userVectors")[t]
        assert list(tu) == list(ju)
        a, b = np.array(list(ju.values())), np.array(list(tu.values()))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max())
        assert tm.get("userComponents")[t] == jm.get("userComponents")[t]
        assert tm.get("tenantStats")[t] == pytest.approx(
            jm.get("tenantStats")[t], rel=1e-4)


def test_helpers_are_the_reference_code():
    data = _access(3, 60)
    data["idx_u"] = np.arange(60) % 7
    data["idx_r"] = np.arange(60) % 5
    outs = []
    for C, D in ((JC, JDataset), (TC, TDataset)):
        ds = D(dict(data))
        ix = C.IdIndexer(inputCol="user", partitionKey="tenant",
                         outputCol="uid").fit(ds)
        indexed = ix.transform(ds)
        back = ix.undo_transform(indexed.drop("user"))
        std = C.StandardScalarScaler(inputCol="likelihood",
                                     partitionKey="tenant",
                                     outputCol="z").fit(ds).transform(ds)
        lin = C.LinearScalarScaler(inputCol="likelihood",
                                   partitionKey="tenant", outputCol="s",
                                   minRequiredValue=5.0,
                                   maxRequiredValue=10.0).fit(ds).transform(ds)
        comp = C.ComplementAccessTransformer(
            partitionKey="tenant", indexedColNamesArr=["idx_u", "idx_r"],
            complementsetFactor=2, seed=1).transform(ds)
        multi = C.MultiIndexer([C.IdIndexer(inputCol="res",
                                            partitionKey="tenant",
                                            outputCol="rid")]).fit(ds)
        outs.append((indexed["uid"], back["user"], std["z"], lin["s"],
                     comp["idx_u"], comp["idx_r"], comp["tenant"],
                     multi.transform(ds)["rid"]))
    for w, g in zip(*outs):
        np.testing.assert_array_equal(g, w)


def test_access_anomaly_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.AccessAnomaly().fit(TDataset(_access(n=10)))
