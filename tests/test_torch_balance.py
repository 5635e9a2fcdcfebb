"""The port's data-balance measures (``exploratory/balance.py``) under the
contracts ``tests/test_exploratory_iforest.py`` holds the JAX package's
to, and every measure equal to the JAX package's (exactly: both are the
same numpy formulas on the host) on seeded random frames."""

import numpy as np
import pytest

from synapseml_tpu.core.dataset import Dataset as JDataset
from synapseml_tpu.exploratory import AggregateBalanceMeasure as JAgg
from synapseml_tpu.exploratory import DistributionBalanceMeasure as JDist
from synapseml_tpu.exploratory import FeatureBalanceMeasure as JFeat
from synapseml_tpu_torch.core import Dataset
from synapseml_tpu_torch.exploratory import (AggregateBalanceMeasure,
                                             DistributionBalanceMeasure,
                                             FeatureBalanceMeasure)
from torch_fuzzing import TestObject, TransformerFuzzing
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


class TestFeatureBalance:
    def test_parity_gap(self):
        # group A: 75% positive, group B: 25% positive
        ds = Dataset({
            "gender": np.array(["A"] * 4 + ["B"] * 4),
            "label": np.array([1, 1, 1, 0, 1, 0, 0, 0], np.float64),
        })
        out = FeatureBalanceMeasure(sensitiveCols=["gender"]).transform(ds)
        m = out.collect()[0]["FeatureBalanceMeasure"]
        np.testing.assert_allclose(m["dp"], 0.5, atol=1e-9)
        assert m["pmi"] > 0

    def test_balanced_is_zero(self):
        ds = Dataset({
            "g": np.array(["A", "A", "B", "B"]),
            "label": np.array([1, 0, 1, 0], np.float64),
        })
        out = FeatureBalanceMeasure(sensitiveCols=["g"]).transform(ds)
        m = out.collect()[0]["FeatureBalanceMeasure"]
        assert abs(m["dp"]) < 1e-9
        assert abs(m["pmi"]) < 1e-9


class TestDistributionBalance:
    def test_uniform_is_zero(self):
        ds = Dataset({"c": np.array(["x", "y", "z", "x", "y", "z"])})
        out = DistributionBalanceMeasure(sensitiveCols=["c"]).transform(ds)
        m = out.collect()[0]["DistributionBalanceMeasure"]
        assert abs(m["kl_divergence"]) < 1e-9
        assert abs(m["total_variation_dist"]) < 1e-9

    def test_skew_increases_divergence(self):
        near = Dataset({"c": np.array(["x"] * 5 + ["y"] * 5 + ["z"] * 2)})
        far = Dataset({"c": np.array(["x"] * 10 + ["y", "z"])})
        m_near = DistributionBalanceMeasure(sensitiveCols=["c"]) \
            .transform(near).collect()[0]["DistributionBalanceMeasure"]
        m_far = DistributionBalanceMeasure(sensitiveCols=["c"]) \
            .transform(far).collect()[0]["DistributionBalanceMeasure"]
        assert m_far["kl_divergence"] > m_near["kl_divergence"]
        assert m_far["js_dist"] > m_near["js_dist"]


class TestAggregateBalance:
    def test_equal_groups_zero_inequality(self):
        ds = Dataset({"a": np.array(["x", "x", "y", "y"]),
                      "b": np.array(["p", "q", "p", "q"])})
        out = AggregateBalanceMeasure(sensitiveCols=["a", "b"]).transform(ds)
        m = out.collect()[0]["AggregateBalanceMeasure"]
        assert abs(m["atkinson_index"]) < 1e-9
        assert abs(m["theil_t_index"]) < 1e-9

    def test_imbalance_positive(self):
        ds = Dataset({"a": np.array(["x"] * 9 + ["y"])})
        out = AggregateBalanceMeasure(sensitiveCols=["a"]).transform(ds)
        m = out.collect()[0]["AggregateBalanceMeasure"]
        assert m["theil_t_index"] > 0.1


def _frame(seed, n=300):
    """Two skewed sensitive columns and a label that depends on one."""
    rng = np.random.default_rng(seed)
    g = rng.choice(["a", "b", "c"], size=n, p=[0.6, 0.3, 0.1])
    r = rng.choice(["p", "q"], size=n, p=[0.7, 0.3])
    y = (rng.random(n) < np.where(g == "a", 0.7, 0.3)).astype(np.float64)
    return {"g": g, "r": r, "label": y}


def _same(a, b):
    """Equal columns: dict cells key by key, floats bit for bit."""
    assert a.columns == b.columns
    for c in a.columns:
        for x, y in zip(a[c], b[c]):
            if isinstance(x, dict):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert x == y, (c, x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["feature", "distribution", "aggregate"])
def test_measures_equal_jax(kind, seed):
    cols = _frame(seed)
    stages = {"feature": (FeatureBalanceMeasure, JFeat, ["g", "r"]),
              "distribution": (DistributionBalanceMeasure, JDist, ["g", "r"]),
              "aggregate": (AggregateBalanceMeasure, JAgg, ["g", "r"])}
    port, ref, sens = stages[kind]
    t = port(sensitiveCols=sens).transform(Dataset(dict(cols)))
    j = ref(sensitiveCols=sens).transform(JDataset(dict(cols)))
    _same(t, j)


class TestBalanceFuzzing(TransformerFuzzing):
    invalid_input_kinds = ("None", "wrong dtype")

    def fuzzing_objects(self):
        ds = Dataset(_frame(3, n=60))
        return [TestObject(FeatureBalanceMeasure(sensitiveCols=["g"]), ds),
                TestObject(DistributionBalanceMeasure(sensitiveCols=["g"]),
                           ds),
                TestObject(AggregateBalanceMeasure(sensitiveCols=["g", "r"]),
                           ds)]
