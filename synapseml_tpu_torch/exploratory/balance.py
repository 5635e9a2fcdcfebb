"""Data-balance measures.

Re-designs the reference's exploratory module (reference: core/.../
exploratory/FeatureBalanceMeasure.scala, DistributionBalanceMeasure.scala,
AggregateBalanceMeasure.scala): the same measure formulas computed with
vectorized numpy group-bys instead of Spark aggregations.  The PyTorch
port's copy of the JAX package's ``exploratory/balance.py``.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.dataset import Dataset
from ..core.params import FloatParam, ListParam, StringParam
from ..core.pipeline import Transformer


def _safe_log(x):
    return np.log(np.maximum(x, 1e-12))


def _kendall_tau_b(x: np.ndarray, y: np.ndarray) -> float:
    """Kendall tau-b for two BINARY vectors via the 2x2 contingency closed
    form: tau_b = (n11 n00 - n10 n01) / sqrt(r1 r0 c1 c0) — equals the phi
    coefficient, O(n)."""
    x = np.asarray(x, np.float64) > 0
    y = np.asarray(y, np.float64) > 0
    n11 = float((x & y).sum())
    n10 = float((x & ~y).sum())
    n01 = float((~x & y).sum())
    n00 = float((~x & ~y).sum())
    denom = np.sqrt(max((n11 + n10) * (n01 + n00)
                        * (n11 + n01) * (n10 + n00), 1e-12))
    return float((n11 * n00 - n10 * n01) / denom)


class FeatureBalanceMeasure(Transformer):
    """Pairwise association gaps between sensitive-feature classes w.r.t.
    a binary label (reference: FeatureBalanceMeasure.scala; measures match:
    dp, sdc, ji, llr, pmi, n_pmi_y, n_pmi_xy, s_pmi, krc, t_test)."""

    sensitiveCols = ListParam(doc="sensitive feature columns")
    labelCol = StringParam(doc="binary label column", default="label")
    outputCol = StringParam(doc="output measures column",
                            default="FeatureBalanceMeasure")

    def _transform(self, ds: Dataset) -> Dataset:
        label = ds[self.labelCol].astype(np.float64)
        n = len(label)
        p_y = label.mean()
        rows = {"FeatureName": [], "ClassA": [], "ClassB": [],
                self.outputCol: []}
        for col in self.sensitiveCols:
            vals = ds[col]
            classes, inv = np.unique(vals, return_inverse=True)
            stats = {}
            for ci, c in enumerate(classes):
                mask = inv == ci
                p_x = mask.mean()                       # P(X=c)
                p_xy = (mask & (label > 0)).mean()      # P(X=c, Y=1)
                p_y_given_x = p_xy / max(p_x, 1e-12)
                p_x_given_y = p_xy / max(p_y, 1e-12)
                stats[c] = dict(p_x=p_x, p_xy=p_xy,
                                p_y_given_x=p_y_given_x,
                                p_x_given_y=p_x_given_y)
            for a, b in combinations(classes, 2):
                sa, sb = stats[a], stats[b]
                dp = sa["p_y_given_x"] - sb["p_y_given_x"]
                sdc = (sa["p_xy"] / max(sa["p_x"] + sb["p_x"], 1e-12)
                       - sb["p_xy"] / max(sa["p_x"] + sb["p_x"], 1e-12))
                ji = (sa["p_xy"] / max(sa["p_x"] + p_y - sa["p_xy"], 1e-12)
                      - sb["p_xy"] / max(sb["p_x"] + p_y - sb["p_xy"], 1e-12))
                llr = float(_safe_log(sa["p_x_given_y"])
                            - _safe_log(sb["p_x_given_y"]))
                pmi = float(_safe_log(sa["p_y_given_x"] / max(p_y, 1e-12))
                            - _safe_log(sb["p_y_given_x"] / max(p_y, 1e-12)))
                n_pmi_y = pmi / max(-float(_safe_log(p_y)), 1e-12)
                n_pmi_xy = (
                    float(_safe_log(sa["p_y_given_x"] / max(p_y, 1e-12)))
                    / max(-float(_safe_log(max(sa["p_xy"], 1e-12))), 1e-12)
                    - float(_safe_log(sb["p_y_given_x"] / max(p_y, 1e-12)))
                    / max(-float(_safe_log(max(sb["p_xy"], 1e-12))), 1e-12))
                s_pmi = float(
                    _safe_log(sa["p_xy"] / max(sa["p_x"] * p_y, 1e-12))
                    - _safe_log(sb["p_xy"] / max(sb["p_x"] * p_y, 1e-12)))
                # Kendall over rows belonging to either class: membership
                # indicator (A vs B) against the label
                pair_mask = (vals == a) | (vals == b)
                krc = _kendall_tau_b(vals[pair_mask] == a, label[pair_mask])
                rows["FeatureName"].append(col)
                rows["ClassA"].append(a)
                rows["ClassB"].append(b)
                rows[self.outputCol].append({
                    "dp": float(dp), "sdc": float(sdc), "ji": float(ji),
                    "llr": llr, "pmi": pmi, "n_pmi_y": float(n_pmi_y),
                    "n_pmi_xy": float(n_pmi_xy), "s_pmi": s_pmi,
                    "krc": krc})
        if not rows["FeatureName"]:
            return Dataset({"FeatureName": np.asarray(["<none>"])})
        return Dataset(rows)


class DistributionBalanceMeasure(Transformer):
    """Distance between a feature's empirical distribution and the uniform
    reference (reference: DistributionBalanceMeasure.scala; measures:
    kl_divergence, js_dist, inf_norm_dist, total_variation_dist,
    wasserstein_dist, chi_sq_stat, chi_sq_p_value)."""

    sensitiveCols = ListParam(doc="sensitive feature columns")
    outputCol = StringParam(doc="output measures column",
                            default="DistributionBalanceMeasure")

    def _transform(self, ds: Dataset) -> Dataset:
        rows = {"FeatureName": [], self.outputCol: []}
        for col in self.sensitiveCols:
            vals = ds[col]
            _, counts = np.unique(vals, return_counts=True)
            p = counts / counts.sum()
            k = len(p)
            q = np.full(k, 1.0 / k)
            m = 0.5 * (p + q)
            kl = float((p * _safe_log(p / q)).sum())
            js = float(np.sqrt(0.5 * (p * _safe_log(p / m)).sum()
                               + 0.5 * (q * _safe_log(q / m)).sum()))
            inf_norm = float(np.max(np.abs(p - q)))
            tv = float(0.5 * np.abs(p - q).sum())
            ws = float(np.abs(np.cumsum(p) - np.cumsum(q)).mean())
            chi2 = float((((counts - counts.sum() / k) ** 2)
                          / (counts.sum() / k)).sum())
            # Wilson–Hilferty chi^2 -> normal approximation for the p-value
            df = max(k - 1, 1)
            z = ((chi2 / df) ** (1 / 3) - (1 - 2 / (9 * df))) \
                / np.sqrt(2 / (9 * df))
            from math import erf, sqrt
            p_val = float(1 - 0.5 * (1 + erf(z / sqrt(2))))
            rows["FeatureName"].append(col)
            rows[self.outputCol].append({
                "kl_divergence": kl, "js_dist": js,
                "inf_norm_dist": inf_norm, "total_variation_dist": tv,
                "wasserstein_dist": ws, "chi_sq_stat": chi2,
                "chi_sq_p_value": p_val})
        return Dataset({"FeatureName": np.asarray(rows["FeatureName"]),
                        self.outputCol: np.asarray(rows[self.outputCol],
                                                   dtype=object)})


class AggregateBalanceMeasure(Transformer):
    """Whole-dataset balance over the cross product of sensitive columns
    (reference: AggregateBalanceMeasure.scala; measures: atkinson_index,
    theil_l_index, theil_t_index)."""

    sensitiveCols = ListParam(doc="sensitive feature columns")
    outputCol = StringParam(doc="output measures column",
                            default="AggregateBalanceMeasure")
    epsilon = FloatParam(doc="Atkinson inequality-aversion", default=1.0)

    def _transform(self, ds: Dataset) -> Dataset:
        from collections import Counter
        keys = [tuple(ds[c][i] for c in self.sensitiveCols)
                for i in range(ds.num_rows)]
        counts = np.asarray(list(Counter(keys).values()), np.float64)
        p = counts / counts.sum()
        mu = p.mean()
        eps = float(self.epsilon)
        if abs(eps - 1.0) < 1e-9:
            atkinson = float(1.0 - np.exp(_safe_log(p).mean()) / mu)
        else:
            atkinson = float(
                1.0 - (np.mean(p ** (1 - eps)) ** (1 / (1 - eps))) / mu)
        theil_l = float(np.mean(_safe_log(mu / p)))
        theil_t = float(np.mean((p / mu) * _safe_log(p / mu)))
        return Dataset({self.outputCol: np.asarray([{
            "atkinson_index": atkinson,
            "theil_l_index": theil_l,
            "theil_t_index": theil_t}], dtype=object)})
