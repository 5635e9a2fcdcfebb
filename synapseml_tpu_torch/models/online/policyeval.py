"""Counterfactual (off-policy) evaluation.

The PyTorch port's copy of the JAX package's ``models/online/policyeval.py``
(numpy and ``scipy.stats.chi2`` on the host).

Re-designs the reference's CSE transformer + policy-eval helpers
(reference: vw/.../VowpalWabbitCSETransformer.scala:222,
vw/.../policyeval/CressieRead.scala:112, CressieReadInterval.scala:216):
IPS and SNIPS value estimators plus Cressie-Read empirical-likelihood
confidence intervals for importance-weighted means, computed with stable
streaming sums (KahanSum, vw/KahanSum.scala:68 — here numpy pairwise
summation provides the same stability).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ...core.dataset import Dataset
from ...core.params import FloatParam, IntParam, StringParam
from ...core.pipeline import Transformer


def ips(rewards: np.ndarray, logged_probs: np.ndarray,
        target_probs: np.ndarray, wmax: float = 0.0) -> float:
    """Inverse-propensity-score value of the target policy."""
    w = np.asarray(target_probs, np.float64) / np.maximum(logged_probs, 1e-12)
    if wmax > 0:
        w = np.minimum(w, wmax)
    return float(np.mean(w * rewards))


def snips(rewards: np.ndarray, logged_probs: np.ndarray,
          target_probs: np.ndarray) -> float:
    """Self-normalized IPS (ratio estimator)."""
    w = np.asarray(target_probs, np.float64) / np.maximum(logged_probs, 1e-12)
    denom = w.sum()
    return float((w * rewards).sum() / max(denom, 1e-12))


def cressie_read(rewards: np.ndarray, logged_probs: np.ndarray,
                 target_probs: np.ndarray) -> float:
    """Cressie-Read power-divergence point estimate of policy value
    (reference: policyeval/CressieRead.scala:112).

    Empirical-likelihood reweighting: find the maximum-likelihood
    importance-weight normalization q_i ∝ 1/(1 + beta * (w_i - 1)) with
    E_q[w] = 1, then report E_q[w r].  beta is solved by bisection on the
    monotone constraint function.
    """
    w = np.asarray(target_probs, np.float64) / np.maximum(logged_probs, 1e-12)
    r = np.asarray(rewards, np.float64)
    n = len(w)
    if n == 0:
        return float("nan")

    def constraint(beta: float) -> float:
        q = 1.0 / np.maximum(1.0 + beta * (w - 1.0), 1e-12)
        q = q / q.sum()
        return float((q * w).sum() - 1.0)

    # beta range keeping 1 + beta*(w-1) > 0 for all observed w
    w_min, w_max = float(w.min()), float(w.max())
    lo = -1.0 / max(w_max - 1.0, 1e-12) + 1e-9 if w_max > 1 else -1e6
    hi = 1.0 / max(1.0 - w_min, 1e-12) - 1e-9 if w_min < 1 else 1e6
    c_lo, c_hi = constraint(lo), constraint(hi)
    if c_lo * c_hi > 0:  # no interior root: fall back to SNIPS weighting
        q = w / w.sum()
        return float((q * r).sum())
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        c = constraint(mid)
        if c_lo * c <= 0:
            hi, c_hi = mid, c
        else:
            lo, c_lo = mid, c
    beta = 0.5 * (lo + hi)
    q = 1.0 / np.maximum(1.0 + beta * (w - 1.0), 1e-12)
    q = q / q.sum()
    return float((q * w * r).sum())


def bernstein_bound(rewards: np.ndarray, logged_probs: np.ndarray,
                    target_probs: np.ndarray, delta: float = 0.05,
                    wmax: Optional[float] = None):
    """Empirical-Bernstein lower/upper bound on the IPS value."""
    w = np.asarray(target_probs, np.float64) / np.maximum(logged_probs, 1e-12)
    z = w * np.asarray(rewards, np.float64)
    if wmax:
        z = np.minimum(z, wmax)
    n = len(z)
    if n < 2:
        return float("nan"), float("nan")
    mean = z.mean()
    var = z.var(ddof=1)
    log_term = np.log(3.0 / delta)
    rng = z.max() - z.min() if n else 1.0
    slack = np.sqrt(2 * var * log_term / n) + 3 * rng * log_term / n
    return float(mean - slack), float(mean + slack)


@dataclasses.dataclass
class CressieReadInterval:
    """Empirical-likelihood CI for an importance-weighted mean
    (reference: policyeval/CressieReadInterval.scala:216).  The interval is
    the set of values v for which the EL ratio test does not reject; we
    scan the dual with the chi-square(1) calibration."""

    delta: float = 0.05
    wmax: float = 100.0

    def interval(self, rewards, logged_probs, target_probs):
        from scipy.stats import chi2  # scipy ships with the image's numpy stack
        w = np.asarray(target_probs, np.float64) / np.maximum(logged_probs, 1e-12)
        w = np.minimum(w, self.wmax)
        z = w * np.asarray(rewards, np.float64)
        n = len(z)
        if n == 0:
            return float("nan"), float("nan")
        crit = chi2.ppf(1 - self.delta, df=1)

        def el_stat(v: float) -> float:
            # EL ratio for H0: E[z] = v, via the standard dual
            d = z - v
            lo_l, hi_l = -1.0 / max(d.max(), 1e-12), -1.0 / min(d.min(), -1e-12)
            if d.max() <= 0 or d.min() >= 0:
                return np.inf  # v outside the convex hull: reject
            lam_lo, lam_hi = lo_l + 1e-10, hi_l - 1e-10

            def dldl(lam):
                return float(np.sum(d / (1.0 + lam * d)))

            a, b = lam_lo, lam_hi
            for _ in range(60):
                m = 0.5 * (a + b)
                if dldl(a) * dldl(m) <= 0:
                    b = m
                else:
                    a = m
            lam = 0.5 * (a + b)
            return float(2.0 * np.sum(np.log1p(lam * d)))

        est = z.mean()
        span = max(z.max() - z.min(), 1e-9)
        lo_v, hi_v = est, est
        stepn = 200
        for k in range(1, stepn + 1):
            v = est - span * k / stepn
            if v < z.min() or el_stat(v) > crit:
                break
            lo_v = v
        for k in range(1, stepn + 1):
            v = est + span * k / stepn
            if v > z.max() or el_stat(v) > crit:
                break
            hi_v = v
        return float(lo_v), float(hi_v)


class PolicyEvalTransformer(Transformer):
    """Aggregate logged bandit rows into off-policy value estimates —
    the CSE (counterfactual slate/statistics estimation) transformer
    analogue (VowpalWabbitCSETransformer.scala: per-slot IPS/SNIPS +
    CressieRead interval output schema)."""

    rewardCol = StringParam(doc="observed reward column", default="reward")
    loggedProbCol = StringParam(doc="logging policy P(a) column",
                                default="probLog")
    targetProbCol = StringParam(doc="target policy P(a) column",
                                default="probPred")
    countCol = StringParam(doc="example count column (weights)", default="count")
    minImportanceWeight = FloatParam(doc="clip floor for 1/p", default=0.0)
    maxImportanceWeight = FloatParam(doc="clip cap for 1/p", default=100.0)
    delta = FloatParam(doc="CI significance", default=0.05)

    def _transform(self, ds: Dataset) -> Dataset:
        r = ds[self.rewardCol].astype(np.float64)
        pl = ds[self.loggedProbCol].astype(np.float64)
        pt = ds[self.targetProbCol].astype(np.float64)
        if self.countCol in ds:
            counts = ds[self.countCol].astype(np.int64)
            r = np.repeat(r, counts)
            pl = np.repeat(pl, counts)
            pt = np.repeat(pt, counts)
        lo, hi = CressieReadInterval(
            delta=self.delta, wmax=self.maxImportanceWeight
        ).interval(r, pl, pt)
        blo, bhi = bernstein_bound(r, pl, pt, delta=self.delta,
                                   wmax=self.maxImportanceWeight)
        return Dataset({
            "ips": np.asarray([ips(r, pl, pt, self.maxImportanceWeight)]),
            "snips": np.asarray([snips(r, pl, pt)]),
            "cressieRead": np.asarray([cressie_read(r, pl, pt)]),
            "cressieReadLower": np.asarray([lo]),
            "cressieReadUpper": np.asarray([hi]),
            "bernsteinLower": np.asarray([blo]),
            "bernsteinUpper": np.asarray([bhi]),
            "exampleCount": np.asarray([float(len(r))]),
        }, num_partitions=1)
