"""Access-anomaly detection via collaborative filtering (reference:
core/src/main/python/synapse/ml/cyber/anomaly/collaborative_filtering.py
AccessAnomaly/AccessAnomalyModel/AccessAnomalyConfig, :61-1254).

Semantics mirrored from the reference:
- per-tenant CF over (user, resource, likelihood) triples; implicit
  feedback (Hu-Koren confidence weighting) by default, explicit feedback
  with complement-set negatives otherwise;
- output anomaly scores are standardized per tenant so that the training
  access pairs score mean 0 / std 1, with HIGHER = more anomalous
  (reference folds ``-1/std`` and ``-mean`` into bias-extended vectors,
  collaborative_filtering.py:1199-1224 — we keep raw factors and apply
  ``(mean - u·v)/std`` at scoring time, which is the same value);
- pairs listed in the access history score exactly 0.0
  (collaborative_filtering.py:494-509);
- users/resources never seen at fit time score NaN (reference: null);
- user and resource in different connected components of the bipartite
  access graph score +inf (reference: ConnectedComponents,
  collaborative_filtering.py:541-616).

Device re-design: instead of Spark blocked ALS, each alternating solve is
a batch of dense ridge normal equations — one product builds every
per-user (and per-resource) Gram matrix at once and one batched
``torch.linalg.solve`` factors them, so each update is a few large
float32 products on the device (TF32 off).  The initial factors are the
JAX package's threefry ``normal`` draws (``models/gbdt/prng.py``), so
both packages start ALS from the same point; connected components and
the per-tenant standardization stay on the host."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import (BoolParam, DatasetParam, DictParam, FloatParam,
                           IntParam, ListParam, StringParam)
from ..core.pipeline import Estimator, Model
from ..device import DeviceLike, full_f32, resolve_device
from ..models.gbdt import prng


class AccessAnomalyConfig:
    """Default values for AccessAnomaly params (reference:
    collaborative_filtering.py:61-85)."""

    default_tenant_col = "tenant"
    default_user_col = "user"
    default_res_col = "res"
    default_likelihood_col = "likelihood"
    default_output_col = "anomaly_score"

    default_rank = 10
    default_max_iter = 25
    default_reg_param = 1.0
    default_separate_tenants = False

    default_low_value = 5.0
    default_high_value = 10.0

    default_apply_implicit_cf = True
    default_alpha = 1.0

    default_complementset_factor = 2
    default_neg_score = 1.0


def _init_factors(nu: int, nr: int, rank: int, seed: int,
                  device: DeviceLike = "cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``0.1 * jax.random.normal(k, (n, rank))`` on the two halves of
    ``jax.random.split(PRNGKey(seed))``, in float32 on ``device``."""
    ku, kv = prng.split(prng.prng_key(seed))
    return (0.1 * prng.normal(ku, (nu, rank), device),
            0.1 * prng.normal(kv, (nr, rank), device))


def _solve_side(w: torch.Tensor, wt: torch.Tensor, other: torch.Tensor,
                eye: torch.Tensor) -> torch.Tensor:
    """Ridge solves of every row of ``w`` (n, m) against the fixed
    factors ``other`` (m, k): Gram_n = sum_m w[n, m] o_m o_m^T + reg I.
    The (n, k, k) Grams come from ONE (n, m) x (m, k*k) product of the
    weights with the factors' outer products, never an (n, m, k, k)
    tensor."""
    m, k = other.shape
    outer = (other[:, :, None] * other[:, None, :]).reshape(m, k * k)
    gram = (w @ outer).reshape(-1, k, k) + eye
    rhs = wt @ other                                     # (n, k)
    return torch.linalg.solve(gram, rhs[..., None])[..., 0]


def _als(weights: torch.Tensor, targets: torch.Tensor, rank: int,
         max_iter: int, reg: float, seed: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alternating batched ridge solves for weighted dense CF.

    ``weights`` (nu, nr) are per-entry confidences/weights, ``targets``
    the values being regressed (preferences for implicit CF, scaled
    likelihoods for explicit), both float32 on one device.  Each
    iteration solves every user against the resource factors, then every
    resource against the new user factors."""
    nu, nr = weights.shape
    u, v = _init_factors(nu, nr, rank, seed, weights.device)
    eye = reg * torch.eye(rank, dtype=torch.float32, device=weights.device)
    wt = targets * weights
    with full_f32():
        w_t, wt_t = weights.T.contiguous(), wt.T.contiguous()
        for _ in range(int(max_iter)):
            u = _solve_side(weights, wt, v, eye)
            v = _solve_side(w_t, wt_t, u, eye)
    return u, v


def _connected_components(users: np.ndarray, ress: np.ndarray
                          ) -> Tuple[Dict[Any, int], Dict[Any, int]]:
    """Union-find over the bipartite access graph (reference:
    ConnectedComponents.transform, collaborative_filtering.py:554-616)."""
    parent: Dict[Any, Any] = {}

    def find(x):
        root = x
        while parent.setdefault(root, root) != root:
            root = parent[root]
        while parent[x] != root:     # path compression
            parent[x], x = root, parent[x]
        return root

    for u, r in zip(users, ress):
        parent[find(("u", u))] = find(("r", r))
    comp_ids: Dict[Any, int] = {}
    user_comp: Dict[Any, int] = {}
    res_comp: Dict[Any, int] = {}
    for u in users:
        root = find(("u", u))
        user_comp[u] = comp_ids.setdefault(root, len(comp_ids))
    for r in ress:
        root = find(("r", r))
        res_comp[r] = comp_ids.setdefault(root, len(comp_ids))
    return user_comp, res_comp


class AccessAnomalyModel(Model):
    """Scores (tenant, user, res) rows by standardized CF reconstruction
    (reference: AccessAnomalyModel, collaborative_filtering.py:194-538)."""

    tenantCol = StringParam(doc="tenant column",
                            default=AccessAnomalyConfig.default_tenant_col)
    userCol = StringParam(doc="user column",
                          default=AccessAnomalyConfig.default_user_col)
    resCol = StringParam(doc="resource column",
                         default=AccessAnomalyConfig.default_res_col)
    outputCol = StringParam(doc="anomaly score output column",
                            default=AccessAnomalyConfig.default_output_col)
    userVectors = DictParam(doc="tenant → {user → latent vector}",
                            default=None)
    resVectors = DictParam(doc="tenant → {res → latent vector}",
                           default=None)
    tenantStats = DictParam(doc="tenant → {mean, std} of training dots",
                            default=None)
    userComponents = DictParam(doc="tenant → {user → component id}",
                               default=None)
    resComponents = DictParam(doc="tenant → {res → component id}",
                              default=None)
    historyPairs = ListParam(doc="[tenant, user, res] triples scoring 0",
                             default=None)

    def _transform(self, ds: Dataset) -> Dataset:
        uvecs = self.get("userVectors") or {}
        rvecs = self.get("resVectors") or {}
        stats = self.get("tenantStats") or {}
        ucomp = self.get("userComponents") or {}
        rcomp = self.get("resComponents") or {}
        history = {tuple(t) for t in (self.get("historyPairs") or [])}

        tenants = np.asarray([str(t) for t in ds[self.tenantCol]], object)
        users = np.asarray([str(u) for u in ds[self.userCol]], object)
        ress = np.asarray([str(r) for r in ds[self.resCol]], object)
        out = np.full(ds.num_rows, np.nan, np.float64)

        # batch per tenant: dict lookups once per unique entity, all dot
        # products in one einsum per tenant (scoring is the volume path)
        for t in dict.fromkeys(tenants):
            rows = np.nonzero(tenants == t)[0]
            uv_map, rv_map = uvecs.get(t, {}), rvecs.get(t, {})
            s = stats.get(t, {"mean": 0.0, "std": 1.0})
            std = s["std"] if s["std"] != 0.0 else 1.0

            uniq_u = list(dict.fromkeys(users[rows]))
            uniq_r = list(dict.fromkeys(ress[rows]))
            u_idx = {u: i for i, u in enumerate(uniq_u)}
            r_idx = {r: i for i, r in enumerate(uniq_r)}
            # rank from whichever map is non-empty: a tenant can have an
            # empty user map but rank>1 resource vectors (or vice versa),
            # and a rank-1 matrix would break the assignment below
            if uv_map:
                rank = len(next(iter(uv_map.values())))
            elif rv_map:
                rank = len(next(iter(rv_map.values())))
            else:
                rank = 1
            u_mat = np.zeros((len(uniq_u), rank))
            u_known = np.zeros(len(uniq_u), bool)
            for i, u in enumerate(uniq_u):
                v = uv_map.get(u)
                if v is not None:
                    u_mat[i], u_known[i] = v, True
            r_mat = np.zeros((len(uniq_r), rank))
            r_known = np.zeros(len(uniq_r), bool)
            for i, r in enumerate(uniq_r):
                v = rv_map.get(r)
                if v is not None:
                    r_mat[i], r_known[i] = v, True

            ui = np.array([u_idx[u] for u in users[rows]])
            ri = np.array([r_idx[r] for r in ress[rows]])
            dots = np.einsum("ik,ik->i", u_mat[ui], r_mat[ri])
            scores = (s["mean"] - dots) / std
            scores[~(u_known[ui] & r_known[ri])] = np.nan  # reference: null

            uc, rc = ucomp.get(t, {}), rcomp.get(t, {})
            if uc and rc:
                cu = np.array([uc.get(u, -1) for u in uniq_u])[ui]
                cr = np.array([rc.get(r, -2) for r in uniq_r])[ri]
                cross = (cu >= 0) & (cr >= 0) & (cu != cr)
                scores[cross & (u_known[ui] & r_known[ri])] = np.inf

            if history:
                in_hist = np.array([(t, u, r) in history
                                    for u, r in zip(users[rows], ress[rows])])
                scores[in_hist] = 0.0
            out[rows] = scores
        return ds.with_column(self.outputCol, out)


class AccessAnomaly(Estimator):
    """Per-tenant collaborative-filtering anomaly estimator (reference:
    AccessAnomaly, collaborative_filtering.py:618-1080)."""

    tenantCol = StringParam(doc="tenant/partition column",
                            default=AccessAnomalyConfig.default_tenant_col)
    userCol = StringParam(doc="user column",
                          default=AccessAnomalyConfig.default_user_col)
    resCol = StringParam(doc="resource column",
                         default=AccessAnomalyConfig.default_res_col)
    likelihoodCol = StringParam(
        doc="likelihood-of-access column (e.g. access counts per time "
            "unit)", default=AccessAnomalyConfig.default_likelihood_col)
    outputCol = StringParam(doc="anomaly score output column",
                            default=AccessAnomalyConfig.default_output_col)
    rankParam = IntParam(doc="number of latent factors",
                         default=AccessAnomalyConfig.default_rank)
    maxIter = IntParam(doc="ALS iterations",
                       default=AccessAnomalyConfig.default_max_iter)
    regParam = FloatParam(doc="ridge regularization",
                          default=AccessAnomalyConfig.default_reg_param)
    separateTenants = BoolParam(
        doc="API-parity flag (reference: runs one joint ALS with "
            "cross-tenant-unique indices when False, per-tenant ALS when "
            "True). Our dense per-tenant solves are block-separable-"
            "equivalent to the joint run — tenants never couple in the "
            "objective — so both settings produce the same scores here",
        default=AccessAnomalyConfig.default_separate_tenants)
    lowValue = FloatParam(doc="likelihood rescale range low",
                          default=AccessAnomalyConfig.default_low_value)
    highValue = FloatParam(doc="likelihood rescale range high",
                           default=AccessAnomalyConfig.default_high_value)
    applyImplicitCf = BoolParam(
        doc="implicit-feedback CF (Hu-Koren confidences) vs explicit",
        default=AccessAnomalyConfig.default_apply_implicit_cf)
    alphaParam = FloatParam(doc="implicit-CF confidence scale",
                            default=AccessAnomalyConfig.default_alpha)
    complementsetFactor = IntParam(
        doc="explicit CF: complement negatives per observed row",
        default=AccessAnomalyConfig.default_complementset_factor)
    negScore = FloatParam(
        doc="explicit CF: target value for complement rows",
        default=AccessAnomalyConfig.default_neg_score)
    seed = IntParam(doc="factor init / complement sampling seed", default=0)
    device = StringParam(doc="device the ALS solves run on: 'cuda' (raises "
                             "when no card is present) or 'cpu'",
                         default="cuda")
    historyAccessDs = DatasetParam(
        doc="optional dataset of known-benign (tenant, user, res) pairs "
            "that must score 0 (reference: historyAccessDf)", default=None)

    def _scale_likelihood(self, vals: np.ndarray) -> np.ndarray:
        """Affine-map this tenant's likelihoods onto [lowValue,
        highValue] (reference: _get_scaled_df via LinearScalarScaler,
        collaborative_filtering.py:843-856)."""
        lo, hi = float(self.lowValue), float(self.highValue)
        vmin, vmax = float(vals.min()), float(vals.max())
        if vmax == vmin:
            return np.full_like(vals, hi)
        return lo + (vals - vmin) * (hi - lo) / (vmax - vmin)

    def _fit(self, ds: Dataset) -> AccessAnomalyModel:
        dev = resolve_device(self.device)
        tenants = ds[self.tenantCol]
        users = ds[self.userCol]
        ress = ds[self.resCol]
        likes = np.asarray(ds[self.likelihoodCol], np.float64)

        rank = int(self.rankParam)
        reg = float(self.regParam)
        alpha = float(self.alphaParam)
        rng = np.random.default_rng(int(self.seed))

        groups: Dict[str, List[int]] = {}
        for i, t in enumerate(tenants):
            groups.setdefault(str(t), []).append(i)

        user_vecs: Dict[str, Dict[str, list]] = {}
        res_vecs: Dict[str, Dict[str, list]] = {}
        tenant_stats: Dict[str, Dict[str, float]] = {}
        user_comp: Dict[str, Dict[str, int]] = {}
        res_comp: Dict[str, Dict[str, int]] = {}

        for t, idx_list in groups.items():
            idx = np.asarray(idx_list)
            t_users = np.asarray([str(u) for u in users[idx]])
            t_ress = np.asarray([str(r) for r in ress[idx]])
            uniq_u = {u: i for i, u in enumerate(dict.fromkeys(t_users))}
            uniq_r = {r: i for i, r in enumerate(dict.fromkeys(t_ress))}
            nu, nr = len(uniq_u), len(uniq_r)
            ui = np.array([uniq_u[u] for u in t_users])
            ri = np.array([uniq_r[r] for r in t_ress])
            scaled = self._scale_likelihood(likes[idx])

            # duplicate (user, res) rows aggregate (every access counts,
            # matching ALS-over-rows semantics); mask from the index pairs
            # so zero/negative scaled likelihoods still count as observed
            dense = np.zeros((nu, nr), np.float32)
            np.add.at(dense, (ui, ri), scaled)
            observed = np.zeros((nu, nr), bool)
            observed[ui, ri] = True
            if bool(self.applyImplicitCf):
                # Hu-Koren: confidence 1 + alpha·r everywhere, binary
                # preference target (reference builds the implicit ALS at
                # collaborative_filtering.py:960-996).
                weights = 1.0 + alpha * dense
                targets = observed.astype(np.float32)
            else:
                # Explicit: regress scaled likelihoods on observed cells
                # plus sampled complement cells pinned to negScore
                # (reference: _enrich_and_normalize + ComplementAccess,
                # collaborative_filtering.py:858-888).
                n_draw = int(self.complementsetFactor) * len(idx)
                cu = rng.integers(0, nu, size=n_draw)
                cr = rng.integers(0, nr, size=n_draw)
                comp = np.zeros_like(observed)
                comp[cu, cr] = True
                comp &= ~observed
                targets = dense.copy()
                targets[comp] = float(self.negScore)
                weights = (observed | comp).astype(np.float32)

            u_f, v_f = _als(torch.as_tensor(weights, device=dev),
                            torch.as_tensor(targets, device=dev),
                            rank, int(self.maxIter), reg, int(self.seed))
            u_np = u_f.cpu().numpy().astype(np.float64)
            v_np = v_f.cpu().numpy().astype(np.float64)

            train_dots = np.einsum("ik,ik->i", u_np[ui], v_np[ri])
            std = float(train_dots.std())
            tenant_stats[t] = {"mean": float(train_dots.mean()),
                               "std": std if std != 0.0 else 1.0}
            user_vecs[t] = {u: u_np[i].tolist() for u, i in uniq_u.items()}
            res_vecs[t] = {r: v_np[i].tolist() for r, i in uniq_r.items()}
            uc, rc = _connected_components(t_users, t_ress)
            user_comp[t] = {str(k): v for k, v in uc.items()}
            res_comp[t] = {str(k): v for k, v in rc.items()}

        history = None
        hist_ds = self.get("historyAccessDs")
        if hist_ds is not None:
            history = [[str(t), str(u), str(r)] for t, u, r in
                       zip(hist_ds[self.tenantCol], hist_ds[self.userCol],
                           hist_ds[self.resCol])]

        return AccessAnomalyModel(
            tenantCol=self.tenantCol, userCol=self.userCol,
            resCol=self.resCol, outputCol=self.outputCol,
            userVectors=user_vecs, resVectors=res_vecs,
            tenantStats=tenant_stats, userComponents=user_comp,
            resComponents=res_comp, historyPairs=history)
