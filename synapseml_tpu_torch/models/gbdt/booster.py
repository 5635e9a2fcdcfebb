"""Boosting loop and the serializable Booster.

The PyTorch port of the JAX package's ``models/gbdt/booster.py`` on one
device: the boosting types gbdt, goss, dart and rf, bagging, the
depthwise and lossguide growth policies, the binary, multiclass,
multiclassova, regression and lambdarank objectives, validation sets
with early stopping (NDCG for rankers), iteration checkpoints and warm
starts, categorical features, exclusive feature bundling (EFB),
monotone constraints, and streamed ingestion from a chunked source.  The
JAX package scans the boosting loop on the device; here it is a Python
loop over the growers of :mod:`.trainer` with the kernels on the card.
Checkpoints are the JAX package's version-2 JSON (:meth:`Booster.to_dict`),
and :meth:`Booster.to_string` writes the LightGBM text format, so a
model, or a checkpoint, moves between the two packages both ways.

``train(..., mesh=ProcessMesh)`` trains data-parallel across the ranks
of a ``torch.distributed`` group (:mod:`synapseml_tpu_torch.parallel`):
every rank holds the full data and bins it identically, keeps its
contiguous block of the rows (padded to a multiple of the world size
with zero-weight rows), and the growers sum each decoded histogram
across the ranks through the collective planner
(``collective_compression``: none, bf16 or int8), so every rank grows
the same trees.  ``parallelism="voting_parallel"`` shards the rows the
same way but keeps each rank's histograms local: the lossguide grower
votes for features and sums only the voted features' histograms
(:func:`~.trainer._best_split_voting`).  ``parallelism=
"feature_parallel"`` replicates the rows and shards the features: every
rank bins all rows, keeps its slice of the columns (features padded to
a multiple of the world size with masked one-bin features; under EFB
one bundler per slice, padded to a common width) and grows with
:func:`~.trainer.grow_tree_feature_parallel`.  Lambdarank over a mesh
that shards rows packs whole query groups onto the ranks
(:func:`~.ranking.pack_groups_for_shards`, pad rows of zero weight) and
computes each rank's lambdas over its own groups; under feature_parallel
every rank runs the plain objective on all rows.  A mesh fit's ranks
checkpoint into one directory (every rank publishes the same
``iter_<n>.json``), and a relaunched gang of any size resumes from the
newest one: the rows re-shard over the new mesh, and a resize is
recorded, never refused.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, synchronize
from ...telemetry.gangplane import agree_capture, check_profiler
from . import metrics as metrics_mod
from .binning import (BinMapper, FeatureBundler, bin_features, bundle_bins,
                      fit_bin_mapper)
from .hist import rows_geometry
from . import prng
from ...parallel.collectives import psum
from ...parallel.compression import resolve_collective_config
from ...parallel.heartbeat import beat
from ...parallel.mesh import DATA_AXIS, ProcessMesh, block_bounds
from ...parallel.planner import planned_psum
from ...resilience.faults import get_faults
from ...telemetry.flight import record as flight_record
from .objectives import (get_objective, initial_score, objective_kwargs,
                         ova_grad_hess, softmax_grad_hess)
from .ranking import (build_group_index, make_lambdarank_objective,
                      make_lambdarank_objective_sharded,
                      pack_groups_for_shards)
from .trainer import (TWO_LEVEL_MIN_ROWS, GrowthParams, Tree,
                      default_n_slots, grow_tree, grow_tree_depthwise,
                      grow_tree_feature_parallel, max_nodes,
                      predict_binned_stacked, predict_binned_tree,
                      predict_binned_tree_featpar, predict_raw_features,
                      stack_trees, tree_depth)


@dataclasses.dataclass
class BoostingConfig:
    """TrainParams analogue; the JAX package's fields and defaults (field
    names follow LightGBM's config strings)."""
    objective: str = "regression"
    boosting_type: str = "gbdt"            # gbdt | rf | dart | goss
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    max_bin: int = 255
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    seed: int = 0
    num_class: int = 1
    boost_from_average: bool = True
    early_stopping_round: int = 0
    metric: str = ""
    top_rate: float = 0.2                  # goss
    other_rate: float = 0.1                # goss
    drop_rate: float = 0.1                 # dart
    max_drop: int = 50                     # dart
    skip_drop: float = 0.5                 # dart
    scale_pos_weight: float = 1.0
    is_unbalance: bool = False
    alpha: float = 0.9                     # huber / quantile
    tweedie_variance_power: float = 1.5
    fair_c: float = 1.0
    max_position: int = 10                 # lambdarank ndcg@
    label_gain: Optional[List[float]] = None
    bin_sample_count: int = 200_000
    bagging_seed: int = 3
    verbosity: int = -1
    parallelism: str = "data_parallel"
    top_k: int = 20                        # voting-parallel votes per rank
    growth_policy: str = "depthwise"
    #: two-level (coarse-then-refine) histograms for wide-bin growth:
    #: "auto" (on at >= 500k rows), "on", "off"
    two_level_hist: Any = "auto"
    refine_features: int = 8
    enable_bundle: bool = False
    max_conflict_rate: float = 0.0
    categorical_feature: Optional[List[int]] = None
    monotone_constraints: Optional[List[int]] = None
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    collective_compression: Any = "none"
    #: bf16 gradient/hessian ingest into the histogram quantization
    #: ("auto" = on); histogram sums stay exact over the rounded values
    fused_ingest: Any = "auto"
    pass_through: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def growth_params(self) -> GrowthParams:
        """The growers' params; ``voting_k`` is ``top_k`` under
        voting_parallel (it votes only over a mesh)."""
        mono = None
        if self.monotone_constraints and any(self.monotone_constraints):
            mono = tuple(int(c) for c in self.monotone_constraints)
        return GrowthParams(
            monotone_constraints=mono,
            monotone_penalty=float(self.monotone_penalty),
            monotone_method=self.monotone_constraints_method,
            num_leaves=self.num_leaves,
            max_depth=self.max_depth,
            min_data_in_leaf=float(self.min_data_in_leaf),
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            min_gain_to_split=self.min_gain_to_split,
            total_bins=self.max_bin + 1,
            voting_k=(self.top_k if self.parallelism == "voting_parallel"
                      else 0),
            two_level=({True: "on", False: "off"}.get(
                self.two_level_hist, str(self.two_level_hist))),
            refine_k=int(self.refine_features),
        )


def _fused_ingest_on(config: BoostingConfig) -> bool:
    v = config.fused_ingest
    if v in ("auto", "on", True):
        return True
    if v in ("off", False):
        return False
    raise ValueError(f"fused_ingest={v!r}: must be 'auto', 'on', 'off', "
                     "True or False")


#: objectives trained with K trees per iteration
MULTICLASS = ("multiclass", "multiclassova")
#: the ``parallelism`` values (LightGBM's tree learners)
PARALLELISM = ("data_parallel", "voting_parallel", "feature_parallel")


def _check_ported(config: BoostingConfig) -> None:
    """Raise ``ValueError`` for a config value no grower takes."""
    if config.parallelism not in PARALLELISM:
        raise ValueError(f"parallelism={config.parallelism!r}: must be one "
                         f"of {PARALLELISM}")
    if config.objective not in MULTICLASS + ("lambdarank",):
        get_objective(config.objective)
    elif config.objective in MULTICLASS and config.num_class < 2:
        raise ValueError(f"objective={config.objective!r} needs num_class "
                         f">= 2, got {config.num_class}")
    if config.boosting_type not in ("gbdt", "goss", "dart", "rf"):
        raise ValueError(f"boosting_type={config.boosting_type!r}: must be "
                         "'gbdt', 'goss', 'dart' or 'rf'")
    if config.growth_policy not in ("depthwise", "lossguide"):
        raise ValueError(f"growth_policy={config.growth_policy!r}: must be "
                         "'depthwise' or 'lossguide'")
    if config.two_level_hist not in ("auto", "on", "off", True, False):
        raise ValueError(f"two_level_hist={config.two_level_hist!r}: must "
                         "be 'auto', 'on', or 'off'")
    _fused_ingest_on(config)


def _check_monotone(config: BoostingConfig, F: int) -> None:
    """The JAX package's monotone config checks (``ValueError``)."""
    if not (config.monotone_constraints and any(config.monotone_constraints)):
        return
    if config.monotone_constraints_method not in ("basic", "intermediate",
                                                  "advanced"):
        raise ValueError(
            f"monotone_constraints_method="
            f"{config.monotone_constraints_method!r}: must be 'basic', "
            "'intermediate' or 'advanced'")
    if len(config.monotone_constraints) != F:
        raise ValueError(f"monotone_constraints has "
                         f"{len(config.monotone_constraints)} entries for "
                         f"{F} features")
    if any(int(c) not in (-1, 0, 1) for c in config.monotone_constraints):
        raise ValueError("monotone_constraints entries must be -1, 0, or 1")
    cats = set(config.categorical_feature or [])
    if any(int(c) != 0 and i in cats
           for i, c in enumerate(config.monotone_constraints)):
        raise ValueError("monotone constraints on categorical features are "
                         "not meaningful (category-subset splits have no "
                         "direction)")
    if config.monotone_constraints_method == "advanced":
        # the advanced refresh builds (M, M, F) masks (~5 bytes an entry)
        # per wave or split: refuse a config whose masks pass the budget
        m_nodes = max_nodes(config.num_leaves)
        adv_bytes = 5 * m_nodes * m_nodes * F
        budget = _advanced_mask_budget_bytes(config)
        if adv_bytes > budget:
            raise ValueError(
                f"monotone_constraints_method='advanced' with num_leaves="
                f"{config.num_leaves} and {F} features needs ~"
                f"{adv_bytes / 2**30:.1f} GiB of (M, M, F) constraint masks "
                f"per refresh (M={m_nodes} nodes), over the "
                f"{budget / 2**30:.1f} GiB budget; use monotone_constraints_"
                "method='intermediate' (a superset of the advanced "
                "constraints) for models this size, or raise the budget "
                "via SYNAPSEML_TPU_ADV_MONO_MASK_BYTES / pass_through="
                "{'advanced_mask_bytes': ...}")


def _available_host_bytes() -> int:
    """Best-effort available host memory (``MemAvailable`` of
    /proc/meminfo, then ``sysconf``'s free pages), 0 when neither source
    exists: the JAX package's order, so both refuse the same configs."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (AttributeError, OSError, ValueError):
        return 0


def _advanced_mask_budget_bytes(config: BoostingConfig) -> int:
    """Byte budget for the advanced method's (M, M, F) masks:
    ``pass_through={"advanced_mask_bytes": ...}``, then the
    ``SYNAPSEML_TPU_ADV_MONO_MASK_BYTES`` environment variable, else a
    quarter of the host's available memory clamped to [1 GiB, 8 GiB],
    the JAX package's rule.  On the card the masks live in device
    memory; at most 8 GiB of them fit an 80 GB card beside the fit."""
    override = config.pass_through.get(
        "advanced_mask_bytes",
        os.environ.get("SYNAPSEML_TPU_ADV_MONO_MASK_BYTES"))
    if override is not None:
        return int(float(override))
    return min(max(1 << 30, _available_host_bytes() // 4), 8 << 30)


def _voting(config: BoostingConfig) -> bool:
    """voting_parallel with votes to cast: it grows lossguide (the JAX
    package's rule; with ``top_k`` 0 the fit is data-parallel)."""
    return config.parallelism == "voting_parallel" and config.top_k > 0


def _n_slots(config: BoostingConfig) -> int:
    """Histogram slots of one build: a depthwise wave's, or one for
    lossguide's per-split build (voting grows lossguide)."""
    if config.growth_policy == "lossguide" or _voting(config):
        return 1
    return default_n_slots(config.num_leaves)


def _check_ported_on(config: BoostingConfig, device: torch.device) -> None:
    """Raise ``NotImplementedError`` before any work for a config the
    card cannot train: on a CUDA device, one feature's histogram at
    ``max_bin + 1`` bins and the slots of one build (a depthwise wave's,
    or lossguide's one) must fit a block's shared memory
    (``hist.rows_geometry``).  The CPU trains any width."""
    if device.type != "cuda":
        return
    try:
        rows_geometry(1, config.max_bin + 1, _n_slots(config))
    except ValueError as e:
        raise NotImplementedError(
            f"maxBin={config.max_bin} with numLeaves={config.num_leaves} "
            "is not ported yet (ROADMAP queue A, GBDT breadth: maxBin on "
            f"the card): {e}") from e


class Booster:
    """Trained model: host-resident flat tree arrays + binning metadata.
    Predicts on ``device`` (the device it was trained on, by default)."""

    def __init__(self, trees: List[Tree], tree_class: List[int],
                 tree_weights: List[float], num_class: int, objective: str,
                 init_score: np.ndarray, bin_mapper: BinMapper,
                 feature_names: List[str], config: BoostingConfig,
                 best_iteration: int = -1, device: DeviceLike = "cuda",
                 bundler: Optional[FeatureBundler] = None):
        self.trees = [Tree(*[np.asarray(torch.as_tensor(a).cpu())
                             for a in t]) for t in trees]
        self.tree_class = list(tree_class)
        self.tree_weights = list(tree_weights)
        self.num_class = num_class
        self.objective = objective
        self.init_score = np.asarray(init_score, np.float32).reshape(-1)
        self.bin_mapper = bin_mapper
        self.feature_names = list(feature_names)
        self.config = config
        self.best_iteration = best_iteration
        self.device = str(device)
        self.bundler = bundler

    # -- prediction --------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return len(self.trees)

    def _derived(self) -> dict:
        """Values derived from the trees (their depth bound, their stacks
        on a device), kept while ``trees`` holds the same tree objects and
        ``tree_weights`` / ``tree_class`` the same values.  Every predict
        call needs them; a fitted booster computes each once.  Readers
        never write an entry's tensors, and two threads that fill one key
        at once build equal values."""
        c = getattr(self, "_derived_cache", None)
        if c is None or not (
                len(c[0]) == len(self.trees)
                and all(a is b for a, b in zip(c[0], self.trees))
                and c[1] == self.tree_weights and c[2] == self.tree_class):
            c = self._derived_cache = (tuple(self.trees),
                                       list(self.tree_weights),
                                       list(self.tree_class), {})
        return c[3]

    def __getstate__(self):
        # a pickled booster carries no derived device tensors
        state = dict(self.__dict__)
        state.pop("_derived_cache", None)
        return state

    def depth_bound(self) -> int:
        d = self._derived()
        if "depth" not in d:
            d["depth"] = max((tree_depth(t) for t in self.trees), default=1)
        return d["depth"]

    def _stacked_for_class(self, k: int, num_iteration: Optional[int],
                           dev: torch.device) -> Optional[Tree]:
        d = self._derived()
        key = ("stacked", k, num_iteration, str(dev))
        if key not in d:
            d[key] = self._stack_class(k, num_iteration, dev)
        return d[key]

    def _stack_class(self, k: int, num_iteration: Optional[int],
                     dev: torch.device) -> Optional[Tree]:
        sel = [i for i, c in enumerate(self.tree_class) if c == k]
        if num_iteration is not None and num_iteration >= 0:
            sel = sel[:num_iteration]
        if not sel:
            return None
        trees = []
        for i in sel:
            t = self.trees[i]
            w = self.tree_weights[i]
            trees.append(t._replace(leaf_value=t.leaf_value * np.float32(w)))
        return Tree(*[t.to(dev) for t in stack_trees(trees)])

    def predict_margin(self, features: np.ndarray,
                       num_iteration: Optional[int] = None,
                       return_leaves: bool = False,
                       device: Optional[DeviceLike] = None):
        """Raw margin (n,) or (n, K): batched tree traversal on the
        device.  Categorical models split in bin space: their rows bin on
        the device and traverse by ``split_bin`` (an imported LightGBM
        categorical model, whose mapper is a placeholder, maps only its
        categorical columns to bin ids and keeps raw thresholds).  EFB
        models need nothing special: their trees split original
        features."""
        dev = resolve_device(self.device if device is None else device)
        features = np.ascontiguousarray(features, np.float32)
        n = features.shape[0]
        depth = self.depth_bound()
        binned = None
        if self.bin_mapper.has_categorical:
            if _placeholder_mapper(self.bin_mapper):
                features = self._cat_columns_to_bins(features)
            else:
                binned = bin_features(features, self.bin_mapper, dev)
        x = None if binned is not None else torch.as_tensor(features,
                                                            device=dev)
        outs, leaves = [], []
        for k in range(self.num_class):
            stacked = self._stacked_for_class(k, num_iteration, dev)
            base = self.init_score[min(k, len(self.init_score) - 1)]
            if stacked is None:
                outs.append(np.full(n, base, np.float32))
                leaves.append(np.zeros((0, n), np.int32))
                continue
            if binned is not None:
                total, lv = predict_binned_stacked(binned, stacked, depth)
            else:
                total, lv = predict_raw_features(x, stacked, depth)
            total = total.cpu().numpy() + base
            if self.config.boosting_type == "rf":
                ntree = stacked.split_feature.shape[0]
                total = base + (total - base) / max(ntree, 1)
            outs.append(total)
            leaves.append(lv.cpu().numpy())
        margin = outs[0] if self.num_class == 1 else np.stack(outs, axis=1)
        if return_leaves:
            return margin, leaves
        return margin

    def _cat_columns_to_bins(self, features: np.ndarray) -> np.ndarray:
        """An imported model's hybrid view: categorical columns become
        their bin ids (floats), numeric columns pass through.  Unseen
        categories and NaN land in bin 0, which every bin-space split
        sends left."""
        out = features.copy()
        for f, (vals, bins) in (self.bin_mapper.cat_features or {}).items():
            col = features[:, f]
            if len(vals) == 0:
                out[:, f] = 0.0
                continue
            idx = np.searchsorted(vals, col)
            idx_c = np.minimum(idx, len(vals) - 1)
            hit = np.asarray(vals)[idx_c] == col
            out[:, f] = np.where(hit, np.asarray(bins)[idx_c], 0)
        return out

    def predict_leaf(self, features: np.ndarray,
                     device: Optional[DeviceLike] = None) -> np.ndarray:
        """Per-tree leaf index (n, num_trees)."""
        _, leaves = self.predict_margin(features, return_leaves=True,
                                        device=device)
        return np.concatenate([l for l in leaves if l.size], axis=0).T

    def to_proba(self, margin: np.ndarray) -> np.ndarray:
        if self.objective in ("multiclass", "multiclassova"):
            if self.objective == "multiclassova":
                p = 1.0 / (1.0 + np.exp(-margin))
                return p / np.maximum(p.sum(1, keepdims=True), 1e-12)
            m = margin - margin.max(axis=1, keepdims=True)
            e = np.exp(m)
            return e / e.sum(axis=1, keepdims=True)
        p1 = 1.0 / (1.0 + np.exp(-margin))
        return np.stack([1 - p1, p1], axis=1)

    def predict_contrib(self, features: np.ndarray,
                        approximate: bool = False) -> np.ndarray:
        """Per-feature contributions + bias (``featuresShapCol``), on the
        host as in the JAX package: exact TreeSHAP over the per-node
        covers (:mod:`.shap`) by default; ``approximate=True``, or a
        model without cover counts (an imported file lacking
        ``internal_count``), takes the Saabas path attribution.
        Categorical models route in bin space; an imported categorical
        model takes its hybrid view (categorical columns as bin ids).
        → (n, F+1), or (n, K·(F+1)) for multiclass (the last slot of each
        block is the bias)."""
        imported_cat = (self.bin_mapper.has_categorical
                        and _placeholder_mapper(self.bin_mapper))
        bin_space = self.bin_mapper.has_categorical and not imported_cat
        if imported_cat:
            features = self._cat_columns_to_bins(
                np.ascontiguousarray(features, np.float32))
        from .shap import has_cover_counts, tree_shap_values
        if not approximate and has_cover_counts(self):
            return tree_shap_values(self, features, bin_space=bin_space)
        features = np.ascontiguousarray(features, np.float32)
        if bin_space:
            features = self.bin_mapper.transform(features).astype(np.float32)
        n = features.shape[0]
        F = self.bin_mapper.num_features
        out = np.zeros((n, self.num_class, F + 1), np.float64)
        rows = np.arange(n)
        for i, t in enumerate(self.trees):
            k = self.tree_class[i]
            w = self.tree_weights[i]
            if self.config.boosting_type == "rf":
                cls_count = max(sum(1 for c in self.tree_class if c == k), 1)
                w = w / cls_count
            nv = t.node_value.astype(np.float64)
            cur = np.zeros(n, np.int64)
            out[:, k, F] += nv[0] * w
            for _ in range(tree_depth(t)):
                feat = t.split_feature[cur]
                internal = feat >= 0
                if not internal.any():
                    break
                f = np.maximum(feat, 0)
                x = features[rows, f]
                if bin_space:
                    go_left = x <= np.asarray(t.split_bin)[cur]
                else:
                    miss = np.isnan(x) | (np.asarray(t.missing_zero)[cur]
                                          & (np.abs(x) <= 1e-35))
                    go_left = np.where(miss, t.default_left[cur],
                                       x <= t.threshold[cur])
                nxt = np.where(go_left, t.left_child[cur], t.right_child[cur])
                nxt = np.where(internal, nxt, cur)
                delta = (nv[nxt] - nv[cur]) * w
                np.add.at(out, (rows[internal], np.full(internal.sum(), k),
                                f[internal]), delta[internal])
                cur = nxt
        out[:, :, F] += self.init_score[:self.num_class][None, :]
        if self.num_class == 1:
            return out[:, 0, :]
        return out.reshape(n, -1)

    # -- introspection -----------------------------------------------------
    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """Split counts or total gains per feature."""
        out = np.zeros(len(self.feature_names), np.float64)
        for t in self.trees:
            for node in np.nonzero(np.asarray(t.split_feature) >= 0)[0]:
                w = (1.0 if importance_type == "split"
                     else float(t.split_gain[node]))
                out[int(t.split_feature[node])] += w
        return out

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """The JAX package's version-2 model JSON."""
        return {
            "version": 2,
            "num_class": self.num_class,
            "objective": self.objective,
            "init_score": self.init_score.tolist(),
            "feature_names": self.feature_names,
            "tree_class": self.tree_class,
            "tree_weights": self.tree_weights,
            "best_iteration": self.best_iteration,
            "config": dataclasses.asdict(self.config),
            "bin_mapper": {
                "upper_bounds": self.bin_mapper.upper_bounds.tolist(),
                "num_bins": self.bin_mapper.num_bins.tolist(),
                "max_bin": self.bin_mapper.max_bin,
                "cat_features": {
                    str(f): [np.asarray(v).tolist(), np.asarray(b).tolist()]
                    for f, (v, b) in
                    (self.bin_mapper.cat_features or {}).items()} or None,
            },
            "bundler": self.bundler.to_dict() if self.bundler else None,
            "trees": [{f: np.asarray(getattr(t, f)).tolist()
                       for f in Tree._fields} for t in self.trees],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: Dict[str, Any],
                  device: DeviceLike = "cuda") -> "Booster":
        """Read the version-2 model JSON (the JAX package's or this
        package's :meth:`to_dict`)."""
        if int(d.get("version", 1)) != 2:
            raise ValueError(f"model JSON version {d.get('version')!r}: "
                             "only version 2 is read")
        names = {f.name for f in dataclasses.fields(BoostingConfig)}
        cfg = BoostingConfig(**{k: v for k, v in d["config"].items()
                                if k in names})
        cat_raw = d["bin_mapper"].get("cat_features")
        bm = BinMapper(
            upper_bounds=np.asarray(d["bin_mapper"]["upper_bounds"],
                                    np.float32),
            num_bins=np.asarray(d["bin_mapper"]["num_bins"], np.int32),
            max_bin=d["bin_mapper"]["max_bin"],
            cat_features={int(f): (np.asarray(v, np.float32),
                                   np.asarray(b, np.int32))
                          for f, (v, b) in cat_raw.items()}
            if cat_raw else None)
        trees = []
        for td in d["trees"]:
            m = len(td["leaf_value"])
            trees.append(Tree(
                split_feature=np.asarray(td["split_feature"], np.int32),
                split_bin=np.asarray(td["split_bin"], np.int32),
                threshold=np.asarray(td["threshold"], np.float32),
                split_gain=np.asarray(td["split_gain"], np.float32),
                left_child=np.asarray(td["left_child"], np.int32),
                right_child=np.asarray(td["right_child"], np.int32),
                leaf_value=np.asarray(td["leaf_value"], np.float32),
                node_value=np.asarray(td["node_value"], np.float32),
                num_nodes=np.asarray(td["num_nodes"], np.int32),
                default_left=np.asarray(
                    td.get("default_left", np.ones(m, bool)), bool),
                node_count=np.asarray(
                    td.get("node_count", np.zeros(m)), np.float32),
                missing_zero=np.asarray(
                    td.get("missing_zero", np.zeros(m, bool)), bool)))
        return Booster(trees, d["tree_class"], d["tree_weights"],
                       d["num_class"], d["objective"],
                       np.asarray(d["init_score"], np.float32), bm,
                       d["feature_names"], cfg, d["best_iteration"],
                       device=device,
                       bundler=(FeatureBundler.from_dict(d["bundler"])
                                if d.get("bundler") else None))

    @staticmethod
    def from_json(s: str, device: DeviceLike = "cuda") -> "Booster":
        return Booster.from_dict(json.loads(s), device=device)

    def to_string(self) -> str:
        """The LightGBM text model format (:mod:`.lgbm_format`): the JAX
        package's ``to_string`` bytes for the same model, loadable by any
        LightGBM runtime.  Checkpoints keep the version-2 JSON
        (:meth:`to_json`)."""
        from .lgbm_format import booster_to_lgbm_string
        return booster_to_lgbm_string(self)

    @staticmethod
    def from_string(s: str, device: DeviceLike = "cuda") -> "Booster":
        """Read either format, in the JAX package's order: the version-2
        JSON when the text starts with ``{``, else a LightGBM text
        model."""
        if s.lstrip().startswith("{"):
            return Booster.from_json(s, device=device)
        from .lgbm_format import booster_from_lgbm_string
        return booster_from_lgbm_string(s, device=device)

    @staticmethod
    def from_file(path: str, device: DeviceLike = "cuda") -> "Booster":
        with open(path) as f:
            return Booster.from_string(f.read(), device=device)


@dataclasses.dataclass
class InstrumentationMeasures:
    """Per-phase wall clock of one fit, attached to the Booster as
    ``.measures``.  Every phase ends in a device synchronize, so the
    clock covers the device work."""
    binning_s: float = 0.0            # bin-mapper fit + device binning
    data_prep_s: float = 0.0          # labels/weights/init score on device
    training_s: float = 0.0           # whole boosting loop
    eval_s: float = 0.0               # validation (within training_s)
    iterations: int = 0
    total_s: float = 0.0

    def seconds_per_iteration(self) -> float:
        return self.training_s / max(self.iterations, 1)


@dataclasses.dataclass
class EvalRecord:
    iteration: int
    metric: str
    value: float


@dataclasses.dataclass
class EarlyStopping:
    """The JAX package's early-stopping rule over a validation metric:
    stop once ``rounds`` (> 0) evaluations in a row did not improve on the
    best; ``best_iter`` is the iteration of the best value."""
    rounds: int
    larger_better: bool
    best_val: Optional[float] = None
    best_iter: int = -1
    since_best: int = 0

    def update(self, it: int, val: float) -> bool:
        """Record iteration ``it``'s value → True when training stops."""
        if self.best_val is None or (val > self.best_val if
                                     self.larger_better
                                     else val < self.best_val):
            self.best_val, self.best_iter, self.since_best = val, it, 0
            return False
        self.since_best += 1
        return self.rounds > 0 and self.since_best >= self.rounds


def _hist_psum_nulled(config: BoostingConfig, mesh_present: bool) -> bool:
    """True where the data-parallel histogram psum does not exist (no
    mesh, feature/voting parallelism): the JAX package's predicate for
    "is the histogram wire codec live"."""
    return (not mesh_present
            or config.parallelism in ("feature_parallel", "voting_parallel"))


def _mesh_world_size(mesh) -> int:
    """The rank count of a fit's mesh (1 with no mesh): the one
    derivation of the checkpoint stamp and the resume comparison."""
    return 1 if mesh is None else int(mesh.world_size)


def _effective_wire_key(config: BoostingConfig, mesh=None):
    """The histogram-psum wire a fit uses, as the checkpoints stamp it
    (the JAX package's key): ``None`` for the flat f32 wire, which is
    every fit without a mesh or without the data-parallel psum
    (:func:`_hist_psum_nulled`); else the codec's (compression, min_size,
    int8 chunk), with the planner's routing appended when it is not flat.
    The world size is not part of the key: a resize resumes."""
    cc = resolve_collective_config(config.collective_compression)
    if cc is None or _hist_psum_nulled(config, mesh is not None):
        return None
    from ...parallel.planner import get_planner
    routing = get_planner().resolved_routing(
        cc, world=_mesh_world_size(mesh))
    if not cc.compresses and routing == "flat":
        return None
    key = ((cc.compression, cc.min_size,
            cc.chunk if cc.compression == "int8" else 0)
           if cc.compresses else ("none", 0, 0))
    if routing != "flat":
        key = key + (routing,)
    return key


_CKPT = re.compile(r"iter_(\d+)\.json$")


def _latest_checkpoint(directory: str,
                       device: DeviceLike = "cuda") -> Optional["Booster"]:
    """The newest ``iter_<n>.json`` of ``directory`` (either package's),
    or None."""
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(directory)
             for m in [_CKPT.match(name)] if m]
    if not found:
        return None
    with open(os.path.join(directory, max(found)[1])) as f:
        return Booster.from_json(f.read(), device=device)


def _write_checkpoint(directory: str, booster: "Booster",
                      keep: int = 3, rank: int = 0) -> None:
    """Write ``iter_<iterations>.json`` atomically (a temporary file, then
    ``os.replace``, so a kill leaves only the previous checkpoint for
    :func:`_latest_checkpoint`) and keep the newest ``keep``.

    Every rank of a mesh fit writes the same file into the one
    directory, each through its own temporary name (rank and pid).  The
    concurrent publishes are safe: every rank holds the same booster, so
    they rename equal bytes onto one name, and ``os.replace`` is atomic,
    so a reader sees one whole copy or the previous step.  A relaunched
    gang of any world size reads the newest.  After the publish the
    iteration is this rank's durable position: it is beaten on the
    heartbeat channel (the supervisor's recovery clock reads it) and
    recorded in the flight ring, between the
    ``gbdt.checkpoint.pre_publish`` and ``gbdt.checkpoint`` kill
    points."""
    os.makedirs(directory, exist_ok=True)
    n = booster.num_trees // max(booster.num_class, 1)
    path = os.path.join(directory, f"iter_{n:08d}.json")
    tmp = path + f".tmp{rank}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(booster.to_dict(), f)
    # a SIGKILL here leaves only the temporary file, which
    # _latest_checkpoint never matches: a resume sees the step before
    get_faults().kill_point("gbdt.checkpoint.pre_publish", iteration=n)
    os.replace(tmp, path)
    beat(step=n)
    flight_record("checkpoint", step=n, path=path)
    get_faults().kill_point("gbdt.checkpoint", iteration=n)
    steps = sorted(int(m.group(1)) for m in map(_CKPT.match,
                                                os.listdir(directory)) if m)
    for old in steps[:-keep]:
        try:
            os.remove(os.path.join(directory, f"iter_{old:08d}.json"))
        except OSError:
            pass


def _placeholder_mapper(m: BinMapper) -> bool:
    """An imported LightGBM model's mapper: all-inf bounds, one bin."""
    return bool(np.all(m.num_bins <= 1)) and bool(np.all(np.isinf(
        m.upper_bounds)))


def _replay_margin(b: "Booster", X: np.ndarray,
                   dev: torch.device) -> torch.Tensor:
    """A warm start's training margin on the device, re-based in the
    training order of f32 adds: the loop advances scores one add per tree
    (``scores + leaf_value[node_id]``), while ``predict_margin`` sums the
    trees in another order; replaying each tree's leaf values in turn
    reproduces training's rounding, so a resumed gbdt/goss run continues
    on the identical trees.  dart and rf reweight trees at predict time
    and take ``predict_margin`` (their resume is approximate, as in the
    JAX package)."""
    if b.config.boosting_type not in ("gbdt", "goss") \
            or any(w != 1.0 for w in b.tree_weights):
        return torch.as_tensor(b.predict_margin(X, device=dev), device=dev)
    _, leaves = b.predict_margin(X, return_leaves=True, device=dev)
    K = max(b.num_class, 1)
    cols = []
    for k in range(K):
        base = float(b.init_score[min(k, len(b.init_score) - 1)])
        m = torch.full((len(X),), base, dtype=torch.float32, device=dev)
        ids = torch.as_tensor(leaves[k], device=dev).long()
        ktrees = [t for t, kc in zip(b.trees, b.tree_class) if kc == k]
        for t, tree in enumerate(ktrees):
            m = m + torch.as_tensor(tree.leaf_value, device=dev)[ids[t]]
        cols.append(m)
    return cols[0] if K == 1 else torch.stack(cols, dim=1)


def goss_weights(g_abs: torch.Tensor, bag: torch.Tensor, key: prng.Key,
                 top_rate: float, other_rate: float) -> torch.Tensor:
    """Gradient one-side sampling (the JAX package's ``goss_weights``):
    keep the ``top_rate`` share of the bagged rows by |grad|, sample
    ``other_rate`` of the rest from ``key`` and amplify them by
    ``(1 - top_rate) / other_rate``; rows outside the bag weigh 0.  The
    threshold is read from a sort on the device (no host sync)."""
    n = g_abs.shape[0]
    n_real = (bag > 0).sum().to(torch.float32)
    k = torch.clamp_min((n_real * top_rate).to(torch.int32), 1)
    sorted_desc = torch.sort(g_abs * (bag > 0), descending=True).values
    thresh = sorted_desc[torch.clamp_max(k - 1, n - 1).long()]
    topset = g_abs >= thresh
    rest_keep = prng.uniform(key, n, g_abs.device) < other_rate
    amp = (1.0 - top_rate) / max(other_rate, 1e-6)
    return torch.where(topset, 1.0, torch.where(rest_keep, amp, 0.0)) * bag


def bag_mask(key: prng.Key, n: int, fraction: float,
             device: torch.device) -> torch.Tensor:
    """The bagging mask (n,) f32 in {0, 1}: ``uniform(key) < fraction``,
    drawn on ``device``."""
    return (prng.uniform(key, n, device) < fraction).to(torch.float32)


def _grad_hess(fn, scores: torch.Tensor, *args):
    """The objective evaluated in float64 and rounded to float32.  The
    card's and the CPU's f32 ``exp``/``sigmoid`` differ in the last bit
    now and then, and the int8-limb quantization can carry that bit into
    a histogram and flip a near-tie split; rounded from float64, both
    devices give the correctly rounded f32 value."""
    g, h = fn(scores.double(), *args)
    return g.float(), h.float()


def _add_scores(scores, contrib, k: int, K: int):
    if K == 1:
        return scores + contrib
    out = scores.clone()
    out[:, k] += contrib
    return out


def _bin_rows(x: np.ndarray, mapper: BinMapper,
              bundler: Optional[FeatureBundler],
              dev: torch.device) -> torch.Tensor:
    b = bin_features(x, mapper, dev)
    return bundle_bins(b, bundler) if bundler is not None else b


def _bin_stream(source, mapper: BinMapper,
                bundler: Optional[FeatureBundler], n: int,
                dev: torch.device, rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
    """The binned matrix of a chunked source: each chunk is uploaded,
    binned (and bundled) on ``dev`` and written straight into its column
    range of one preallocated (Fb, n) int32 matrix, so neither the host
    nor the device holds a second copy.  ``rows`` = [lo, hi): only those
    rows of the source, rows at ``>= n`` binned as all-NaN pad rows (a
    data-parallel rank's block)."""
    lo, hi = rows if rows is not None else (0, n)
    Fb = bundler.num_bundles if bundler is not None else mapper.num_features
    out = torch.empty((Fb, hi - lo), dtype=torch.int32, device=dev)
    start = 0
    for cx, _, _ in source.iter_chunks():
        a, b = max(start, lo), min(start + len(cx), hi)
        if a < b:
            out[:, a - lo:b - lo] = _bin_rows(cx[a - start:b - start],
                                              mapper, bundler, dev)
        start += len(cx)
    if start != n:
        raise ValueError(f"the source's chunks hold {start} rows, its "
                         f"num_rows {n}")
    if hi > n:
        out[:, max(n, lo) - lo:] = _bin_rows(
            np.full((1, mapper.num_features), np.nan, np.float32), mapper,
            bundler, dev)
    return out


def _block(a: Optional[np.ndarray], lo: int, hi: int, fill=0):
    """Rows [lo, hi) of ``a``, padded past its end with ``fill``."""
    if a is None:
        return None
    part = a[lo:min(hi, len(a))]
    pad = hi - max(lo, len(a))
    if pad > 0:
        part = np.concatenate(
            [part, np.full((pad,) + a.shape[1:], fill, a.dtype)])
    return part


def _featpar_columns(X, source, mapper: BinMapper, config: BoostingConfig,
                     shards: int, rank: int, bins_full, dev) -> dict:
    """This rank's columns under feature_parallel: the features pad to
    ``F_loc · shards`` with one-bin features (bin 0, bound +inf, never
    split), rank r keeps features [r·F_loc, (r+1)·F_loc).  Under EFB one
    bundler fits each rank's slice of the 50k-row sample (bundles never
    cross ranks; every rank fits all of them, so all agree on the common
    width their bundled columns pad to) → {"bins" (Fb_loc, n), "bundle_map"
    (this rank's route tables) or None, "upper_bounds" (F_loc, B-1),
    "num_bins" (F_loc,), "F_loc"}."""
    F = mapper.num_features
    B = config.max_bin + 1
    F_loc = -(-F // shards)
    Fp = F_loc * shards
    f0, f1 = rank * F_loc, min((rank + 1) * F_loc, F)
    nb_pad = np.concatenate([mapper.num_bins,
                             np.ones(Fp - F, mapper.num_bins.dtype)])
    ub_pad = np.concatenate([mapper.upper_bounds, np.full(
        (Fp - F, mapper.upper_bounds.shape[1]), np.inf, np.float32)])
    if bins_full is None:
        bins_full = _bin_stream(source, mapper, None, source.num_rows, dev)
    bins = torch.zeros((F_loc, bins_full.shape[1]), dtype=torch.int32,
                       device=dev)
    bins[:max(f1 - f0, 0)] = bins_full[f0:f1]
    del bins_full
    bundle_map = None
    if config.enable_bundle:
        take = min(config.bin_sample_count, 50_000)
        sample = (source.sample_rows(take, config.seed) if source is not None
                  else X[:take])
        sb = bin_features(np.ascontiguousarray(sample, np.float32), mapper,
                          dev).t().cpu().numpy()
        sb = np.concatenate([sb, np.zeros((len(sb), Fp - F), sb.dtype)], 1)
        bundlers = [FeatureBundler.fit(
            sb[:, r * F_loc:(r + 1) * F_loc], nb_pad[r * F_loc:(r + 1) * F_loc],
            max_total_bins=B, max_conflict_rate=config.max_conflict_rate)
            for r in range(shards)]
        width = max(b.num_bundles for b in bundlers)
        mine = bundlers[rank]
        bundled = bundle_bins(bins, mine)
        bins = torch.zeros((width, bins.shape[1]), dtype=torch.int32,
                           device=dev)
        bins[:bundled.shape[0]] = bundled
        bundle_map = {k: torch.as_tensor(v.astype(np.int32), device=dev)
                      for k, v in mine.route_tables(
                          nb_pad[rank * F_loc:(rank + 1) * F_loc],
                          B).items()}
    return dict(bins=bins, bundle_map=bundle_map,
                upper_bounds=ub_pad[rank * F_loc:(rank + 1) * F_loc],
                num_bins=nb_pad[rank * F_loc:(rank + 1) * F_loc],
                F_loc=F_loc)


def train(X, y: Optional[np.ndarray], config: BoostingConfig,
          sample_weight: Optional[np.ndarray] = None,
          feature_names: Optional[Sequence[str]] = None,
          valid: Optional[Tuple] = None,
          init_model: Optional[Booster] = None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_interval: int = 0,
          group: Optional[np.ndarray] = None,
          valid_group: Optional[np.ndarray] = None,
          mesh=None,
          step_profiler=None,
          device: DeviceLike = "cuda") -> Tuple[Booster, List[EvalRecord]]:
    """Full training run on ``device`` → (booster, eval history).

    Raw features bin on the device; gradients, the binned matrix and the
    scores stay there for the whole run, and each tree comes back to the
    host once it is grown.  The random streams are the JAX package's:
    the bagging and GOSS masks are threefry draws (:mod:`.prng`) made on
    the device, and feature_fraction and DART draw from one host numpy
    generator seeded with ``seed``, in the JAX package's order.

    ``valid`` = (X, y, weights or None): after every iteration the new
    trees' outputs add to the validation margins on the device and the
    metric (``config.metric``, else the objective's default) is copied to
    the host, one scalar an iteration; ``early_stopping_round`` > 0 stops
    after that many evaluations without improvement, and the model's
    ``best_iteration`` is the best one's.  ``init_model`` continues
    training from a model (its trees, bin mapper, bundler and init
    score).  ``checkpoint_dir`` (a directory, or a
    :class:`~synapseml_tpu_torch.core.checkpoint.CheckpointManager`,
    whose ``directory`` is used) with ``checkpoint_interval`` > 0 writes
    the partial model every that many iterations (the JAX package's
    checkpoint files: either package resumes the other's) and a later
    call with the same directory resumes from the newest one: an
    unbagged gbdt/goss resume grows the trees the uninterrupted run
    would; rf continues the same bag stream; dart freezes the carried
    trees' weights (approximate, as in the JAX package).  A checkpoint
    whose histogram wire (codec and routing) or ingest differs from this
    fit's raises ``ValueError``; one written at another world size
    resumes (a gang resize), recorded as the ``gbdt.resize_resume``
    fault note and flight event.

    ``X`` is a numpy matrix or a chunked source (anything with
    ``num_rows``, ``num_features``, ``iter_chunks``, ``sample_rows``,
    ``read_labels`` and ``read_weights``, such as
    :class:`~synapseml_tpu_torch.io.colstore.ChunkedColumnSource`): the bin
    mapper fits on ``sample_rows``, and each chunk is uploaded and binned
    (and bundled) on the device straight into its column range of the
    binned matrix, so host memory stays O(chunk) plus the label, weight
    and score vectors.  With a source carrying a label column, ``y=None``
    reads the labels from it.  Streamed categorical bins are ordered by
    value (the sample carries no aligned labels), as in the JAX package.

    ``objective="lambdarank"`` takes ``group``, the query group sizes in
    row order (rows group-contiguous), and NDCG validation
    ``valid_group``.

    ``mesh`` (a :class:`~synapseml_tpu_torch.parallel.mesh.ProcessMesh`
    on ``device``) trains data-parallel over its ``data`` axis, the JAX
    package's ``train(..., mesh=data_parallel_mesh(n))``: every rank
    passes the full data, fits the same bin mapper, keeps its contiguous
    block of the rows padded to a multiple of the world size with
    zero-weight rows, folds its rank into the bagging key, and sums each
    decoded histogram across the ranks (``collective_compression`` on
    the wire); every rank returns the same booster.  ``parallelism``
    voting_parallel (rows sharded the same way, lossguide with the
    voting pick) and feature_parallel (rows replicated, features
    sharded) train over the mesh too, and so does lambdarank (whole
    query groups packed onto the ranks where rows are sharded).  Every
    rank checkpoints into the same directory (:func:`_write_checkpoint`).
    Over a mesh every rank captures the step profiler's cost at the same
    iteration (the capture reruns it, collectives included): the ranks
    must agree on ``capture_xla`` (``ValueError`` before any work).

    ``step_profiler`` (a :class:`~synapseml_tpu_torch.telemetry.gangplane
    .StepProfiler`) decomposes each iteration's wall time into data (the
    draws) / compute (the trees grown and copied to the host, a sync) /
    other (evaluation, checkpoint).  With its ``capture_xla`` it captures
    one iteration's cost once (``gbdt_step``), running the iteration on
    a copy of the scores (the fit's trees do not change; the capture's
    time is left out of the step).  Without a profiler nothing is
    added."""
    dev = resolve_device(device)
    if mesh is not None:
        if not isinstance(mesh, ProcessMesh):
            raise TypeError(f"mesh must be a ProcessMesh, got "
                            f"{type(mesh).__name__}")
        if mesh.device != dev:
            raise ValueError(f"the mesh's device {mesh.device} is not "
                             f"device={dev}")
    # a CheckpointManager (anything carrying ``.directory``) checkpoints
    # into its directory
    if checkpoint_dir is not None and not isinstance(checkpoint_dir,
                                                     (str, os.PathLike)):
        if getattr(checkpoint_dir, "directory", None) is None:
            raise TypeError(
                "checkpoint_dir must be a directory or a "
                "core.checkpoint.CheckpointManager (an object with a "
                f"directory), got {type(checkpoint_dir).__name__}")
        checkpoint_dir = checkpoint_dir.directory
    _check_ported(config)
    _check_ported_on(config, dev)
    check_profiler(step_profiler, "train")
    agree_capture(step_profiler, mesh)
    # the histogram wire's codec (validated here; it applies only where
    # the histogram all-reduce exists: over a mesh)
    cconfig = resolve_collective_config(config.collective_compression)
    measures = InstrumentationMeasures()
    t0 = time.perf_counter()
    ckpt_every = checkpoint_interval if checkpoint_dir else 0
    if ckpt_every > 0:
        resumed = _latest_checkpoint(checkpoint_dir, dev)
        if resumed is not None:
            # the remaining trees must grow on the histogram wire and
            # ingest the carried ones grew on: a stamp from either
            # package names them
            saved_pt = resumed.config.pass_through or {}
            saved_cc = saved_pt.get("_codec_wire_key")
            saved_cc = tuple(saved_cc) if saved_cc is not None else None
            cur_cc = _effective_wire_key(config, mesh)
            if saved_cc != cur_cc:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} was trained with "
                    f"collective_compression wire {saved_cc!r} but this "
                    f"fit requests {cur_cc!r}; resuming would grow the "
                    "remaining trees under different histogram numerics "
                    "— use a fresh checkpoint_dir or keep the codec")
            saved_fused = bool(saved_pt.get("_fused_ingest", False))
            cur_fused = _fused_ingest_on(config)
            if saved_fused != cur_fused:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} was trained with "
                    f"fused_ingest={saved_fused} but this fit requests "
                    f"{cur_fused}; resuming would grow the remaining "
                    "trees under a different histogram ingest dtype — "
                    "use a fresh checkpoint_dir or keep the knob "
                    "(fused_ingest=False resumes pre-fused checkpoints)")
            # the world size is not part of the refusal: an elastic gang
            # resize resumes an N-rank checkpoint on M ranks (the rows
            # re-shard below; the histogram psum sums over all rows, so
            # the partition is not model state), and is recorded
            cur_ws = _mesh_world_size(mesh)
            saved_ws = saved_pt.get("_fit_world_size")
            if saved_ws is not None and int(saved_ws) != cur_ws:
                get_faults().note("gbdt.resize_resume",
                                  saved=int(saved_ws), current=cur_ws)
                flight_record("resize_resume", trainer="gbdt",
                              saved_shards=int(saved_ws),
                              current_shards=cur_ws)
            done = resumed.num_trees // max(resumed.num_class, 1)
            if mesh is not None:
                # the restored durable position: the supervisor's
                # recovery clock closes on the first beat at the dead
                # attempt's highest step, which a resume already holds
                beat(done)
            if done >= config.num_iterations:
                return resumed, []
            config = dataclasses.replace(
                config, num_iterations=config.num_iterations - done)
            init_model = resumed
        key = _effective_wire_key(config, mesh)
        config = dataclasses.replace(config, pass_through={
            **config.pass_through,
            "_codec_wire_key": list(key) if key is not None else None,
            "_fused_ingest": _fused_ingest_on(config),
            "_fit_world_size": _mesh_world_size(mesh)})

    source = X if hasattr(X, "iter_chunks") else None
    if source is not None:
        n, F = source.num_rows, source.num_features
        if y is None:
            y = source.read_labels()
            if y is None:
                raise ValueError("streaming train with y=None needs the "
                                 "source to carry a label_col")
        if sample_weight is None:
            sample_weight = source.read_weights()
    else:
        X = np.ascontiguousarray(X, np.float32)
        n, F = X.shape
    n_src = n
    featpar = mesh is not None and config.parallelism == "feature_parallel"
    rank, shards = ((0, 1) if mesh is None else
                    (mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS)))
    if config.objective == "lambdarank":
        if group is None:
            raise ValueError("lambdarank requires group sizes (groupCol)")
        group = np.asarray(group)
        if int(group.sum()) != n:
            raise ValueError(f"group sizes sum to {int(group.sum())}, the "
                             f"data has {n} rows")
    lr_pack = stream_perm = None
    if config.objective == "lambdarank" and mesh is not None \
            and not featpar:
        # rows are sharded: whole groups pack onto the ranks, each rank's
        # slab padded to a common length L with zero-weight rows; a
        # streamed source permutes its binned columns on the device
        perm, sq, smask, L = pack_groups_for_shards(group, shards, 1,
                                                    max_group_size=128)
        real = perm >= 0
        pc = np.maximum(perm, 0)
        if source is not None:
            stream_perm = (pc[rank * L:(rank + 1) * L],
                           real[rank * L:(rank + 1) * L])
        else:
            X = X[pc]
            X[~real] = np.nan          # pads must not move the bin bounds
        y = np.asarray(y)[pc] * real
        sw = (np.asarray(sample_weight, np.float32)[pc]
              if sample_weight is not None else np.ones(len(pc), np.float32))
        sample_weight = (sw * real).astype(np.float32)
        n = len(pc)
        lr_pack = (sq, smask, L)
    # this rank's rows [lo, hi) of the padded rows (all rows on one
    # device, or on every rank under feature_parallel)
    lo, hi = 0, n
    if mesh is not None and not featpar:
        lo, hi = block_bounds(n, shards, rank)
    n_local = hi - lo
    _check_monotone(config, F)
    K = config.num_class if config.objective in MULTICLASS else 1
    feature_names = (list(feature_names) if feature_names
                     else [f"f{i}" for i in range(F)])
    rng = np.random.default_rng(config.seed)

    # a warm start bins with its model's mapper (an imported LightGBM
    # model's placeholder mapper would put every row in bin 1)
    if init_model is not None and not _placeholder_mapper(
            init_model.bin_mapper):
        mapper = init_model.bin_mapper
    elif source is not None:
        # the streamed sample carries no aligned labels: categorical bins
        # order by value instead of target statistic
        mapper = fit_bin_mapper(
            source.sample_rows(config.bin_sample_count, config.seed),
            config.max_bin, sample_count=config.bin_sample_count,
            seed=config.seed, categorical_features=config.categorical_feature)
    else:
        mapper = fit_bin_mapper(
            X, config.max_bin, sample_count=config.bin_sample_count,
            seed=config.seed, categorical_features=config.categorical_feature,
            y=np.asarray(y, np.float64))
    bins_t = (None if source is not None
              else bin_features(_block(X, lo, hi, np.nan), mapper, dev))
    B = config.max_bin + 1
    bundler = bundle_map = None
    fp_cols = None
    if featpar:
        fp_cols = _featpar_columns(X, source, mapper, config, shards, rank,
                                   bins_t, dev)
        bins_t, bundle_map = fp_cols["bins"], fp_cols["bundle_map"]
    elif config.enable_bundle:
        # EFB: fit on the first 50k binned rows (a source: on a 50k-row
        # sample, the JAX package's samples)
        if init_model is not None and init_model.bundler is not None:
            bundler = init_model.bundler
        else:
            if source is not None:
                sample_b = bin_features(source.sample_rows(
                    min(config.bin_sample_count, 50_000), config.seed),
                    mapper, dev)
            elif mesh is None:
                sample_b = bins_t[:, :min(n, 50_000)]
            else:
                # every rank fits on the same (global) first rows
                sample_b = bin_features(X[:min(n, 50_000)], mapper, dev)
            bundler = FeatureBundler.fit(
                sample_b.t().cpu().numpy(), mapper.num_bins,
                max_total_bins=B, max_conflict_rate=config.max_conflict_rate)
            del sample_b
        # a bundle holds at most max_bin + 1 bins, so the card's width
        # check (_check_ported_on) covers the bundled histograms
        assert int(bundler.num_bins.max()) <= B, bundler.num_bins.max()
        if bins_t is not None:
            bins_t = bundle_bins(bins_t, bundler)         # (Fb, n)
        bundle_map = {k: torch.as_tensor(v.astype(np.int32), device=dev)
                      for k, v in bundler.route_tables(mapper.num_bins,
                                                       B).items()}
    if source is not None and stream_perm is not None:
        # this rank's packed slab of the source-order columns; pad rows
        # take the NaN row's bins, as the in-memory packing bins them
        pc, real = (torch.as_tensor(a, device=dev) for a in stream_perm)
        full = _bin_stream(source, mapper, bundler, n_src, dev)
        pad = _bin_rows(np.full((1, F), np.nan, np.float32), mapper, bundler,
                        dev)
        bins_t = torch.where(real[None], full[:, pc], pad)
        del full
    elif source is not None and not featpar:
        bins_t = _bin_stream(source, mapper, bundler, n, dev, (lo, hi))
    synchronize(dev)
    measures.binning_s = time.perf_counter() - t0
    t_prep = time.perf_counter()

    # w None: unit weights, made on the device (a host vector of ones
    # would be one more O(n) allocation of a streamed fit)
    w = (None if sample_weight is None
         else np.asarray(sample_weight, np.float32).copy())
    if config.objective == "binary":
        yb = (np.asarray(y) > 0).astype(np.float32)
        if config.is_unbalance or config.scale_pos_weight != 1.0:
            pos = max(float(yb.sum()), 1.0)
            neg = max(float(n - yb.sum()), 1.0)
            spw = (neg / pos) if config.is_unbalance \
                else config.scale_pos_weight
            w = np.ones(n, np.float32) if w is None else w
            w = np.where(yb > 0, w * spw, w).astype(np.float32)
        labels_np = yb
    else:
        # a copy where ``y`` is read-only (a source's memory-mapped column)
        labels_np = np.require(np.asarray(y, np.float32), requirements="W")
    y = None
    if init_model is not None:
        init_sc = init_model.init_score
    elif config.boost_from_average and K == 1:
        init_sc = np.full(1, initial_score(config.objective, labels_np, w),
                          np.float32)
    else:
        init_sc = np.zeros(K, np.float32)
    # from here on this rank's rows only (pad rows: label 0, weight 0)
    labels_np = _block(labels_np, lo, hi)
    w = _block(w, lo, hi)

    # "auto" two-level resolves from the row count, as the JAX package
    # resolves it when its kernel grower is in play; the voting and
    # feature-parallel growers build at full resolution
    if config.two_level_hist == "auto":
        config = dataclasses.replace(
            config, two_level_hist=(
                "on" if (n >= TWO_LEVEL_MIN_ROWS and not featpar
                         and config.parallelism != "voting_parallel")
                else "off"))
    labels = torch.as_tensor(labels_np, device=dev)
    weights = (torch.ones(n_local, dtype=torch.float32, device=dev)
               if w is None else torch.as_tensor(w, device=dev))
    init_scores = torch.full((n_local,) if K == 1 else (n_local, K),
                             float(init_sc[0]), dtype=torch.float32,
                             device=dev)
    is_rf = config.boosting_type == "rf"
    # a warm start continues from the carried model's margin (rf trees
    # fit at the constant init margin)
    if init_model is None or is_rf:
        scores = init_scores
    elif source is None:
        scores = _replay_margin(init_model, _block(X, lo, hi, np.nan), dev)
    else:
        # the carried margin, replayed chunk by chunk (a row's margin
        # depends on that row alone); pad rows keep the init margin
        scores = init_scores.clone()
        start = 0
        for cx, _, _ in source.iter_chunks():
            a, b = max(start, lo), min(start + len(cx), hi)
            if a < b:
                scores[a - lo:b - lo] = _replay_margin(
                    init_model, cx[a - start:b - start], dev)
            start += len(cx)
    if K > 1:
        onehot = torch.nn.functional.one_hot(labels.long(), K).to(
            torch.float32)
        multi_fn = (ova_grad_hess if config.objective == "multiclassova"
                    else softmax_grad_hess)
    elif lr_pack is not None:
        # this rank's lambdas over its own packed groups
        sq, smask, L = lr_pack
        objective_fn = make_lambdarank_objective_sharded(
            sq, smask, L, rank, sigma=1.0, max_position=config.max_position,
            label_gain=config.label_gain, device=dev)
    elif config.objective == "lambdarank":
        qidx, qmask = build_group_index(group)
        objective_fn = make_lambdarank_objective(
            qidx, qmask, n_rows=n, sigma=1.0,
            max_position=config.max_position,
            label_gain=config.label_gain, device=dev)
    else:
        objective_fn = functools.partial(
            get_objective(config.objective),
            **objective_kwargs(config.objective, config))
    upper_bounds = torch.as_tensor(
        mapper.upper_bounds if fp_cols is None else fp_cols["upper_bounds"],
        device=dev)
    num_bins = torch.as_tensor(
        mapper.num_bins if fp_cols is None else fp_cols["num_bins"],
        device=dev)
    p = config.growth_params()
    is_dart = config.boosting_type == "dart"
    use_goss = config.boosting_type == "goss"
    lr = 1.0 if is_rf else config.learning_rate
    use_bagging = (config.bagging_fraction < 1.0
                   and (is_rf or config.bagging_freq > 0))
    hist_ar = vote_psum = None
    if mesh is not None and not featpar:
        # the histogram wire's codec applies to the data-parallel psum only
        wire = None if _hist_psum_nulled(config, True) else cconfig
        op = "gbdt_hist_psum" if wire is not None else "psum"

        def hist_ar(h):
            return planned_psum(h, mesh, DATA_AXIS, wire, op=op)

        if _voting(config):
            def vote_psum(t):
                return psum(t, mesh, DATA_AXIS, op="gbdt_vote_psum")
    if featpar:
        grower = functools.partial(grow_tree_feature_parallel, mesh=mesh,
                                   n_slots=_n_slots(config),
                                   bundle_map=bundle_map)
    elif config.growth_policy == "lossguide" or _voting(config):
        grower = functools.partial(grow_tree, bundle_map=bundle_map,
                                   hist_allreduce=hist_ar,
                                   vote_psum=vote_psum)
    else:
        grower = functools.partial(grow_tree_depthwise,
                                   n_slots=_n_slots(config),
                                   bundle_map=bundle_map,
                                   hist_allreduce=hist_ar)
    fused = _fused_ingest_on(config)
    bag_root = prng.prng_key(config.bagging_seed)
    # the rows' base weight: 1, and 0 for a rank's pad rows
    ones = torch.ones(n_local, dtype=torch.float32, device=dev)
    if hi > n:
        ones[max(n, lo) - lo:] = 0.0
    # leaf-wise depth is bounded by num_leaves - 1 splits
    depth_hint = max(2, config.num_leaves)
    # continued training picks the key streams up where the carried model
    # left off, and fast-forwards the host stream
    prior_iters = (len(init_model.trees) // K if init_model is not None
                   else 0)
    if prior_iters and config.feature_fraction < 1.0:
        nf = max(1, int(round(F * config.feature_fraction)))
        for _ in range(prior_iters):
            rng.choice(F, nf, replace=False)

    stopper = None
    if valid is not None:
        Xv, yv, wv = valid
        Xv = np.ascontiguousarray(Xv, np.float32)
        bins_v = bin_features(Xv, mapper, dev)     # original features
        yv = ((np.asarray(yv) > 0) if config.objective == "binary"
              else np.asarray(yv)).astype(np.float32)
        yv_t = torch.as_tensor(yv, device=dev)
        wv_t = None if wv is None else torch.as_tensor(
            np.asarray(wv, np.float32), device=dev)
        # the trees' part of the margins, apart from the init margin, so
        # rf can average it
        valid_contrib = torch.zeros((len(yv), K) if K > 1 else len(yv),
                                    dtype=torch.float32, device=dev)
        if init_model is not None:
            valid_init = torch.as_tensor(
                init_model.predict_margin(Xv, device=dev), device=dev)
        else:
            valid_init = torch.as_tensor(init_sc if K > 1 else init_sc[0],
                                         device=dev)
        metric_name = config.metric or metrics_mod.default_metric(
            config.objective, K)
        if metric_name.startswith("ndcg"):
            # NDCG@max_position over the validation groups, on the device
            if valid_group is None:
                raise ValueError("ndcg eval requires valid_group sizes")
            grid = metrics_mod.GroupGrid(valid_group, dev)
            k_pos = config.max_position

            def metric_fn(yy, mm, ww):
                return metrics_mod.ndcg_t(yy, mm, grid, ww, k_pos)
            larger_better = True
        else:
            metric_fn, larger_better = metrics_mod.DEVICE_METRICS.get(
                metric_name, metrics_mod.DEVICE_METRICS["l2"])
        stopper = EarlyStopping(config.early_stopping_round, larger_better)
    synchronize(dev)
    measures.data_prep_s = time.perf_counter() - t_prep

    def on_dev(tree: Tree) -> Tree:
        return Tree(*[torch.as_tensor(a).to(dev) for a in tree])

    def contrib(tree: Tree, weight: float) -> torch.Tensor:
        """One tree's weighted outputs on the training rows (DART); under
        feature_parallel over the sharded columns, one all-reduce a
        level."""
        if featpar:
            return predict_binned_tree_featpar(
                bins_t, on_dev(tree), depth_hint, B, mesh,
                bundle_map) * weight
        return predict_binned_tree(bins_t, on_dev(tree), depth_hint,
                                   bundle_map, B) * weight

    t_train = time.perf_counter()
    trees: List[Tree] = []
    tree_class: List[int] = []
    tree_weights: List[float] = []
    eval_history: List[EvalRecord] = []
    rf_count = 0

    def local_mask(fmask: np.ndarray) -> torch.Tensor:
        """The grower's feature mask: the global one, or under
        feature_parallel this rank's slice (pad features off)."""
        if fp_cols is not None:
            F_loc = fp_cols["F_loc"]
            fmask = np.concatenate(
                [fmask, np.zeros(F_loc * shards - F, bool)])[
                    rank * F_loc:(rank + 1) * F_loc]
        return torch.as_tensor(fmask, device=dev)

    fmask_dev = local_mask(np.ones(F, bool))

    def grow_iteration(scores, bag, key, fmask_dev):
        """One iteration's gradients and trees → (the trees on the device,
        the scores with their outputs added); ``scores`` is not changed."""
        if K == 1:
            grad, hess = _grad_hess(objective_fn, scores, labels, weights)
            g_all, h_all = grad[:, None], hess[:, None]
        else:
            g_all, h_all = _grad_hess(multi_fn, scores, onehot, weights)
        new_dev, new_scores = [], scores
        for k in range(K):
            rv = bag
            if use_goss:
                # GOSS ranks |grad| at full f32 resolution, before the
                # bf16 ingest below
                rv = goss_weights(g_all[:, k].abs(), bag,
                                  key if K == 1 else prng.fold_in(key, k),
                                  config.top_rate, config.other_rate)
            g, h = g_all[:, k], h_all[:, k]
            if fused:
                g, h = g.to(torch.bfloat16), h.to(torch.bfloat16)
            tree, node_id = grower(bins_t, g, h, rv, fmask_dev,
                                   upper_bounds, num_bins, lr, p)
            new_scores = _add_scores(new_scores,
                                     tree.leaf_value[node_id.long()], k, K)
            new_dev.append(tree)
        return new_dev, new_scores

    prof = step_profiler
    try:
        for it in range(config.num_iterations):
            if prof is not None:
                prof.step_begin(it)
            if config.feature_fraction < 1.0:
                # the host stream the JAX package draws from, draw by draw
                nf = max(1, int(round(F * config.feature_fraction)))
                fmask = np.zeros(F, bool)
                fmask[rng.choice(F, nf, replace=False)] = True
                fmask_dev = local_mask(fmask)
            # dart: drop trees and take them out of the scores
            dropped: List[int] = []
            if is_dart and trees and rng.random() >= config.skip_drop:
                drop = rng.random(len(trees)) < config.drop_rate
                dropped = [int(d)
                           for d in np.nonzero(drop)[0][:config.max_drop]]
                for d in dropped:
                    scores = _add_scores(scores,
                                         -contrib(trees[d], tree_weights[d]),
                                         tree_class[d], K)
            gi = prior_iters + it
            key = prng.prng_key((config.seed * 100003 + gi) & 0xffffffff)
            bag = ones
            if use_bagging:
                bag_key = prng.fold_in(bag_root,
                                       gi // max(config.bagging_freq, 1))
                if mesh is not None and not featpar:
                    # each rank draws its own rows' bag, as the JAX
                    # package's fold_in(bag_key, axis_index); replicated
                    # rows (feature_parallel) draw the same bag
                    bag_key = prng.fold_in(bag_key, rank)
                bag = bag_mask(bag_key, n_local, config.bagging_fraction,
                               dev) * ones

            if prof is not None:
                prof.mark("data")
                if prof.capture_xla and "gbdt_step" not in prof.costs:
                    with prof.excluded():
                        prof.capture_cost("gbdt_step", grow_iteration,
                                          scores.clone(), bag, key,
                                          fmask_dev, items=n, device=dev,
                                          mesh=mesh)
            new_dev, new_scores = grow_iteration(scores, bag, key, fmask_dev)
            new_trees = [Tree(*[a.cpu() for a in t]) for t in new_dev]
            if prof is not None:
                prof.mark("compute")      # the trees' host copy synchronized

            reweighted = []                  # (dart) (tree, its old weight)
            if dropped:
                # normalize: the new trees weigh 1/(|D|+1), dropped trees
                # are scaled by |D|/(|D|+1)
                new_w = 1.0 / (len(dropped) + 1)
                factor = len(dropped) / (len(dropped) + 1)
                for k in range(K):
                    scores = _add_scores(scores,
                                         contrib(new_trees[k], new_w), k, K)
                for d in dropped:
                    reweighted.append((d, tree_weights[d]))
                    tree_weights[d] *= factor
                    scores = _add_scores(scores,
                                         contrib(trees[d], tree_weights[d]),
                                         tree_class[d], K)
                weights_new = [new_w] * K
            else:
                scores = new_scores
                weights_new = [1.0] * K
            trees += new_trees
            tree_class += list(range(K))
            tree_weights += weights_new
            if is_rf:
                # rf: every tree fits the gradients at the init margin
                rf_count += 1
                scores = init_scores

            if stopper is not None:
                t_eval = time.perf_counter()
                # the new trees, and the weight changes of dart's dropped ones
                for k in range(K):
                    valid_contrib = _add_scores(
                        valid_contrib, predict_binned_tree(
                            bins_v, new_dev[k], depth_hint) * weights_new[k],
                        k, K)
                for d, old_w in reweighted:
                    valid_contrib = _add_scores(
                        valid_contrib, predict_binned_tree(
                            bins_v, on_dev(trees[d]), depth_hint)
                        * (tree_weights[d] - old_w), tree_class[d], K)
                if is_rf:
                    # the rf model averages all its trees, carried ones too
                    base = torch.as_tensor(init_sc if K > 1 else init_sc[0],
                                           device=dev)
                    count = torch.full((), max(prior_iters + rf_count, 1),
                                       dtype=torch.float32, device=dev)
                    vm = base + ((valid_init - base) * prior_iters
                                 + valid_contrib) / count
                else:
                    vm = valid_init + valid_contrib
                val = float(metric_fn(yv_t, vm, wv_t))    # the one host copy
                eval_history.append(EvalRecord(it, metric_name, val))
                stop = stopper.update(it, val)
                measures.eval_s += time.perf_counter() - t_eval
                if stop:
                    break
            if ckpt_every > 0 and (it + 1) % ckpt_every == 0:
                pre_t, pre_c, pre_w = (
                    (init_model.trees, init_model.tree_class,
                     init_model.tree_weights)
                    if init_model else ([], [], []))
                _write_checkpoint(checkpoint_dir, Booster(
                    pre_t + trees, pre_c + tree_class, pre_w + tree_weights, K,
                    config.objective, init_sc, mapper, feature_names, config,
                    device=dev, bundler=bundler), rank=rank)
            elif mesh is not None:
                # the gang's progress (a checkpoint write beats its own)
                beat(prior_iters + it + 1)
            if prof is not None:
                prof.step_end()       # evaluation + checkpoint: "other"
    finally:
        if prof is not None:
            prof.finish()             # early stop or an exception
    synchronize(dev)
    measures.training_s = time.perf_counter() - t_train
    measures.iterations = len(trees) // K
    if init_model is not None:
        # continued training carries the previous trees forward
        trees = init_model.trees + trees
        tree_class = init_model.tree_class + tree_class
        tree_weights = init_model.tree_weights + tree_weights
    measures.total_s = time.perf_counter() - t0
    booster = Booster(trees, tree_class, tree_weights, K, config.objective,
                      init_sc, mapper, feature_names, config,
                      best_iteration=(stopper.best_iter if stopper else -1),
                      device=dev, bundler=bundler)
    booster.measures = measures
    return booster, eval_history
