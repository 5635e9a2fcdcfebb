"""GBDT pipeline estimators: ``GBDTClassifier`` → ``GBDTClassificationModel``,
``GBDTRegressor`` → ``GBDTRegressionModel`` and ``GBDTRanker`` →
``GBDTRankerModel``.

The PyTorch port of the JAX package's ``models/gbdt/estimators.py`` on
one card: ``fit`` trains with :func:`~.booster.train` on the ``device``
param, ``transform`` scores whole column batches with one batched
traversal on the model's ``device`` (``featuresShapCol`` adds TreeSHAP
contributions, computed on the host as in the JAX package).
``get_model_string`` writes the LightGBM text format and
``load_native_model_from_string`` / ``_from_file`` read it or the
version-2 JSON.  The param surface is the JAX package's.  ``numShards``
counts the ranks of the initialized ``torch.distributed`` group (in the
JAX package it counts local devices): 0 trains over every rank (one
rank, or no group, trains locally), 1 trains locally on each rank, the
world size trains over the group (``booster.train(mesh=...)``, every
rank fitting the same model), and any other value raises.
``parallelism`` picks the tree learner over the group: data_parallel
(rows sharded, histograms summed), voting_parallel (rows sharded, the
``topK`` votes of each rank choose the histograms summed; lossguide) or
feature_parallel (rows replicated, features sharded); on one rank each
trains as the JAX package trains it without a mesh.
``collectiveCompression`` (``none`` / ``bf16`` / ``int8`` or a
``CollectiveConfig``) is the data-parallel histogram all-reduce's wire
codec.  ``checkpointManager`` (a ``core.checkpoint.CheckpointManager``)
with ``checkpointInterval`` saves the fit's state from every rank, and
a fit of any gang size resumes from it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...core.dataset import Dataset
from ...core.params import (BoolParam, DictParam, FloatParam, IntParam,
                            ListParam, Params, PyObjectParam, StringParam)
from ...core.pipeline import Estimator, Model
from .booster import Booster, BoostingConfig, train


class GBDTParams(Params):
    """Shared boosting params (reference: params/LightGBMParams.scala)."""
    device = StringParam(doc="device to train on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")
    featuresCol = StringParam(doc="features vector column", default="features")
    labelCol = StringParam(doc="label column", default="label")
    weightCol = StringParam(doc="sample weight column")
    predictionCol = StringParam(doc="prediction output column", default="prediction")
    validationIndicatorCol = StringParam(
        doc="bool column marking validation rows: they are evaluated "
            "every iteration (``metric``, early stopping) and not trained "
            "on")
    numIterations = IntParam(doc="number of boosting iterations", default=100)
    learningRate = FloatParam(doc="shrinkage rate", default=0.1)
    numLeaves = IntParam(doc="max leaves per tree", default=31)
    maxDepth = IntParam(doc="max tree depth (<=0: unlimited)", default=-1)
    minDataInLeaf = IntParam(doc="min rows per leaf", default=20)
    minSumHessianInLeaf = FloatParam(doc="min hessian sum per leaf", default=1e-3)
    lambdaL1 = FloatParam(doc="L1 regularization", default=0.0)
    lambdaL2 = FloatParam(doc="L2 regularization", default=0.0)
    minGainToSplit = FloatParam(doc="min split gain", default=0.0)
    maxBin = IntParam(doc="max feature bins", default=255)
    binSampleCount = IntParam(doc="rows sampled for bin boundaries", default=200000)
    featureFraction = FloatParam(doc="per-tree feature subsample", default=1.0)
    baggingFraction = FloatParam(doc="row subsample fraction", default=1.0)
    baggingFreq = IntParam(doc="resample every k iterations", default=0)
    baggingSeed = IntParam(doc="bagging seed", default=3)
    boostingType = StringParam(doc="gbdt|rf|dart|goss (all ported)",
                               default="gbdt",
                               allowed=("gbdt", "rf", "dart", "goss"))
    growthPolicy = StringParam(
        doc="depthwise (waves of up to 16 leaves, K2) | lossguide (strict "
            "leaf-wise, LightGBM's order, one K1 build per split); both "
            "ported", default="depthwise",
        allowed=("depthwise", "lossguide"))
    topRate = FloatParam(doc="goss top-gradient keep rate", default=0.2)
    otherRate = FloatParam(doc="goss small-gradient sample rate", default=0.1)
    dropRate = FloatParam(doc="dart tree dropout rate", default=0.1)
    maxDrop = IntParam(doc="dart max dropped trees per iter", default=50)
    skipDrop = FloatParam(doc="dart skip-dropout probability", default=0.5)
    earlyStoppingRound = IntParam(doc="early stopping patience (0=off)", default=0)
    metric = StringParam(doc="eval metric name", default="")
    boostFromAverage = BoolParam(doc="init score from label mean", default=True)
    seed = IntParam(doc="master seed", default=0)
    verbosity = IntParam(doc="log verbosity", default=-1)
    numBatches = IntParam(
        doc="split data into k sequential warm-started batches",
        default=0)
    numShards = IntParam(
        doc="data-parallel shards: the ranks of the initialized "
            "torch.distributed group; 0 = every rank, 1 = train locally",
        default=0)
    parallelism = StringParam(
        doc="data_parallel|voting_parallel|feature_parallel: the tree "
            "learner over the torch.distributed group (the reference's "
            "tree_learner values)",
        default="data_parallel",
        allowed=("data_parallel", "voting_parallel", "feature_parallel"))
    topK = IntParam(doc="voting-parallel top features per shard", default=20)
    enableBundle = BoolParam(
        doc="exclusive feature bundling: rarely-co-nonzero features share "
            "a histogram column; the trees stay in original feature space",
        default=False)
    maxConflictRate = FloatParam(doc="EFB allowed conflict fraction",
                                 default=0.0)
    categoricalSlotIndexes = ListParam(
        doc="feature-vector slots holding category codes: binned in "
            "target-statistic order so bin-range splits act as "
            "category-subset splits")
    checkpointDir = StringParam(
        doc="iteration-checkpoint directory: the partial model is saved "
            "every checkpointInterval iterations and a re-fit resumes "
            "from the newest one")
    checkpointInterval = IntParam(doc="save every N boosting iterations "
                                      "(0 = off)", default=0)
    checkpointManager = PyObjectParam(
        doc="core.checkpoint.CheckpointManager to checkpoint through: the "
            "iteration checkpoints go into its directory (overrides "
            "checkpointDir)")
    monotoneConstraints = ListParam(
        doc="per-feature monotone direction {-1, 0, 1}: 1 forces "
            "predictions non-decreasing in the feature, -1 non-increasing")
    monotoneConstraintsMethod = StringParam(
        doc="constraint enforcement method", default="basic",
        allowed=("basic", "intermediate", "advanced"))
    monotonePenalty = FloatParam(
        doc="gain penalization for constrained-feature splits near the "
            "root", default=0.0)
    passThroughArgs = DictParam(doc="extra engine params (ParamsStringBuilder "
                                    "pass-through analogue)")
    predictDisableShapeCheck = BoolParam(doc="skip feature-count check at "
                                             "predict", default=False)
    collectiveCompression = PyObjectParam(
        doc="wire codec for the data-parallel histogram allreduce: None / "
            "'none', 'bf16', 'int8' or a CollectiveConfig (ignored without "
            "a mesh, as in the JAX package)")

    def _mesh(self):
        """The mesh ``numShards`` asks for (None: train locally), checked
        with the unported params before any work."""
        self._checkpoint_dir()
        from ...parallel.compression import resolve_collective_config
        resolve_collective_config(self.get("collectiveCompression"))
        import torch.distributed as dist
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        shards = int(self.numShards) or world
        if shards == 1:
            return None
        if shards != world:
            raise ValueError(
                f"numShards={self.numShards}: in the port the shards are "
                f"the ranks of the initialized torch.distributed group, "
                f"which has {world} (parallel.initialize_cluster, "
                "parallel.run_on_local_cluster); in the JAX package they "
                "are local devices.  Pass 0 (every rank), 1 (local) or "
                f"{world}")
        from ...parallel.mesh import data_parallel_mesh
        return data_parallel_mesh(device=self.device)

    def _build_config(self, objective: str, num_class: int = 1) -> BoostingConfig:
        extra = self.passThroughArgs or {}
        cfg = BoostingConfig(
            objective=objective,
            boosting_type=self.boostingType,
            growth_policy=self.growthPolicy,
            num_iterations=self.numIterations,
            learning_rate=self.learningRate,
            num_leaves=self.numLeaves,
            max_depth=self.maxDepth,
            min_data_in_leaf=self.minDataInLeaf,
            min_sum_hessian_in_leaf=self.minSumHessianInLeaf,
            lambda_l1=self.lambdaL1,
            lambda_l2=self.lambdaL2,
            min_gain_to_split=self.minGainToSplit,
            max_bin=self.maxBin,
            bin_sample_count=self.binSampleCount,
            feature_fraction=self.featureFraction,
            bagging_fraction=self.baggingFraction,
            bagging_freq=self.baggingFreq,
            bagging_seed=self.baggingSeed,
            seed=self.seed,
            num_class=num_class,
            boost_from_average=self.boostFromAverage,
            early_stopping_round=self.earlyStoppingRound,
            metric=self.metric,
            top_rate=self.topRate,
            other_rate=self.otherRate,
            drop_rate=self.dropRate,
            max_drop=self.maxDrop,
            skip_drop=self.skipDrop,
            parallelism=self.parallelism,
            top_k=self.topK,
            enable_bundle=self.enableBundle,
            max_conflict_rate=self.maxConflictRate,
            categorical_feature=[int(i) for i in self.categoricalSlotIndexes]
            if self.get("categoricalSlotIndexes") else None,
            monotone_constraints=[int(c) for c in self.monotoneConstraints]
            if self.get("monotoneConstraints") else None,
            monotone_constraints_method=self.monotoneConstraintsMethod,
            monotone_penalty=self.monotonePenalty,
            collective_compression=(self.get("collectiveCompression")
                                    or "none"),
        )
        for k, v in extra.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
            else:
                cfg.pass_through[k] = v
        return cfg

    def _features_matrix(self, ds: Dataset) -> np.ndarray:
        return ds.to_numpy([self.featuresCol])

    def _split_validation(self, ds: Dataset):
        """(training rows, validation rows or None) by
        ``validationIndicatorCol``."""
        vcol = self.validationIndicatorCol
        if vcol and vcol in ds:
            mask = ds[vcol].astype(bool)
            return ds.filter(~mask), ds.filter(mask)
        return ds, None

    def _valid_tuple(self, valid_ds, labels: np.ndarray):
        if valid_ds is None or valid_ds.num_rows == 0:
            return None
        return (self._features_matrix(valid_ds), labels,
                valid_ds[self.weightCol].astype(np.float32)
                if self.weightCol else None)

    def _checkpoint_dir(self):
        """The checkpoint directory: the manager's, else checkpointDir."""
        manager = self.get("checkpointManager")
        if manager is None:
            return self.get("checkpointDir")
        if getattr(manager, "directory", None) is None:
            raise TypeError(
                "checkpointManager must be a core.checkpoint."
                "CheckpointManager (an object with a directory), got "
                f"{type(manager).__name__}")
        return manager.directory

    def _train(self, X, y, cfg, w, valid, mesh=None):
        return _train_batched(X, y, cfg, w, valid, self.numBatches,
                              checkpoint_dir=self._checkpoint_dir(),
                              checkpoint_interval=int(
                                  self.checkpointInterval),
                              mesh=mesh, device=self.device)


def _train_batched(X, y, cfg, w, valid, num_batches: int,
                   checkpoint_dir=None, checkpoint_interval: int = 0,
                   mesh=None, device="cuda"):
    """The ``numBatches`` fold: k sequential row batches, each fit warm
    started from the model of the ones before."""
    if num_batches and num_batches > 1:
        if checkpoint_dir:
            raise ValueError(
                "checkpointDir cannot combine with numBatches > 1: the "
                "batch fold is itself a warm-start sequence — checkpoint "
                "single-batch training instead")
        booster, history = None, []
        for part in np.array_split(np.arange(len(X)), num_batches):
            booster, h = train(X[part], y[part], cfg,
                               sample_weight=None if w is None else w[part],
                               valid=valid, init_model=booster, mesh=mesh,
                               device=device)
            history.extend(h)
        return booster, history
    return train(X, y, cfg, sample_weight=w, valid=valid,
                 checkpoint_dir=checkpoint_dir,
                 checkpoint_interval=checkpoint_interval, mesh=mesh,
                 device=device)


class GBDTModelBase(Model):
    device = StringParam(doc="device to score on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")
    featuresCol = StringParam(doc="features vector column", default="features")
    predictionCol = StringParam(doc="prediction output column", default="prediction")
    leafPredictionCol = StringParam(doc="per-tree leaf index output column")
    featuresShapCol = StringParam(doc="per-feature contribution output "
                                      "column (TreeSHAP, plus the bias)")
    numIterationsUsed = IntParam(doc="trees used at predict (-1: all)", default=-1)
    predictDisableShapeCheck = BoolParam(doc="skip feature-count check",
                                         default=False)
    boosterModel = PyObjectParam(doc="trained booster")

    @property
    def booster(self) -> Booster:
        return self.boosterModel

    @property
    def training_measures(self):
        """Per-phase wall clock of the fit that produced this model; None
        for deserialized models."""
        return getattr(self.booster, "measures", None)

    def get_feature_importances(self, importance_type: str = "split") -> List[float]:
        return list(self.booster.feature_importance(importance_type))

    def get_booster_num_trees(self) -> int:
        return self.booster.num_trees

    def get_model_string(self) -> str:
        """saveNativeModel analogue: the LightGBM text format
        (:meth:`Booster.to_string`), as in the JAX package."""
        return self.booster.to_string()

    def _check_features(self, X: np.ndarray):
        expected = self.booster.bin_mapper.num_features
        if not self.predictDisableShapeCheck and X.shape[1] != expected:
            raise ValueError(f"feature count {X.shape[1]} != model's {expected}")

    def _maybe_add_leaves(self, ds: Dataset, X: np.ndarray) -> Dataset:
        if self.leafPredictionCol:
            leaves = self.booster.predict_leaf(
                X, device=self.device).astype(np.float64)
            ds = ds.with_column(self.leafPredictionCol, list(leaves))
        if self.featuresShapCol:
            shap = self.booster.predict_contrib(X)
            ds = ds.with_column(self.featuresShapCol, list(shap))
        return ds

    @classmethod
    def load_native_model_from_string(cls, s: str, device: str = "cuda",
                                      **kw):
        """loadNativeModelFromString analogue: a model from LightGBM text
        or the version-2 JSON of either package (``Booster.from_string``),
        predicting on ``device``."""
        return cls._from_booster(Booster.from_string(s, device=device),
                                 device=device, **kw)

    @classmethod
    def load_native_model_from_file(cls, path: str, device: str = "cuda",
                                    **kw):
        """loadNativeModelFromFile analogue."""
        with open(path) as f:
            return cls.load_native_model_from_string(f.read(), device=device,
                                                     **kw)

    @classmethod
    def _from_booster(cls, b: Booster, **kw):
        return cls(boosterModel=b, **kw)


class GBDTClassifier(GBDTParams, Estimator):
    """LightGBMClassifier analogue (reference: LightGBMClassifier.scala:27)."""
    objective = StringParam(doc="binary|multiclass|multiclassova (all "
                                "ported; binary with more than two label "
                                "values trains multiclass)",
                            default="binary",
                            allowed=("binary", "multiclass", "multiclassova"))
    probabilityCol = StringParam(doc="probability vector column", default="probability")
    rawPredictionCol = StringParam(doc="margin vector column", default="rawPrediction")
    isUnbalance = BoolParam(doc="auto-reweight positive class", default=False)
    scalePosWeight = FloatParam(doc="positive class weight", default=1.0)
    thresholds = ListParam(doc="per-class prediction thresholds")

    def _fit(self, ds: Dataset) -> "GBDTClassificationModel":
        mesh = self._mesh()
        ds, valid_ds = self._split_validation(ds)
        X = self._features_matrix(ds)
        y_raw = np.asarray(ds[self.labelCol], np.float64)
        w = ds[self.weightCol].astype(np.float32) if self.weightCol else None
        classes = np.unique(y_raw[~np.isnan(y_raw)])
        num_class = len(classes)
        # remap arbitrary label values to contiguous 0..K-1 class indices
        y = np.searchsorted(classes, y_raw).astype(np.float64)
        objective = self.objective
        if objective == "binary" and num_class > 2:
            objective = "multiclass"
        K = num_class if objective in ("multiclass", "multiclassova") else 1
        cfg = self._build_config(objective, max(K, 1))
        cfg.is_unbalance = self.isUnbalance
        cfg.scale_pos_weight = self.scalePosWeight
        valid = None
        if valid_ds is not None:
            valid = self._valid_tuple(valid_ds, np.searchsorted(
                classes, np.asarray(valid_ds[self.labelCol],
                                    np.float64)).astype(np.float64))
        booster, history = self._train(X, y, cfg, w, valid, mesh)
        model = GBDTClassificationModel(
            boosterModel=booster,
            device=self.device,
            featuresCol=self.featuresCol,
            predictionCol=self.predictionCol,
            probabilityCol=self.probabilityCol,
            rawPredictionCol=self.rawPredictionCol,
            numClasses=max(num_class, 2),
            classLabels=[float(c) for c in classes],
        )
        if self.is_set("thresholds"):
            model.set("thresholds", self.thresholds)
        model._eval_history = history
        return model


class GBDTClassificationModel(GBDTModelBase):
    """LightGBMClassificationModel analogue; batched scoring."""
    probabilityCol = StringParam(doc="probability vector column", default="probability")
    rawPredictionCol = StringParam(doc="margin vector column", default="rawPrediction")
    numClasses = IntParam(doc="number of classes", default=2)
    classLabels = ListParam(doc="original label value per class index")
    thresholds = ListParam(doc="per-class prediction thresholds")

    def _transform(self, ds: Dataset) -> Dataset:
        X = ds.to_numpy([self.featuresCol])
        self._check_features(X)
        ni = self.numIterationsUsed
        margin = self.booster.predict_margin(X, None if ni < 0 else ni,
                                             device=self.device)
        proba = self.booster.to_proba(np.asarray(margin))
        if margin.ndim == 1:
            raw = np.stack([-margin, margin], axis=1)
        else:
            raw = margin
        if self.thresholds:
            scaled = proba / np.asarray(self.thresholds)[None, :]
            pred = np.argmax(scaled, axis=1).astype(np.float64)
        else:
            pred = np.argmax(proba, axis=1).astype(np.float64)
        if self.classLabels:
            pred = np.asarray(self.classLabels, np.float64)[pred.astype(int)]
        out = ds
        if self.rawPredictionCol:
            out = out.with_column(self.rawPredictionCol, list(raw.astype(np.float64)))
        if self.probabilityCol:
            out = out.with_column(self.probabilityCol, list(proba.astype(np.float64)))
        out = out.with_column(self.predictionCol, pred)
        return self._maybe_add_leaves(out, X)

    @classmethod
    def _from_booster(cls, b: Booster, **kw):
        return cls(boosterModel=b, numClasses=max(b.num_class, 2), **kw)


class GBDTRegressor(GBDTParams, Estimator):
    """LightGBMRegressor analogue."""
    objective = StringParam(
        doc="regression objective (all ported)", default="regression",
        allowed=("regression", "regression_l1", "huber", "fair", "poisson",
                 "quantile", "mape", "gamma", "tweedie", "mse", "mae"))
    alpha = FloatParam(doc="huber/quantile alpha", default=0.9)
    tweedieVariancePower = FloatParam(doc="tweedie variance power",
                                      default=1.5)

    def _fit(self, ds: Dataset) -> "GBDTRegressionModel":
        mesh = self._mesh()
        ds, valid_ds = self._split_validation(ds)
        X = self._features_matrix(ds)
        y = np.asarray(ds[self.labelCol], np.float64)
        w = ds[self.weightCol].astype(np.float32) if self.weightCol else None
        cfg = self._build_config(self.objective)
        cfg.alpha = self.alpha
        cfg.tweedie_variance_power = self.tweedieVariancePower
        valid = None
        if valid_ds is not None:
            valid = self._valid_tuple(valid_ds, np.asarray(
                valid_ds[self.labelCol], np.float64))
        booster, history = self._train(X, y, cfg, w, valid, mesh)
        model = GBDTRegressionModel(
            boosterModel=booster,
            device=self.device,
            featuresCol=self.featuresCol,
            predictionCol=self.predictionCol,
        )
        model._eval_history = history
        return model


class GBDTRegressionModel(GBDTModelBase):
    """LightGBMRegressionModel analogue: the margin, through exp for the
    log-link objectives (poisson, gamma, tweedie)."""

    def _transform(self, ds: Dataset) -> Dataset:
        X = ds.to_numpy([self.featuresCol])
        self._check_features(X)
        ni = self.numIterationsUsed
        pred = self.booster.predict_margin(X, None if ni < 0 else ni,
                                           device=self.device)
        if self.booster.objective in ("poisson", "gamma", "tweedie"):
            pred = np.exp(pred)
        out = ds.with_column(self.predictionCol, np.asarray(pred, np.float64))
        return self._maybe_add_leaves(out, X)


class GBDTRanker(GBDTParams, Estimator):
    """LightGBMRanker analogue: the lambdarank objective over query
    groups.  Rows are stable-sorted by ``groupCol`` (a query's rows must
    be contiguous) and the group sizes come from ``np.unique``; a
    validation set (``validationIndicatorCol``) is grouped the same way
    and evaluated by NDCG@``maxPosition``."""
    groupCol = StringParam(doc="query/group id column", default="query")
    maxPosition = IntParam(doc="NDCG truncation position", default=10)
    labelGain = ListParam(doc="relevance gain per label level")
    evalAt = ListParam(doc="NDCG eval positions", default=[1, 3, 5, 10])

    def _fit(self, ds: Dataset) -> "GBDTRankerModel":
        mesh = self._mesh()
        ds, valid_ds = self._split_validation(ds)
        ds = ds.sort(self.groupCol)
        X = self._features_matrix(ds)
        y = np.asarray(ds[self.labelCol], np.float64)
        w = ds[self.weightCol].astype(np.float32) if self.weightCol else None
        _, counts = np.unique(ds[self.groupCol], return_counts=True)
        cfg = self._build_config("lambdarank")
        cfg.max_position = self.maxPosition
        if self.labelGain:
            cfg.label_gain = list(self.labelGain)
        valid = vgroups = None
        if valid_ds is not None and valid_ds.num_rows > 0:
            valid_ds = valid_ds.sort(self.groupCol)
            _, vgroups = np.unique(valid_ds[self.groupCol],
                                   return_counts=True)
            valid = self._valid_tuple(valid_ds, np.asarray(
                valid_ds[self.labelCol], np.float64))
        booster, history = train(
            X, y, cfg, sample_weight=w, valid=valid, group=counts,
            valid_group=vgroups, checkpoint_dir=self._checkpoint_dir(),
            checkpoint_interval=int(self.checkpointInterval), mesh=mesh,
            device=self.device)
        model = GBDTRankerModel(boosterModel=booster, device=self.device,
                                featuresCol=self.featuresCol,
                                predictionCol=self.predictionCol)
        model._eval_history = history
        return model


class GBDTRankerModel(GBDTModelBase):
    """LightGBMRankerModel analogue: transform writes the margin."""

    def _transform(self, ds: Dataset) -> Dataset:
        X = ds.to_numpy([self.featuresCol])
        self._check_features(X)
        ni = self.numIterationsUsed
        pred = self.booster.predict_margin(X, None if ni < 0 else ni,
                                           device=self.device)
        out = ds.with_column(self.predictionCol, np.asarray(pred, np.float64))
        return self._maybe_add_leaves(out, X)
