"""Deep-learning pipeline estimators: text and vision classifiers.

The PyTorch port of the JAX package's ``models/dl/estimators.py`` on one
card: ``DeepTextClassifier`` → ``DeepTextModel`` (a BERT-style
``TextEncoder``) and ``DeepVisionClassifier`` → ``DeepVisionModel`` (a
ResNet).  ``fit`` tokenizes (or stacks images) on the host, draws the
reference's batches from the same numpy generator
(:func:`~.training.iterate_minibatches`), copies each batch to the
``device`` param and runs :class:`~.training.DLTrainer`'s eager step; the
step's metrics stay on the device and the fit reads them once an epoch.
``transform`` scores in ``batchSize`` chunks, halving the chunk on a CUDA
out-of-memory error and remembering the size that worked per model
shape.

The param surface is the JAX package's plus ``device``.  What is not
ported raises ``NotImplementedError`` naming its ROADMAP item before any
tokenizing or image work: a mesh (``numDevices > 1``,
``modelParallelism > 1``, ``zero1``, ``collectiveCompression``,
``expertParallelism > 1``) waits for A5.  Step checkpoints
(``checkpointDir`` or ``checkpointManager`` with ``checkpointInterval``)
save the model's parameters and buffers, the optimizer's moments and
count and the step every that many optimizer steps
(:class:`_CheckpointLoop`); a later fit with the same directory resumes
from the newest, replaying the data order so it trains on the batches
the uninterrupted fit would.  ``numExperts > 0`` trains the MoE
FFN (:mod:`.moe`) on the one card.  ``stepProfiler`` (a
:class:`~synapseml_tpu_torch.telemetry.gangplane.StepProfiler`) times
each step's data / compute / other segments, synchronizing the device
before ``compute`` ends (only when a profiler is set); with its
``capture_xla`` it captures one step's cost (``dl_text_step`` /
``dl_vision_step``), run on a deep copy of the training state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Dict, List

import numpy as np
import torch

from ...core.dataset import Dataset
from ...core.params import (BoolParam, FloatParam, IntParam, Params,
                            PyObjectParam, StringParam)
from ...core.pipeline import Estimator, Model
from ...device import resolve_device, synchronize
from ...telemetry.gangplane import check_profiler
from .precision import resolve_precision
from .resnet import BACKBONES, BottleneckResNetBlock, make_backbone
from .tokenizer import WordPieceTokenizer, WordTokenizer, tokenizer_from_dict
from .training import (DLTrainer, OptimizerConfig, TrainState,
                       iterate_minibatches, num_minibatches, to_device)
from .transformer import TextEncoder, TransformerConfig


def _bert_checkpoint_assets(path, dropout_rate):
    """Tokenizer + TransformerConfig for an HF-format BERT checkpoint dir
    (config.json + vocab.txt)."""
    d = path if os.path.isdir(path) else os.path.dirname(path)
    cfg_path = os.path.join(d, "config.json")
    vocab_path = os.path.join(d, "vocab.txt")
    if not os.path.exists(cfg_path) or not os.path.exists(vocab_path):
        raise ValueError(
            f"checkpoint {path!r} needs config.json and vocab.txt beside the "
            "weights (an HF model directory) so dims and tokenization match "
            "the pretrained weights")
    with open(cfg_path) as f:
        hc = json.load(f)
    tokenizer = WordPieceTokenizer.from_vocab_file(
        vocab_path, lowercase=hc.get("do_lower_case", True))
    # max_len must equal the pretrained position table for weight import;
    # callers truncate sequences separately via maxTokenLen
    cfg = TransformerConfig(
        vocab_size=hc["vocab_size"],
        max_len=int(hc.get("max_position_embeddings", 512)),
        num_layers=hc["num_hidden_layers"],
        num_heads=hc["num_attention_heads"],
        d_model=hc["hidden_size"],
        d_ff=hc["intermediate_size"],
        dropout_rate=dropout_rate)
    return tokenizer, cfg


def _host_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and batch statistics as host numpy."""
    return {k: v.detach().cpu().numpy() for k, v in
            model.state_dict().items()}


def _load_state(model: torch.nn.Module, state: Dict[str, np.ndarray]):
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return model


#: OOM-discovered safe inference batch sizes, per model shape (process-wide,
#: as the reference's row guard keeps them)
_safe_batch: Dict[str, int] = {}
_safe_batch_lock = threading.Lock()


def _batched_infer(key: str, n: int, batch_size: int,
                   infer_chunk: Callable[[int, int, int], np.ndarray]
                   ) -> np.ndarray:
    """Run ``infer_chunk(start, size, bs)`` over ``[0, n)`` in windows of
    ``bs`` rows and concatenate.  On ``torch.OutOfMemoryError`` the batch
    size halves and the whole pass reruns; a size found that way is
    remembered for ``key`` so later calls start there.  Other errors, and
    an out-of-memory error at batch size 1, propagate."""
    requested = max(1, int(batch_size))
    with _safe_batch_lock:
        bs = min(requested, _safe_batch.get(key, requested))
    hit_oom = False
    while True:
        try:
            outs = [infer_chunk(start, min(bs, n - start), bs)
                    for start in range(0, n, bs)]
        except torch.OutOfMemoryError:
            if bs <= 1:
                raise
            bs = max(1, bs // 2)
            hit_oom = True
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            continue
        if hit_oom:
            with _safe_batch_lock:
                _safe_batch[key] = bs
        return np.concatenate(outs)


def _softmax_predict(logits: np.ndarray, classes: np.ndarray):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    proba = e / e.sum(-1, keepdims=True)
    return classes[np.argmax(proba, axis=1)], proba


def _profile_data(prof, key: str, step, state, inputs, labels, seed: int,
                  items: int, dev) -> None:
    """The step's data segment ends (the batch is on the device); with the
    profiler's ``capture_xla``, its cost is captured once, on a deep copy
    of the training state, outside the step's time."""
    if prof is None:
        return
    prof.mark("data")
    if prof.capture_xla and key not in prof.costs:
        import copy
        with prof.excluded():
            prof.capture_cost(key, step, copy.deepcopy(state), inputs,
                              labels, seed, items=items, device=dev)


def _profile_step_end(prof, dev) -> None:
    """The step's compute segment ends once the device has run it (the
    step returns before the card finishes), and the step closes."""
    if prof is None:
        return
    synchronize(dev)
    prof.mark("compute")
    prof.step_end()


class _DLParamsBase(Params):
    #: the DL stages name their inputs textCol/imageCol — declare them to
    #: the row guard so contract checks + None screens cover them
    _guard_input_params = ("inputCol", "inputCols", "textCol", "imageCol")

    labelCol = StringParam(doc="label column", default="label")
    predictionCol = StringParam(doc="prediction column", default="prediction")
    probabilityCol = StringParam(doc="probability column", default="probability")
    device = StringParam(doc="device to train on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")
    batchSize = IntParam(doc="global batch size", default=32)
    maxEpochs = IntParam(doc="training epochs", default=3)
    learningRate = FloatParam(doc="peak learning rate", default=1e-4)
    optimizer = StringParam(doc="adamw|adam|sgd", default="adamw",
                            allowed=("adamw", "adam", "sgd"))
    weightDecay = FloatParam(doc="adamw weight decay", default=0.01)
    lrSchedule = StringParam(doc="constant|cosine|linear", default="cosine",
                             allowed=("constant", "cosine", "linear"))
    warmupRatio = FloatParam(doc="warmup fraction of steps", default=0.06)
    gradClipNorm = FloatParam(doc="gradient clip norm (0=off)", default=1.0)
    seed = IntParam(doc="rng seed", default=0)
    numDevices = IntParam(doc="devices to use (0 = all; the port runs on "
                              "one card, more is ROADMAP A5)", default=0)
    modelParallelism = IntParam(doc="tensor-parallel size (not ported: "
                                    "ROADMAP A5)", default=1)
    zero1 = BoolParam(doc="shard optimizer moments (not ported: ROADMAP "
                          "A5)", default=False)
    validationFraction = FloatParam(doc="fraction held out for eval logging",
                                    default=0.0)
    checkpointDir = StringParam(doc="step-checkpoint directory: a fit "
                                    "resumes from its newest checkpoint")
    checkpointInterval = IntParam(doc="save every N optimizer steps "
                                  "(0 = off)", default=0)
    checkpointManager = PyObjectParam(
        doc="core.checkpoint.CheckpointManager to checkpoint through "
            "(overrides checkpointDir)")
    stepProfiler = PyObjectParam(
        doc="telemetry.gangplane.StepProfiler: per-step data / compute / "
            "other wall time (and, with capture_xla, one step's counted "
            "cost)")
    rematPolicy = StringParam(
        doc="rematerialize model blocks in the backward pass: 'none' | "
            "'dots_saveable' (keep matmul/conv outputs, recompute the "
            "cheap chains) | 'full'/'blocks' (save only block inputs); "
            "gradients equal 'none''s bit for bit",
        default="none", allowed=("none", "dots_saveable", "full", "blocks"))
    precision = StringParam(
        doc="mixed-precision policy (models/dl/precision.py): 'bf16' "
            "(bf16 activations, f32 grads/params) | 'f32' | 'bf16_grad' "
            "(gradients rounded through bf16; f32 master params, "
            "optimizer and batch statistics)",
        default="bf16", allowed=("bf16", "f32", "bf16_grad"))
    collectiveCompression = PyObjectParam(
        doc="gradient-sync codec: only 'none' on one card (the codecs are "
            "ROADMAP A5)")

    def _check_ported(self) -> None:
        """Refuse what is not ported, before any work."""
        def refuse(what, item):
            raise NotImplementedError(
                f"{type(self).__name__}: {what} is not ported yet "
                f"(ROADMAP {item})")
        if self.numDevices > 1:
            refuse("numDevices > 1 (a data-parallel mesh)",
                   "A5: DL mesh training")
        if self.modelParallelism > 1:
            refuse("modelParallelism > 1 (tensor parallelism)",
                   "A5: DL mesh training")
        if self.zero1:
            refuse("zero1 (sharded optimizer moments)",
                   "A5: DL mesh training")
        cc = self.get("collectiveCompression")
        if cc is not None and cc != "none":
            refuse(f"collectiveCompression={cc!r} (compressed gradient "
                   "collectives)", "A5: DL mesh training")
        shards = _saved_shards(self.get("checkpointManager"),
                               self.get("checkpointDir"))
        if shards != 1:
            refuse(f"resuming a {shards}-shard mesh fit's step checkpoint "
                   "(re-sharding it onto one card)", "A5: DL mesh training")
        check_profiler(self.get("stepProfiler"), type(self).__name__)

    def _precision_policy(self):
        return resolve_precision(self.precision)

    def _checkpoint_loop(self, trainer: DLTrainer,
                         state: TrainState) -> "_CheckpointLoop":
        return _CheckpointLoop(self, trainer, state)

    def _opt_config(self, total_steps: int) -> OptimizerConfig:
        return OptimizerConfig(
            name=self.optimizer, learning_rate=self.learningRate,
            weight_decay=self.weightDecay, schedule=self.lrSchedule,
            warmup_steps=int(total_steps * self.warmupRatio),
            total_steps=total_steps, grad_clip_norm=self.gradClipNorm)

    @staticmethod
    def _labels(ds: Dataset, col: str):
        y_raw = np.asarray(ds[col], np.float64)
        classes = np.unique(y_raw)
        return classes, np.searchsorted(classes, y_raw).astype(np.int32)


def _saved_shards(manager, ckpt_dir) -> int:
    """The ``shards`` the newest step checkpoint of ``manager`` (else of
    ``ckpt_dir``) was written with; 1 when there is none."""
    if manager is not None:
        if getattr(manager, "directory", None) is None:
            raise TypeError(
                "checkpointManager must be a core.checkpoint."
                "CheckpointManager (an object with a directory), got "
                f"{type(manager).__name__}")
        ckpt_dir = manager.directory
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return 1
    from ...core.checkpoint import CheckpointManager
    mgr = CheckpointManager(ckpt_dir)
    latest = mgr.latest_step()
    if latest is None:
        return 1
    return int(mgr.metrics(latest).get("shards", 1.0))


class _CheckpointLoop:
    """Step checkpoints and resume for the DL fit loops (the JAX
    package's ``_CheckpointLoop`` on one card).

    The config guard takes the JAX package's keys: the data-order keys
    (``batchSize``, ``seed``, ``validationFraction``), ``precision``,
    ``shards`` (1 on one card) and the codec, sharding, error-feedback,
    manual-step, min-size, chunk and routing keys, all 0.0 here.  A saved
    value that differs in any key but ``shards`` raises ``ValueError``;
    a saved ``shards`` other than 1 (a mesh fit's checkpoint) is refused
    before any work (:func:`_saved_shards`): there is no DL mesh to
    re-shard onto.

    A save holds the model's parameters and buffers (its
    ``state_dict``), the optimizer's moments and count and
    ``TrainState.step``, every ``checkpointInterval`` optimizer steps,
    with the ``dl.checkpoint`` kill point after it.  A resume restores
    them onto the fit's device and :meth:`skips` the steps already taken
    (their batches are drawn, nothing runs)."""

    _CONFIG_KEYS = ("batchSize", "seed", "validationFraction")
    #: keys of a mesh fit's gradient sync: 0.0 on one card, and a
    #: checkpoint that predates them wrote none (the same 0.0)
    _SYNC_KEYS = ("compression", "sharded_update", "error_feedback",
                  "manual_step", "codec_min_size", "codec_chunk", "routing")

    def __init__(self, est: "_DLParamsBase", trainer: DLTrainer,
                 state: TrainState):
        from ...core.checkpoint import CheckpointManager
        from .precision import PRECISION_CODE
        self.manager = None
        self.start_step = 0
        self.interval = int(est.checkpointInterval)
        self.state = state
        self.device = trainer.device
        self._config = {k: float(est.get_or_default(k))
                        for k in self._CONFIG_KEYS}
        self._config["shards"] = 1.0
        self._config.update({k: 0.0 for k in self._SYNC_KEYS})
        self._config["precision"] = PRECISION_CODE[
            str(est.get_or_default("precision"))]
        manager = est.get("checkpointManager")
        ckpt_dir = est.get("checkpointDir")
        if manager is None and not ckpt_dir:
            return
        self.manager = (manager if manager is not None
                        else CheckpointManager(ckpt_dir))
        ckpt_dir = self.manager.directory
        latest = self.manager.latest_step()
        if latest is None:
            return
        saved_cfg = {k: v for k, v in self.manager.metrics(latest).items()
                     if k in self._config}
        for k in self._SYNC_KEYS + ("precision",):
            saved_cfg.setdefault(k, 0.0)
        mismatch = {k: (saved_cfg[k], self._config[k]) for k in saved_cfg
                    if saved_cfg[k] != self._config[k] and k != "shards"}
        if mismatch:
            raise ValueError(
                f"checkpoint at {ckpt_dir} step {latest} was written with a "
                f"different data-order config {mismatch}; resuming would "
                f"silently train on wrong batches — use a fresh "
                f"checkpointDir or restore manually")
        # a saved shards != 1 was refused before any work (_check_ported)
        restored = self.manager.restore_state_dict(self._tree(state), latest,
                                                   device=self.device)
        self._load(state, restored)
        self.start_step = state.step

    @staticmethod
    def _tree(state: TrainState) -> dict:
        """The saved pytree: tensors on the fit's device."""
        opt = state.opt
        moments = ({"mu": opt.mu, "nu": opt.nu} if hasattr(opt, "mu")
                   else {"trace": opt.trace})
        return {"model": state.model.state_dict(),
                "opt": {"count": np.asarray(opt.count, np.int64),
                        **moments},
                "step": np.asarray(state.step, np.int64)}

    @staticmethod
    def _load(state: TrainState, tree: dict) -> None:
        state.model.load_state_dict(tree["model"])
        opt = state.opt
        with torch.no_grad():
            for name in ("mu", "nu", "trace"):
                if name in tree["opt"]:
                    for dst, src in zip(getattr(opt, name),
                                        tree["opt"][name]):
                        dst.copy_(src)
        opt.count = int(tree["opt"]["count"])
        state.step = int(tree["step"])

    def skips(self, gstep: int) -> bool:
        """True while replaying steps the checkpoint already holds."""
        return gstep <= self.start_step

    def after_step(self, gstep: int, state: TrainState) -> None:
        if self.manager and self.interval and gstep % self.interval == 0:
            self.manager.save(gstep, self._tree(state),
                              metrics=self._config)
            # the preemption point: after a durable step, before the next
            from ...resilience.faults import get_faults
            get_faults().kill_point("dl.checkpoint", step=gstep)


class DeepTextClassifier(_DLParamsBase, Estimator):
    """BERT-style text classifier (reference: DeepTextClassifier.py:27)."""
    textCol = StringParam(doc="input text column", default="text")
    maxTokenLen = IntParam(doc="max sequence length "
                               "(DeepTextClassifier.py:55)", default=128)
    vocabSize = IntParam(doc="tokenizer vocab size", default=8192)
    modelSize = StringParam(doc="tiny|small|base", default="small",
                            allowed=("tiny", "small", "base"))
    checkpoint = StringParam(
        doc="HF-format BERT checkpoint to fine-tune from: a model dir "
            "(config.json + vocab.txt + weights) or a weights file; "
            "overrides modelSize/vocabSize with the checkpoint's dims")
    dropoutRate = FloatParam(doc="dropout rate", default=0.1)
    numExperts = IntParam(doc="0 = dense FFN; > 0 = MoE FFN with this many "
                              "experts on every other encoder block "
                              "(models/dl/moe.py)", default=0)
    gradientCheckpointing = BoolParam(
        doc="rematerialize encoder blocks in the backward pass (the legacy "
            "form of rematPolicy='full')", default=False)
    moeTopK = IntParam(doc="MoE router top-k", default=2)
    expertParallelism = IntParam(doc="expert-axis mesh size (not ported: "
                                     "ROADMAP A5)", default=1)

    def _check_ported(self) -> None:
        super()._check_ported()
        if self.expertParallelism > 1:
            raise NotImplementedError(
                "DeepTextClassifier: expertParallelism > 1 (an expert mesh "
                "axis) is not ported yet (ROADMAP A5: expertParallelism)")

    def _model_config(self, num_classes: int) -> TransformerConfig:
        sizes = {
            "tiny": dict(num_layers=2, num_heads=4, d_model=128, d_ff=512),
            "small": dict(num_layers=4, num_heads=8, d_model=256, d_ff=1024),
            "base": dict(num_layers=12, num_heads=12, d_model=768, d_ff=3072),
        }[self.modelSize]
        return TransformerConfig(
            vocab_size=self.vocabSize, max_len=self.maxTokenLen,
            num_classes=num_classes, dropout_rate=self.dropoutRate,
            num_experts=self.numExperts, moe_top_k=self.moeTopK, **sizes)

    def _fit(self, ds: Dataset) -> "DeepTextModel":
        self._check_ported()
        dev = resolve_device(self.device)
        texts = list(ds[self.textCol])
        classes, labels = self._labels(ds, self.labelCol)
        num_classes = len(classes)

        ckpt_path = self.get("checkpoint")
        ckpt_cfg = None
        if ckpt_path:
            tokenizer, ckpt_cfg = _bert_checkpoint_assets(
                ckpt_path, self.dropoutRate)
        else:
            tokenizer = WordTokenizer.fit(texts, self.vocabSize)
        ids, mask = tokenizer.encode(texts, self.maxTokenLen)

        # validationFraction: the last rows are held out for per-epoch
        # eval logging
        n_all = len(texts)
        n_val = int(n_all * self.validationFraction)
        if n_val:
            keep = n_all - n_val
            ids, mask, labels, val_ids, val_mask, val_labels = (
                ids[:keep], mask[:keep], labels[:keep], ids[keep:],
                mask[keep:], labels[keep:])
        n = len(labels)
        total_steps = num_minibatches(n, self.batchSize, 1) * self.maxEpochs

        base_cfg = (ckpt_cfg if ckpt_cfg is not None
                    else self._model_config(num_classes))
        # rematPolicy supersedes the legacy gradientCheckpointing bool
        remat = (self.rematPolicy if self.rematPolicy != "none"
                 else bool(self.gradientCheckpointing))
        policy = self._precision_policy()
        cfg = dataclasses.replace(base_cfg, num_classes=num_classes,
                                  remat=remat, dtype=policy.compute_dtype)
        model = TextEncoder(cfg, device=dev, seed=None)
        trainer = DLTrainer(model, self._opt_config(total_steps), dev,
                            precision=policy)
        state = trainer.init_state(self.seed)
        if ckpt_path:
            from .checkpoints import import_bert
            model.load_state_dict(import_bert(
                model.state_dict(), ckpt_path, num_layers=cfg.num_layers))
        step = trainer.train_step()
        eval_step = trainer.eval_step()
        rng = np.random.default_rng(self.seed)
        ckpt = self._checkpoint_loop(trainer, state)

        history: List[dict] = []
        prof = self.get("stepProfiler")
        gstep = 0
        try:
            for _ in range(self.maxEpochs):
                metrics = {}
                for idx in iterate_minibatches(n, self.batchSize, 1, rng):
                    gstep += 1
                    if ckpt.skips(gstep):
                        continue
                    if prof is not None:
                        prof.step_begin(gstep)
                    bi, bm, bl = trainer.shard_batch(
                        (ids[idx], mask[idx], labels[idx]))
                    _profile_data(prof, "dl_text_step", step, state, (bi, bm),
                                  bl, self.seed, len(idx), dev)
                    state, metrics = step(state, (bi, bm), bl, self.seed)
                    _profile_step_end(prof, dev)
                    ckpt.after_step(gstep, state)
                if ckpt.skips(gstep):
                    continue     # the checkpoint covers the whole epoch
                record = {k: float(v) for k, v in metrics.items()}
                if n_val:
                    bs = max(int(self.batchSize), 1)
                    vlogits = np.concatenate([
                        eval_step(state, trainer.shard_batch(
                            (val_ids[s:s + bs], val_mask[s:s + bs])))
                        .float().cpu().numpy() for s in range(0, n_val, bs)])
                    record["val_accuracy"] = float(
                        (vlogits.argmax(-1) == val_labels).mean())
                history.append(record)
        finally:
            if prof is not None:
                prof.finish()

        return DeepTextModel(
            modelPayload={
                "variables": _host_state(model),
                "config": cfg,
                "tokenizer": tokenizer.to_dict(),
                "classes": [float(c) for c in classes],
                "history": history,
            },
            device=self.device,
            textCol=self.textCol,
            predictionCol=self.predictionCol,
            probabilityCol=self.probabilityCol,
            maxTokenLen=self.maxTokenLen,
            batchSize=self.batchSize,
        )


class DeepTextModel(Model):
    """Inference transformer (reference: DeepTextModel.py:1-119)."""
    textCol = StringParam(doc="input text column", default="text")
    predictionCol = StringParam(doc="prediction column", default="prediction")
    probabilityCol = StringParam(doc="probability column", default="probability")
    device = StringParam(doc="device to score on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")
    maxTokenLen = IntParam(doc="max sequence length", default=128)
    batchSize = IntParam(doc="inference batch size", default=64)
    modelPayload = PyObjectParam(doc="trained weights + tokenizer + config")

    def _transform(self, ds: Dataset) -> Dataset:
        dev = resolve_device(self.device)
        payload = self.modelPayload
        cfg: TransformerConfig = payload["config"]
        model = _load_state(TextEncoder(cfg, device=dev, seed=None),
                            payload["variables"])
        tokenizer = tokenizer_from_dict(payload["tokenizer"])
        classes = np.asarray(payload["classes"])

        texts = list(ds[self.textCol])
        ids, mask = tokenizer.encode(texts, self.maxTokenLen)

        @torch.no_grad()
        def infer_chunk(start, size, bs):
            bi, bm = to_device((ids[start:start + size],
                                mask[start:start + size]), dev)
            return model(bi, bm, deterministic=True).cpu().numpy()

        # structural key: a reloaded model keeps its discovered safe size
        key = (f"dl:text:{cfg.num_layers}l{cfg.d_model}d"
               f"{cfg.vocab_size}v:{self.maxTokenLen}t")
        logits = _batched_infer(key, len(texts), int(self.batchSize),
                                infer_chunk)
        pred, proba = _softmax_predict(logits, classes)
        return (ds.with_column(self.predictionCol, pred.astype(np.float64))
                  .with_column(self.probabilityCol,
                               list(proba.astype(np.float64))))


class DeepVisionClassifier(_DLParamsBase, Estimator):
    """CNN image classifier (reference: DeepVisionClassifier.py:31)."""
    imageCol = StringParam(doc="image column (HWC arrays)", default="image")
    backbone = StringParam(doc="resnet18|resnet34|resnet50|resnet101|resnet152",
                           default="resnet50")
    checkpoint = StringParam(
        doc="torchvision-format resnet checkpoint (state-dict file) to "
            "fine-tune from; the classifier head reloads only when its "
            "shape matches")

    def _fit(self, ds: Dataset) -> "DeepVisionModel":
        self._check_ported()
        dev = resolve_device(self.device)
        imgs = np.stack([np.asarray(im, np.float32)
                         for im in ds[self.imageCol]])
        # decide normalization once at fit; the model stores the decision
        # so transform always scales consistently
        scale255 = bool(imgs.max() > 2.0)
        if scale255:
            imgs = imgs / 255.0
        classes, labels = self._labels(ds, self.labelCol)
        n = len(imgs)
        total_steps = num_minibatches(n, self.batchSize, 1) * self.maxEpochs

        policy = self._precision_policy()
        model = make_backbone(self.backbone, num_classes=len(classes),
                              remat=self.rematPolicy,
                              dtype=policy.compute_dtype, device=dev,
                              seed=None)
        trainer = DLTrainer(model, self._opt_config(total_steps), dev,
                            has_batch_stats=True, train_kwarg="train",
                            precision=policy)
        state = trainer.init_state(self.seed)
        if self.get("checkpoint"):
            from .checkpoints import import_resnet
            bb = BACKBONES[self.backbone]
            model.load_state_dict(import_resnet(
                model.state_dict(), self.get("checkpoint"),
                stage_sizes=bb.keywords["stage_sizes"],
                bottleneck=bb.keywords["block_cls"] is BottleneckResNetBlock))
        step = trainer.train_step()
        rng = np.random.default_rng(self.seed)
        ckpt = self._checkpoint_loop(trainer, state)

        history: List[dict] = []
        prof = self.get("stepProfiler")
        gstep = 0
        try:
            for _ in range(self.maxEpochs):
                metrics = {}
                for idx in iterate_minibatches(n, self.batchSize, 1, rng):
                    gstep += 1
                    if ckpt.skips(gstep):
                        continue
                    if prof is not None:
                        prof.step_begin(gstep)
                    bi, bl = trainer.shard_batch((imgs[idx], labels[idx]))
                    _profile_data(prof, "dl_vision_step", step, state, (bi,),
                                  bl, self.seed, len(idx), dev)
                    state, metrics = step(state, (bi,), bl, self.seed)
                    _profile_step_end(prof, dev)
                    ckpt.after_step(gstep, state)
                if ckpt.skips(gstep):
                    continue     # the checkpoint covers the whole epoch
                history.append({k: float(v) for k, v in metrics.items()})
        finally:
            if prof is not None:
                prof.finish()

        return DeepVisionModel(
            modelPayload={
                "variables": _host_state(model),
                "backbone": self.backbone,
                "classes": [float(c) for c in classes],
                "scale255": scale255,
                "history": history,
            },
            device=self.device,
            imageCol=self.imageCol,
            predictionCol=self.predictionCol,
            probabilityCol=self.probabilityCol,
            batchSize=self.batchSize,
        )


class DeepVisionModel(Model):
    """Inference transformer (reference: DeepVisionModel.py:1-122)."""
    imageCol = StringParam(doc="image column", default="image")
    predictionCol = StringParam(doc="prediction column", default="prediction")
    probabilityCol = StringParam(doc="probability column", default="probability")
    device = StringParam(doc="device to score on: 'cuda' (raises when no "
                             "card is present) or 'cpu'", default="cuda")
    batchSize = IntParam(doc="inference batch size", default=64)
    modelPayload = PyObjectParam(doc="trained weights + config")

    def _transform(self, ds: Dataset) -> Dataset:
        dev = resolve_device(self.device)
        payload = self.modelPayload
        classes = np.asarray(payload["classes"])
        # the backbone at its default compute dtype (bf16), whatever the
        # fit's precision, as the reference's transform builds it
        model = _load_state(make_backbone(payload["backbone"],
                                          num_classes=len(classes),
                                          device=dev, seed=None),
                            payload["variables"])

        imgs = np.stack([np.asarray(im, np.float32)
                         for im in ds[self.imageCol]])
        if payload.get("scale255"):
            imgs = imgs / 255.0

        @torch.no_grad()
        def infer_chunk(start, size, bs):
            (chunk,) = to_device((imgs[start:start + size],), dev)
            return model(chunk, train=False).cpu().numpy()

        key = (f"dl:vision:{payload['backbone']}:{len(classes)}c:"
               f"{'x'.join(str(d) for d in imgs.shape[1:])}")
        logits = _batched_infer(key, len(imgs), int(self.batchSize),
                                infer_chunk)
        pred, proba = _softmax_predict(logits, classes)
        return (ds.with_column(self.predictionCol, pred.astype(np.float64))
                  .with_column(self.probabilityCol,
                               list(proba.astype(np.float64))))
