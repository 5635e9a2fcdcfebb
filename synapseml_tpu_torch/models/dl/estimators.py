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

The param surface is the JAX package's plus ``device``.  A fit runs over
the ranks of the initialized ``torch.distributed`` group (the shards are
ranks, as the GBDT's ``numShards``): ``numDevices=0`` means every rank,
``1`` the local device, and any other value must equal the group's size
(``ValueError`` before any work otherwise).  Over a gang each rank
trains on its block of every batch (:mod:`.training`), the model is the
same on every rank when the fit ends, and it loads on one card.
``expertParallelism`` shards the MoE experts over an ``expert`` axis
(``{data: world / ep, expert: ep}``), ``modelParallelism`` (text only,
as in the reference) shards the encoder's weights over a ``model`` axis
(``{data: world / tp, model: tp}``, the Megatron layout of
:mod:`.transformer`; ignored when ``expertParallelism > 1``, and a
``ValueError`` before any work when tp does not divide the group's
ranks), ``zero1`` shards the optimizer moments over ``data`` on any of
these meshes and ``collectiveCompression`` ('bf16' | 'int8' with error
feedback, or a ``CollectiveConfig``) runs the manual data-parallel step
(a pure data mesh only).  ``DeepVisionClassifier`` always trains
data-parallel, whatever ``modelParallelism`` says, as the reference's
does.  Step checkpoints
(``checkpointDir`` or ``checkpointManager`` with ``checkpointInterval``)
save the model's parameters and buffers, the optimizer's moments and
count, the residuals and the step every that many optimizer steps
(:class:`_CheckpointLoop`; over a gang, rank 0 writes); a later fit with
the same directory resumes from the newest, at any number of ranks,
replaying the data order so it trains on the batches the uninterrupted
fit would.  ``stepProfiler`` (a
:class:`~synapseml_tpu_torch.telemetry.gangplane.StepProfiler`) times
each step's data / compute / other segments, synchronizing the device
before ``compute`` ends (only when a profiler is set); with its
``capture_xla`` it captures one step's cost (``dl_text_step`` /
``dl_vision_step``), run on a deep copy of the training state; over a
gang every rank captures the same step together (the copy's step runs
the collectives), and the ranks must agree on ``capture_xla``.
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
from ...parallel.mesh import DATA_AXIS, axis_size
from ...telemetry.gangplane import agree_capture, check_profiler
from .precision import resolve_precision
from .resnet import BACKBONES, BottleneckResNetBlock, make_backbone
from .tokenizer import WordPieceTokenizer, WordTokenizer, tokenizer_from_dict
from .training import (DLTrainer, OptimizerConfig, TrainState,
                       iterate_minibatches, make_dl_mesh, num_minibatches,
                       to_device)
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
    """The whole model's parameters and batch statistics as host numpy
    (an expert-sharded model's experts gathered: collective)."""
    sd = (model.full_state_dict() if hasattr(model, "full_state_dict")
          else model.state_dict())
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


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
                  items: int, dev, mesh=None) -> None:
    """The step's data segment ends (the batch is on the device); with the
    profiler's ``capture_xla``, its cost is captured once, on a deep copy
    of the training state, outside the step's time (over a mesh, by
    every rank together)."""
    if prof is None:
        return
    prof.mark("data")
    if prof.capture_xla and key not in prof.costs:
        import copy
        with prof.excluded():
            prof.capture_cost(key, step, copy.deepcopy(state), inputs,
                              labels, seed, items=items, device=dev,
                              mesh=mesh)


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
    numDevices = IntParam(doc="ranks to train over: 0 = every rank of the "
                              "initialized process group, 1 = this device, "
                              "else the group's size", default=0)
    modelParallelism = IntParam(doc="tensor-parallel size: the text "
                                    "encoder's weights shard over a "
                                    "'model' axis of this many ranks "
                                    "(ignored with expertParallelism > 1 "
                                    "and by the vision classifier, as in "
                                    "the reference)", default=1)
    zero1 = BoolParam(doc="shard the optimizer moments over the data axis "
                          "(ZeRO-1)", default=False)
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
        doc="wire codec + sharding for the gradient sync: 'none' (default) "
            "| 'bf16' | 'int8' (both with error feedback) | a parallel."
            "compression.CollectiveConfig (compression / sharded_update / "
            "error_feedback / min_size knobs): runs the manual "
            "data-parallel step; needs a pure data mesh")

    def _collective_config(self):
        from ...parallel.compression import resolve_collective_config
        return resolve_collective_config(self.get("collectiveCompression"))

    def _resolve_mesh(self, ep: int = 1, tp: int = 1):
        """Check the knobs and build the fit's mesh, before any work: None
        for a fit on this device, else a ProcessMesh over every rank of
        the group (``{data, expert}`` when ``ep > 1``, ``{data, model}``
        when ``tp > 1``)."""
        name = type(self).__name__
        _manager_dir(self.get("checkpointManager"))
        check_profiler(self.get("stepProfiler"), name)
        cc = self._collective_config()
        if cc is not None and self.zero1:
            raise ValueError(
                f"{name}: zero1 and collectiveCompression are mutually "
                "exclusive (sharded_update=True is the explicit form of "
                "zero1 and composes with compression)")
        if cc is not None and (ep > 1 or tp > 1):
            raise ValueError(
                f"{name}: collectiveCompression runs the manual "
                "data-parallel step, which needs a pure data mesh; drop "
                "expertParallelism / modelParallelism or "
                "collectiveCompression")
        mesh = make_dl_mesh(tp, int(self.numDevices), ep,
                            device=self.device, owner=name)
        agree_capture(self.get("stepProfiler"), mesh)
        return mesh

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


def _manager_dir(manager):
    """``checkpointManager``'s directory (None without one); raises
    ``TypeError`` for an object that is not a manager."""
    if manager is None:
        return None
    if getattr(manager, "directory", None) is None:
        raise TypeError(
            "checkpointManager must be a core.checkpoint."
            "CheckpointManager (an object with a directory), got "
            f"{type(manager).__name__}")
    return manager.directory


class _CheckpointLoop:
    """Step checkpoints and resume for the DL fit loops (the JAX
    package's ``_CheckpointLoop``).

    The config guard takes the JAX package's keys: the data-order keys
    (``batchSize``, ``seed``, ``validationFraction``), ``precision``,
    ``shards`` (the data axis's size) and the gradient sync's codec,
    sharding, error-feedback, manual-step, min-size, chunk and routing
    keys, plus the port's ``zero1`` (its moments are laid out as one flat
    stream).  A saved value that differs in any key but ``shards``
    raises ``ValueError``; a saved ``shards`` that differs is an elastic
    resize: the checkpoint is re-laid for this size
    (:meth:`~.training.DLTrainer.load_checkpoint_tree`) and
    ``dl.resize_resume`` (saved, current) is noted in the fault registry
    and the flight ring.

    A save holds :meth:`~.training.DLTrainer.checkpoint_tree` (the whole
    model, the optimizer, the step and the residuals; gathered over a
    mesh, written by rank 0, then a barrier) every
    ``checkpointInterval`` optimizer steps, with the ``dl.checkpoint``
    kill point after it.  A resume restores it and :meth:`skips` the
    steps already taken (their batches are drawn, nothing runs)."""

    _CONFIG_KEYS = ("batchSize", "seed", "validationFraction")
    #: keys of the gradient sync; a checkpoint that predates them wrote
    #: none (0.0)
    _SYNC_KEYS = ("compression", "sharded_update", "error_feedback",
                  "manual_step", "codec_min_size", "codec_chunk", "routing",
                  "zero1")
    #: collectiveCompression codec → config-guard float
    _CODEC_CODE = {"none": 0.0, "bf16": 1.0, "int8": 2.0}

    def __init__(self, est: "_DLParamsBase", trainer: DLTrainer,
                 state: TrainState):
        from ...core.checkpoint import CheckpointManager
        from .precision import PRECISION_CODE
        self.manager = None
        self.start_step = 0
        self.interval = int(est.checkpointInterval)
        self.state = state
        self.trainer = trainer
        self._config = {k: float(est.get_or_default(k))
                        for k in self._CONFIG_KEYS}
        self._config["shards"] = float(trainer.data_size)
        self._config.update(self._sync_config(trainer))
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
        saved = int(saved_cfg.get("shards", self._config["shards"]))
        current = int(self._config["shards"])
        trainer.load_checkpoint_tree(
            state, self.manager.restore(latest, device="cpu"), saved)
        if saved != current:
            from ...resilience.faults import get_faults
            from ...telemetry.flight import record as flight_record
            get_faults().note("dl.resize_resume", saved=saved,
                              current=current)
            flight_record("resize_resume", trainer="dl",
                          saved_shards=saved, current_shards=current)
        self.start_step = state.step

    @classmethod
    def _sync_config(cls, trainer: DLTrainer) -> Dict[str, float]:
        """The gradient sync's guard keys: 0.0 each without a codec."""
        cc = trainer.collective
        out = {k: 0.0 for k in cls._SYNC_KEYS}
        out["zero1"] = float(trainer.zero1)
        if cc is None:
            return out
        from ...parallel.planner import STRATEGIES, get_planner
        out.update(
            compression=cls._CODEC_CODE[cc.compression],
            sharded_update=float(cc.sharded_update),
            error_feedback=float(cc.error_feedback), manual_step=1.0,
            codec_min_size=float(cc.min_size),
            codec_chunk=float(cc.chunk if cc.compression == "int8"
                              else 0.0))
        # the resolved route: flat wherever the sync cannot route (no
        # codec and no explicit route, or the sharded update's own
        # reduce-scatter), as the reference stamps it
        unroutable = cc.sharded_update or (not cc.compresses
                                           and not cc.routes)
        routing = ("flat" if unroutable else get_planner().resolved_routing(
            cc, world=trainer.data_size))
        out["routing"] = (0.0 if routing == "flat"
                          else float(1 + STRATEGIES.index(routing)))
        return out

    def skips(self, gstep: int) -> bool:
        """True while replaying steps the checkpoint already holds."""
        return gstep <= self.start_step

    def after_step(self, gstep: int, state: TrainState) -> None:
        if self.manager and self.interval and gstep % self.interval == 0:
            tree = self.trainer.checkpoint_tree(state)
            if self.trainer.is_writer:
                self.manager.save(gstep, tree, metrics=self._config)
            if self.trainer.mesh is not None:
                # every rank leaves the step once the checkpoint is durable
                import torch.distributed as dist
                dist.barrier()
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
    expertParallelism = IntParam(doc="expert-axis mesh size (> 1 shards "
                                     "the MoE experts over the ranks; "
                                     "requires numExperts > 0)", default=1)

    def _resolve_mesh(self, ep: int = 1, tp: int = 1):
        ep = int(self.expertParallelism)
        if ep > 1:
            if self.numExperts <= 0:
                raise ValueError("expertParallelism > 1 requires "
                                 "numExperts > 0 (MoE FFN)")
            if self.numExperts % ep:
                raise ValueError(
                    f"numExperts={self.numExperts} must be divisible by "
                    f"expertParallelism={ep} to shard experts evenly")
        # the reference builds dp_ep_mesh and ignores modelParallelism
        # when experts shard
        tp = 1 if ep > 1 else int(self.modelParallelism)
        return super()._resolve_mesh(max(ep, 1), max(tp, 1))

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
        mesh = self._resolve_mesh()
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
        shards = axis_size(mesh, DATA_AXIS)
        total_steps = (num_minibatches(n, self.batchSize, shards)
                       * self.maxEpochs)

        base_cfg = (ckpt_cfg if ckpt_cfg is not None
                    else self._model_config(num_classes))
        # rematPolicy supersedes the legacy gradientCheckpointing bool
        remat = (self.rematPolicy if self.rematPolicy != "none"
                 else bool(self.gradientCheckpointing))
        policy = self._precision_policy()
        cfg = dataclasses.replace(base_cfg, num_classes=num_classes,
                                  remat=remat, dtype=policy.compute_dtype)
        model = TextEncoder(cfg, device=dev, seed=None, mesh=mesh)
        trainer = DLTrainer(model, self._opt_config(total_steps), dev,
                            precision=policy, mesh=mesh,
                            zero1=bool(self.zero1),
                            collective=self._collective_config())
        state = trainer.init_state(self.seed)
        if ckpt_path:
            from .checkpoints import import_bert
            model.load_full_state_dict(import_bert(
                model.full_state_dict(), ckpt_path,
                num_layers=cfg.num_layers))
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
                for idx in iterate_minibatches(n, self.batchSize, shards,
                                               rng):
                    gstep += 1
                    if ckpt.skips(gstep):
                        continue
                    if prof is not None:
                        prof.step_begin(gstep)
                    idx = trainer.local_rows(idx)
                    bi, bm, bl = trainer.shard_batch(
                        (ids[idx], mask[idx], labels[idx]))
                    _profile_data(prof, "dl_text_step", step, state, (bi, bm),
                                  bl, self.seed, len(idx), dev, mesh)
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
        mesh = self._resolve_mesh()
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
        shards = axis_size(mesh, DATA_AXIS)
        total_steps = (num_minibatches(n, self.batchSize, shards)
                       * self.maxEpochs)

        policy = self._precision_policy()
        model = make_backbone(self.backbone, num_classes=len(classes),
                              remat=self.rematPolicy,
                              dtype=policy.compute_dtype, device=dev,
                              seed=None, mesh=mesh)
        trainer = DLTrainer(model, self._opt_config(total_steps), dev,
                            has_batch_stats=True, train_kwarg="train",
                            precision=policy, mesh=mesh,
                            zero1=bool(self.zero1),
                            collective=self._collective_config())
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
                for idx in iterate_minibatches(n, self.batchSize, shards,
                                               rng):
                    gstep += 1
                    if ckpt.skips(gstep):
                        continue
                    if prof is not None:
                        prof.step_begin(gstep)
                    idx = trainer.local_rows(idx)
                    bi, bl = trainer.shard_batch((imgs[idx], labels[idx]))
                    _profile_data(prof, "dl_vision_step", step, state, (bi,),
                                  bl, self.seed, len(idx), dev, mesh)
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
