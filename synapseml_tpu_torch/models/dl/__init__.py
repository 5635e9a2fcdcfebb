"""Deep-learning estimators (the port of the JAX package's ``models/dl``):
a BERT-style text classifier and ResNet vision classifiers, trained and
scored with plain PyTorch ops on one card or over the ranks of a process
group (``make_dl_mesh``: data, expert- or tensor-parallel), with ring
attention over a ``seq`` axis (``ring_attention``) and the GPipe
pipeline over a ``pipe`` axis (``pipeline``)."""

from .convert import params_from_reference
from .estimators import (DeepTextClassifier, DeepTextModel,
                         DeepVisionClassifier, DeepVisionModel)
from .pipeline import (encoder_stage_fn, merge_encoder_stages, pp_logits_fn,
                       pp_train_loss, split_encoder_stages)
from .precision import PrecisionPolicy, remat_policy, resolve_precision
from .resnet import BACKBONES, ResNet, make_backbone
from .ring_attention import ring_attention, ring_attention_inner, shard_blocks
from .tokenizer import WordPieceTokenizer, WordTokenizer, tokenizer_from_dict
from .training import DLTrainer, OptimizerConfig, TrainState, make_dl_mesh
from .transformer import TextEncoder, TransformerConfig

__all__ = [
    "BACKBONES", "DLTrainer", "DeepTextClassifier", "DeepTextModel",
    "DeepVisionClassifier", "DeepVisionModel", "OptimizerConfig",
    "PrecisionPolicy", "ResNet", "TextEncoder", "TrainState",
    "TransformerConfig", "WordPieceTokenizer", "WordTokenizer",
    "encoder_stage_fn", "make_backbone", "make_dl_mesh",
    "merge_encoder_stages", "params_from_reference", "pp_logits_fn",
    "pp_train_loss", "remat_policy", "resolve_precision", "ring_attention",
    "ring_attention_inner", "shard_blocks", "split_encoder_stages",
    "tokenizer_from_dict",
]
