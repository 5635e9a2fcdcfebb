"""Deep-learning estimators (the port of the JAX package's ``models/dl``):
a BERT-style text classifier and ResNet vision classifiers, trained and
scored with plain PyTorch ops on one card or over the ranks of a process
group (``make_dl_mesh``)."""

from .convert import params_from_reference
from .estimators import (DeepTextClassifier, DeepTextModel,
                         DeepVisionClassifier, DeepVisionModel)
from .precision import PrecisionPolicy, remat_policy, resolve_precision
from .resnet import BACKBONES, ResNet, make_backbone
from .tokenizer import WordPieceTokenizer, WordTokenizer, tokenizer_from_dict
from .training import DLTrainer, OptimizerConfig, TrainState, make_dl_mesh
from .transformer import TextEncoder, TransformerConfig

__all__ = [
    "BACKBONES", "DLTrainer", "DeepTextClassifier", "DeepTextModel",
    "DeepVisionClassifier", "DeepVisionModel", "OptimizerConfig",
    "PrecisionPolicy", "ResNet", "TextEncoder", "TrainState",
    "TransformerConfig", "WordPieceTokenizer", "WordTokenizer",
    "make_backbone", "make_dl_mesh", "params_from_reference", "remat_policy",
    "resolve_precision", "tokenizer_from_dict",
]
