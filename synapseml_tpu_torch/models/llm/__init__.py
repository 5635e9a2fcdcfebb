"""Decoder-only LLM and its continuous-batching decode engine (the port
of the JAX package's ``models/llm``), with the paged decode-attention
kernel K3 in CUDA, and the causal-LM fine-tuning of ``finetune``."""

from .convert import params_from_reference
from .drafter import NgramDrafter
from .finetune import (finetune_lm, lm_loss_fn, make_lm_train_step,
                       templated_log_corpus)
from .generate import cast_params, generate, sample_logits
from .kvtier import RadixPrefixIndex
from .model import (CausalAttention, DecoderBlock, LlamaConfig, LlamaModel,
                    RMSNorm, apply_rope, causal_lm_loss, init_cache,
                    rope_frequencies)
from .paged_attn import (ATTENTION_BACKENDS, PagedGeometry,
                         dense_read_bytes, paged_decode_attention,
                         paged_decode_attention_plain, paged_geometry,
                         paged_read_bytes, resolve_attention_backend,
                         span_bucket_tiles)
from .slots import AdmitResult, SlotEngine, StepEvent

__all__ = [
    "ATTENTION_BACKENDS", "AdmitResult", "CausalAttention", "DecoderBlock",
    "LlamaConfig", "LlamaModel", "NgramDrafter", "PagedGeometry", "RMSNorm",
    "RadixPrefixIndex", "SlotEngine", "StepEvent", "apply_rope",
    "cast_params", "causal_lm_loss", "dense_read_bytes", "finetune_lm",
    "generate", "init_cache", "lm_loss_fn", "make_lm_train_step",
    "paged_decode_attention", "paged_decode_attention_plain",
    "paged_geometry", "paged_read_bytes", "params_from_reference",
    "resolve_attention_backend", "rope_frequencies", "sample_logits",
    "span_bucket_tiles", "templated_log_corpus",
]
