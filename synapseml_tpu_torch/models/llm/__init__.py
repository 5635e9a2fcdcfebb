"""Decoder-only LLM and its continuous-batching decode engine (the port
of the JAX package's ``models/llm``), with the paged decode-attention
kernel K3 in CUDA; the host KV arena and session journal of ``kvtier``,
int8 weights, speculative and dense generation, ``LLMTransformer``,
``llama_from_pretrained``, and the causal-LM fine-tuning of
``finetune``.  ``LlamaModel(..., mesh=)`` shards the decoder over a
``model`` axis (the Megatron layout, ``tp_shard_specs``) for the dense
``generate``."""

from .convert import params_from_reference, shard_state_dict
from .drafter import NgramDrafter
from .finetune import (finetune_lm, lm_loss_fn, make_lm_train_step,
                       templated_log_corpus)
from .generate import (cast_params, generate, generate_speculative,
                       quantize_int8, sample_logits, spec_unpack)
from .kvtier import (KVTIER_METRICS, TRANSFER_MAGIC, ChecksumError,
                     HostKVArena, KVTransfer, RadixPrefixIndex,
                     SessionJournal, SessionState, kvtier_metrics,
                     pack_kv_transfer, token_prefix_hash,
                     unpack_kv_transfer)
from .model import (CausalAttention, DecoderBlock, LlamaConfig, LlamaModel,
                    QuantDense, QuantEmbed, RMSNorm, apply_rope,
                    causal_lm_loss, init_cache, llama_from_pretrained,
                    rope_frequencies, tp_shard_specs)
from .paged_attn import (ATTENTION_BACKENDS, PagedGeometry,
                         dense_read_bytes, paged_decode_attention,
                         paged_decode_attention_plain, paged_geometry,
                         paged_read_bytes, resolve_attention_backend,
                         span_bucket_tiles)
from .slots import AdmitResult, SlotEngine, StepEvent
from .stage import LLMTransformer
from .warmup import CompilePlane, ProgramSpec, program_lattice

__all__ = [
    "ATTENTION_BACKENDS", "AdmitResult", "CausalAttention", "ChecksumError",
    "CompilePlane", "DecoderBlock", "HostKVArena", "KVTIER_METRICS",
    "KVTransfer", "LLMTransformer", "LlamaConfig", "LlamaModel",
    "NgramDrafter", "PagedGeometry", "ProgramSpec", "QuantDense",
    "QuantEmbed", "RMSNorm", "RadixPrefixIndex", "SessionJournal",
    "SessionState", "SlotEngine", "StepEvent", "TRANSFER_MAGIC", "apply_rope",
    "cast_params", "causal_lm_loss", "dense_read_bytes", "finetune_lm",
    "generate", "generate_speculative", "init_cache", "kvtier_metrics",
    "llama_from_pretrained", "lm_loss_fn", "make_lm_train_step",
    "pack_kv_transfer", "paged_decode_attention",
    "paged_decode_attention_plain", "paged_geometry", "paged_read_bytes",
    "params_from_reference", "program_lattice", "quantize_int8",
    "resolve_attention_backend", "rope_frequencies", "sample_logits",
    "shard_state_dict", "span_bucket_tiles", "spec_unpack",
    "templated_log_corpus", "token_prefix_hash", "tp_shard_specs",
    "unpack_kv_transfer",
]
