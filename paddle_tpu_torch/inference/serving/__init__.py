"""LLM serving for the port: a paged KV cache, a continuous-batching
scheduler and ``LLMEngine``, with paged attention on hand-written CUDA
kernels (counterpart of ``paddle_tpu.inference.serving``); the llama
serving artifacts (plain and int8) that ``LLMEngine.reload_weights`` and
``inference.create_predictor`` read; and pages that leave and re-enter a
pool: the disaggregated prefill/decode handoff (``export_kv_pages``,
``add_request_with_pages``, ``pack_kv_pages``/``unpack_kv_pages``), the
host-RAM tier (``HostKVTier``) and the on-disk prefix store
(``prefix_store``); deadlines, tenants and QoS tiers (``TenantQuota``,
``TIER_LATENCY``/``TIER_BATCH``, ``LLMEngine.configure_tenant``); and
serving integrity (page checksums and the weight audit, ``integrity``)."""

from .engine import (ARTIFACT_QMAX, LLMEngine, StepOutput,
                     dequantize_state_dict, is_llama_artifact,
                     is_quantized_artifact, load_llama_artifact,
                     load_llama_state_dict, quantize_state_dict,
                     save_llama_artifact)
from .errors import (DeadlineInfeasibleError, EngineClosedError,
                     KVIntegrityError, RequestTimeoutError,
                     TenantQuotaExceededError)
from .kv_cache import (KV_QMAX, BlockAllocator, HostKVTier, PagedKVCache,
                       PageSnapshot, PrefixCache, kv_pool_bytes_per_block,
                       pack_kv_pages, quantize_kv_rows, unpack_kv_pages)
from .paged_attention import (paged_decode_attention,
                              paged_multiquery_attention)
from .prefix_store import (PrefixStoreMismatch, load_prefix_store,
                           pool_geometry, save_prefix_store,
                           weights_fingerprint)
from .scheduler import (TIER_BATCH, TIER_LATENCY, Request, SamplingParams,
                        Scheduler, TenantQuota)

__all__ = ["LLMEngine", "StepOutput", "EngineClosedError", "KV_QMAX",
           "BlockAllocator", "PagedKVCache", "PrefixCache",
           "kv_pool_bytes_per_block", "quantize_kv_rows",
           "paged_decode_attention", "paged_multiquery_attention",
           "Request", "SamplingParams", "Scheduler", "ARTIFACT_QMAX",
           "quantize_state_dict", "dequantize_state_dict",
           "save_llama_artifact", "is_llama_artifact",
           "is_quantized_artifact", "load_llama_state_dict",
           "load_llama_artifact", "pack_kv_pages", "unpack_kv_pages",
           "HostKVTier", "PageSnapshot", "PrefixStoreMismatch",
           "weights_fingerprint", "pool_geometry", "save_prefix_store",
           "load_prefix_store", "RequestTimeoutError",
           "TenantQuotaExceededError", "DeadlineInfeasibleError",
           "KVIntegrityError", "TenantQuota", "TIER_LATENCY", "TIER_BATCH"]
