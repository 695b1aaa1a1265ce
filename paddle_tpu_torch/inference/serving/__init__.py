"""LLM serving for the port: a paged KV cache, a continuous-batching
scheduler and ``LLMEngine``, with paged attention on hand-written CUDA
kernels (counterpart of ``paddle_tpu.inference.serving``)."""

from .engine import LLMEngine, StepOutput
from .errors import EngineClosedError
from .kv_cache import (KV_QMAX, BlockAllocator, PagedKVCache, PrefixCache,
                       kv_pool_bytes_per_block, quantize_kv_rows)
from .paged_attention import (paged_decode_attention,
                              paged_multiquery_attention)
from .scheduler import Request, SamplingParams, Scheduler

__all__ = ["LLMEngine", "StepOutput", "EngineClosedError", "KV_QMAX",
           "BlockAllocator", "PagedKVCache", "PrefixCache",
           "kv_pool_bytes_per_block", "quantize_kv_rows",
           "paged_decode_attention", "paged_multiquery_attention",
           "Request", "SamplingParams", "Scheduler"]
