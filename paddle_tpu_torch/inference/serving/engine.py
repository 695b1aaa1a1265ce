"""LLM serving engine (counterpart of
``paddle_tpu/inference/serving/engine.py``).

``LLMEngine`` turns a ``LlamaForCausalLM`` into a continuously batched
server over a paged KV pool on one device (``cuda`` by default):

* ``add_request`` queues the prompt; with ``ingest_async=True`` (the
  default, as in the reference) an ingest thread pads it to its prefill
  bucket and starts its copy to the device, so admission never waits on
  the host: on the card into a pinned buffer, copied with
  ``non_blocking=True`` on the engine's staging stream, with a
  ``torch.cuda.Event`` the prefill chunk's stream waits on. If the thread
  dies it warns once and the engine stages synchronously (the same
  function, on the caller's thread);
* ``step`` runs one scheduler tick: drain the ingest thread, admit queued
  prompts (charging only blocks the prefix cache cannot supply), advance
  prefills by at most ``max_prefill_tokens_per_step`` tokens of
  block-aligned chunks, then one decode step (or one speculative verify)
  over every decode-ready slot;
* prefill chunks attend through ``paged_multiquery_attention`` and decode
  through ``paged_decode_attention``: the hand-written CUDA kernels on the
  card, their plain PyTorch versions on the CPU;
* by default decode fetches ``[B, V]`` logits and samples on the host
  with ``models.llama.sample_next_tokens`` (``capture_logits=True`` keeps
  the last row sampled from as ``Request.last_logits``);
* **device-resident decode** (``in_graph_sampling=True``, or
  ``decode_steps_per_sync=k > 1``): one window runs k decode iterations
  with greedy argmax on the device and per-row ``active``, ``budget`` and
  ``eos`` freezing, and fetches ``[B, k]`` int32 tokens once. On the card
  the window is captured once per engine into a ``torch.cuda.CUDAGraph``
  and replayed once per window (static input buffers filled by
  ``copy_``; block, offset and context lengths computed on the device);
  on the CPU the same function runs eagerly. A batch holding a
  ``do_sample`` request takes the per-step host path (one warning per
  engine);
* **speculative decoding** (``draft_model=``, ``spec_tokens=K``, greedy
  only): the draft's pools share the target's allocator and block tables,
  and every target prefill chunk is mirrored into them. A step catches the
  draft up to each request's committed tokens (ragged feeds left-padded by
  repeating the first; with ``fuse_draft_catchup`` one call per
  power-of-two feed bucket, a ``torch.cuda.CUDAGraph`` on the card), lets
  it propose K tokens by K - 1 single-token decodes with host argmax, then
  scores all K + 1 positions in ONE target pass whose attention is one
  ``paged_multiquery_attention`` call a layer (q ``[B, K+1, H, D]`` at
  ``q_start = positions``). The accept count (argmax, cumprod of matches)
  and the next token are computed on the device; only ``[2, B]`` int32 are
  fetched. Emission is bit-exact against sequential greedy decode;
  rejected rows are rolled back and lookahead blocks trimmed;
* ``stream`` yields tokens as they are produced, ``generate`` runs a batch
  to completion;
* **disaggregated prefill/decode**: a ``prefill_only=True`` engine runs
  prefills and samples each request's first token but never decodes (no
  decode window is built, no decode attention launched);
  ``export_kv_pages(rid)`` hands the request's pages to the host, and
  another engine's ``add_request_with_pages(prompt + [first token],
  pages)`` admits it decode-ready: the pages are written into its pool in
  place before the step decodes, and no prefill runs for it;
* **the host KV tier** (``kv_host_blocks > 0``): a preempted decode-ready
  request's pages and reclaimed prefix blocks spill to host memory on a
  transfer thread and revive by page import instead of re-prefill;
* **the prefix store** (``prefix_store_path``, with the prefix cache and
  the tier): the registered chains are saved on ``close`` (and every
  ``prefix_store_autosave_chains`` new chains) and loaded into the tier at
  boot, so a restarted engine revives them;
* ``reload_weights`` hot-swaps the weights from a checkpoint manager, a
  step directory, a serving artifact or a state-dict file, in place, so
  the captured graphs stay valid. The artifact functions at the end of
  this module save and load the reference's llama serving artifacts,
  plain or int8 per channel;
* **deadlines**: ``add_request(..., deadline=)`` (absolute
  ``time.time()``) raises :class:`~.errors.RequestTimeoutError` at once
  when it has passed, before any allocation; one that passes later is
  checked at the start of each ``step`` (a window boundary, never inside
  a captured graph), and the request is aborted through the scheduler
  (blocks freed, slot recycled) with a final ``StepOutput(rid, -1, True,
  "timeout")``;
* **tenants and QoS tiers**: ``tenant=`` and ``tier=`` (``latency`` |
  ``batch``) on both admission doors, ``configure_tenant`` (weight, a
  token-rate quota, host-tier and prefix-cache shares): weighted-fair
  admission, batch-tier yields through the host tier, per-tenant served
  tokens (``scheduler``);
* **integrity**: ``kv_page_checksums=True`` seals every page payload
  that reaches host memory with per-block CRC32s and verifies them where
  they come back (tier revivals, ``add_request_with_pages``, the prefix
  store's entries); ``weight_audit=True`` anchors the weight fingerprint
  at construction, and ``audit_weights`` compares the live weights with
  it (``integrity``).

Prefill chunks, the per-step decode and the verify run eagerly; pools are
written in place (see ``kv_cache``). Sharding plans are not ported, and
the constructor does not take ``plan``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import queue
import threading
import time
import warnings

import numpy as np
import torch

from ...core.device import resolve_device
from ...core.dtype import get_default_dtype
from ...framework.io import host_value
from ...models.llama import (LlamaForCausalLM, _rope_apply, _rotate,
                             greedy_tokens_in_graph, sample_next_tokens)
from ...nn.layer.layers import set_state_dict
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from ...ops.cuda import GraphLaunches
from .errors import EngineClosedError, RequestTimeoutError
from .integrity import (_M_PAGES_REJECTED, _M_PAGES_VERIFIED,
                        _M_WEIGHT_AUDIT_FAIL, verify_pages)
from .kv_cache import (HostKVTier, PagedKVCache, PrefixCache,
                       _G_HOST_BLOCKS, _H_REVIVE_MS, _H_SPILL_MS,
                       _M_HOST_EVICT, _M_REVIVE_BYTES, _M_REVIVES,
                       _M_SPILL_BYTES, _M_SPILLS, _nbytes, quantize_kv_rows)
from .paged_attention import (paged_decode_attention,
                              paged_multiquery_attention)
from .prefix_store import (PrefixStoreMismatch, _M_STORE_LOADED,
                           _M_STORE_REJECTED, _M_STORE_SAVED,
                           load_prefix_store, pool_geometry,
                           save_prefix_store, weights_fingerprint)
from .scheduler import (Request, SamplingParams, Scheduler, _M_ADMITTED,
                        _M_BATCH_YIELD, _M_COW, _M_EVICTIONS, _M_FINISHED,
                        _M_PREFIX_REUSED, _M_QUEUED_EXH, _M_TENANT_TOKENS,
                        _M_THROTTLED)

__all__ = ["LLMEngine", "StepOutput", "EngineClosedError",
           "RequestTimeoutError", "ARTIFACT_QMAX",
           "quantize_state_dict", "dequantize_state_dict",
           "save_llama_artifact", "is_llama_artifact",
           "is_quantized_artifact", "load_llama_state_dict",
           "load_llama_artifact"]

_H_TTFT = _obs_metrics.histogram(
    "serving_ttft_ms", "time to first token per request (submit -> first "
    "sampled token)", buckets=_obs_metrics.DEFAULT_MS_BUCKETS)
_H_ITL = _obs_metrics.histogram(
    "serving_itl_ms", "inter-token latency per decoded token",
    buckets=_obs_metrics.DEFAULT_MS_BUCKETS)
_M_TOKENS = _obs_metrics.counter(
    "serving_tokens_out_total", "tokens sampled across all requests")
_M_PREFILLS = _obs_metrics.counter(
    "serving_prefills_total", "prefill completions (incl. eviction "
    "re-prefills)")
_M_PREFILL_CHUNKS = _obs_metrics.counter(
    "serving_prefill_chunks_total",
    "block-aligned prefill chunk executions")
_M_SPEC_PROPOSED = _obs_metrics.counter(
    "serving_spec_proposed_total",
    "draft tokens proposed by the speculative decoder")
_M_SPEC_ACCEPTED = _obs_metrics.counter(
    "serving_spec_accepted_total",
    "draft tokens accepted by the verify step")
_G_SPEC_RATIO = _obs_metrics.gauge(
    "serving_spec_accept_ratio",
    "running accepted/proposed ratio of the speculative decoder")
_M_SPEC_VERIFY = _obs_metrics.counter(
    "serving_spec_verify_steps_total",
    "speculative verify steps (one paged multi-query attention per target "
    "layer each)")
_M_SPEC_DRAFT = _obs_metrics.counter(
    "serving_spec_draft_decode_steps_total",
    "single-token draft decode iterations run on the device (catch-up "
    "feeds with their padding, a fused bucket's warm-up, and proposals; "
    "one paged decode attention per draft layer each)")
_M_DECODE_STEPS = _obs_metrics.counter(
    "serving_decode_steps_total",
    "batched decode iterations run (one paged-decode attention per layer "
    "each; a window of k iterations counts k)")
_G_KV_UTIL = _obs_metrics.gauge(
    "serving_kv_block_utilization",
    "fraction of usable KV pool blocks in use after the last step")
_G_OCCUPANCY = _obs_metrics.gauge(
    "serving_decode_batch_occupancy",
    "fraction of decode slots occupied after the last step")
_M_DEADLINE = _obs_metrics.counter(
    "serving_deadline_expired_total",
    "requests aborted by the engine because their deadline expired "
    "(admission-time rejections raise before a request exists and are "
    "not counted here)")
_M_KV_SAVED = _obs_metrics.counter(
    "serving_kv_bytes_saved_total",
    "pool bytes saved by int8 KV quantization vs the same pool in the "
    "model dtype (counted once at engine construction)")
_G_QUANT_BLOCKS = _obs_metrics.gauge(
    "serving_quantized_kv_blocks_in_use",
    "int8-quantized KV pool blocks held by live requests after the last "
    "step")
_M_HOST_SYNCS = _obs_metrics.counter(
    "serving_host_syncs_total",
    "blocking device->host fetches made by the decode loop (logits per "
    "step, or tokens per window)")
_M_FETCH_BYTES = _obs_metrics.counter(
    "serving_decode_fetch_bytes_total",
    "bytes fetched device->host by the decode loop (B*V fp32 logits per "
    "step, or B*k int32 tokens per window)")

# every serving metric an engine instance owns: metrics(), reset_metrics()
# and close() iterate this one list
_SERVING_METRICS = (_M_ADMITTED, _M_EVICTIONS, _M_FINISHED, _M_QUEUED_EXH,
                    _M_PREFIX_REUSED, _M_COW, _M_PREFILLS, _M_PREFILL_CHUNKS,
                    _M_SPEC_PROPOSED, _M_SPEC_ACCEPTED, _G_SPEC_RATIO,
                    _M_SPEC_VERIFY, _M_SPEC_DRAFT, _M_DECODE_STEPS,
                    _M_TOKENS, _M_KV_SAVED, _H_TTFT, _H_ITL, _G_KV_UTIL,
                    _G_OCCUPANCY, _G_QUANT_BLOCKS, _M_HOST_SYNCS,
                    _M_FETCH_BYTES,
                    # the host tier and the prefix store (the reason-
                    # labeled _M_STORE_REJECTED is removed by label set)
                    _M_SPILLS, _M_REVIVES, _M_SPILL_BYTES, _M_REVIVE_BYTES,
                    _M_HOST_EVICT, _G_HOST_BLOCKS, _H_SPILL_MS,
                    _H_REVIVE_MS, _M_STORE_SAVED, _M_STORE_LOADED,
                    # deadlines and QoS (the tenant-labeled
                    # _M_TENANT_TOKENS is removed by label set too)
                    _M_DEADLINE, _M_THROTTLED, _M_BATCH_YIELD,
                    # integrity
                    _M_PAGES_VERIFIED, _M_PAGES_REJECTED,
                    _M_WEIGHT_AUDIT_FAIL)


@dataclasses.dataclass
class StepOutput:
    rid: int
    token: int
    finished: bool
    finish_reason: str | None = None


def _default_buckets(block_size, max_model_len):
    """Doubling ladder of block-aligned prefill lengths."""
    buckets, b = [], block_size
    while b < max_model_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_model_len)
    return buckets


def _check_deadline(deadline, what):
    """Raise :class:`RequestTimeoutError` when the absolute ``time.time()``
    ``deadline`` has already passed (admission, before any state moves)."""
    if deadline is not None and time.time() >= float(deadline):
        raise RequestTimeoutError(
            f"deadline {deadline} already expired at admission "
            f"(now={time.time():.3f}); {what} before any block allocation",
            deadline=deadline)


@dataclasses.dataclass
class _Staged:
    """A request's prompt prefix padded to its prefill bucket: ``ids``
    [1, bucket] int64 on the engine's device, and on the card the pinned
    host source (held for the request's life, so the copy never reads a
    freed buffer) and the event the copy recorded on the staging stream."""
    ids: torch.Tensor
    bucket: int
    length: int
    host: torch.Tensor | None = None
    ready: torch.cuda.Event | None = None


class _IngestThread:
    """Stages each submitted request (``stage_fn``) on its own thread, so
    admission never blocks decode on the host. Dies once, warns once, and
    hands every unstaged request back: the engine then stages them
    synchronously."""

    def __init__(self, stage_fn, name):
        self._stage = stage_fn
        self._q: queue.Queue = queue.Queue()
        self._ready: list = []
        self._cond = threading.Condition()
        self._pending = 0  # submitted but not yet drained
        self._dead = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=f"{name}-ingest")
        self._thread.start()

    def _worker(self):
        while True:
            req = self._q.get()
            if req is None:
                return
            try:
                self._stage(req)
            except BaseException as e:
                warnings.warn(
                    f"LLMEngine ingest thread died ({e!r}); degrading to "
                    "synchronous request staging", RuntimeWarning)
                with self._cond:
                    # _dead flips and the queue flushes under one lock hold:
                    # submit() checks _dead and enqueues under the same lock,
                    # so no request can land in _q after the flush
                    self._dead = True
                    self._ready.append(req)
                    while True:
                        try:
                            nxt = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if nxt is not None:
                            self._ready.append(nxt)
                    self._cond.notify_all()
                return
            with self._cond:
                self._ready.append(req)
                self._cond.notify_all()

    @property
    def pending(self):
        with self._cond:
            return self._pending

    def submit(self, req):
        with self._cond:
            self._pending += 1
            if self._dead:
                self._ready.append(req)
                self._cond.notify_all()
                return
            self._q.put(req)

    def drain(self, wait=False, timeout=1.0):
        """Requests handed back since the last drain (staged, or unstaged
        after the thread died). ``wait=True`` blocks up to ``timeout`` for
        at least one while some are in flight."""
        with self._cond:
            if wait and not self._ready and self._pending:
                self._cond.wait_for(lambda: self._ready, timeout=timeout)
            out, self._ready = self._ready, []
            self._pending -= len(out)
        return out

    def close(self):
        if not self._dead:
            self._q.put(None)
            self._thread.join(timeout=2.0)


class _GraphStep:
    """One engine step function ``fn(buf, tables)`` over a static int64
    device buffer ``buf`` (filled by ``copy_`` before each run) and the
    engine's persistent block-table buffer: a decode window, or the draft's
    catch-up for one feed bucket. On the CPU :meth:`run` calls ``fn``
    eagerly. On the card the first run warms ``fn`` up on a side stream on
    the real inputs (first launches set kernel attributes; cuBLAS takes its
    workspace for that stream; every pool write is one the replay repeats
    with the same values, and each row attends only up to its own
    position), then captures it into a ``torch.cuda.CUDAGraph``; every run
    replays it (``captures`` and ``replays`` count them). The capture
    launches nothing, so it records each kernel wrapper's launches
    (``ops.cuda.GraphLaunches``) and puts the counts back; each replay adds
    the recorded counts. A failed capture or replay raises: there is no
    eager fallback on the card."""

    def __init__(self, engine, fn, shape):
        self.engine, self.fn = engine, fn
        self.buf = torch.zeros(shape, dtype=torch.int64,
                               device=engine.device)
        self.graph = None
        self.out = None
        self.launches = GraphLaunches()
        self.captures = 0
        self.replays = 0

    @torch.inference_mode()
    def _capture(self):
        dev, tables = self.engine.device, self.engine._tables_dev
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(self.buf, tables)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the ingest thread's pinned allocations and copies
        # meanwhile must not invalidate this capture
        with self.launches.capture(), torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            out = self.fn(self.buf, tables)
        self.graph, self.out = graph, out
        self.captures += 1

    @torch.inference_mode()
    def run(self, host):
        """``fn`` on ``host`` (an int64 numpy array of ``buf``'s shape);
        returns its output tensor (on the card the graph's static
        output, valid until the next run)."""
        self.buf.copy_(torch.from_numpy(host))
        if self.engine.device.type != "cuda":
            return self.fn(self.buf, self.engine._tables_dev)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        self.launches.replayed()
        return self.out


class LLMEngine:
    """Continuous-batching paged-KV serving engine over a llama model.

    ``device`` (default ``cuda``; raises when CUDA is absent) is where the
    model, the pools and every step run; the model is moved there."""

    _instance_ids = itertools.count(1)

    def __init__(self, model, *, num_blocks=64, block_size=16,
                 max_batch_size=4, max_model_len=None, prefill_buckets=None,
                 max_prefills_per_step=1, ingest_async=True,
                 enable_prefix_cache=False, max_prefill_tokens_per_step=None,
                 draft_model=None, spec_tokens=2, kv_dtype=None,
                 prefill_only=False, kv_host_blocks=0,
                 prefix_store_path=None, prefix_store_autosave_chains=None,
                 fuse_draft_catchup=True, decode_steps_per_sync=1,
                 in_graph_sampling=None, capture_logits=False,
                 kv_page_checksums=False, weight_audit=False, device=None):
        for m in (model, draft_model):
            if m is None:
                continue
            if not isinstance(m, LlamaForCausalLM):
                raise TypeError(
                    f"LLMEngine serves LlamaForCausalLM models"
                    f"{' (draft_model too)' if m is draft_model else ''}; "
                    f"got {type(m).__name__}")
            if m.config.num_experts > 0:
                raise NotImplementedError(
                    "serving a Llama-MoE model is not ported yet (ROADMAP "
                    "Queue 1); the port trains it")
        # prefill-only mode: the disaggregated prefill worker prefills and
        # samples each request's FIRST token, but never decodes; requests
        # wait decode-ready for export_kv_pages and cancel
        self.prefill_only = bool(prefill_only)
        if self.prefill_only and draft_model is not None:
            raise ValueError("prefill_only engines never decode; a "
                             "draft_model would be dead weight")
        kv_host_blocks = int(kv_host_blocks)
        if kv_host_blocks < 0:
            raise ValueError("kv_host_blocks must be >= 0")
        if prefix_store_path is not None:
            if not enable_prefix_cache:
                raise ValueError(
                    "prefix_store_path requires enable_prefix_cache=True: "
                    "the store persists prefix hash chains")
            if kv_host_blocks == 0:
                raise ValueError(
                    "prefix_store_path requires kv_host_blocks > 0: "
                    "loaded entries land in the host tier until a "
                    "matching request revives them")
        if prefix_store_autosave_chains is not None:
            prefix_store_autosave_chains = int(prefix_store_autosave_chains)
            if prefix_store_autosave_chains < 1:
                raise ValueError(
                    "prefix_store_autosave_chains must be >= 1")
            if prefix_store_path is None:
                raise ValueError("prefix_store_autosave_chains without "
                                 "prefix_store_path saves nowhere")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self._was_training = model.training
        model.eval()
        self.config = model.config
        limit = self.config.max_position_embeddings
        self.block_size = int(block_size)
        requested_len = min(int(max_model_len or limit), limit)
        # prefill writes whole pages only: round DOWN to a block multiple
        self.max_model_len = (requested_len // self.block_size
                              ) * self.block_size
        if self.max_model_len == 0:
            raise ValueError(
                f"max_model_len={requested_len} is smaller than "
                f"block_size={self.block_size}; nothing fits in one page")
        if self.max_model_len != requested_len:
            warnings.warn(
                f"max_model_len={requested_len} is not a multiple of "
                f"block_size={self.block_size}; rounding down to "
                f"{self.max_model_len} so prefill stays page-aligned",
                RuntimeWarning)
        self.max_pages = self.max_model_len // self.block_size
        self.kv_dtype = kv_dtype
        self.cache = PagedKVCache(self.config, num_blocks, block_size,
                                  dtype=model.dtype, kv_dtype=kv_dtype,
                                  device=self.device)
        # seal every page payload that reaches host memory; the read-back
        # boundaries verify and degrade to re-prefill on a mismatch
        self.cache.page_checksums = bool(kv_page_checksums)
        self._kv_bytes_saved = self.cache.bytes_saved_vs_unquantized(
            self.config)
        self.prefix_cache = (PrefixCache(self.cache.allocator,
                                         self.block_size)
                             if enable_prefix_cache else None)
        if max_prefill_tokens_per_step is not None:
            max_prefill_tokens_per_step = int(max_prefill_tokens_per_step)
            if max_prefill_tokens_per_step < 1:
                raise ValueError("max_prefill_tokens_per_step must be >= 1")
        self.max_prefill_tokens_per_step = max_prefill_tokens_per_step
        self._name = f"llm_engine#{next(LLMEngine._instance_ids)}"
        # the host tier: preempted decode-ready requests and reclaimed
        # prefix blocks spill to it and revive by page import
        self.kv_tier = (HostKVTier(self.cache, kv_host_blocks,
                                   instance=self._name)
                        if kv_host_blocks > 0 else None)
        if self.kv_tier is not None and self.prefix_cache is not None:
            self.prefix_cache.on_spill = self.kv_tier.spill_blocks
        self._store_path = prefix_store_path
        self._store_autosave = prefix_store_autosave_chains
        self._store_fingerprint = None
        self._store_geometry = None
        self._store_saved_chains = -1  # force the first autosave crossing
        self.scheduler = Scheduler(self.cache.allocator, block_size,
                                   max_batch_size, max_prefills_per_step,
                                   instance=self._name,
                                   prefix_cache=self.prefix_cache,
                                   kv_tier=self.kv_tier)
        if self.cache.quantized:
            _M_KV_SAVED.inc(self._kv_bytes_saved, instance=self._name)
            _G_QUANT_BLOCKS.set(0, instance=self._name)
        self.max_batch_size = int(max_batch_size)
        buckets = prefill_buckets or _default_buckets(self.block_size,
                                                      self.max_model_len)
        self.prefill_buckets = sorted({
            min(-(-int(b) // self.block_size) * self.block_size,
                self.max_model_len)
            for b in buckets})
        # speculative decoding: the draft's pools share the target's
        # allocator and block tables; their shapes are the draft's own
        self.draft_model = draft_model
        self._spec_k = 0
        if draft_model is not None:
            if draft_model.config.vocab_size != self.config.vocab_size:
                raise ValueError(
                    "draft_model vocab_size "
                    f"{draft_model.config.vocab_size} != target "
                    f"{self.config.vocab_size}: verify compares token ids")
            if int(spec_tokens) < 1:
                raise ValueError("spec_tokens must be >= 1")
            self._spec_k = int(spec_tokens)
            self._draft_was_training = draft_model.training
            draft_model.to(self.device).eval()
            self.draft_cache = PagedKVCache(
                draft_model.config, num_blocks, block_size,
                dtype=draft_model.dtype, kv_dtype=kv_dtype,
                device=self.device, allocator=self.cache.allocator)
        k = int(decode_steps_per_sync)
        if k < 1:
            raise ValueError(f"decode_steps_per_sync must be >= 1, got {k}")
        if k > 1 and draft_model is not None:
            raise ValueError(
                "decode_steps_per_sync > 1 and speculative decoding are "
                "mutually exclusive: the verify window already batches "
                "device work and samples on the device")
        if in_graph_sampling is None:
            in_graph_sampling = k > 1
        in_graph_sampling = bool(in_graph_sampling)
        if k > 1 and not in_graph_sampling:
            raise ValueError(
                "decode_steps_per_sync > 1 requires in_graph_sampling: a "
                "fused window cannot round-trip logits to the host between "
                "its iterations")
        if in_graph_sampling and draft_model is not None:
            raise ValueError(
                "in_graph_sampling applies to the plain decode path; the "
                "speculative verify step already samples on the device")
        if capture_logits and in_graph_sampling:
            raise ValueError(
                "capture_logits=True requires host-side sampling "
                "(in_graph_sampling=False, decode_steps_per_sync=1): "
                "device-resident decode never fetches the logits rows")
        self._decode_window = k
        self._in_graph = in_graph_sampling
        self.capture_logits = bool(capture_logits)
        self._warned_do_sample = False
        # built on the first window (a CUDA graph on the card)
        self._window = None
        # fused draft catch-up: one _GraphStep per power-of-two feed bucket
        self._fuse_catchup = bool(fuse_draft_catchup)
        self._catchups = {}
        # the decode slots' block tables: one persistent device buffer
        # (the window's and the catch-up's graphs read it at every replay),
        # refilled when the scheduler's table version or the slots'
        # readiness moves
        self._tables_key = None
        self._tables_np = None
        self._tables_dev = torch.zeros(self.max_batch_size, self.max_pages,
                                       dtype=torch.int32, device=self.device)
        self._requests: dict[int, Request] = {}
        self._closed = False
        self.stats_extra = {"steps": 0, "prefills": 0, "decode_steps": 0,
                            "tokens_out": 0}
        # prompts are copied on their own stream, so a copy overlaps the
        # step running on the current one
        self._stage_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        if self.kv_tier is not None:
            # the tier's series read zero from boot, not from a first spill
            for m in (_M_SPILLS, _M_REVIVES, _M_SPILL_BYTES,
                      _M_REVIVE_BYTES, _M_HOST_EVICT):
                m.inc(0, instance=self._name)
            _G_HOST_BLOCKS.set(0, instance=self._name)
        if self.cache.page_checksums:
            _M_PAGES_VERIFIED.inc(0, instance=self._name)
            _M_PAGES_REJECTED.inc(0, instance=self._name)
        # the weight audit: the live fingerprint anchored now;
        # audit_weights() re-hashes and compares (a divergence means the
        # weights changed in place), reload_weights re-anchors
        self._weight_audit = bool(weight_audit)
        self._weight_audits = 0
        self._weight_audit_ref = (weights_fingerprint(model)
                                  if weight_audit else None)
        if weight_audit:
            _M_WEIGHT_AUDIT_FAIL.inc(0, instance=self._name)
        if self._store_path is not None:
            self._store_fingerprint = weights_fingerprint(model)
            self._store_geometry = pool_geometry(self.cache, self.config)
            self._load_prefix_store()
        self._ingest = (_IngestThread(self._stage_request, self._name)
                        if ingest_async else None)

    def _ensure_open(self):
        if self._closed:
            raise EngineClosedError(
                f"{self._name} is closed; create a new LLMEngine")

    # ------------------------------------------------------------------
    # the persistent prefix store
    # ------------------------------------------------------------------
    def _prefix_store_entries(self):
        """Chain entries worth persisting: every device-registered chain
        (gathered from the pool in one snapshot) plus every host-resident
        one, deduped by hash; the device copy wins."""
        chains = self.prefix_cache.registered_chains()
        entries = {}
        if chains:
            snap = self.cache.snapshot_request_pages(
                [b for _, b in chains], len(chains) * self.block_size)
            for i, (h, _) in enumerate(chains):
                entries[h] = snap.view(i).materialize()
        for h, pages in self.kv_tier.prefix_items():
            entries.setdefault(h, pages)
        return list(entries.items())

    def save_prefix_store(self):
        """Serialize the current prefix chains to ``prefix_store_path``
        (atomic publish: the previous store stays intact on any failure).
        Returns the number of entries written."""
        if self._store_path is None:
            raise ValueError(f"{self._name} has no prefix_store_path")
        entries = self._prefix_store_entries()
        save_prefix_store(self._store_path, entries,
                          fingerprint=self._store_fingerprint,
                          geometry=self._store_geometry,
                          instance=self._name)
        self._store_saved_chains = len(self.prefix_cache)
        return len(entries)

    def _load_prefix_store(self):
        """Import the on-disk store into the host tier; a mismatch (CRC,
        version, fingerprint, geometry) is a clean cold start. Returns the
        entries loaded."""
        try:
            entries = load_prefix_store(
                self._store_path, fingerprint=self._store_fingerprint,
                geometry=self._store_geometry, instance=self._name)
        except PrefixStoreMismatch as e:
            warnings.warn(
                f"{self._name}: rejecting prefix store "
                f"(reason={e.reason}): {e}; cold-starting the prefix "
                "cache", RuntimeWarning)
            return 0
        if entries is None:
            return 0
        return sum(bool(self.kv_tier.put_prefix_payload(h, pages))
                   for h, pages in entries)

    def _maybe_autosave_store(self):
        if self._store_path is None or self._store_autosave is None:
            return
        grown = len(self.prefix_cache) - max(self._store_saved_chains, 0)
        if (grown >= self._store_autosave
                or self._store_saved_chains < 0 and len(self.prefix_cache)):
            try:
                self.save_prefix_store()
            except OSError as e:
                # saving is an optimisation; serving never dies for it
                warnings.warn(f"{self._name}: prefix store autosave "
                              f"failed: {e}", RuntimeWarning)
                self._store_saved_chains = len(self.prefix_cache)

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------
    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds the largest "
                         f"prefill bucket {self.prefill_buckets[-1]}")

    def _stage_request(self, req):
        """Zero-pad the request's current prefix to its prefill bucket and
        start its copy to the device (on the ingest thread, or on the
        caller's for the synchronous path and re-prefills). On the card the
        source is pinned and the copy runs on the staging stream; its event
        is what ``_run_chunk`` waits on."""
        toks = req.tokens
        bucket = self._bucket_for(len(toks))
        cuda = self.device.type == "cuda"
        host = torch.zeros((1, bucket), dtype=torch.int64, pin_memory=cuda)
        host[0, :len(toks)] = torch.from_numpy(toks.astype(np.int64))
        if not cuda:
            req._staged = _Staged(host, bucket, len(toks))
            return
        with torch.cuda.stream(self._stage_stream):
            ids = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        req._staged = _Staged(ids, bucket, len(toks), host, ready)

    def add_request(self, prompt_ids, sampling: SamplingParams | None = None,
                    deadline=None, tenant=None, tier=None):
        """Enqueue a prompt; returns the request id. Never blocks on pool
        exhaustion — the request queues until blocks free up.

        ``deadline`` is an absolute ``time.time()`` deadline: one that has
        passed raises :class:`RequestTimeoutError` HERE, before the request
        is registered, staged or allocated anything; one that passes later
        aborts the request at the next step (``"timeout"``). ``tenant`` and
        ``tier`` attach a QoS identity; the defaults (``"default"``,
        latency) keep the exact FIFO behavior."""
        self._ensure_open()
        _check_deadline(deadline, "request rejected")
        req = Request(prompt_ids, sampling, deadline=deadline, tenant=tenant,
                      tier=tier)
        self._check_admissible(req)
        req.t_submit = req.t_queue_start = time.perf_counter_ns()
        self._requests[req.rid] = req
        if self._ingest is not None:
            self._ingest.submit(req)
        else:
            self._stage_request(req)
            self.scheduler.waiting.append(req)
        return req.rid

    def configure_tenant(self, name, *, weight=1.0, rate_tokens_per_s=None,
                         window_s=1.0, host_blocks=None, prefix_blocks=None):
        """Declare one tenant's QoS envelope: its fair-share ``weight`` and
        token-rate quota (the scheduler's), ``host_blocks`` capping its
        resident host-tier blocks (needs ``kv_host_blocks``) and
        ``prefix_blocks`` capping its published prefix blocks (needs
        ``enable_prefix_cache``; over the cap it demotes its own oldest to
        the tier). Unconfigured tenants serve at weight 1 with no quota;
        QoS stays off until the first call. Returns the tenant's state."""
        self._ensure_open()
        if host_blocks is not None and self.kv_tier is None:
            raise ValueError(
                "host_blocks needs a host tier; construct the engine with "
                "kv_host_blocks=")
        if prefix_blocks is not None and self.prefix_cache is None:
            raise ValueError(
                "prefix_blocks needs prefix sharing; construct the engine "
                "with enable_prefix_cache=True")
        st = self.scheduler.configure_tenant(
            name, weight=weight, rate_tokens_per_s=rate_tokens_per_s,
            window_s=window_s)
        if host_blocks is not None:
            self.kv_tier.set_tenant_share(name, host_blocks)
        if prefix_blocks is not None:
            self.prefix_cache.set_tenant_share(name, prefix_blocks)
        return st

    def _check_admissible(self, req):
        if self._spec_k and req.sampling.do_sample:
            raise ValueError(
                "speculative decoding is greedy-only (the verify step "
                "accepts by argmax identity); submit do_sample requests "
                "to an engine without a draft_model")
        total = len(req.prompt) + req.sampling.max_new_tokens
        cap = min(self.max_model_len,
                  (self.cache.num_blocks - 1) * self.block_size)
        # the verify window writes spec_k lookahead positions past the
        # final token: they must fit in the pool too
        if total + self._spec_k > cap:
            raise ValueError(
                f"request needs {total + self._spec_k} tokens (incl. "
                f"{self._spec_k} speculative lookahead) but the engine caps "
                f"at {cap} (max_model_len={self.max_model_len}, pool="
                f"{self.cache.num_blocks - 1} usable blocks x "
                f"{self.block_size})")
        # an evicted request re-prefills its full prefix (up to total-1)
        if total - 1 > self.prefill_buckets[-1]:
            raise ValueError(
                f"request may need a {total - 1}-token prefill (prompt + "
                f"re-prefill after eviction) but the largest prefill "
                f"bucket is {self.prefill_buckets[-1]}")
        if req.sampling.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    # -- disaggregated prefill/decode handoff ----------------------------
    def export_kv_pages(self, rid):
        """The pages of a decode-ready request (the prefill side of the
        handoff): its blocks holding the ``num_cached`` tokens written so
        far, as host arrays (``PagedKVCache.export_request_pages``)."""
        req = self._requests[rid]
        if req.finished or req.prefilling or req.num_cached < 1:
            raise ValueError(
                f"request {rid} is not decode-ready "
                f"(state={req.state}, prefilling={req.prefilling}); only "
                "a completed prefill exports pages")
        n_pages = self.cache.blocks_for_tokens(req.num_cached)
        return self.cache.export_request_pages(req.blocks[:n_pages],
                                               req.num_cached)

    def add_request_with_pages(self, prompt_ids, pages,
                               sampling: SamplingParams | None = None,
                               deadline=None, tenant=None, tier=None):
        """Admit a request whose prompt pages were computed elsewhere (the
        decode side of the handoff): ``prompt_ids`` is the original prompt
        PLUS the first token the prefill engine sampled, and ``pages`` (an
        ``export_kv_pages`` payload) covers every position but the last.
        Admission allocates blocks as usual (queueing on exhaustion); the
        next ``step`` writes the pages into them in place and the request
        decodes from that step on, with no prefill. The payload is
        validated here, before any request or allocator state moves, and a
        sealed one is verified: a CRC mismatch raises
        :class:`~.errors.KVIntegrityError`. ``deadline``, ``tenant`` and
        ``tier`` are :meth:`add_request`'s. Returns the id."""
        self._ensure_open()
        if self.prefill_only:
            raise ValueError("prefill_only engines never decode; "
                             "imported pages have nowhere to go")
        _check_deadline(deadline, "imported pages rejected")
        req = Request(prompt_ids, sampling, deadline=deadline,
                      tenant=tenant, tier=tier)
        covered = int(pages["covered"])
        if covered != len(req.prompt) - 1:
            raise ValueError(
                f"pages cover {covered} tokens but the prompt has "
                f"{len(req.prompt)} — the handoff prompt is the original "
                "prompt plus the prefill engine's first sampled token, "
                "so coverage must be len(prompt) - 1")
        n_payload = self.cache.validate_request_pages(pages)
        # the import boundary: a sealed payload verifies before admission
        # (unsealed ones pass)
        verify_pages(pages, instance=self._name, key=("import", req.rid))
        if n_payload != self.cache.blocks_for_tokens(covered):
            raise ValueError(
                f"pages hold {n_payload} blocks but cover {covered} "
                f"tokens ({self.cache.blocks_for_tokens(covered)} blocks "
                f"at block_size={self.block_size})")
        self._check_admissible(req)
        req.preloaded = pages
        req.t_submit = req.t_queue_start = time.perf_counter_ns()
        self._requests[req.rid] = req
        # nothing to prefill, so nothing to stage: straight to the queue
        self.scheduler.waiting.append(req)
        return req.rid

    def _adopt_preloaded(self, req):
        """Write a just-admitted preloaded request's pages (a handoff, or a
        revival from the host tier) into its blocks, in place, before this
        step decodes, and publish their identities to the prefix cache.
        One-shot: afterwards the request is one prefilled here (an
        eviction re-prefills through the staged path)."""
        pages, req.preloaded = req.preloaded, None
        revived, req.revived_from_tier = req.revived_from_tier, False
        t0 = time.perf_counter()
        self.cache.import_request_pages(req.blocks, pages)
        if revived:
            _M_REVIVES.inc(instance=self._name)
            _M_REVIVE_BYTES.inc(_nbytes(pages), instance=self._name)
            _H_REVIVE_MS.observe((time.perf_counter() - t0) * 1e3,
                                 instance=self._name)
        if self.prefix_cache is not None:
            # the imported pages are byte for byte local prefill's
            self.prefix_cache.register(req.tokens, req.blocks,
                                       req.num_cached, tenant=req.tenant)
        req.t_decode_start = time.perf_counter_ns()
        _obs_trace.add_complete(
            "request.import", getattr(req, "_t_admit", req.t_queue_start),
            req.t_decode_start, cat="request", tid=req.rid,
            args={"rid": req.rid, "engine": self._name,
                  "covered": req.num_cached})

    def _drain_revives(self):
        """Land this step's host-tier prefix hits (queued by the
        scheduler's ``match_with_tier``) in their allocated blocks, ONE
        batched import a request, and adopt their chain identities. A hash
        that left the tier between match and drain degrades to prefilling
        that span and everything after it (a chain with a hole is no
        chain)."""
        sched = self.scheduler
        if not sched.pending_revive:
            return
        spans = {}   # rid -> (req, [(block, h, pages), ...])
        dead = set()  # rids whose chain broke
        for req, block, h in sched.pending_revive:
            if req.finished:
                self.kv_tier.pop_prefix(h)
                continue
            idx = req.blocks.index(block)
            if req.rid in dead:
                req.num_cached = min(req.num_cached, idx * self.block_size)
                self.kv_tier.pop_prefix(h)  # unreachable behind the hole
                continue
            pages = self.kv_tier.pop_prefix(h)
            if pages is None:
                dead.add(req.rid)
                req.num_cached = min(req.num_cached, idx * self.block_size)
                continue
            spans.setdefault(req.rid, (req, []))[1].append((block, h,
                                                            pages))
        sched.pending_revive.clear()
        for req, parts in spans.values():
            t0 = time.perf_counter()
            merged = dict(parts[0][2])
            merged["covered"] = len(parts) * self.block_size
            if len(parts) > 1:
                for key in ("k", "v", "k_scale", "v_scale"):
                    if key in merged:
                        merged[key] = np.concatenate(
                            [p[key] for _, _, p in parts], axis=1)
            self.cache.import_request_pages([b for b, _, _ in parts],
                                            merged)
            for b, h, _ in parts:
                self.prefix_cache.adopt(b, h, tenant=req.tenant)
            _M_REVIVES.inc(len(parts), instance=self._name)
            _M_REVIVE_BYTES.inc(_nbytes(merged), instance=self._name)
            _H_REVIVE_MS.observe((time.perf_counter() - t0) * 1e3,
                                 instance=self._name)

    def request(self, rid):
        return self._requests[rid]

    def output_tokens(self, rid):
        """np prompt+generated tokens for a request."""
        r = self._requests[rid]
        return np.concatenate(
            [r.prompt, np.asarray(r.output_tokens, np.int32)])

    def release(self, rid):
        """Drop a FINISHED request's bookkeeping."""
        req = self._requests.get(rid)
        if req is None:
            return
        if not req.finished:
            raise ValueError(f"request {rid} is {req.state}; only "
                             "finished requests can be released")
        del self._requests[rid]

    def cancel(self, rid, reason="cancelled"):
        """Abort a live request (blocks freed, slot recycled). Returns True
        when a live request was aborted; no-op on unknown/finished ids."""
        req = self._requests.get(rid)
        if req is None or req.finished:
            return False
        self._abort(req, reason)
        return True

    def _abort(self, req, reason):
        """Abort through the scheduler: its blocks free and the table
        version moves, so the next window's ``_tables()`` refill drops the
        row before any replay could write through it."""
        self.scheduler.abort(req, reason)
        if reason == "timeout":
            _M_DEADLINE.inc(instance=self._name)

    def _expire_deadlines(self, outputs):
        """Abort every queued or running request whose deadline has passed
        (once a step, BEFORE admission and decode, so an expired request
        never takes blocks it is about to release). Each expiry appends a
        final ``StepOutput(rid, -1, True, "timeout")``."""
        now = time.time()
        for req in (list(self.scheduler.waiting)
                    + list(self.scheduler.running)):
            if req.deadline is not None and now >= req.deadline:
                self._abort(req, "timeout")
                outputs.append(StepOutput(req.rid, -1, True, "timeout"))

    def has_work(self):
        if self._closed:
            return False
        if self._ingest is not None and self._ingest.pending:
            return True
        return self.scheduler.has_work()

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _write_rows(self, cache, layer, index, k, v):
        """Write K/V rows into ``cache``'s layer ``layer`` pools at
        ``index`` (a tuple of index tensors for ``index_put_``), quantizing
        on int8 pools. In place."""
        if cache.quantized:
            qk, sk = quantize_kv_rows(k)
            qv, sv = quantize_kv_rows(v)
            cache.k[layer].index_put_(index, qk)
            cache.v[layer].index_put_(index, qv)
            cache.k_scale[layer].index_put_(index, sk)
            cache.v_scale[layer].index_put_(index, sv)
        else:
            cache.k[layer].index_put_(index, k.to(cache.k[layer].dtype))
            cache.v[layer].index_put_(index, v.to(cache.v[layer].dtype))

    @staticmethod
    def _pool_args(cache, layer):
        if cache.quantized:
            return (cache.k[layer], cache.v[layer], cache.k_scale[layer],
                    cache.v_scale[layer])
        return cache.k[layer], cache.v[layer], None, None

    def _draft(self, draft):
        """(model, cache) of the target, or of the draft."""
        if draft:
            return self.draft_model, self.draft_cache
        return self.model, self.cache

    @torch.inference_mode()
    def _chunk_forward(self, ids, start, upto, tables_row, draft=False):
        """One prefill chunk of the target (or the draft): ``ids`` [1, C]
        at block-aligned offset ``start``; queries attend causally over
        pool pages [0, upto) via paged multi-query attention. Writes the
        chunk's K/V pages (padding pages go to the null block through zero
        table entries). Returns logits [1, V] at position ``upto - 1``."""
        model, cache = self._draft(draft)
        llama = model.llama
        bs, P = self.block_size, self.max_pages
        C = ids.shape[1]
        pages, page0 = C // bs, start // bs
        meta = np.zeros(P + 2, np.int32)
        meta[:P] = tables_row
        meta[P], meta[P + 1] = upto, start
        meta = torch.from_numpy(meta).to(self.device)
        tables, lens, starts = meta[:P].view(1, P), meta[P:P + 1], \
            meta[P + 1:P + 2]
        page_blocks = meta[page0:page0 + pages].long()
        cos = llama.rope_cos[start:start + C]
        sin = llama.rope_sin[start:start + C]
        scale = 1.0 / math.sqrt(model.config.head_dim)
        x = llama.embed_tokens(ids)
        for li, layer in enumerate(llama.layers):
            attn = layer.self_attn
            q, k, v = attn.project(layer.input_layernorm(x))
            q = _rope_apply(q, cos, sin)
            k = _rope_apply(k, cos, sin)
            geo = (pages, bs, attn.num_kv_heads, attn.head_dim)
            self._write_rows(cache, li, (page_blocks,), k.reshape(geo),
                             v.reshape(geo))
            kp, vp, ks, vs = self._pool_args(cache, li)
            out = paged_multiquery_attention(
                q, kp, vp, tables, lens, starts, scale=scale,
                k_scale=ks, v_scale=vs)
            x = x + attn.o_proj(out.reshape(1, C, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        h = llama.norm(x)
        return model.head(h[:, upto - 1 - start])

    @torch.inference_mode()
    def _decode_forward(self, ids, positions, tables, tables_np,
                        draft=False):
        """One token for every decode slot of the target (or the draft):
        ``ids``/``positions`` host int arrays [B]. Each row writes its K/V
        at its position (empty and mid-prefill slots: position 0 of the
        null block) and attends over ``positions + 1`` tokens. Returns
        logits [B, V]."""
        bs = self.block_size
        B = len(ids)
        meta = np.stack([ids, positions,
                         tables_np[np.arange(B), positions // bs],
                         positions % bs, positions + 1]).astype(np.int32)
        meta = torch.from_numpy(meta).to(self.device)
        ids_d, pos_d, blk_d, off_d = (meta[i].long() for i in range(4))
        return self._decode_layers(ids_d, pos_d, blk_d, off_d, meta[4],
                                   tables, draft)

    def _decode_layers(self, ids, pos, blk, off, lens, tables, draft=False):
        """The decode body on device metadata: ids, positions, write block
        and offset (int64 [B]), context lengths (int32 [B]) and the block
        tables [B, P]. Returns logits [B, V]."""
        model, cache = self._draft(draft)
        llama = model.llama
        B = ids.shape[0]
        c = llama.rope_cos[pos][:, None, None, :]
        s = llama.rope_sin[pos][:, None, None, :]
        scale = 1.0 / math.sqrt(model.config.head_dim)
        x = llama.embed_tokens(ids[:, None])
        for li, layer in enumerate(llama.layers):
            attn = layer.self_attn
            q, k, v = attn.project(layer.input_layernorm(x))
            q = _rotate(q, c.to(q.dtype), s.to(q.dtype))
            k = _rotate(k, c.to(k.dtype), s.to(k.dtype))
            self._write_rows(cache, li, (blk, off), k[:, 0], v[:, 0])
            kp, vp, ks, vs = self._pool_args(cache, li)
            out = paged_decode_attention(q, kp, vp, tables, lens,
                                         scale=scale, k_scale=ks,
                                         v_scale=vs)
            x = x + attn.o_proj(out.reshape(B, 1, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        h = llama.norm(x)
        return model.head(h[:, -1])

    def _window_forward(self, meta, tables):
        """The decode window (no host work inside): ``meta`` int64 [5, B]
        holds each row's input id, position, active flag, token budget and
        eos id (-1: none); ``tables`` [B, P]. Runs ``decode_steps_per_sync``
        iterations: the decode body with block, offset and context length
        computed on the device (a frozen row writes to position 0 of the
        null block), greedy argmax, then each active row advances its
        position and input id and freezes after its eos id or when its
        budget is spent; a frozen row repeats its input id. Returns the
        tokens [B, k] int32."""
        bs = self.block_size
        ids, pos, budget, eos = meta[0], meta[1], meta[3], meta[4]
        active = meta[2] != 0
        rows = torch.arange(ids.shape[0], device=ids.device)
        zero = torch.zeros((), dtype=torch.int64, device=ids.device)
        toks = []
        for _ in range(self._decode_window):
            blk = torch.where(active, tables[rows, pos // bs].long(), zero)
            off = torch.where(active, pos % bs, zero)
            logits = self._decode_layers(ids, pos, blk, off,
                                         (pos + 1).to(torch.int32), tables)
            nxt = greedy_tokens_in_graph(logits).long()
            emitted = torch.where(active, nxt, ids)
            toks.append(emitted)
            stepped = active.long()
            pos = pos + stepped
            budget = budget - stepped
            active = active & ~((emitted == eos) | (budget <= 0))
            ids = emitted
        return torch.stack(toks, dim=1).to(torch.int32)

    def _catchup_forward(self, feed, tables):
        """The draft's fused catch-up (no host work inside): ``feed`` int64
        [2, B, F] holds each row's F (token, position) feeds, left-padded by
        repeating the first (rewriting a row with the same token at the
        same position changes nothing); ``tables`` [B, P]. Runs F
        single-token draft decodes with block, offset and context length
        computed on the device, the same body as the unfused loop. Returns
        the last feed's logits [B, V]."""
        bs = self.block_size
        ids, pos = feed[0], feed[1]
        rows = torch.arange(ids.shape[0], device=ids.device)
        for t in range(ids.shape[1]):
            p = pos[:, t]
            logits = self._decode_layers(
                ids[:, t], p, tables[rows, p // bs].long(), p % bs,
                (p + 1).to(torch.int32), tables, draft=True)
        return logits

    @torch.inference_mode()
    def _verify_forward(self, meta, tables):
        """The speculative verify over the target: ``meta`` int64
        [B, 2K + 2] holds each row's K + 1 ids (its last committed token,
        then the K drafts), its position and the K drafts again; ``tables``
        [B, P]. One pass scores positions ``pos .. pos + K``: rope at
        ``pos + t``, the K + 1 rows written with one indexed write a layer,
        one ``paged_multiquery_attention`` a layer (``q_start = pos``,
        ``context_lens = pos + K + 1``). On the device: the target's
        argmax, the accept count (1s until the first mismatch with the
        drafts) and the next token (the argmax at the first rejected
        position, or the bonus one). Returns int32 [2, B]: counts, next."""
        model, cache = self.model, self.cache
        llama = model.llama
        K = self._spec_k
        T = K + 1
        ids, pos, drafts = meta[:, :T], meta[:, T], meta[:, T + 1:]
        B = ids.shape[0]
        bs = self.block_size
        grid = pos[:, None] + torch.arange(T, device=ids.device)[None]
        rows = torch.arange(B, device=ids.device)[:, None]
        blk = tables[rows, grid // bs].long().reshape(-1)
        off = (grid % bs).reshape(-1)
        lens = (pos + T).to(torch.int32)
        starts = pos.to(torch.int32)
        c = llama.rope_cos[grid][:, :, None, :]
        s = llama.rope_sin[grid][:, :, None, :]
        scale = 1.0 / math.sqrt(model.config.head_dim)
        x = llama.embed_tokens(ids)
        for li, layer in enumerate(llama.layers):
            attn = layer.self_attn
            q, k, v = attn.project(layer.input_layernorm(x))
            q = _rotate(q, c.to(q.dtype), s.to(q.dtype))
            k = _rotate(k, c.to(k.dtype), s.to(k.dtype))
            geo = (B * T, attn.num_kv_heads, attn.head_dim)
            self._write_rows(cache, li, (blk, off), k.reshape(geo),
                             v.reshape(geo))
            kp, vp, ks, vs = self._pool_args(cache, li)
            out = paged_multiquery_attention(
                q, kp, vp, tables, lens, starts, scale=scale, k_scale=ks,
                v_scale=vs)
            x = x + attn.o_proj(out.reshape(B, T, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        tgt = torch.argmax(model.head(llama.norm(x)), dim=-1)   # [B, T]
        counts = torch.cumprod((tgt[:, :K] == drafts).long(), dim=1).sum(1)
        nxt = tgt.gather(1, counts[:, None])[:, 0]
        return torch.stack([counts, nxt]).to(torch.int32)

    @staticmethod
    def _fetch(t):
        return t.float().cpu().numpy()

    # ------------------------------------------------------------------
    # the scheduler tick
    # ------------------------------------------------------------------
    def _tables(self):
        """(device, host) block tables for the decode slots. Empty and
        mid-prefill slots map to the null block: the decode step writes a
        K/V row for EVERY slot, and an inactive slot's write must not land
        in a prefilling request's pages."""
        sched = self.scheduler
        mask = tuple(r is not None and not r.prefilling
                     for r in sched.slots)
        key = (sched.version, mask)
        if key != self._tables_key:
            lists = [(r.blocks if ok else [])
                     for ok, r in zip(mask, sched.slots)]
            tbl = np.zeros((len(lists), self.max_pages), np.int32)
            for i, blocks in enumerate(lists):
                tbl[i, :len(blocks)] = blocks
            self._tables_np = tbl
            self._tables_dev.copy_(torch.from_numpy(tbl))
            self._tables_key = key
        return self._tables_dev, self._tables_np

    def _drain_cow(self):
        for src, dst in self.scheduler.pending_cow:
            self.cache.copy_block(src, dst)
            if self.draft_model is not None:
                self.draft_cache.copy_block(src, dst)
        self.scheduler.pending_cow.clear()

    def _run_chunk(self, req, start, take, outputs):
        """One block-aligned prefill chunk of ``take`` tokens at ``start``;
        on the final chunk, sample the first output token."""
        staged = getattr(req, "_staged", None)
        if staged is None or staged.length != req.prefill_upto:
            self._stage_request(req)  # re-prefill after eviction
            staged = req._staged
        if staged.ready is not None:
            # the copy ran on the staging stream: order this stream after
            # it, and keep the ids' memory from reuse while this stream
            # still reads them
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.ready)
            staged.ids.record_stream(cur)
        ids_dev, bucket = staged.ids, staged.bucket
        # chunk length is always a ladder rung: the smallest one covering
        # ``take`` that fits the staged room, else the largest that fits
        # (the remainder continues next step)
        room = bucket - start
        C = None
        for b in self.prefill_buckets:
            if take <= b <= room:
                C = b
                break
        if C is None:
            C = max(b for b in self.prefill_buckets if b <= room)
            take = min(take, C)
        tables_row = np.zeros(self.max_pages, np.int32)
        nblk = min(len(req.blocks), self.max_pages)
        tables_row[:nblk] = req.blocks[:nblk]
        ids_chunk = ids_dev[:, start:start + C]
        logits = self._chunk_forward(ids_chunk, start, start + take,
                                     tables_row)
        if self.draft_model is not None:
            # mirror every target chunk into the draft pools: the draft
            # proposes over the same block tables, so it must hold the
            # same prefix
            self._chunk_forward(ids_chunk, start, start + take, tables_row,
                                draft=True)
            req.draft_cached = start + take
        req.num_cached = start + take
        _M_PREFILL_CHUNKS.inc(instance=self._name)
        # QoS: prefill work charges the tenant as it is served, by chunk
        self.scheduler.note_served(req, take)
        if self.prefix_cache is not None:
            self.prefix_cache.register(req.tokens, req.blocks,
                                       req.num_cached, tenant=req.tenant)
        if req.num_cached >= req.prefill_upto:
            req.prefilling = False
            self.stats_extra["prefills"] += 1
            _M_PREFILLS.inc(instance=self._name)
            outputs.extend(self._emit(req, self._fetch(logits)[0]))
            req.t_decode_start = time.perf_counter_ns()
            _obs_trace.add_complete(
                "request.prefill",
                getattr(req, "_t_admit", req.t_queue_start),
                req.t_decode_start, cat="request", tid=req.rid,
                args={"rid": req.rid, "engine": self._name,
                      "bucket": bucket, "true_len": req.prefill_upto})

    def step(self):
        """One engine tick: drain the ingest thread, admit, advance chunked
        prefills under the token budget, one decode (or speculative verify)
        for all decode-ready slots. Returns the ``StepOutput`` tokens
        produced."""
        self._ensure_open()
        sched = self.scheduler
        if self._ingest is not None:
            # block (briefly) only when the scheduler would otherwise spin
            # empty while requests are in flight on the ingest thread
            for req in self._ingest.drain(wait=not sched.has_work()):
                # cancelled while still on the ingest thread
                if req.finished:
                    continue
                if not hasattr(req, "_staged"):  # the ingest thread died
                    self._stage_request(req)
                sched.waiting.append(req)
        outputs = []
        # before admission and decode: an expired request is never
        # admitted or decoded once more, and its blocks and slot serve
        # this very step's admissions
        self._expire_deadlines(outputs)
        if not sched.has_work():
            return outputs
        self.stats_extra["steps"] += 1
        for _, req in sched.pick_prefills():
            req._t_admit = time.perf_counter_ns()
            _obs_trace.add_complete(
                "request.queued", req.t_queue_start, req._t_admit,
                cat="request", tid=req.rid,
                args={"rid": req.rid, "engine": self._name,
                      "evictions": req.evictions})
            if req.preloaded is not None:
                # a handoff or a tier revival: its pages land in the fresh
                # blocks before this step decodes
                self._adopt_preloaded(req)
        self._drain_revives()
        for req, start, take in sched.prefill_work(
                self.max_prefill_tokens_per_step):
            self._run_chunk(req, start, take, outputs)
        if self.prefill_only:
            # decode-ready requests wait for export_kv_pages + cancel
            self._update_gauges()
            return outputs

        sched.ensure_decode_room(
            extra=self._spec_k,
            extra_for=(self._window_extra if self._decode_window > 1
                       else None))
        self._drain_cow()
        ready = [(i, r) for i, r in enumerate(sched.slots)
                 if r is not None and not r.prefilling]
        sampled = any(r.sampling.do_sample for _, r in ready)
        if ready and self._spec_k:
            self._spec_step(ready, outputs)
        elif ready and self._in_graph and not sampled:
            self._window_step(ready, outputs)
        elif ready:
            if self._in_graph and not self._warned_do_sample:
                self._warned_do_sample = True
                warnings.warn(
                    f"{self._name}: do_sample=True requests keep the host "
                    "sampling path (per-request numpy RNG); device-resident "
                    "decode degrades to per-step host sampling while any is "
                    "in the batch", RuntimeWarning)
            B = self.max_batch_size
            ids = np.zeros(B, np.int64)
            positions = np.zeros(B, np.int64)
            for i, req in ready:
                ids[i] = req.last_token
                positions[i] = req.num_cached
            tables, tables_np = self._tables()
            logits = self._fetch(self._decode_forward(ids, positions,
                                                      tables, tables_np))
            self.stats_extra["decode_steps"] += 1
            _M_DECODE_STEPS.inc(instance=self._name)
            _M_HOST_SYNCS.inc(instance=self._name)
            _M_FETCH_BYTES.inc(logits.nbytes, instance=self._name)
            for i, req in ready:
                req.num_cached += 1
                outputs.extend(self._emit(req, logits[i]))
        self._maybe_autosave_store()
        self._update_gauges()
        return outputs

    def _window_extra(self, req):
        """Lookahead positions ``ensure_decode_room`` reserves for ``req``
        before a window: it writes at most ``min(k, tokens remaining)``
        positions, the first of which the base room check covers."""
        remaining = req.sampling.max_new_tokens - len(req.output_tokens)
        return max(min(self._decode_window, remaining) - 1, 0)

    def _window_step(self, ready, outputs):
        """Device-resident decode for every decode-ready slot: one window
        (one graph replay on the card), one ``[B, k]`` int32 token fetch,
        then one emission pass per request. Greedy only: ``step`` routes a
        batch holding a ``do_sample`` request to the per-step host path."""
        B, k = self.max_batch_size, self._decode_window
        meta = np.zeros((5, B), np.int64)
        meta[4] = -1
        for i, req in ready:
            s = req.sampling
            meta[0, i] = req.last_token
            meta[1, i] = req.num_cached
            meta[2, i] = 1
            meta[3, i] = min(k, s.max_new_tokens - len(req.output_tokens))
            if s.eos_token_id is not None:
                meta[4, i] = s.eos_token_id
        self._tables()  # refreshes the buffer the window reads
        if self._window is None:
            self._window = _GraphStep(self, self._window_forward, (5, B))
        toks = self._window.run(meta).cpu().numpy()
        self.stats_extra["decode_steps"] += k
        _M_DECODE_STEPS.inc(k, instance=self._name)
        _M_HOST_SYNCS.inc(instance=self._name)
        _M_FETCH_BYTES.inc(toks.nbytes, instance=self._name)
        for i, req in ready:
            self._emit_window(req, toks[i], outputs)

    def _emit_window(self, req, toks, outputs):
        """Commit one window's tokens for ``req`` (its ``[k]`` row of the
        fetch) in one pass: the accept scan mirrors the device's freezing
        (stop after the eos id or at ``max_new_tokens``), and the one clock
        read at the window's end is spread over the m accepted tokens as m
        ITL observations of dt / m (an imported request's first window
        observes its TTFT only). Appends StepOutputs to ``outputs``."""
        s = req.sampling
        accepted = []
        for t in toks:
            accepted.append(int(t))
            if len(req.output_tokens) + len(accepted) >= s.max_new_tokens:
                break
            if s.eos_token_id is not None and int(t) == s.eos_token_id:
                break
        m = len(accepted)
        req.output_tokens.extend(accepted)
        req.num_cached += m
        self.stats_extra["tokens_out"] += m
        # QoS: one charge of m tokens at the window boundary
        self.scheduler.note_served(req, m)
        now = time.perf_counter_ns()
        _M_TOKENS.inc(m, instance=self._name)
        spread = m
        if req.t_first_token is None:
            # a first emission in decode: an imported request (a handoff or
            # a tier revival); TTFT takes the window, with no ITL before it
            req.t_first_token = now
            if req.t_submit is not None:
                _H_TTFT.observe((now - req.t_submit) / 1e6,
                                instance=self._name)
            spread = m - 1
        if spread > 0 and req.t_last_token is not None:
            dt_ms = (now - req.t_last_token) / 1e6 / spread
            for _ in range(spread):
                _H_ITL.observe(dt_ms, instance=self._name)
        req.t_last_token = now
        done = self._finish_if_done(req, now)
        for j, tok in enumerate(accepted):
            last = done and j == m - 1
            outputs.append(StepOutput(req.rid, tok, last,
                                      req.finish_reason() if last else None))

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------
    def _draft_propose(self, ready, tables):
        """Catch the draft pools up to every ready request's committed
        tokens, then propose ``spec_k`` greedy draft tokens each; ``tables``
        is ``_tables()``'s (device, host) pair. Returns drafts int64
        [B, K] (rows of other slots are zeros)."""
        tables_dev, tables_np = tables
        B, K = self.max_batch_size, self._spec_k
        feeds = {}
        F = 1
        for _, r in ready:
            lo = min(r.draft_cached, r.num_tokens - 1)
            feeds[r.rid] = list(range(lo, r.num_tokens))
            F = max(F, len(feeds[r.rid]))
        fused = self._fuse_catchup and F > 1
        if fused:
            # one call per power-of-two bucket (one graph each on the card)
            F = 1 << (F - 1).bit_length()
        # ragged rows left-pad by repeating their first feed
        feed = np.zeros((2, B, F), np.int64)
        for i, r in ready:
            fs = feeds[r.rid]
            fs = [fs[0]] * (F - len(fs)) + fs
            feed[0, i] = r.tokens[fs]
            feed[1, i] = fs
        if fused:
            step = self._catchups.get(F)
            if step is None:
                step = self._catchups[F] = _GraphStep(
                    self, self._catchup_forward, (2, B, F))
            # the first run on the card also runs the warm-up
            ran = F * (2 if self.device.type == "cuda"
                       and step.graph is None else 1)
            logits = step.run(feed)
        else:
            ran = F
            for t in range(F):
                logits = self._decode_forward(feed[0, :, t], feed[1, :, t],
                                              tables_dev, tables_np,
                                              draft=True)
        prev = self._fetch(logits)
        _M_HOST_SYNCS.inc(instance=self._name)
        _M_FETCH_BYTES.inc(prev.nbytes, instance=self._name)
        drafts = np.zeros((B, K), np.int64)
        for kstep in range(K):
            for i, _ in ready:
                drafts[i, kstep] = int(prev[i].argmax())
            if kstep + 1 < K:
                ids = np.zeros(B, np.int64)
                pos = np.zeros(B, np.int64)
                for i, r in ready:
                    ids[i] = drafts[i, kstep]
                    pos[i] = r.num_tokens + kstep
                prev = self._fetch(self._decode_forward(
                    ids, pos, tables_dev, tables_np, draft=True))
                ran += 1
                _M_HOST_SYNCS.inc(instance=self._name)
                _M_FETCH_BYTES.inc(prev.nbytes, instance=self._name)
        _M_SPEC_DRAFT.inc(ran, instance=self._name)
        for _, r in ready:
            # positions 0 .. num_tokens + K - 2 now hold draft K/V
            r.draft_cached = r.num_tokens + K - 1
        return drafts

    def _spec_step(self, ready, outputs):
        """One speculative step for the decode-ready slots: the draft
        proposes K tokens, one verify scores K + 1 positions, accepted
        tokens are emitted in order (bit-exact against sequential greedy
        decode), and each row is rolled back: cached lengths rewound to the
        kept tokens (rejected rows stay in the pool, masked by the context
        lengths until overwritten) and lookahead blocks trimmed."""
        B, K = self.max_batch_size, self._spec_k
        tables = self._tables()
        drafts = self._draft_propose(ready, tables)
        _M_SPEC_PROPOSED.inc(K * len(ready), instance=self._name)
        meta = np.zeros((B, 2 * K + 2), np.int64)
        n_old = {}
        for i, r in ready:
            meta[i, 0] = r.last_token
            meta[i, 1:K + 1] = drafts[i]
            meta[i, K + 1] = r.num_cached
            meta[i, K + 2:] = drafts[i]
            n_old[r.rid] = r.num_tokens
        res = self._verify_forward(torch.from_numpy(meta).to(self.device),
                                   tables[0]).cpu().numpy()
        counts, nxt = res
        _M_SPEC_VERIFY.inc(instance=self._name)
        _M_HOST_SYNCS.inc(instance=self._name)
        _M_FETCH_BYTES.inc(res.nbytes, instance=self._name)
        accepted = 0
        for i, r in ready:
            a = int(counts[i])
            emitted = [int(drafts[i, j]) for j in range(a)] + [int(nxt[i])]
            m = 0
            for tok in emitted:
                outputs.extend(self._emit_token(r, tok))
                m += 1
                if r.finished:
                    break
            accepted += min(a, m)
            if r.finished:
                continue
            r.num_cached = r.num_tokens - 1
            r.draft_cached = min(n_old[r.rid] + min(a, m, K - 1),
                                 r.num_tokens)
            self.scheduler.trim_to_capacity(r, extra=K)
        _M_SPEC_ACCEPTED.inc(accepted, instance=self._name)
        prop = _M_SPEC_PROPOSED.value(instance=self._name)
        if prop:
            _G_SPEC_RATIO.set(
                _M_SPEC_ACCEPTED.value(instance=self._name) / prop,
                instance=self._name)

    def _update_gauges(self):
        usable = max(self.cache.num_blocks - 1, 1)
        _G_KV_UTIL.set(1.0 - self.cache.allocator.num_free / usable,
                       instance=self._name)
        _G_OCCUPANCY.set(len(self.scheduler.running) / self.max_batch_size,
                         instance=self._name)
        if self.cache.quantized:
            _G_QUANT_BLOCKS.set(usable - self.cache.allocator.num_free,
                                instance=self._name)

    def _emit(self, req, row):
        """Sample the next token for ``req`` from logits ``row`` [V] on the
        host and commit it (keeping ``row`` as ``req.last_logits`` with
        ``capture_logits``). Returns [StepOutput]."""
        s = req.sampling
        if self.capture_logits:
            # [V] fp32, overwritten per emission, dropped with the request
            req.last_logits = np.asarray(row)
        tok = int(sample_next_tokens(
            row[None], do_sample=s.do_sample, temperature=s.temperature,
            top_k=s.top_k, top_p=s.top_p, rng=req._rng)[0])
        return self._emit_token(req, tok)

    def _emit_token(self, req, tok):
        """Commit one chosen token (sampled on the host, or accepted by the
        speculative verify): append it, observe TTFT/ITL, finish the
        request when it ends. Returns [StepOutput]."""
        tok = int(tok)
        req.output_tokens.append(tok)
        self.stats_extra["tokens_out"] += 1
        self.scheduler.note_served(req, 1)
        now = time.perf_counter_ns()
        _M_TOKENS.inc(instance=self._name)
        if req.t_first_token is None:
            req.t_first_token = now
            if req.t_submit is not None:
                _H_TTFT.observe((now - req.t_submit) / 1e6,
                                instance=self._name)
        elif req.t_last_token is not None:
            _H_ITL.observe((now - req.t_last_token) / 1e6,
                           instance=self._name)
        req.t_last_token = now
        done = self._finish_if_done(req, now)
        return [StepOutput(req.rid, tok, done,
                           req.finish_reason() if done else None)]

    def _finish_if_done(self, req, now):
        """Finish ``req`` (blocks freed, decode span traced) when its last
        token ends it; returns whether it did."""
        done = req.should_finish()
        if done:
            self.scheduler.finish(req)
            start = req.t_decode_start or req.t_first_token or now
            _obs_trace.add_complete(
                "request.decode", start, now, cat="request", tid=req.rid,
                args={"rid": req.rid, "engine": self._name,
                      "tokens": len(req.output_tokens),
                      "finish_reason": req.finish_reason()})
        return done

    def stream(self):
        """Yield ``StepOutput`` s until the engine drains."""
        self._ensure_open()
        while self.has_work():
            yield from self.step()

    def generate(self, prompts, sampling: SamplingParams | None = None,
                 deadline=None):
        """Submit every prompt, run to completion, return the full token
        arrays (prompt + generated) in order. With ``deadline``, a request
        it kills makes the call raise :class:`RequestTimeoutError` once the
        batch drains (partial outputs are ``stream()``'s). A failed
        admission cancels and releases the requests already admitted, so
        none is left to decode on a later ``stream()``."""
        self._ensure_open()
        rids = []
        try:
            for p in prompts:
                rids.append(self.add_request(
                    p, dataclasses.replace(sampling) if sampling else None,
                    deadline=deadline))
        except BaseException:
            for r in rids:
                self.cancel(r)
                self.release(r)
            raise
        for _ in self.stream():
            pass
        timed_out = [r for r in rids
                     if self._requests[r].abort_reason == "timeout"]
        if timed_out:
            for r in rids:
                self.release(r)
            raise RequestTimeoutError(
                f"{len(timed_out)} of {len(rids)} requests hit the deadline "
                f"mid-generation: rids {timed_out}", rid=timed_out[0],
                deadline=deadline)
        outs = [self.output_tokens(r) for r in rids]
        for r in rids:
            self.release(r)
        return outs

    def reload_weights(self, source):
        """Hot-swap the target model's weights, writing in place: from a
        ``CheckpointManager`` (its ``latest_healthy_step()``, else its
        ``latest_valid_step()``; ``FileNotFoundError`` when it has none),
        a checkpoint step directory, a serving artifact (dequantized when
        it is the int8 format) or a state-dict file. Every value is
        ``copy_``'d into the live parameter, cast to its dtype and device,
        so no ``data_ptr()`` moves and the captured decode windows and
        catch-up graphs stay valid with nothing recaptured. A partial
        state dict loads the names it has (the reference's lenient
        ``set_state_dict``). Returns the restored step, or None. With a
        prefix store, weights of another fingerprint drop every cached
        chain (device-registered and host-resident) and the store is read
        again for the new fingerprint, and an armed (or already anchored)
        weight audit re-anchors at the new weights. The reference's
        sharding-plan branch is not ported (this engine takes no plan)."""
        step = self._reload_weights_impl(source)
        audited = self._weight_audit_ref is not None or self._weight_audit
        if not audited and self._store_path is None:
            return step
        fp = weights_fingerprint(self.model)
        if audited:
            # a reload changes the fingerprint legitimately: re-anchor
            self._weight_audit_ref = fp
        if self._store_path is not None and fp != self._store_fingerprint:
            self.prefix_cache.invalidate()
            self.kv_tier.drop_prefixes()
            self._store_fingerprint = fp
            self._store_saved_chains = -1
            self._load_prefix_store()
        return step

    def audit_weights(self):
        """Re-hash the live weights and compare with the fingerprint
        anchored at construction (``weight_audit=True``) or at the last
        ``reload_weights``. True when they match; False, counting
        ``serving_weight_audit_failures_total``, when the weights changed
        in place. On an engine built without ``weight_audit`` the first
        call anchors instead of comparing. It copies every weight to the
        host and hashes it: seconds at llama_1b, so it runs when called,
        never per step."""
        fp = weights_fingerprint(self.model)
        self._weight_audits += 1
        if self._weight_audit_ref is None:
            self._weight_audit_ref = fp
            return True
        if fp != self._weight_audit_ref:
            _M_WEIGHT_AUDIT_FAIL.inc(instance=self._name)
            return False
        return True

    def _reload_weights_impl(self, source):
        from ...distributed.checkpoint import (CheckpointManager,
                                               load_state_dict)
        from ...framework import io as _fio

        if isinstance(source, CheckpointManager):
            step = source.latest_healthy_step()
            if step is None:
                step = source.latest_valid_step()
            if step is None:
                raise FileNotFoundError(
                    "reload_weights: no committed checkpoint in "
                    f"{source.root}")
            load_state_dict(self.model.state_dict(), source.step_dir(step))
            return step
        path = os.fspath(source)
        if os.path.isdir(path):
            load_state_dict(self.model.state_dict(), path)
        elif is_llama_artifact(path):
            set_state_dict(self.model, load_llama_state_dict(path))
        else:
            set_state_dict(self.model, _fio.load(path))
        return None

    # ------------------------------------------------------------------
    # observability + teardown
    # ------------------------------------------------------------------
    def stats(self):
        d = dict(self.stats_extra)
        d.update(self.scheduler.stats)
        d["blocks_free"] = self.cache.allocator.num_free
        d["blocks_high_water"] = self.cache.allocator.high_water
        d["waiting"] = len(self.scheduler.waiting)
        d["running"] = len(self.scheduler.running)
        return d

    def metrics(self):
        """This engine instance's counters, latency summaries (ms) and
        gauges, read from ``observability.metrics``."""
        inst = self._name
        prop = _M_SPEC_PROPOSED.value(instance=inst)
        return {
            "instance": inst,
            "device": str(self.device),
            "admitted": int(_M_ADMITTED.value(instance=inst)),
            "evictions": int(_M_EVICTIONS.value(instance=inst)),
            "finished": int(_M_FINISHED.value(instance=inst)),
            "queued_on_exhaustion": int(_M_QUEUED_EXH.value(instance=inst)),
            "prefills": int(_M_PREFILLS.value(instance=inst)),
            "prefill_chunks": int(_M_PREFILL_CHUNKS.value(instance=inst)),
            "decode_steps": int(_M_DECODE_STEPS.value(instance=inst)),
            "prefix_blocks_reused": int(
                _M_PREFIX_REUSED.value(instance=inst)),
            "cow_copies": int(_M_COW.value(instance=inst)),
            "spec_proposed": int(prop),
            "spec_accepted": int(_M_SPEC_ACCEPTED.value(instance=inst)),
            "spec_accept_ratio": (
                float(_G_SPEC_RATIO.value(instance=inst)) if prop
                else None),
            "spec_verify_steps": int(_M_SPEC_VERIFY.value(instance=inst)),
            "spec_draft_steps": int(_M_SPEC_DRAFT.value(instance=inst)),
            "tokens_out": int(_M_TOKENS.value(instance=inst)),
            "ttft_ms": _H_TTFT.summary(instance=inst),
            "itl_ms": _H_ITL.summary(instance=inst),
            "kv_block_utilization": _G_KV_UTIL.value(instance=inst),
            "decode_batch_occupancy": _G_OCCUPANCY.value(instance=inst),
            "kv_dtype": self.kv_dtype,
            "kv_bytes_saved": int(_M_KV_SAVED.value(instance=inst)),
            "quantized_blocks_in_use": (
                int(_G_QUANT_BLOCKS.value(instance=inst))
                if self.cache.quantized else None),
            "host_syncs": int(_M_HOST_SYNCS.value(instance=inst)),
            "decode_fetch_bytes": int(_M_FETCH_BYTES.value(instance=inst)),
            # the host tier and the prefix store: zeros when they are off
            "kv_spills": int(_M_SPILLS.value(instance=inst)),
            "kv_revives": int(_M_REVIVES.value(instance=inst)),
            "kv_spill_bytes": int(_M_SPILL_BYTES.value(instance=inst)),
            "kv_revive_bytes": int(_M_REVIVE_BYTES.value(instance=inst)),
            "kv_host_evictions": int(_M_HOST_EVICT.value(instance=inst)),
            "kv_host_blocks": int(_G_HOST_BLOCKS.value(instance=inst)),
            "kv_spill_ms": _H_SPILL_MS.summary(instance=inst),
            "kv_revive_ms": _H_REVIVE_MS.summary(instance=inst),
            "revive_misses": self.scheduler.revive_misses,
            "prefix_store_saved": int(_M_STORE_SAVED.value(instance=inst)),
            "prefix_store_loaded": int(
                _M_STORE_LOADED.value(instance=inst)),
            "prefix_store_rejected": sum(
                self._store_rejected_by_reason().values()),
            "prefix_store_rejected_by_reason":
                self._store_rejected_by_reason(),
            # deadlines and QoS: zeros when unused
            "deadline_expired": int(_M_DEADLINE.value(instance=inst)),
            "quota_throttled": int(_M_THROTTLED.value(instance=inst)),
            "batch_yields": int(_M_BATCH_YIELD.value(instance=inst)),
            "tenant_tokens": self._by_label(_M_TENANT_TOKENS, "tenant",
                                            "default"),
            # integrity: zeros when checksums and the audit are off
            "kv_pages_verified": int(
                _M_PAGES_VERIFIED.value(instance=inst)),
            "kv_pages_rejected": int(
                _M_PAGES_REJECTED.value(instance=inst)),
            "weight_audits": int(self._weight_audits),
            "weight_audit_failures": int(
                _M_WEIGHT_AUDIT_FAIL.value(instance=inst)),
        }

    def _labeled_series(self, metric):
        """THIS instance's label sets of a metric with a second label
        (the store's ``reason``, the tenant counter's ``tenant``): an
        exact-match ``remove(instance=)`` cannot reach them."""
        return [d for d in (dict(lb) for lb in metric.labels())
                if d.get("instance") == self._name]

    def _by_label(self, metric, label, default):
        return {d.get(label, default): int(metric.value(**d))
                for d in self._labeled_series(metric)}

    def _store_rejected_by_reason(self):
        return self._by_label(_M_STORE_REJECTED, "reason", "corrupt")

    def _remove_tenant_series(self):
        """Remove THIS instance's tenant- and reason-labeled series."""
        for m in (_M_TENANT_TOKENS, _M_STORE_REJECTED):
            for d in self._labeled_series(m):
                m.remove(**d)

    def reset_block_high_water(self):
        """Re-anchor the allocator's high-water mark at the blocks in use
        now (a benchmark window's start)."""
        alloc = self.cache.allocator
        alloc.high_water = (self.cache.num_blocks - 1) - alloc.num_free

    def reset_metrics(self):
        """Drop THIS instance's registry series (a benchmark window's
        start); the construction-time KV saving and the host tier's
        occupancy (current state, not window activity) are republished."""
        for m in _SERVING_METRICS:
            m.remove(instance=self._name)
        self._remove_tenant_series()
        if self.cache.quantized and not self._closed:
            _M_KV_SAVED.inc(self._kv_bytes_saved, instance=self._name)
        if self.kv_tier is not None and not self._closed:
            _G_HOST_BLOCKS.set(self.kv_tier.host_blocks_in_use,
                               instance=self._name)

    def close(self):
        """Join the ingest thread, abort every live request, drop
        bookkeeping and this instance's metric series, restore the models'
        training flags. Idempotent;
        afterwards the request API raises :class:`EngineClosedError`."""
        if self._closed:
            return
        if self._store_path is not None:
            # persist the warm chains BEFORE teardown frees their blocks; a
            # failed save keeps the previous store and never blocks close
            try:
                self.save_prefix_store()
            except OSError as e:
                warnings.warn(f"{self._name}: prefix store save on close "
                              f"failed: {e}", RuntimeWarning)
        self._closed = True
        if self._ingest is not None:
            self._ingest.close()
            # anything still staged on the (now joined) ingest thread was
            # never admitted: no blocks to free
            self._ingest.drain()
        for req in list(self.scheduler.running) + list(
                self.scheduler.waiting):
            self.scheduler.abort(req, "closed")
        self._requests.clear()
        if self.kv_tier is not None:
            self.kv_tier.close()
        # frees the graphs' memory pools
        self._window = None
        self._catchups.clear()
        self.reset_metrics()
        if self._was_training:
            self.model.train()
        if self.draft_model is not None and self._draft_was_training:
            self.draft_model.train()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ----------------------------------------------------------------------
# llama serving artifacts (read by inference.create_predictor)
# ----------------------------------------------------------------------

ARTIFACT_QMAX = 127.0


def _quantizable(v):
    """The reference's rule: >= 2 dims and a numpy float dtype (kind
    "f"). bfloat16 is kind "V" there (ml_dtypes), so it passes through;
    a bfloat16 tensor does here too."""
    if isinstance(v, torch.Tensor):
        return v.dim() >= 2 and v.dtype in (torch.float16, torch.float32,
                                            torch.float64)
    return v.ndim >= 2 and v.dtype.kind == "f"


def quantize_state_dict(state_dict, qmax=ARTIFACT_QMAX):
    """Per-channel int8 quantization of a weights state dict (the int8
    artifact format): every float tensor or array with >= 2 dims becomes
    int8 codes and an fp32 per-channel scale row (abs-max over all axes
    but the LAST, the output channel of every ``Linear``); everything
    else passes through. A tensor is quantized on its own device by the
    shared :func:`~paddle_tpu_torch.quantization.base.per_channel_int8`
    (bit for bit the reference's numpy quantizer), then copied to the
    host. As in the reference, a bfloat16 weight is not quantized (its
    numpy dtype there has kind "V"): an "int8" artifact of a bf16 model is
    bf16 passthrough with no scales.

    Returns ``(packed, scales)`` of host values: codes, passthrough numpy
    arrays (bfloat16: CPU tensors) and, for the quantized names only, the
    DEQUANT MULTIPLIER ``absmax / qmax`` (fp32, in numpy)."""
    from ...quantization.base import per_channel_int8

    packed, scales = {}, {}
    for name, val in state_dict.items():
        if not isinstance(val, torch.Tensor):
            val = host_value(val)
        if _quantizable(val):
            codes, absmax = per_channel_int8(val, qmax=qmax)
            packed[name] = host_value(codes)
            scales[name] = (host_value(absmax) / qmax).astype(np.float32)
        else:
            packed[name] = host_value(val)
    return packed, scales


def dequantize_state_dict(packed, scales, dtype=np.float32):
    """Inverse of :func:`quantize_state_dict`: codes x scale back to
    ``dtype`` host arrays, passthrough entries untouched."""
    out = {}
    for name, arr in packed.items():
        if name in scales:
            out[name] = (host_value(arr).astype(np.float32)
                         * host_value(scales[name])).astype(dtype)
        else:
            out[name] = arr
    return out


def _base(path):
    path = os.fspath(path)
    return path[: -len(".pdmodel")] if path.endswith(".pdmodel") else path


def save_llama_artifact(model, path, quantize=None):
    """Persist a llama model as a serving artifact, the reference's files:
    ``<path>.llamacfg.json`` (the ``LlamaConfig``, whose fields are a
    subset of the reference's, so the JAX package reads it) and
    ``<path>.pdiparams`` (the weights, through ``framework.io.save``).

    ``quantize="int8"`` writes the quantized format: ``<path>.pdiparams``
    holds the packed int8 codes (per-channel abs-max) and passthrough
    tensors, ``<path>.qscales.pdiparams`` the scales and
    ``<path>.quant.json`` the scheme. A plain save removes a previous int8
    save's two sidecars.

    The weights are stored as numpy arrays, which both packages' ``load``
    return as they are, so the JAX package reads the port's fp32 and int8
    artifacts; bfloat16 weights are stored as the port's bfloat16 payloads
    (numpy has no bfloat16), which only the port reads."""
    import json

    from ...framework.io import save as fsave

    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8'; got "
                         f"{quantize!r}")
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".llamacfg.json", "w") as f:
        json.dump(dataclasses.asdict(model.config), f)
    if quantize == "int8":
        packed, scales = quantize_state_dict(model.state_dict())
        fsave(packed, path + ".pdiparams")
        fsave(scales, path + ".qscales.pdiparams")
        with open(path + ".quant.json", "w") as f:
            json.dump({"scheme": "int8_per_channel",
                       "qmax": ARTIFACT_QMAX,
                       "quantized_tensors": sorted(scales)}, f)
    else:
        fsave({k: host_value(v) for k, v in model.state_dict().items()},
              path + ".pdiparams")
        # a resave over a previously-quantized path must not leave a
        # stale scheme sidecar claiming the fp weights are codes
        for ext in (".quant.json", ".qscales.pdiparams"):
            try:
                os.remove(path + ext)
            except OSError:
                pass


def is_llama_artifact(path):
    return os.path.exists(_base(path) + ".llamacfg.json")


def is_quantized_artifact(path):
    return os.path.exists(_base(path) + ".quant.json")


def load_llama_state_dict(path):
    """The weights of an artifact as host values, the int8 format
    dequantized to fp32 (``LLMEngine.reload_weights`` casts them into the
    live parameters). bfloat16 weights come back as bfloat16 tensors,
    never as their integer bits."""
    import json

    from ...framework.io import load as fload

    path = _base(path)
    if is_quantized_artifact(path):
        with open(path + ".quant.json") as f:
            meta = json.load(f)
        if meta.get("scheme") != "int8_per_channel":
            raise ValueError(
                f"unknown quantized-artifact scheme {meta.get('scheme')!r} "
                f"in {path}.quant.json")
        packed = fload(path + ".pdiparams")
        scales = fload(path + ".qscales.pdiparams")
        return dequantize_state_dict(packed, scales)
    return fload(path + ".pdiparams")


# the reference's LlamaConfig fields the port's lacks, at the only values
# it runs: (default, what a different value needs)
_REFERENCE_ONLY = {
    "dropout": (0.0, "llama dropout is not ported"),
    "use_ring_attention": (False, "ring attention is not ported yet "
                           "(ROADMAP Queue 1, item 8)"),
    "use_sep_attention": (False, "Ulysses (sep) attention is not ported "
                          "yet (ROADMAP Queue 1, item 8)"),
}


def _llama_config(raw):
    """A ``LlamaConfig`` from an artifact's JSON: the reference's extra
    fields are accepted at their defaults and refused otherwise."""
    from ...models.llama import LlamaConfig

    raw = dict(raw)
    for key, (default, why) in _REFERENCE_ONLY.items():
        if key in raw and raw.pop(key) != default:
            raise NotImplementedError(
                f"artifact config sets {key}; {why}")
    return LlamaConfig(**raw)


def load_llama_artifact(path, device=None):
    """Rebuild the model saved by :func:`save_llama_artifact` (either
    package's): built on ``device`` (default ``cuda``; raises without it)
    in the global default dtype (``get_default_dtype()``), the weights
    cast into it (an int8 artifact dequantized), in eval mode."""
    import json

    path = _base(path)
    with open(path + ".llamacfg.json") as f:
        cfg = _llama_config(json.load(f))
    model = LlamaForCausalLM(cfg, device=device, dtype=get_default_dtype())
    set_state_dict(model, load_llama_state_dict(path))
    model.eval()
    return model
