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
  to completion.

Prefill chunks, the per-step decode and the verify run eagerly; pools are
written in place (see ``kv_cache``). Sharding plans,
prefill-only/disaggregated serving, the host KV tier, the prefix store,
integrity checks, deadlines and tenants are not ported, and the
constructor does not take their arguments.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import threading
import time
import warnings

import numpy as np
import torch

from ...core.device import resolve_device
from ...models.llama import (LlamaForCausalLM, _rope_apply, _rotate,
                             greedy_tokens_in_graph, sample_next_tokens)
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from ...ops.cuda import GraphLaunches
from .errors import EngineClosedError
from .kv_cache import PagedKVCache, PrefixCache, quantize_kv_rows
from .paged_attention import (paged_decode_attention,
                              paged_multiquery_attention)
from .scheduler import (Request, SamplingParams, Scheduler, _M_ADMITTED,
                        _M_COW, _M_EVICTIONS, _M_FINISHED, _M_PREFIX_REUSED,
                        _M_QUEUED_EXH)

__all__ = ["LLMEngine", "StepOutput", "EngineClosedError"]

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
                    _M_FETCH_BYTES)


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
    replays it. The capture launches nothing, so it records each kernel
    wrapper's launches (``ops.cuda.GraphLaunches``) and puts the counts
    back; each replay adds the recorded counts. A failed capture or
    replay raises: there is no eager fallback on the card."""

    def __init__(self, engine, fn, shape):
        self.engine, self.fn = engine, fn
        self.buf = torch.zeros(shape, dtype=torch.int64,
                               device=engine.device)
        self.graph = None
        self.out = None
        self.launches = GraphLaunches()
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
        with self.launches.capture(), torch.cuda.graph(graph, stream=side):
            out = self.fn(self.buf, tables)
        self.graph, self.out = graph, out

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
                 fuse_draft_catchup=True, decode_steps_per_sync=1,
                 in_graph_sampling=None, capture_logits=False, device=None):
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
        self.scheduler = Scheduler(self.cache.allocator, block_size,
                                   max_batch_size, max_prefills_per_step,
                                   instance=self._name,
                                   prefix_cache=self.prefix_cache)
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
        self._ingest = (_IngestThread(self._stage_request, self._name)
                        if ingest_async else None)

    def _ensure_open(self):
        if self._closed:
            raise EngineClosedError(
                f"{self._name} is closed; create a new LLMEngine")

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

    def add_request(self, prompt_ids, sampling: SamplingParams | None = None):
        """Enqueue a prompt; returns the request id. Never blocks on pool
        exhaustion — the request queues until blocks free up."""
        self._ensure_open()
        req = Request(prompt_ids, sampling)
        self._check_admissible(req)
        req.t_submit = req.t_queue_start = time.perf_counter_ns()
        self._requests[req.rid] = req
        if self._ingest is not None:
            self._ingest.submit(req)
        else:
            self._stage_request(req)
            self.scheduler.waiting.append(req)
        return req.rid

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
        self.scheduler.abort(req, reason)
        return True

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
        if self.prefix_cache is not None:
            self.prefix_cache.register(req.tokens, req.blocks,
                                       req.num_cached)
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
        for req, start, take in sched.prefill_work(
                self.max_prefill_tokens_per_step):
            self._run_chunk(req, start, take, outputs)

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
        ITL observations of dt / m. Appends StepOutputs to ``outputs``."""
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
        now = time.perf_counter_ns()
        _M_TOKENS.inc(m, instance=self._name)
        dt_ms = (now - req.t_last_token) / 1e6 / m
        for _ in range(m):
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

    def generate(self, prompts, sampling: SamplingParams | None = None):
        """Submit every prompt, run to completion, return the full token
        arrays (prompt + generated) in order."""
        self._ensure_open()
        rids = []
        try:
            for p in prompts:
                rids.append(self.add_request(
                    p, dataclasses.replace(sampling) if sampling else None))
        except (ValueError, EngineClosedError):
            for r in rids:
                self.cancel(r)
                self.release(r)
            raise
        for _ in self.stream():
            pass
        outs = [self.output_tokens(r) for r in rids]
        for r in rids:
            self.release(r)
        return outs

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
        }

    def reset_metrics(self):
        """Drop THIS instance's registry series (a benchmark window's
        start); the construction-time KV saving is republished."""
        for m in _SERVING_METRICS:
            m.remove(instance=self._name)
        if self.cache.quantized and not self._closed:
            _M_KV_SAVED.inc(self._kv_bytes_saved, instance=self._name)

    def close(self):
        """Join the ingest thread, abort every live request, drop
        bookkeeping and this instance's metric series, restore the models'
        training flags. Idempotent;
        afterwards the request API raises :class:`EngineClosedError`."""
        if self._closed:
            return
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
