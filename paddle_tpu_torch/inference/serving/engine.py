"""LLM serving engine (counterpart of
``paddle_tpu/inference/serving/engine.py``).

``LLMEngine`` turns a ``LlamaForCausalLM`` into a continuously batched
server over a paged KV pool on one device (``cuda`` by default):

* ``add_request`` pads the prompt to its prefill bucket and copies it to
  the device (synchronously), then queues it;
* ``step`` runs one scheduler tick: admit queued prompts (charging only
  blocks the prefix cache cannot supply), advance prefills by at most
  ``max_prefill_tokens_per_step`` tokens of block-aligned chunks, then one
  decode step over every decode-ready slot;
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
* ``stream`` yields tokens as they are produced, ``generate`` runs a batch
  to completion.

Prefill chunks and the per-step decode run eagerly; pools are written in
place (see ``kv_cache``). Sharding plans, speculative decoding,
prefill-only/disaggregated serving, the host KV tier, the prefix store,
integrity checks, deadlines and tenants are not ported, and the
constructor does not take their arguments.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
import warnings

import numpy as np
import torch

from ...core.device import resolve_device
from ...models.llama import (LlamaForCausalLM, _rope_apply, _rotate,
                             greedy_tokens_in_graph, sample_next_tokens)
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from ...ops.cuda import paged_attention as _decode_kernels
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
                    _M_DECODE_STEPS, _M_TOKENS, _M_KV_SAVED, _H_TTFT, _H_ITL,
                    _G_KV_UTIL, _G_OCCUPANCY, _G_QUANT_BLOCKS, _M_HOST_SYNCS,
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


class _DecodeWindow:
    """One engine's decode window over static device buffers: ``meta``
    int64 [5, B] (ids, positions, active, budget, eos ids; filled by
    ``copy_`` before each run) and the engine's persistent block-table
    buffer. On the CPU :meth:`run` calls the window function eagerly. On
    the card the first run warms the function up on a side stream with
    every row inactive (first launches set kernel attributes; cuBLAS takes
    its workspace for that stream), then captures it into a
    ``torch.cuda.CUDAGraph``; every run replays it. The capture launches
    nothing, so it records each decode-kernel wrapper's launch count and
    puts the counts back; each replay adds the recorded counts. A failed
    capture or replay raises: there is no eager fallback on the card."""

    def __init__(self, engine):
        self.engine = engine
        self.meta = torch.zeros(5, engine.max_batch_size, dtype=torch.int64,
                                device=engine.device)
        self.graph = None
        self.tokens = None
        self.launches = {}
        self.replays = 0

    @torch.inference_mode()
    def _capture(self):
        dev = self.engine.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.engine._window_forward(self.meta, self.engine._tables_dev)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = {w: w.launches for w in _decode_kernels._WRAPPERS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            tokens = self.engine._window_forward(self.meta,
                                                 self.engine._tables_dev)
        for w, n in before.items():
            self.launches[w] = w.launches - n
            w.launches = n
        self.graph, self.tokens = graph, tokens

    @torch.inference_mode()
    def run(self, meta):
        """One window on ``meta`` (host int64 [5, B]); returns the tokens
        as a host int32 array [B, k] (the window's one fetch)."""
        if self.engine.device.type != "cuda":
            self.meta.copy_(torch.from_numpy(meta))
            return self.engine._window_forward(
                self.meta, self.engine._tables_dev).numpy()
        if self.graph is None:
            self._capture()  # on the inactive rows the buffer starts with
        self.meta.copy_(torch.from_numpy(meta))
        self.graph.replay()
        self.replays += 1
        for w, n in self.launches.items():
            w.launches += n
        return self.tokens.cpu().numpy()


class LLMEngine:
    """Continuous-batching paged-KV serving engine over a llama model.

    ``device`` (default ``cuda``; raises when CUDA is absent) is where the
    model, the pools and every step run; the model is moved there."""

    _instance_ids = itertools.count(1)

    def __init__(self, model, *, num_blocks=64, block_size=16,
                 max_batch_size=4, max_model_len=None, prefill_buckets=None,
                 max_prefills_per_step=1, enable_prefix_cache=False,
                 max_prefill_tokens_per_step=None, kv_dtype=None,
                 decode_steps_per_sync=1, in_graph_sampling=None,
                 capture_logits=False, device=None):
        if not isinstance(model, LlamaForCausalLM):
            raise TypeError("LLMEngine serves LlamaForCausalLM models; got "
                            f"{type(model).__name__}")
        if model.config.num_experts > 0:
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
        attn = model.llama.layers[0].self_attn
        self._scale = 1.0 / math.sqrt(attn.head_dim)
        k = int(decode_steps_per_sync)
        if k < 1:
            raise ValueError(f"decode_steps_per_sync must be >= 1, got {k}")
        if in_graph_sampling is None:
            in_graph_sampling = k > 1
        in_graph_sampling = bool(in_graph_sampling)
        if k > 1 and not in_graph_sampling:
            raise ValueError(
                "decode_steps_per_sync > 1 requires in_graph_sampling: a "
                "fused window cannot round-trip logits to the host between "
                "its iterations")
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
        # the decode slots' block tables: one persistent device buffer
        # (the window's graph reads it at every replay), refilled when the
        # scheduler's table version or the slots' readiness moves
        self._tables_key = None
        self._tables_np = None
        self._tables_dev = torch.zeros(self.max_batch_size, self.max_pages,
                                       dtype=torch.int32, device=self.device)
        self._requests: dict[int, Request] = {}
        self._closed = False
        self.stats_extra = {"steps": 0, "prefills": 0, "decode_steps": 0,
                            "tokens_out": 0}

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
        copy it to the device."""
        toks = req.tokens
        bucket = self._bucket_for(len(toks))
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :len(toks)] = toks
        req._staged = (torch.from_numpy(ids).to(self.device), bucket,
                       len(toks))

    def add_request(self, prompt_ids, sampling: SamplingParams | None = None):
        """Enqueue a prompt; returns the request id. Never blocks on pool
        exhaustion — the request queues until blocks free up."""
        self._ensure_open()
        req = Request(prompt_ids, sampling)
        self._check_admissible(req)
        req.t_submit = req.t_queue_start = time.perf_counter_ns()
        self._requests[req.rid] = req
        self._stage_request(req)
        self.scheduler.waiting.append(req)
        return req.rid

    def _check_admissible(self, req):
        total = len(req.prompt) + req.sampling.max_new_tokens
        cap = min(self.max_model_len,
                  (self.cache.num_blocks - 1) * self.block_size)
        if total > cap:
            raise ValueError(
                f"request needs {total} tokens but the engine caps at {cap} "
                f"(max_model_len={self.max_model_len}, pool="
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
        return not self._closed and self.scheduler.has_work()

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _write_rows(self, layer, index, k, v):
        """Write K/V rows into layer ``layer``'s pools at ``index`` (a
        tuple of index tensors for ``index_put_``), quantizing on int8
        pools. In place."""
        c = self.cache
        if c.quantized:
            qk, sk = quantize_kv_rows(k)
            qv, sv = quantize_kv_rows(v)
            c.k[layer].index_put_(index, qk)
            c.v[layer].index_put_(index, qv)
            c.k_scale[layer].index_put_(index, sk)
            c.v_scale[layer].index_put_(index, sv)
        else:
            c.k[layer].index_put_(index, k.to(c.k[layer].dtype))
            c.v[layer].index_put_(index, v.to(c.v[layer].dtype))

    def _pool_args(self, layer):
        c = self.cache
        if c.quantized:
            return (c.k[layer], c.v[layer], c.k_scale[layer],
                    c.v_scale[layer])
        return c.k[layer], c.v[layer], None, None

    @torch.inference_mode()
    def _chunk_forward(self, ids, start, upto, tables_row):
        """One prefill chunk: ``ids`` [1, C] at block-aligned offset
        ``start``; queries attend causally over pool pages [0, upto) via
        paged multi-query attention. Writes the chunk's K/V pages (padding
        pages go to the null block through zero table entries). Returns
        logits [1, V] at position ``upto - 1``."""
        llama = self.model.llama
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
        x = llama.embed_tokens(ids)
        for li, layer in enumerate(llama.layers):
            attn = layer.self_attn
            q, k, v = attn.project(layer.input_layernorm(x))
            q = _rope_apply(q, cos, sin)
            k = _rope_apply(k, cos, sin)
            geo = (pages, bs, attn.num_kv_heads, attn.head_dim)
            self._write_rows(li, (page_blocks,), k.reshape(geo),
                             v.reshape(geo))
            kp, vp, ks, vs = self._pool_args(li)
            out = paged_multiquery_attention(
                q, kp, vp, tables, lens, starts, scale=self._scale,
                k_scale=ks, v_scale=vs)
            x = x + attn.o_proj(out.reshape(1, C, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        h = llama.norm(x)
        return self.model.head(h[:, upto - 1 - start])

    @torch.inference_mode()
    def _decode_forward(self, ids, positions, tables, tables_np):
        """One token for every decode slot: ``ids``/``positions`` host
        int arrays [B]. Each row writes its K/V at its position (empty and
        mid-prefill slots: position 0 of the null block) and attends over
        ``positions + 1`` tokens. Returns logits [B, V]."""
        bs = self.block_size
        B = len(ids)
        meta = np.stack([ids, positions,
                         tables_np[np.arange(B), positions // bs],
                         positions % bs, positions + 1]).astype(np.int32)
        meta = torch.from_numpy(meta).to(self.device)
        ids_d, pos_d, blk_d, off_d = (meta[i].long() for i in range(4))
        return self._decode_layers(ids_d, pos_d, blk_d, off_d, meta[4],
                                   tables)

    def _decode_layers(self, ids, pos, blk, off, lens, tables):
        """The decode body on device metadata: ids, positions, write block
        and offset (int64 [B]), context lengths (int32 [B]) and the block
        tables [B, P]. Returns logits [B, V]."""
        llama = self.model.llama
        B = ids.shape[0]
        c = llama.rope_cos[pos][:, None, None, :]
        s = llama.rope_sin[pos][:, None, None, :]
        x = llama.embed_tokens(ids[:, None])
        for li, layer in enumerate(llama.layers):
            attn = layer.self_attn
            q, k, v = attn.project(layer.input_layernorm(x))
            q = _rotate(q, c.to(q.dtype), s.to(q.dtype))
            k = _rotate(k, c.to(k.dtype), s.to(k.dtype))
            self._write_rows(li, (blk, off), k[:, 0], v[:, 0])
            kp, vp, ks, vs = self._pool_args(li)
            out = paged_decode_attention(q, kp, vp, tables, lens,
                                         scale=self._scale, k_scale=ks,
                                         v_scale=vs)
            x = x + attn.o_proj(out.reshape(B, 1, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        h = llama.norm(x)
        return self.model.head(h[:, -1])

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
        self.scheduler.pending_cow.clear()

    def _run_chunk(self, req, start, take, outputs):
        """One block-aligned prefill chunk of ``take`` tokens at ``start``;
        on the final chunk, sample the first output token."""
        staged = getattr(req, "_staged", None)
        if staged is None or staged[2] != req.prefill_upto:
            self._stage_request(req)  # re-prefill after eviction
            staged = req._staged
        ids_dev, bucket, _ = staged
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
        logits = self._chunk_forward(ids_dev[:, start:start + C], start,
                                     start + take, tables_row)
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
        """One engine tick: admit, advance chunked prefills under the token
        budget, one decode for all decode-ready slots. Returns the
        ``StepOutput`` tokens produced."""
        self._ensure_open()
        sched = self.scheduler
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
            extra_for=(self._window_extra if self._decode_window > 1
                       else None))
        self._drain_cow()
        ready = [(i, r) for i, r in enumerate(sched.slots)
                 if r is not None and not r.prefilling]
        sampled = any(r.sampling.do_sample for _, r in ready)
        if ready and self._in_graph and not sampled:
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
            self._window = _DecodeWindow(self)
        toks = self._window.run(meta)
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
        """Abort every live request, drop bookkeeping and this instance's
        metric series, restore the model's training flag. Idempotent;
        afterwards the request API raises :class:`EngineClosedError`."""
        if self._closed:
            return
        self._closed = True
        for req in list(self.scheduler.running) + list(
                self.scheduler.waiting):
            self.scheduler.abort(req, "closed")
        self._requests.clear()
        self._window = None  # frees the graph's memory pool
        self.reset_metrics()
        if self._was_training:
            self.model.train()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
