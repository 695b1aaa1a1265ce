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
* decode fetches ``[B, V]`` logits and samples on the host with
  ``models.llama.sample_next_tokens``;
* ``stream`` yields tokens as they are produced, ``generate`` runs a batch
  to completion.

The engine runs eagerly; pools are written in place (see ``kv_cache``).
Sharding plans, speculative decoding, prefill-only/disaggregated serving,
the host KV tier, the prefix store, fused decode windows and in-graph
sampling, logit capture, integrity checks, deadlines and tenants are not
ported, and the constructor does not take their arguments.
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
                             sample_next_tokens)
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
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
    "batched decode steps run (one paged-decode attention per layer each)")
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
    "blocking device->host logits fetches made by the decode loop")
_M_FETCH_BYTES = _obs_metrics.counter(
    "serving_decode_fetch_bytes_total",
    "bytes fetched device->host by the decode loop (B*V logits per step)")

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


class LLMEngine:
    """Continuous-batching paged-KV serving engine over a llama model.

    ``device`` (default ``cuda``; raises when CUDA is absent) is where the
    model, the pools and every step run; the model is moved there."""

    _instance_ids = itertools.count(1)

    def __init__(self, model, *, num_blocks=64, block_size=16,
                 max_batch_size=4, max_model_len=None, prefill_buckets=None,
                 max_prefills_per_step=1, enable_prefix_cache=False,
                 max_prefill_tokens_per_step=None, kv_dtype=None,
                 device=None):
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
        # device block tables of the decode slots, cached against the
        # scheduler's table version and slot readiness
        self._tables_key = None
        self._tables_np = None
        self._tables_dev = None
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
        llama = self.model.llama
        bs = self.block_size
        B = len(ids)
        meta = np.stack([ids, positions,
                         tables_np[np.arange(B), positions // bs],
                         positions % bs, positions + 1]).astype(np.int32)
        meta = torch.from_numpy(meta).to(self.device)
        ids_d, pos_d, blk_d, off_d = (meta[i].long() for i in range(4))
        lens = meta[4]
        cos_t, sin_t = llama.rope_cos, llama.rope_sin
        c = cos_t[pos_d][:, None, None, :]
        s = sin_t[pos_d][:, None, None, :]
        x = llama.embed_tokens(ids_d[:, None])
        for li, layer in enumerate(llama.layers):
            attn = layer.self_attn
            q, k, v = attn.project(layer.input_layernorm(x))
            q = _rotate(q, c.to(q.dtype), s.to(q.dtype))
            k = _rotate(k, c.to(k.dtype), s.to(k.dtype))
            self._write_rows(li, (blk_d, off_d), k[:, 0], v[:, 0])
            kp, vp, ks, vs = self._pool_args(li)
            out = paged_decode_attention(q, kp, vp, tables, lens,
                                         scale=self._scale, k_scale=ks,
                                         v_scale=vs)
            x = x + attn.o_proj(out.reshape(B, 1, -1))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        h = llama.norm(x)
        return self.model.head(h[:, -1])

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
            self._tables_dev = torch.from_numpy(tbl).to(self.device)
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

        sched.ensure_decode_room()
        self._drain_cow()
        ready = [(i, r) for i, r in enumerate(sched.slots)
                 if r is not None and not r.prefilling]
        if ready:
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
        host and commit it. Returns [StepOutput]."""
        s = req.sampling
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
        done = req.should_finish()
        if done:
            self.scheduler.finish(req)
            start = req.t_decode_start or req.t_first_token or now
            _obs_trace.add_complete(
                "request.decode", start, now, cat="request", tid=req.rid,
                args={"rid": req.rid, "engine": self._name,
                      "tokens": len(req.output_tokens),
                      "finish_reason": req.finish_reason()})
        return [StepOutput(req.rid, tok, done,
                           req.finish_reason() if done else None)]

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
        self.reset_metrics()
        if self._was_training:
            self.model.train()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
