"""Continuous batching scheduler — host-only copy of
``paddle_tpu/inference/serving/scheduler.py`` for the port.

Token-granularity admission into a fixed set of decode slots:

* ``max_batch_size`` decode slots; a finished request's slot is refilled
  by the next waiting request at the very next step (continuous batching);
* **chunked prefill**: ``prefill_work`` hands out at most
  ``max_prefill_tokens_per_step`` NEW prompt tokens per engine step in
  block-aligned chunks (``None`` = whole prompts in one chunk);
* **prefix-aware admission**: with a :class:`~.kv_cache.PrefixCache`,
  admission charges the allocator only for the unshared tail — matched
  blocks are ``acquire``\\ d (ref-counted) and ``num_cached`` starts past
  them;
* **copy-on-write guard**: before decode writes, a block in the write
  window that another request can see (refcount > 1) is replaced by a
  private copy (queued on ``pending_cow`` for the engine to execute);
* **graceful degradation**: a request that cannot get blocks stays queued
  (FIFO). If a RUNNING request cannot grow by one block, the most recently
  admitted running request is evicted (blocks freed, re-queued at the
  FRONT, re-prefilled later from its prompt + generated prefix).

``version`` counts every block-table mutation so the engine can cache the
device block-table tensor against it. Tenants, tiers, deadlines, the host
KV tier and page handoff are not part of the port yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np

from ...observability import metrics as _obs_metrics

__all__ = ["SamplingParams", "Request", "Scheduler"]

_M_ADMITTED = _obs_metrics.counter(
    "serving_requests_admitted_total", "requests admitted to decode slots")
_M_EVICTIONS = _obs_metrics.counter(
    "serving_evictions_total",
    "recompute-preemption evictions under pool pressure")
_M_FINISHED = _obs_metrics.counter(
    "serving_requests_finished_total", "requests finished (EOS or length)")
_M_QUEUED_EXH = _obs_metrics.counter(
    "serving_queued_on_exhaustion_total",
    "admissions deferred because the block pool was exhausted")
_M_PREFIX_REUSED = _obs_metrics.counter(
    "serving_prefix_blocks_reused_total",
    "pool blocks admitted from the prefix cache instead of fresh prefill")
_M_COW = _obs_metrics.counter(
    "serving_cow_copies_total",
    "copy-on-write block copies (divergent write to a shared block)")

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 32
    eos_token_id: int | None = None
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int | None = None


class Request:
    """One in-flight generation request."""

    _ids = itertools.count(1)

    def __init__(self, prompt_ids, sampling: SamplingParams | None = None,
                 rid=None):
        self.rid = rid if rid is not None else next(Request._ids)
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.sampling = sampling or SamplingParams()
        # set by Scheduler.abort ("cancelled", "closed"); overrides the
        # eos/length finish reasons
        self.abort_reason = None
        self.state = WAITING
        # observability timestamps (perf_counter_ns, host clocks only)
        self.t_queue_start = time.perf_counter_ns()
        self.t_submit = None
        self.t_first_token = None
        self.t_last_token = None
        self.t_decode_start = None
        self.output_tokens: list[int] = []
        self.blocks: list[int] = []       # pool block ids, in order
        self.num_cached = 0               # tokens materialized in the pool
        # tokens the current admission must materialize before the request
        # is decode-ready; ``prefilling`` is True from admission until the
        # final chunk's logits were sampled
        self.prefill_upto = 0
        self.prefilling = False
        self.admit_seq = -1               # admission order (eviction policy)
        self.evictions = 0
        self._rng = (np.random.RandomState(self.sampling.seed)
                     if self.sampling.do_sample else None)

    @property
    def tokens(self):
        """Prompt + generated so far (the re-prefill prefix on eviction)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.output_tokens, np.int32)])

    @property
    def num_tokens(self):
        return len(self.prompt) + len(self.output_tokens)

    @property
    def last_token(self):
        return (self.output_tokens[-1] if self.output_tokens
                else int(self.prompt[-1]))

    @property
    def finished(self):
        return self.state == FINISHED

    def finish_reason(self):
        if self.state != FINISHED:
            return None
        if self.abort_reason is not None:
            return self.abort_reason
        s = self.sampling
        if (s.eos_token_id is not None and self.output_tokens
                and self.output_tokens[-1] == s.eos_token_id):
            return "eos"
        return "length"

    def should_finish(self):
        s = self.sampling
        if len(self.output_tokens) >= s.max_new_tokens:
            return True
        return (s.eos_token_id is not None and bool(self.output_tokens)
                and self.output_tokens[-1] == s.eos_token_id)


class Scheduler:
    """Slots + FIFO wait queue over a :class:`~.kv_cache.BlockAllocator`.
    ``instance`` names this scheduler's registry label (the owning engine
    passes its own name)."""

    _ids = itertools.count(1)

    def __init__(self, allocator, block_size, max_batch_size,
                 max_prefills_per_step=1, instance=None, prefix_cache=None):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.slots: list[Request | None] = [None] * int(max_batch_size)
        self.waiting: deque[Request] = deque()
        self.max_prefills_per_step = int(max_prefills_per_step)
        self._admit_seq = itertools.count()
        self.instance = instance or f"scheduler#{next(Scheduler._ids)}"
        self.prefix_cache = prefix_cache
        self.version = 0
        # (src, dst) page copies the engine must run before the next pool
        # write — queued by the COW guard, drained by the engine's step
        self.pending_cow: list[tuple[int, int]] = []
        for m in (_M_ADMITTED, _M_EVICTIONS, _M_FINISHED, _M_QUEUED_EXH,
                  _M_PREFIX_REUSED, _M_COW):
            m.inc(0, instance=self.instance)

    @property
    def stats(self):
        inst = self.instance
        return {
            "admitted": int(_M_ADMITTED.value(instance=inst)),
            "evictions": int(_M_EVICTIONS.value(instance=inst)),
            "finished": int(_M_FINISHED.value(instance=inst)),
            "queued_on_exhaustion": int(_M_QUEUED_EXH.value(instance=inst)),
            "prefix_blocks_reused": int(
                _M_PREFIX_REUSED.value(instance=inst)),
            "cow_copies": int(_M_COW.value(instance=inst)),
        }

    @property
    def running(self):
        return [r for r in self.slots if r is not None]

    def has_work(self):
        return bool(self.waiting) or any(self.slots)

    def _free_slot(self):
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def pick_prefills(self):
        """Pop up to ``max_prefills_per_step`` waiting requests that fit (a
        free slot + blocks for prompt and first token, charging only blocks
        the prefix cache cannot supply). The FIFO head that does not fit
        stays queued — no overtaking. Returns ``[(slot, request)]``."""
        picked = []
        while len(picked) < self.max_prefills_per_step and self.waiting:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            if self.prefix_cache is not None:
                matched, mtok = self.prefix_cache.match(req.tokens)
            else:
                matched, mtok = [], 0
            need = -(-(req.num_tokens + 1) // self.block_size) - len(matched)
            if matched:
                # pin the match first: the allocation below may reclaim
                # reusable blocks and must not take the match
                self.allocator.acquire(matched)
            blocks = self.allocator.allocate(need) if need > 0 else []
            if blocks is None:
                if matched:
                    self.allocator.free(matched)
                _M_QUEUED_EXH.inc(instance=self.instance)
                break
            self.waiting.popleft()
            req.blocks = list(matched) + blocks
            req.num_cached = mtok
            req.prefilling = True
            req.prefill_upto = req.num_tokens
            req.state = RUNNING
            req.admit_seq = next(self._admit_seq)
            self.slots[slot] = req
            self.version += 1
            _M_ADMITTED.inc(instance=self.instance)
            if matched:
                _M_PREFIX_REUSED.inc(len(matched), instance=self.instance)
            picked.append((slot, req))
        return picked

    def prefill_work(self, budget=None):
        """Chunk assignments ``[(req, start, n_new_tokens)]`` for this step:
        oldest-admitted prefilling requests first, total NEW tokens bounded
        by ``budget`` (``None`` = unlimited). Non-final chunks are
        block-aligned; the head assignment always gets at least one block."""
        out = []
        remaining = float("inf") if budget is None else int(budget)
        for req in sorted((r for r in self.slots
                           if r is not None and r.prefilling),
                          key=lambda r: r.admit_seq):
            todo = req.prefill_upto - req.num_cached
            if todo <= 0:
                continue
            if remaining <= 0:
                break
            allowed = remaining
            if allowed < todo:
                allowed = int(allowed) // self.block_size * self.block_size
                if allowed == 0:
                    if out:
                        break
                    allowed = self.block_size  # guaranteed progress
            take = int(min(todo, allowed))
            out.append((req, req.num_cached, take))
            remaining -= take
        return out

    def _grow_one(self, req, evicted):
        """One block for ``req``, evicting peers (then self) on exhaustion.
        Returns the block id, or None if ``req`` itself was evicted."""
        while True:
            got = self.allocator.allocate(1)
            if got is not None:
                return got[0]
            peers = [r for r in self.running if r is not req]
            victim = max(peers, key=lambda r: r.admit_seq, default=None)
            if victim is None:
                victim = req  # alone and out of memory: preempt self
            self._evict(victim)
            evicted.append(victim)
            if victim is req:
                return None

    def ensure_decode_room(self):
        """Grow every decode-ready request that is about to write past its
        last block, evicting on exhaustion; queue COW copies for shared
        blocks in the write position. Returns the evicted requests."""
        evicted = []
        for req in list(self.slots):
            if req is None:
                continue
            # the decode step writes ONE token at position num_tokens - 1
            while (req.state == RUNNING
                   and req.num_tokens > len(req.blocks) * self.block_size):
                got = self._grow_one(req, evicted)
                if got is None:
                    break
                req.blocks.append(got)
                self.version += 1
            if req.state != RUNNING or req.prefilling:
                continue
            bi = req.num_cached // self.block_size
            b = req.blocks[bi]
            if self.allocator.is_shared(b):
                got = self._grow_one(req, evicted)
                if got is None:
                    continue
                self.pending_cow.append((b, got))
                self.allocator.free([b])
                req.blocks[bi] = got
                self.version += 1
                _M_COW.inc(instance=self.instance)
            elif (self.prefix_cache is not None
                    and self.prefix_cache.registered(b)):
                # sole holder of published content: the write diverges it
                self.prefix_cache.forget(b)
        return evicted

    def _evict(self, req):
        slot = self.slots.index(req)
        self.allocator.free(req.blocks)
        req.blocks = []
        req.num_cached = 0
        req.prefilling = False
        req.state = WAITING
        req.evictions += 1
        req.t_queue_start = time.perf_counter_ns()
        self.slots[slot] = None
        self.waiting.appendleft(req)
        self.version += 1
        _M_EVICTIONS.inc(instance=self.instance)

    def abort(self, req, reason="cancelled"):
        """Finish ``req`` early, releasing its blocks and slot (running) or
        its queue place (waiting). Idempotent on finished requests. Not
        counted as ``serving_requests_finished_total``."""
        if req.state == FINISHED:
            return
        if req.state == RUNNING:
            slot = self.slots.index(req)
            if self.pending_cow and req.blocks:
                dying = set(req.blocks)
                self.pending_cow = [(s, d) for s, d in self.pending_cow
                                    if d not in dying]
            if req.blocks:
                self.allocator.free(req.blocks)
            req.blocks = []
            self.slots[slot] = None
            self.version += 1
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        req.prefilling = False
        req.abort_reason = reason
        req.state = FINISHED

    def finish(self, req):
        slot = self.slots.index(req)
        self.allocator.free(req.blocks)
        req.blocks = []
        req.state = FINISHED
        self.slots[slot] = None
        self.version += 1
        _M_FINISHED.inc(instance=self.instance)
