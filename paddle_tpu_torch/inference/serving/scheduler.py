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
  window (one position, or a decode window's lookahead) that another
  request can see (refcount > 1) is replaced by a private copy (queued on
  ``pending_cow`` for the engine to execute);
* **graceful degradation**: a request that cannot get blocks stays queued
  (FIFO). If a RUNNING request cannot grow by one block, the most recently
  admitted running request is evicted (blocks freed, re-queued at the
  FRONT, re-prefilled later from its prompt + generated prefix);
* **preloaded admission** (the disaggregated handoff and the host tier's
  revival): a request carrying imported pages (``Request.preloaded``) is
  admitted decode-ready, charging full blocks and skipping prefix
  matching; the engine imports the pages before the step decodes;
* **the host KV tier** (``kv_tier``, a :class:`~.kv_cache.HostKVTier`):
  eviction spills a decode-ready victim's pages instead of dropping them,
  and its re-admission revives them as a ``preloaded`` import; admission
  also extends a device prefix match into host-resident chain links,
  queued on ``pending_revive`` for the engine to import;
* **multi-tenant QoS**: requests carry a ``tenant`` and a ``tier``
  (``latency`` | ``batch``). Once a tenant is configured
  (:meth:`Scheduler.configure_tenant`) or non-default traffic is queued,
  admission is weighted-fair: the latency tier strictly outranks batch,
  within a tier the backlogged tenant with the lowest virtual time
  (served tokens / weight) admits next, and a tenant's own requests keep
  their FIFO order, so QoS moves *when* work runs, never *which* tokens.
  A :class:`TenantQuota` (a rolling-window token-rate bucket) DEFERS an
  over-quota tenant's admissions, never sheds them. Batch-tier requests
  yield their decode slots to waiting latency work through the normal
  eviction (which spills decode-ready pages to the host tier) and
  re-admit later. Default traffic keeps the exact FIFO order.

``version`` counts every block-table mutation so the engine can cache the
device block-table tensor against it. Deadlines are the engine's
(``LLMEngine._expire_deadlines`` aborts through :meth:`Scheduler.abort`).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np

from ...observability import metrics as _obs_metrics

__all__ = ["SamplingParams", "Request", "Scheduler", "TenantQuota",
           "TIER_LATENCY", "TIER_BATCH"]

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
# multi-tenant QoS
_M_THROTTLED = _obs_metrics.counter(
    "serving_quota_throttled_total",
    "admission passes that deferred every waiting tenant on its token-"
    "rate quota (deferred, never shed)")
_M_BATCH_YIELD = _obs_metrics.counter(
    "serving_batch_yields_total",
    "batch-tier requests preempted (spilled to the host tier when "
    "decode-ready) so latency-tier work could take their slot")
_M_TENANT_TOKENS = _obs_metrics.counter(
    "serving_tenant_tokens_total",
    "tokens served per tenant (prefill chunks + decode emissions); the "
    "tenant label is bounded to configured tenant names plus 'default'")

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"
TIER_LATENCY, TIER_BATCH = "latency", "batch"


class TenantQuota:
    """Per-tenant token-rate quota: a rolling-window leaky bucket over
    SERVED tokens (events pruned past the window; an injectable ``clock``,
    so tests never sleep). ``rate_tokens_per_s * window_s`` tokens may be
    served per rolling ``window_s``. The scheduler charges tokens as they
    are served and gates *admission* on the bucket: an over-quota
    tenant's waiting requests are deferred, never shed. One in-flight
    request may overshoot: throttling mid-decode would hold a decode slot
    idle. :meth:`retry_after` estimates the wait."""

    def __init__(self, rate_tokens_per_s, window_s=1.0,
                 clock=time.monotonic):
        self.rate = float(rate_tokens_per_s)
        if self.rate <= 0:
            raise ValueError(
                f"rate_tokens_per_s must be > 0, got {rate_tokens_per_s}")
        self.window_s = float(window_s)
        self.limit = self.rate * self.window_s
        self._clock = clock
        self._events: deque[tuple[float, float]] = deque()
        self._used = 0.0

    def _prune(self, now):
        ev = self._events
        while ev and now - ev[0][0] > self.window_s:
            self._used -= ev.popleft()[1]

    @property
    def used(self):
        """Tokens served inside the current rolling window."""
        self._prune(self._clock())
        return self._used

    def admissible(self):
        return self.used < self.limit

    def note(self, n):
        """Charge ``n`` served tokens to the window."""
        now = self._clock()
        self._prune(now)
        self._events.append((now, float(n)))
        self._used += float(n)

    def retry_after(self):
        """Seconds until the bucket re-admits (0.0 while admissible)."""
        now = self._clock()
        self._prune(now)
        if self._used < self.limit:
            return 0.0
        over = self._used - self.limit
        expired = 0.0
        for t, n in self._events:
            expired += n
            if expired > over:
                return max(0.0, t + self.window_s - now)
        return self.window_s


class _TenantState:
    """Per-tenant accounting: the weighted-fair virtual time plus the
    optional rate quota. ``configured`` marks tenants registered through
    ``configure_tenant``; only their names label the token counter (the
    cardinality bound), others count under ``default``."""

    __slots__ = ("name", "weight", "quota", "served_tokens", "vtime",
                 "configured")

    def __init__(self, name, weight=1.0, quota=None, vtime=0.0):
        self.name = str(name)
        self.weight = float(weight)
        self.quota = quota
        self.served_tokens = 0
        self.vtime = float(vtime)
        self.configured = False


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
                 rid=None, deadline=None, tenant=None, tier=None):
        self.rid = rid if rid is not None else next(Request._ids)
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.sampling = sampling or SamplingParams()
        # QoS: who the request bills to and how urgent it is. Latency
        # requests hold their slots; batch requests admit behind latency
        # work and yield their slots under pressure
        self.tenant = str(tenant) if tenant else "default"
        tier = tier or TIER_LATENCY
        if tier not in (TIER_LATENCY, TIER_BATCH):
            raise ValueError(f"unknown tier {tier!r}; expected "
                             f"{TIER_LATENCY!r} or {TIER_BATCH!r}")
        self.tier = tier
        # absolute wall-clock deadline (time.time() seconds): the engine
        # checks it at admission and at every step boundary
        self.deadline = float(deadline) if deadline is not None else None
        # set by Scheduler.abort ("timeout", "cancelled", "closed");
        # overrides the eos/length finish reasons
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
        # speculative decoding: tokens materialized in the DRAFT pool
        self.draft_cached = 0
        self.admit_seq = -1               # admission order (eviction policy)
        self.evictions = 0
        # disaggregated handoff: pages computed elsewhere, imported at
        # admission instead of prefilling; cleared after the one import
        self.preloaded = None
        # host tier: the tier key while this request's pages sit there
        # (set at spill-eviction); ``revived_from_tier`` marks an admission
        # whose ``preloaded`` payload came back FROM the tier
        self.spill_key = None
        self.revived_from_tier = False
        # the last logits row sampled from, with the engine's
        # ``capture_logits=True`` ([V] fp32 numpy)
        self.last_logits = None
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
    passes its own name); ``prefix_cache`` arms prefix-aware admission and
    ``kv_tier`` the host tier's spills and revivals."""

    _ids = itertools.count(1)

    def __init__(self, allocator, block_size, max_batch_size,
                 max_prefills_per_step=1, instance=None, prefix_cache=None,
                 kv_tier=None):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.slots: list[Request | None] = [None] * int(max_batch_size)
        self.waiting: deque[Request] = deque()
        self.max_prefills_per_step = int(max_prefills_per_step)
        self._admit_seq = itertools.count()
        self.instance = instance or f"scheduler#{next(Scheduler._ids)}"
        self.prefix_cache = prefix_cache
        self.kv_tier = kv_tier
        # (req, block_id, chain_hash) host-prefix revivals the engine must
        # import and adopt before this step's prefill work
        self.pending_revive: list[tuple] = []
        # spill revivals that missed (the tier LRU-dropped the entry, or
        # its read-back CRC check freed it): each one degrades to
        # re-prefill
        self.revive_misses = 0
        self.version = 0
        # (src, dst) page copies the engine must run before the next pool
        # write — queued by the COW guard, drained by the engine's step
        self.pending_cow: list[tuple[int, int]] = []
        # per-tenant QoS state, created per tenant name on first sight;
        # weighted-fair admission arms once a tenant is configured or
        # non-default traffic is queued
        self.tenants: dict[str, _TenantState] = {}
        self._qos_configured = False
        for m in (_M_ADMITTED, _M_EVICTIONS, _M_FINISHED, _M_QUEUED_EXH,
                  _M_PREFIX_REUSED, _M_COW, _M_THROTTLED, _M_BATCH_YIELD):
            m.inc(0, instance=self.instance)
        _M_TENANT_TOKENS.inc(0, instance=self.instance, tenant="default")

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
            "quota_throttled": int(_M_THROTTLED.value(instance=inst)),
            "batch_yields": int(_M_BATCH_YIELD.value(instance=inst)),
            "revive_misses": self.revive_misses,
        }

    # -- multi-tenant QoS -----------------------------------------------
    def configure_tenant(self, name, *, weight=1.0, rate_tokens_per_s=None,
                         window_s=1.0, clock=time.monotonic):
        """Register (or refresh) tenant ``name``: its weighted-fair
        ``weight`` and an optional :class:`TenantQuota`. The first
        configured tenant arms QoS admission; until then it is FIFO."""
        if float(weight) <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        st = self._tenant(name)
        st.weight = float(weight)
        st.quota = (TenantQuota(rate_tokens_per_s, window_s, clock=clock)
                    if rate_tokens_per_s else None)
        st.configured = True
        self._qos_configured = True
        return st

    def _tenant(self, name):
        st = self.tenants.get(name)
        if st is None:
            # a tenant joining late starts at the LOWEST live virtual time,
            # not 0, or it would monopolize admission until it caught up
            vt = min((s.vtime for s in self.tenants.values()), default=0.0)
            st = self.tenants[name] = _TenantState(name, vtime=vt)
        return st

    def _qos_active(self):
        return self._qos_configured or any(
            r.tier != TIER_LATENCY or r.tenant != "default"
            for r in self.waiting)

    def note_served(self, req, n):
        """Charge ``n`` served tokens (a prefill chunk or decode emissions)
        to the request's tenant: its virtual time advances by
        ``n / weight``, its quota and the per-tenant counter by ``n``.
        Host arithmetic only."""
        if n <= 0:
            return
        st = self._tenant(req.tenant)
        st.served_tokens += int(n)
        st.vtime += n / st.weight
        if st.quota is not None:
            st.quota.note(n)
        _M_TENANT_TOKENS.inc(
            n, instance=self.instance,
            tenant=st.name if st.configured else "default")

    def _admissible(self, st):
        return st.quota is None or st.quota.admissible()

    def _next_admission(self):
        """The ``waiting`` position to admit next under QoS, or None when
        every waiting tenant is quota-deferred: the latency tier outranks
        batch; within a tier the tenant with the lowest virtual time wins
        and its EARLIEST queued request goes (per-tenant FIFO);
        over-quota tenants are skipped (deferred, never shed)."""
        throttled = False
        for tier in (TIER_LATENCY, TIER_BATCH):
            best = None
            seen = set()
            for pos, req in enumerate(self.waiting):
                if req.tier != tier or req.tenant in seen:
                    continue
                seen.add(req.tenant)
                st = self._tenant(req.tenant)
                if not self._admissible(st):
                    throttled = True
                    continue
                if best is None or (st.vtime, pos) < best:
                    best = (st.vtime, pos)
            if best is not None:
                return best[1]
        if throttled:
            _M_THROTTLED.inc(instance=self.instance)
        return None

    def _yield_batch_slot(self):
        """The slots are full and a latency request waits admissibly:
        preempt the most recently admitted batch-tier running request
        through :meth:`_evict` (which spills decode-ready pages to the
        host tier, so its revival is a page import). Returns True when a
        slot was freed."""
        wants_latency = any(
            r.tier == TIER_LATENCY and self._admissible(self._tenant(
                r.tenant))
            for r in self.waiting)
        if not wants_latency:
            return False
        batch = [r for r in self.running if r.tier == TIER_BATCH]
        if not batch:
            return False
        # decode-ready victims first: their pages spill (a mid-prefill
        # victim's pages are incomplete, so it re-prefills)
        ready = [r for r in batch if not r.prefilling]
        victim = max(ready or batch, key=lambda r: r.admit_seq)
        self._evict(victim)
        _M_BATCH_YIELD.inc(instance=self.instance)
        return True

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
        the prefix cache cannot supply). Default traffic takes the FIFO
        head; with QoS active :meth:`_next_admission` chooses, and a full
        slot set may first make room by yielding a batch-tier request. The
        chosen request that does not fit stays queued — no overtaking
        within the step. A request spilled to the host tier
        revives as a ``preloaded`` import (re-prefill if the tier dropped
        it); a preloaded request is admitted decode-ready; otherwise
        host-resident chain links continuing the device match are queued on
        ``pending_revive``. Returns ``[(slot, request)]``."""
        picked = []
        while len(picked) < self.max_prefills_per_step and self.waiting:
            qos = self._qos_active()
            if self._free_slot() is None:
                # under latency pressure a full slot set preempts batch
                # work to the host tier instead of queueing behind it
                if not (qos and self._yield_batch_slot()):
                    break
            pos = self._next_admission() if qos else 0
            if pos is None:
                break  # every waiting tenant is quota-deferred
            req = self.waiting[pos]
            if req.spill_key is not None and self.kv_tier is not None:
                payload = self.kv_tier.peek_request(req.spill_key)
                if payload is not None:
                    req.preloaded = payload
                    req.revived_from_tier = True
                else:
                    # LRU-dropped, or freed by the read-back CRC check:
                    # both degrade to re-prefill, counted
                    self.revive_misses += 1
                    req.spill_key = None
            # preloaded requests charge full blocks and skip prefix
            # matching: their pages arrive by import (the engine registers
            # the imported full blocks afterwards)
            host_hits = []
            if self.prefix_cache is not None and req.preloaded is None:
                matched, mtok, host_hits = self.prefix_cache.match_with_tier(
                    req.tokens, self.kv_tier)
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
            del self.waiting[pos]
            slot = self._free_slot()
            req.blocks = list(matched) + blocks
            if req.preloaded is not None:
                # decode-ready: the pages cover every token but the last
                # (whose K/V the first decode writes). The draft pool is
                # not transferred; its catch-up re-derives the positions
                req.num_cached = int(req.preloaded["covered"])
                req.draft_cached = 0
                req.prefilling = False
                if req.revived_from_tier:
                    self.kv_tier.drop_request(req.spill_key)
                    req.spill_key = None
            else:
                # host-resident chain links continue the device match: the
                # engine imports them before prefill, so num_cached starts
                # past them. The draft pool mirrors only the DEVICE match
                for j, h in enumerate(host_hits):
                    self.pending_revive.append((req, blocks[j], h))
                req.num_cached = mtok + len(host_hits) * self.block_size
                # the draft pool shares the matched blocks' ids, and every
                # target chunk is mirrored into it, so it holds the same
                # prefix
                req.draft_cached = mtok
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
            # batch-tier peers yield first: growing latency work never
            # preempts a latency peer while batch work holds slots
            batch = [r for r in peers if r.tier == TIER_BATCH]
            victim = max(batch or peers, key=lambda r: r.admit_seq,
                         default=None)
            if victim is None:
                victim = req  # alone and out of memory: preempt self
            if victim.tier == TIER_BATCH and req.tier == TIER_LATENCY:
                _M_BATCH_YIELD.inc(instance=self.instance)
            self._evict(victim)
            evicted.append(victim)
            if victim is req:
                return None

    def ensure_decode_room(self, extra=0, extra_for=None):
        """Grow every decode-ready request that is about to write past its
        last block, evicting on exhaustion; queue COW copies for shared
        blocks in the write window. ``extra`` reserves that many lookahead
        positions beyond the one the next decode writes; ``extra_for`` (a
        ``Request -> int`` callable) overrides it per request: a decode
        window of k steps reserves ``min(k, tokens remaining) - 1``, so a
        request one token from its cap never grows a block it will not
        write. Returns the evicted requests."""
        evicted = []
        for req in list(self.slots):
            if req is None:
                continue
            # mid-prefill requests already own blocks for prompt + 1 tokens
            lookahead = 0 if req.prefilling else int(
                extra_for(req) if extra_for is not None else extra)
            # the decode step writes ONE token at position num_tokens - 1
            # (plus ``lookahead`` more), so capacity num_tokens + lookahead
            # is exactly enough
            while (req.state == RUNNING and req.num_tokens + lookahead
                    > len(req.blocks) * self.block_size):
                got = self._grow_one(req, evicted)
                if got is None:
                    break
                req.blocks.append(got)
                self.version += 1
            if req.state != RUNNING or req.prefilling:
                continue
            # COW guard over the write window [num_cached, num_cached +
            # lookahead]: a shared block is never written in place
            first = req.num_cached // self.block_size
            last = min((req.num_cached + lookahead) // self.block_size,
                       len(req.blocks) - 1)
            for bi in range(first, last + 1):
                b = req.blocks[bi]
                if self.allocator.is_shared(b):
                    got = self._grow_one(req, evicted)
                    if got is None:
                        break
                    self.pending_cow.append((b, got))
                    self.allocator.free([b])
                    req.blocks[bi] = got
                    self.version += 1
                    _M_COW.inc(instance=self.instance)
                elif (self.prefix_cache is not None
                        and self.prefix_cache.registered(b)):
                    # sole holder of published content: the write
                    # diverges it
                    self.prefix_cache.forget(b)
        return evicted

    def trim_to_capacity(self, req, extra=0):
        """Free tail blocks beyond what ``req.num_tokens + extra`` needs
        (the speculative rollback: a rejected window leaves lookahead
        blocks behind). ``extra`` keeps the next verify window's room, so
        a request near a block boundary does not free a block that
        ``ensure_decode_room`` takes again one step later."""
        keep = max(-(-(req.num_tokens + int(extra)) // self.block_size), 1)
        if len(req.blocks) > keep:
            extras = req.blocks[keep:]
            del req.blocks[keep:]
            self.allocator.free(extras)
            self.version += 1

    def _evict(self, req):
        slot = self.slots.index(req)
        # host tier: spill a decode-ready victim's pages BEFORE its blocks
        # free. The snapshot's gathers are enqueued on the pools' stream
        # ahead of any later write, so reusing the blocks cannot corrupt
        # the spilled copy. Mid-prefill victims are not spilled (their
        # pages are incomplete); a failed or over-budget spill degrades to
        # plain recompute preemption
        if (self.kv_tier is not None and not req.prefilling
                and req.num_cached > 0
                and req.num_cached == req.num_tokens - 1):
            if self.kv_tier.spill_request(req.rid, req.blocks,
                                          req.num_cached,
                                          tenant=req.tenant):
                req.spill_key = req.rid
        self.allocator.free(req.blocks)
        req.blocks = []
        req.num_cached = 0
        req.draft_cached = 0
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
        # unwind queued device-page work referencing the dying request: a
        # pending revive would index its emptied block list (and its host
        # pages, pinned for this admission, would sit in the tier forever)
        if self.pending_revive:
            mine = [t for t in self.pending_revive if t[0] is req]
            if mine:
                self.pending_revive = [t for t in self.pending_revive
                                       if t[0] is not req]
                for _, _, h in mine:
                    if self.kv_tier is not None:
                        self.kv_tier.pop_prefix(h)
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
        req.preloaded = None  # never-imported handoff pages die here
        if req.spill_key is not None and self.kv_tier is not None:
            self.kv_tier.drop_request(req.spill_key)  # host pages too
            req.spill_key = None
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
