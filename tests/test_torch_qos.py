"""The port's deadlines, tenants and QoS tiers on the CPU: the single-engine
cases of ``tests/test_qos.py`` (the ``TenantQuota`` bucket, weighted-fair
two-tier admission, batch-tier yields, abort against the host tier, tenant
shares of the tier and the prefix cache, the typed errors, the engine's
QoS), ``tests/test_serving.py``'s ``TestEngineDeadlines`` and
``tests/test_disagg.py``'s deadline cases proved again in the port; plus
the cross-package cases: one admission script through both packages'
``Scheduler``s gives the same admissions, yields and served tokens, and the
contended engine arm (two tenants, both tiers, a quota on a step clock, a
deadline that expires at a given step) gives the same tokens and
``tenant_tokens`` in both packages on fp32 llama_tiny (tolerance: exact)."""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference.serving as jax_serving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
import paddle_tpu_torch.inference.serving as port_serving
from paddle_tpu_torch.inference.serving import (
    TIER_BATCH, TIER_LATENCY, BlockAllocator, DeadlineInfeasibleError,
    HostKVTier, LLMEngine, PagedKVCache, PrefixCache, Request,
    RequestTimeoutError, SamplingParams, Scheduler, TenantQuota,
    TenantQuotaExceededError)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.observability import metrics as om

# the reference's handoff engine (tests/test_disagg.py)
ENGINE_KW = dict(num_blocks=64, block_size=8, max_batch_size=4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def model(models):
    return models[1]


def engine(m, **kw):
    return LLMEngine(m, device="cpu", ingest_async=False, **kw)


def prompts_fixed(cfg, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _mk_req(n_prompt, tenant=None, tier=None, **samp):
    return Request(np.arange(1, n_prompt + 1, dtype=np.int32),
                   SamplingParams(**samp) if samp else None,
                   tenant=tenant, tier=tier)


# ---------------------------------------------------------------------------
# TenantQuota: the leaky bucket (injectable clock; no sleeps)
# ---------------------------------------------------------------------------

class TestTenantQuota:
    def test_validates_rate(self):
        with pytest.raises(ValueError):
            TenantQuota(0)
        with pytest.raises(ValueError):
            TenantQuota(-5.0)

    def test_window_prunes_and_readmits(self):
        t = [0.0]
        q = TenantQuota(10, window_s=1.0, clock=lambda: t[0])
        assert q.admissible() and q.used == 0
        q.note(10)
        assert not q.admissible() and q.used == 10
        t[0] = 0.5
        assert not q.admissible()
        t[0] = 1.01
        assert q.admissible() and q.used == 0

    def test_overshoot_allowed_but_gates_admission(self):
        t = [0.0]
        q = TenantQuota(10, window_s=1.0, clock=lambda: t[0])
        q.note(25)
        assert q.used == 25 and not q.admissible()

    def test_retry_after_estimates_drain(self):
        t = [0.0]
        q = TenantQuota(10, window_s=1.0, clock=lambda: t[0])
        assert q.retry_after() == 0.0
        q.note(10)
        assert q.retry_after() == pytest.approx(1.0)
        t[0] = 0.6
        assert q.retry_after() == pytest.approx(0.4)
        t[0] = 1.01
        assert q.retry_after() == 0.0

    def test_retry_after_walks_events_oldest_first(self):
        t = [0.0]
        q = TenantQuota(10, window_s=1.0, clock=lambda: t[0])
        q.note(8)
        t[0] = 0.5
        q.note(8)  # used 16, over by 6: the FIRST event's expiry frees 8
        assert q.retry_after() == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# weighted-fair two-tier admission (host only)
# ---------------------------------------------------------------------------

class TestWeightedFairScheduler:
    def _sched(self, num_blocks=64, block_size=4, slots=1, prefills=1,
               **kw):
        return Scheduler(BlockAllocator(num_blocks), block_size, slots,
                         prefills, **kw)

    def _serve_loop(self, s, n_admissions, cost=12):
        order = []
        for _ in range(n_admissions):
            picked = s.pick_prefills()
            if not picked:
                break
            ((_, req),) = picked
            req.num_cached = req.num_tokens
            s.note_served(req, cost)
            s.finish(req)
            order.append(req)
        return order

    def test_default_traffic_stays_fifo(self):
        s = self._sched(slots=2, prefills=4)
        reqs = [_mk_req(3) for _ in range(3)]
        s.waiting.extend(reqs)
        assert not s._qos_active()
        assert [r for _, r in s.pick_prefills()] == reqs[:2]

    def test_weighted_fair_ratio_one_to_three(self):
        s = self._sched()
        s.configure_tenant("bronze", weight=1.0)
        s.configure_tenant("gold", weight=3.0)
        for _ in range(40):
            s.waiting.append(_mk_req(3, tenant="bronze"))
            s.waiting.append(_mk_req(3, tenant="gold"))
        order = self._serve_loop(s, 40)
        served = {"bronze": 0, "gold": 0}
        for r in order:
            served[r.tenant] += 1
        assert 28 <= served["gold"] <= 32, served
        assert 8 <= served["bronze"] <= 12, served
        ratio = (s.tenants["gold"].served_tokens
                 / s.tenants["bronze"].served_tokens)
        assert 2.5 <= ratio <= 3.5, ratio

    def test_starvation_freedom_under_weight_flood(self):
        s = self._sched()
        s.configure_tenant("small", weight=1.0)
        s.configure_tenant("flood", weight=100.0)
        for _ in range(150):
            s.waiting.append(_mk_req(3, tenant="flood"))
        s.waiting.append(_mk_req(3, tenant="small"))
        s.waiting.append(_mk_req(3, tenant="small"))
        order = self._serve_loop(s, 130)
        assert len([r for r in order if r.tenant == "small"]) == 2
        assert sum(r.tenant == "flood" for r in order) > 100

    def test_per_tenant_order_stays_fifo(self):
        s = self._sched()
        s.configure_tenant("a", weight=1.0)
        s.configure_tenant("b", weight=2.0)
        a_reqs = [_mk_req(3, tenant="a") for _ in range(5)]
        b_reqs = [_mk_req(3, tenant="b") for _ in range(5)]
        for ra, rb in zip(a_reqs, b_reqs):
            s.waiting.append(rb)
            s.waiting.append(ra)
        order = self._serve_loop(s, 10)
        assert [r for r in order if r.tenant == "a"] == a_reqs
        assert [r for r in order if r.tenant == "b"] == b_reqs

    def test_latency_tier_strictly_outranks_batch(self):
        s = self._sched()
        s.configure_tenant("t", weight=1.0)
        batch = [_mk_req(3, tenant="t", tier=TIER_BATCH) for _ in range(3)]
        lat = [_mk_req(3, tenant="t", tier=TIER_LATENCY) for _ in range(3)]
        s.waiting.extend(batch)
        s.waiting.extend(lat)
        assert self._serve_loop(s, 6) == lat + batch

    def test_late_joiner_starts_at_live_virtual_time(self):
        s = self._sched()
        s.configure_tenant("old", weight=1.0)
        for _ in range(10):
            s.waiting.append(_mk_req(3, tenant="old"))
        self._serve_loop(s, 10)
        assert s.tenants["old"].vtime > 0
        s.configure_tenant("new", weight=1.0)
        assert s.tenants["new"].vtime == pytest.approx(
            s.tenants["old"].vtime)

    def test_quota_defers_never_sheds(self):
        t = [0.0]
        s = self._sched()
        s.configure_tenant("acme", rate_tokens_per_s=10,
                           clock=lambda: t[0])
        req = _mk_req(3, tenant="acme")
        s.waiting.append(req)
        s.tenants["acme"].quota.note(10)
        assert s.pick_prefills() == []
        assert s.stats["quota_throttled"] >= 1
        assert om.REGISTRY.get("serving_quota_throttled_total").value(
            instance=s.instance) >= 1
        assert list(s.waiting) == [req]  # deferred, NOT shed
        t[0] = 1.01
        assert [r for _, r in s.pick_prefills()] == [req]

    def test_throttled_tenant_does_not_block_others(self):
        t = [0.0]
        s = self._sched()
        s.configure_tenant("hog", rate_tokens_per_s=10, clock=lambda: t[0])
        s.configure_tenant("quiet", weight=1.0)
        hog, quiet = _mk_req(3, tenant="hog"), _mk_req(3, tenant="quiet")
        s.waiting.extend([hog, quiet])
        s.tenants["hog"].quota.note(999)
        assert [r for _, r in s.pick_prefills()] == [quiet]
        assert list(s.waiting) == [hog]

    def test_served_tokens_feed_quota_and_vtime(self):
        t = [0.0]
        s = self._sched()
        st = s.configure_tenant("acme", weight=2.0, rate_tokens_per_s=100,
                                clock=lambda: t[0])
        s.note_served(_mk_req(3, tenant="acme"), 10)
        assert st.served_tokens == 10
        assert st.vtime == pytest.approx(5.0)
        assert st.quota.used == 10

    def test_batch_yields_slot_to_latency_pressure(self):
        s = self._sched(slots=1)
        s.configure_tenant("t", weight=1.0)
        batch = _mk_req(3, tenant="t", tier=TIER_BATCH)
        s.waiting.append(batch)
        ((_, got),) = s.pick_prefills()
        assert got is batch
        lat = _mk_req(3, tenant="t", tier=TIER_LATENCY)
        s.waiting.append(lat)
        assert [r for _, r in s.pick_prefills()] == [lat]
        assert batch.state == "waiting" and batch.evictions == 1
        assert s.stats["batch_yields"] == 1
        assert om.REGISTRY.get("serving_batch_yields_total").value(
            instance=s.instance) == 1

    def test_no_yield_without_latency_pressure(self):
        s = self._sched(slots=1)
        s.configure_tenant("t", weight=1.0)
        b1 = _mk_req(3, tenant="t", tier=TIER_BATCH)
        s.waiting.append(b1)
        s.pick_prefills()
        s.waiting.append(_mk_req(3, tenant="t", tier=TIER_BATCH))
        assert s.pick_prefills() == []
        assert b1.state == "running" and s.stats["batch_yields"] == 0

    def test_decode_growth_prefers_batch_victim(self):
        s = self._sched(num_blocks=8, block_size=2, slots=2, prefills=2)
        lat = _mk_req(5, tenant="default", tier=TIER_LATENCY)
        bat = _mk_req(7, tenant="default", tier=TIER_BATCH)
        s.waiting.extend([lat, bat])
        assert len(s.pick_prefills()) == 2  # 3 + 4 blocks: the pool is full
        lat.num_cached = 6
        lat.output_tokens.extend([1, 1])  # needs a 4th block; none free
        s.ensure_decode_room()
        assert bat.state == "waiting" and bat.evictions == 1
        assert lat.state == "running" and len(lat.blocks) == 4
        assert s.stats["batch_yields"] == 1

    def test_configure_tenant_validates_weight(self):
        s = self._sched()
        with pytest.raises(ValueError):
            s.configure_tenant("x", weight=0)
        with pytest.raises(ValueError):
            s.configure_tenant("x", weight=-1.5)

    def test_request_validates_tier(self):
        with pytest.raises(ValueError, match="tier"):
            _mk_req(3, tier="bulk")
        r = _mk_req(3)
        assert (r.tenant, r.tier, r.deadline) == ("default", TIER_LATENCY,
                                                  None)


# ---------------------------------------------------------------------------
# one admission script through both packages' schedulers
# ---------------------------------------------------------------------------

def _admission_script(pkg, seed):
    """Drive ``pkg``'s host-only ``Scheduler`` through a seeded script:
    tenants with weights and a quota on an injected clock, requests of
    both tiers arriving over time, a one-step prefill at admission, one
    token a step for every running request, growth under a small pool.
    Returns the admission/eviction event list, the served tokens per
    tenant and the stats."""
    rng = np.random.RandomState(seed)
    t = [0.0]
    s = pkg.Scheduler(pkg.BlockAllocator(8), 4, 2, 2)
    s.configure_tenant("gold", weight=3.0)
    s.configure_tenant("bronze", weight=1.0, rate_tokens_per_s=20,
                       window_s=1.0, clock=lambda: t[0])
    reqs = []
    for i in range(18):
        r = pkg.Request(
            rng.randint(0, 500, rng.randint(2, 11)).astype(np.int32),
            pkg.SamplingParams(max_new_tokens=int(rng.randint(2, 7))),
            tenant=("gold", "bronze", "default")[rng.randint(3)],
            tier=(pkg.TIER_LATENCY, pkg.TIER_BATCH)[rng.randint(2)])
        r.idx = i
        reqs.append(r)
    events = []
    pending = list(reqs)
    for step in range(400):
        for _ in range(2):
            if pending:
                s.waiting.append(pending.pop(0))
        before = {r.idx: r.evictions for r in reqs}
        for _, r in s.pick_prefills():
            events.append(("admit", step, r.idx))
            r.num_cached = r.num_tokens
            r.prefilling = False
            s.note_served(r, r.num_tokens)
            r.output_tokens.append(7)
            s.note_served(r, 1)
            if r.should_finish():
                s.finish(r)
        for r in s.ensure_decode_room():
            events.append(("evict", step, r.idx))
        for r in list(s.running):
            if r.prefilling:
                continue
            r.num_cached += 1
            r.output_tokens.append(7)
            s.note_served(r, 1)
            if r.should_finish():
                s.finish(r)
        events += [("yield", step, r.idx) for r in reqs
                   if r.evictions > before[r.idx]
                   and ("evict", step, r.idx) not in events]
        t[0] += 0.1
        if not pending and not s.has_work():
            break
    served = {n: st.served_tokens for n, st in s.tenants.items()}
    stats = {k: s.stats[k] for k in ("admitted", "evictions", "finished",
                                     "quota_throttled", "batch_yields")}
    return events, served, stats


@pytest.mark.parametrize("seed", [4, 5, 11])
def test_admission_order_matches_the_reference(seed):
    """The same admissions, yields, growth evictions, served tokens and
    counters in both packages; each seed's script yields a batch request
    and throttles a tenant or evicts on growth."""
    want = _admission_script(jax_serving, seed)
    got = _admission_script(port_serving, seed)
    assert got == want
    events, _, stats = got
    assert stats["finished"] == 18
    assert stats["batch_yields"] > 0
    assert stats["quota_throttled"] > 0 or any(e[0] == "evict"
                                               for e in events)


# ---------------------------------------------------------------------------
# abort against the host tier
# ---------------------------------------------------------------------------

def _pool(num_blocks=8, block_size=4, fill_seed=None):
    cache = PagedKVCache(llama_tiny(), num_blocks, block_size, device="cpu")
    if fill_seed is not None:
        rng = np.random.RandomState(fill_seed)
        for p in cache.k + cache.v:
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return cache


class TestAbortDropsTierState:
    def test_abort_drops_spilled_request_pages(self):
        cache = _pool(fill_seed=3)
        tier = HostKVTier(cache, 16, async_transfer=False)
        s = Scheduler(cache.allocator, cache.block_size, 1, kv_tier=tier)
        req = _mk_req(6, max_new_tokens=8)
        s.waiting.append(req)
        assert len(s.pick_prefills()) == 1
        req.num_cached = req.num_tokens - 1
        req.prefilling = False
        s._evict(req)
        assert req.spill_key == req.rid
        assert tier.peek_request(req.rid) is not None
        assert tier.tenant_blocks_in_use("default") == 2
        s.abort(req, reason="timeout")
        assert tier.peek_request(req.rid) is None
        assert req.spill_key is None
        assert tier.tenant_blocks_in_use("default") == 0
        assert req.finish_reason() == "timeout"
        assert s.allocator.num_free == s.allocator.num_blocks - 1
        tier.close()

    def test_abort_purges_pending_revive_and_tier_pins(self):
        cache = _pool(fill_seed=5)
        tier = HostKVTier(cache, 16, async_transfer=False)
        s = Scheduler(cache.allocator, cache.block_size, 2, kv_tier=tier)
        h1, h2 = b"h" * 20, b"g" * 20
        tier.spill_blocks([(2, h1), (3, h2)])
        dying, alive = _mk_req(6), _mk_req(6)
        s.waiting.extend([dying, alive])
        s.pick_prefills()
        s.pick_prefills()
        s.pending_revive = [(dying, dying.blocks[0], h1),
                            (alive, alive.blocks[0], h2)]
        s.abort(dying)
        assert s.pending_revive == [(alive, alive.blocks[0], h2)]
        assert tier.pop_prefix(h1) is None
        assert tier.has_prefix(h2)
        tier.close()

    def test_abort_purges_pending_cow_to_dying_blocks(self):
        s = Scheduler(BlockAllocator(16), 4, 2)
        req, other = _mk_req(6), _mk_req(6)
        s.waiting.extend([req, other])
        s.pick_prefills()
        s.pick_prefills()
        s.pending_cow = [(99, req.blocks[0]), (98, other.blocks[0])]
        s.abort(req)
        assert s.pending_cow == [(98, other.blocks[0])]


# ---------------------------------------------------------------------------
# per-tenant shares of the host tier and the prefix cache
# ---------------------------------------------------------------------------

class TestTenantCacheShares:
    def test_host_tier_share_evicts_tenants_own_oldest(self):
        tier = HostKVTier(_pool(fill_seed=1), 16, async_transfer=False)
        tier.set_tenant_share("a", 2)
        a1, a2, a3, b1 = b"a1" * 10, b"a2" * 10, b"a3" * 10, b"b1" * 10
        tier.spill_blocks([(1, a1)], ["a"])
        tier.spill_blocks([(2, a2)], ["a"])
        tier.spill_blocks([(3, b1)], ["b"])
        tier.spill_blocks([(4, a3)], ["a"])  # a over its share: a1 goes
        assert not tier.has_prefix(a1)
        assert tier.has_prefix(a2) and tier.has_prefix(a3)
        assert tier.has_prefix(b1)
        assert tier.tenant_blocks_in_use("a") == 2
        assert tier.tenant_blocks_in_use("b") == 1
        assert len(tier) == 3
        tier.close()

    def test_host_tier_share_rejects_oversized_entry(self):
        cache = _pool(fill_seed=2)
        tier = HostKVTier(cache, 16, async_transfer=False)
        tier.set_tenant_share("c", 1)
        assert not tier.spill_request(71, [1, 2], 2 * cache.block_size,
                                      tenant="c")
        assert tier.tenant_blocks_in_use("c") == 0
        tier.close()

    def test_host_tier_share_validation(self):
        tier = HostKVTier(_pool(), 16, async_transfer=False)
        with pytest.raises(ValueError):
            tier.set_tenant_share("x", 0)
        tier.set_tenant_share("x", 4)
        tier.set_tenant_share("x", None)
        tier.close()

    def test_prefix_cache_share_demotes_own_oldest(self):
        alloc = BlockAllocator(16)
        pc = PrefixCache(alloc, 4)
        spilled = []
        pc.on_spill = lambda pairs, tenants: spilled.extend(
            zip(pairs, tenants))
        pc.set_tenant_share("a", 2)
        toks = np.arange(100, 112, dtype=np.int32)
        blocks = alloc.allocate(3)
        pc.register(toks, blocks, 12, tenant="a")
        assert pc.tenant_blocks("a") == 2
        assert len(spilled) == 1
        (b, _h), t = spilled[0]
        assert b == blocks[0] and t == "a"
        assert not pc.registered(blocks[0])
        assert pc.registered(blocks[1]) and pc.registered(blocks[2])

    def test_prefix_cache_share_isolated_per_tenant(self):
        alloc = BlockAllocator(16)
        pc = PrefixCache(alloc, 4)
        pc.set_tenant_share("a", 1)
        ba = alloc.allocate(1)
        bb = alloc.allocate(2)
        pc.register(np.arange(0, 4, dtype=np.int32), ba, 4, tenant="a")
        pc.register(np.arange(50, 58, dtype=np.int32), bb, 8, tenant="b")
        assert pc.tenant_blocks("a") == 1
        assert pc.tenant_blocks("b") == 2
        assert pc.registered(ba[0])

    def test_prefix_cache_share_validation(self):
        pc = PrefixCache(BlockAllocator(8), 4)
        with pytest.raises(ValueError):
            pc.set_tenant_share("x", 0)

    def test_demoted_parked_block_is_unparked(self):
        """A refcount-0 block over the share leaves the reusable pool for
        the plain free list (its identity is gone), and its content goes
        to the tier, tagged with its tenant."""
        cache = _pool(fill_seed=4)
        pc = PrefixCache(cache.allocator, cache.block_size)
        tier = HostKVTier(cache, 16, async_transfer=False)
        pc.on_spill = tier.spill_blocks
        blocks = cache.allocator.allocate(2)
        pc.register(np.arange(8, dtype=np.int32), blocks, 8, tenant="a")
        cache.allocator.free(blocks)  # both parked as reusable
        assert len(cache.allocator._reusable) == 2
        pc.set_tenant_share("a", 1)
        pc.register(np.arange(8, dtype=np.int32), blocks, 8, tenant="a")
        more = cache.allocator.allocate(1)
        pc.register(np.arange(100, 104, dtype=np.int32), more, 4,
                    tenant="a")
        assert pc.tenant_blocks("a") == 1
        assert not cache.allocator._reusable
        assert tier.tenant_blocks_in_use("a") == 2
        assert cache.allocator._allocated == set(more)
        tier.close()


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------

class TestTypedQoSErrors:
    def test_retry_after_fields(self):
        q = TenantQuotaExceededError("over", tenant="acme",
                                     retry_after_s=0.8)
        assert q.tenant == "acme" and q.retry_after_s == 0.8
        d = DeadlineInfeasibleError("no", deadline=5.0, retry_after_s=1.2)
        assert d.deadline == 5.0 and d.retry_after_s == 1.2
        e = RequestTimeoutError("late", rid=3, deadline=1.0)
        assert (e.rid, e.deadline) == (3, 1.0)

    def test_hierarchy_and_exports(self):
        assert issubclass(DeadlineInfeasibleError, RequestTimeoutError)
        assert issubclass(RequestTimeoutError, TimeoutError)
        assert issubclass(TenantQuotaExceededError, RuntimeError)
        for name in ("TenantQuota", "TenantQuotaExceededError",
                     "DeadlineInfeasibleError", "RequestTimeoutError",
                     "KVIntegrityError", "TIER_LATENCY", "TIER_BATCH"):
            assert (name in port_serving.__all__
                    and hasattr(port_serving, name)), name


# ---------------------------------------------------------------------------
# the engine's QoS
# ---------------------------------------------------------------------------

class TestEngineQoS:
    def test_qos_is_greedy_bit_exact(self, model):
        cfg = model.config
        prompts = prompts_fixed(cfg, [5, 9, 3, 12, 7, 6], seed=11)
        kw = dict(num_blocks=24, block_size=4, max_batch_size=2)
        samp = SamplingParams(max_new_tokens=8)
        with engine(model, **kw) as eng:
            ref_list = []
            for p in prompts:
                rid = eng.add_request(p, samp)
                for _ in eng.stream():
                    pass
                ref_list.append(eng.output_tokens(rid))
        with engine(model, **kw) as eng:
            eng.configure_tenant("gold", weight=3.0)
            eng.configure_tenant("bronze", weight=1.0)
            rids = [eng.add_request(
                p, samp, tenant="gold" if i % 2 else "bronze",
                tier=TIER_BATCH if i % 3 == 0 else TIER_LATENCY)
                for i, p in enumerate(prompts)]
            for _ in eng.stream():
                pass
            got = [eng.output_tokens(r) for r in rids]
            m = eng.metrics()
        for g, r in zip(got, ref_list):
            np.testing.assert_array_equal(g, r)
        assert m["tenant_tokens"]["gold"] > 0
        assert m["tenant_tokens"]["bronze"] > 0
        assert set(m["tenant_tokens"]) <= {"gold", "bronze", "default"}

    def test_configure_tenant_validates_wiring(self, model):
        with engine(model, num_blocks=16, block_size=4,
                    max_batch_size=2) as eng:
            with pytest.raises(ValueError, match="kv_host_blocks"):
                eng.configure_tenant("a", host_blocks=8)
            with pytest.raises(ValueError, match="enable_prefix_cache"):
                eng.configure_tenant("a", prefix_blocks=4)
            assert not eng.scheduler._qos_configured  # nothing moved
            eng.configure_tenant("a", weight=2.0)
            assert eng.scheduler.tenants["a"].weight == 2.0
        with engine(model, num_blocks=16, block_size=4, max_batch_size=2,
                    kv_host_blocks=8, enable_prefix_cache=True) as eng:
            eng.configure_tenant("a", host_blocks=4, prefix_blocks=2)
            assert eng.kv_tier._tenant_share == {"a": 4}
            assert eng.prefix_cache._tenant_share == {"a": 2}

    def test_tenant_series_removed_on_close(self, model):
        eng = engine(model, num_blocks=16, block_size=4, max_batch_size=2)
        name = eng._name
        eng.configure_tenant("acme", weight=1.0)
        p = prompts_fixed(model.config, [5], seed=3)[0]
        eng.add_request(p, SamplingParams(max_new_tokens=2), tenant="acme")
        for _ in eng.stream():
            pass
        assert eng.metrics()["tenant_tokens"]["acme"] > 0
        eng.close()
        snap = om.REGISTRY.snapshot().get("serving_tenant_tokens_total",
                                          {"series": {}})
        assert not any(name in k for k in snap["series"])

    def test_batch_yield_spills_and_revives_bit_exact(self, model):
        """A batch request running in the only slot yields to a latency
        request: it spills to the host tier, revives by import with no
        re-prefill, and both requests' tokens equal their batch-of-one
        runs; no revive misses."""
        cfg = model.config
        pb, pl = prompts_fixed(cfg, [14, 6], seed=21)
        kw = dict(num_blocks=32, block_size=4, max_batch_size=1)
        with engine(model, **kw) as eng:
            want = [eng.generate([p], SamplingParams(max_new_tokens=12))[0]
                    for p in (pb, pl)]
        with engine(model, kv_host_blocks=16, **kw) as eng:
            eng.configure_tenant("bulk", weight=1.0)
            rb = eng.add_request(pb, SamplingParams(max_new_tokens=12),
                                 tenant="bulk", tier=TIER_BATCH)
            for _ in range(3):
                eng.step()
            rl = eng.add_request(pl, SamplingParams(max_new_tokens=12))
            for _ in eng.stream():
                pass
            got = [eng.output_tokens(r) for r in (rb, rl)]
            m = eng.metrics()
        assert m["batch_yields"] == 1 and m["kv_spills"] == 1
        assert m["kv_revives"] == 1 and m["revive_misses"] == 0
        assert m["prefills"] == 2  # the yielded request never re-prefilled
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_quota_throttles_and_sheds_nothing(self, model):
        cfg = model.config
        prompts = prompts_fixed(cfg, [6, 7, 5, 8], seed=5)
        with engine(model, num_blocks=32, block_size=4,
                    max_batch_size=2) as eng:
            # 5 tokens an hour: the first prefill puts it over
            eng.configure_tenant("bronze", rate_tokens_per_s=5 / 3600,
                                 window_s=3600)
            rids = [eng.add_request(p, SamplingParams(max_new_tokens=3),
                                    tenant="bronze") for p in prompts]
            for _ in range(6):
                eng.step()
            m = eng.metrics()
            assert m["quota_throttled"] > 0
            assert len(eng.scheduler.waiting) == 3  # deferred, not shed
            # the quota lifts: every request finishes
            eng.scheduler.tenants["bronze"].quota = None
            for _ in eng.stream():
                pass
            assert all(eng.request(r).finish_reason() == "length"
                       for r in rids)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

class TestEngineDeadlines:
    def test_expired_at_add_request_allocator_untouched(self, model):
        with engine(model, num_blocks=32, block_size=8,
                    max_batch_size=2) as eng:
            free0 = eng.cache.allocator.num_free
            n_reqs = len(eng._requests)
            with pytest.raises(RequestTimeoutError):
                eng.add_request(np.arange(1, 6, dtype=np.int32),
                                SamplingParams(max_new_tokens=4),
                                deadline=time.time() - 1.0)
            assert eng.cache.allocator.num_free == free0
            assert len(eng._requests) == n_reqs
            assert not eng.has_work()
            assert eng.metrics()["deadline_expired"] == 0

    @pytest.mark.parametrize("window", [1, 4])
    def test_mid_decode_expiry_frees_blocks_and_recycles_slot(self, model,
                                                              window):
        with engine(model, num_blocks=32, block_size=8, max_batch_size=1,
                    decode_steps_per_sync=window) as eng:
            free0 = eng.cache.allocator.num_free
            eng.reset_block_high_water()
            rid = eng.add_request(np.arange(1, 7, dtype=np.int32),
                                  SamplingParams(max_new_tokens=200),
                                  deadline=time.time() + 0.4)
            outs = []
            while eng.has_work():
                outs.extend(eng.step())
            assert outs[-1].finished and outs[-1].finish_reason == "timeout"
            assert outs[-1].token == -1
            assert len(eng.request(rid).output_tokens) > 0
            assert eng.request(rid).finish_reason() == "timeout"
            assert om.REGISTRY.get("serving_deadline_expired_total").value(
                instance=eng._name) == 1
            assert eng.metrics()["deadline_expired"] == 1
            assert eng.cache.allocator.num_free == free0
            out2 = eng.generate([np.arange(1, 5, dtype=np.int32)],
                                SamplingParams(max_new_tokens=3))
            assert len(out2[0]) == 4 + 3
            assert eng.cache.allocator.num_free == free0
            eng.reset_block_high_water()
            assert eng.cache.allocator.high_water == 0

    def test_freed_slot_admits_a_waiting_request_bit_exact(self, model):
        """The slot a deadline frees admits the waiting request at the same
        step; its tokens equal its batch-of-one run."""
        cfg = model.config
        pa, pb = prompts_fixed(cfg, [9, 5], seed=17)
        with engine(model, num_blocks=32, block_size=4,
                    max_batch_size=1) as eng:
            want = eng.generate([pb], SamplingParams(max_new_tokens=6))[0]
            ra = eng.add_request(pa, SamplingParams(max_new_tokens=50),
                                 deadline=time.time() + 3600)
            rb = eng.add_request(pb, SamplingParams(max_new_tokens=6))
            for _ in range(4):
                eng.step()
            eng.request(ra).deadline = time.time() - 1.0  # expires now
            outs = eng.step()
            assert outs[0].rid == ra and outs[0].finish_reason == "timeout"
            assert eng.scheduler.slots[0] is eng.request(rb)
            for _ in eng.stream():
                pass
            np.testing.assert_array_equal(eng.output_tokens(rb), want)

    def test_generate_raises_after_drain(self, model):
        with engine(model, num_blocks=32, block_size=8,
                    max_batch_size=1) as eng:
            with pytest.raises(RequestTimeoutError):
                eng.generate([np.arange(1, 7, dtype=np.int32)],
                             SamplingParams(max_new_tokens=200),
                             deadline=time.time() + 0.3)
            assert not eng._requests

    def test_generate_mid_admission_expiry_leaves_no_orphans(
            self, model, monkeypatch):
        with engine(model, num_blocks=32, block_size=8,
                    max_batch_size=2) as eng:
            free0 = eng.cache.allocator.num_free
            real = time.time
            deadline = real() + 30.0
            calls = {"n": 0}

            def fake_time():
                calls["n"] += 1
                return real() + (60.0 if calls["n"] >= 2 else 0.0)

            monkeypatch.setattr(time, "time", fake_time)
            with pytest.raises(RequestTimeoutError):
                eng.generate([np.arange(1, 5, dtype=np.int32),
                              np.arange(1, 7, dtype=np.int32)],
                             SamplingParams(max_new_tokens=4),
                             deadline=deadline)
            monkeypatch.undo()
            assert not eng._requests
            assert not eng.has_work()
            assert eng.cache.allocator.num_free == free0

    def test_cancel_frees_and_types_reason(self, model):
        with engine(model, num_blocks=32, block_size=8,
                    max_batch_size=2) as eng:
            free0 = eng.cache.allocator.num_free
            rid = eng.add_request(np.arange(1, 9, dtype=np.int32),
                                  SamplingParams(max_new_tokens=20))
            eng.step()
            assert eng.cancel(rid)
            assert eng.request(rid).finish_reason() == "cancelled"
            assert eng.cache.allocator.num_free == free0
            assert not eng.cancel(rid)
            assert eng.metrics()["deadline_expired"] == 0


class TestHandoffDeadlines:
    def _pages(self, model, max_new=6):
        pre = engine(model, prefill_only=True, **ENGINE_KW)
        try:
            p = prompts_fixed(model.config, [5], seed=3)[0]
            rid = pre.add_request(p, SamplingParams(max_new_tokens=max_new))
            first = None
            while first is None:
                for out in pre.step():
                    first = out
            pages = pre.export_kv_pages(rid)
            pre.cancel(rid, reason="handoff")
            pre.release(rid)
            return np.concatenate([p, [first.token]]).astype(np.int32), \
                pages
        finally:
            pre.close()

    def test_expired_deadline_rejected_before_any_state(self, model):
        p2, pages = self._pages(model)
        with engine(model, **ENGINE_KW) as dec:
            free0 = dec.cache.allocator.num_free
            with pytest.raises(RequestTimeoutError):
                dec.add_request_with_pages(
                    p2, pages, SamplingParams(max_new_tokens=5),
                    deadline=time.time() - 1.0)
            assert dec.cache.allocator.num_free == free0
            assert not dec.scheduler.waiting and not dec.has_work()

    def test_deadline_between_prefill_and_decode_admission(self, model):
        p2, pages = self._pages(model)
        with engine(model, **dict(ENGINE_KW, max_batch_size=1)) as dec:
            hog = dec.add_request(prompts_fixed(model.config, [6], 8)[0],
                                  SamplingParams(max_new_tokens=20))
            dec.step()
            rid = dec.add_request_with_pages(
                p2, pages, SamplingParams(max_new_tokens=5),
                deadline=time.time() + 0.05, tenant="t", tier=TIER_BATCH)
            assert dec.request(rid).tier == TIER_BATCH
            time.sleep(0.08)
            ends = [o for o in dec.step() if o.rid == rid and o.finished]
            assert ends and ends[0].finish_reason == "timeout"
            assert dec.request(rid).preloaded is None  # pages dropped
            assert dec.metrics()["deadline_expired"] == 1
            dec.cancel(hog)
            dec.release(hog)
            dec.release(rid)
            assert dec.cache.allocator.num_free == \
                ENGINE_KW["num_blocks"] - 1


# ---------------------------------------------------------------------------
# the contended arm in both packages
# ---------------------------------------------------------------------------

def _contended(pkg, model, prompts, dev=None):
    """Two tenants (gold 3, bronze 1 with a quota on a step clock), both
    tiers, a pool small enough to evict, a deadline that expires at step 5
    on the fourth request. Returns (tokens, finish reasons, tenant_tokens,
    admission order)."""
    kw = dict(num_blocks=9, block_size=4, max_batch_size=2,
              ingest_async=False)
    if dev is not None:
        kw["device"] = dev
    eng = pkg.LLMEngine(model, **kw)
    try:
        eng.configure_tenant("gold", weight=3.0)
        eng.configure_tenant("bronze", weight=1.0)
        eng.scheduler.configure_tenant(
            "bronze", weight=1.0, rate_tokens_per_s=8.0, window_s=1.0,
            clock=lambda: eng.stats_extra["steps"] * 0.25)
        order = []
        pick = eng.scheduler.pick_prefills

        def recording():
            got = pick()
            order.extend(rids.index(r.rid) for _, r in got)
            return got

        eng.scheduler.pick_prefills = recording
        rids = []
        for i, p in enumerate(prompts):
            rids.append(eng.add_request(
                p, pkg.SamplingParams(max_new_tokens=8),
                deadline=time.time() + 3600,
                tenant=("gold", "bronze", None, "bronze")[i % 4],
                tier=pkg.TIER_BATCH if i % 4 == 1 else pkg.TIER_LATENCY))
        steps = 0
        while eng.has_work():
            steps += 1
            if steps == 5:
                eng.request(rids[3]).deadline = time.time() - 1.0
            eng.step()
        outs = [eng.output_tokens(r) for r in rids]
        reasons = [eng.request(r).finish_reason() for r in rids]
        m = eng.metrics()
        return outs, reasons, m["tenant_tokens"], order, m
    finally:
        eng.close()


def test_contended_arm_matches_the_reference(models):
    """Tokens (exact), finish reasons, ``tenant_tokens`` and the admission
    order of the contended arm equal the JAX engine's on fp32 llama_tiny;
    the arm really throttled, evicted and timed out."""
    jm, tm = models
    prompts = prompts_fixed(tm.config, [7, 12, 5, 9, 14, 6, 10], seed=31)
    want = _contended(jax_serving, jm, prompts)
    got = _contended(port_serving, tm, prompts, dev="cpu")
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1:4] == want[1:4]
    m = got[4]
    assert got[1][3] == "timeout" and m["deadline_expired"] == 1
    assert m["quota_throttled"] > 0
    assert m["evictions"] > 0
    assert set(got[2]) == {"gold", "bronze", "default"}
