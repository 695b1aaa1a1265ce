"""The port's host-RAM KV tier and on-disk prefix store on the CPU: every
case of ``tests/test_kv_tiering.py`` proved again in the port (tier round
trips fp32 and int8, LRU order, the ``serve.kv_spill`` degrade, spilled
shared blocks keeping chain identity and refcounts, revival bit for bit
against a never-evicted engine, the store's save/load/corrupt/
fingerprint/geometry gates, warm restarts), plus the cross-package cases:
equal weight fingerprints, a store written by either package booting the
other's engine with the same warm tokens, byte-identical stream shards,
and a store the JAX package sealed: verified and served, rejected whole
as "corrupt" when its file is flipped, an entry flipped under a valid
frame rejected at its revive."""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.inference.serving import \
    weights_fingerprint as jax_fingerprint
from paddle_tpu.io.streaming import read_stream_shard as jax_read_shard
from paddle_tpu.io.streaming import write_stream_shard as jax_write_shard
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import (
    HostKVTier, LLMEngine, PagedKVCache, PrefixCache, PrefixStoreMismatch,
    SamplingParams, load_prefix_store, pack_kv_pages, pool_geometry,
    save_prefix_store, save_llama_artifact, unpack_kv_pages,
    weights_fingerprint)
from paddle_tpu_torch.io.streaming import (read_stream_shard,
                                           write_stream_shard)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.utils import fault_injection as fi


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


def shared_prompts(cfg, prefix_len, suffix_lens, seed=0):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(
        0, cfg.vocab_size, s).astype(np.int32)]) for s in suffix_lens]


def unique_prompts(cfg, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _pool(num_blocks=8, block_size=4, kv_dtype=None, fill_seed=None):
    """A CPU PagedKVCache (+ a PrefixCache on its allocator), optionally
    filled in place with seeded non-zero content."""
    cache = PagedKVCache(llama_tiny(), num_blocks, block_size,
                         kv_dtype=kv_dtype, device="cpu")
    prefix = PrefixCache(cache.allocator, block_size)
    if fill_seed is not None:
        rng = np.random.RandomState(fill_seed)

        def fill(pools, scale=1.0):
            for p in pools:
                host = rng.standard_normal(tuple(p.shape)) * scale
                p.copy_(torch.from_numpy(
                    host.astype(p.numpy().dtype)))

        fill(cache.k, 20.0 if kv_dtype == "int8" else 1.0)
        fill(cache.v, 20.0 if kv_dtype == "int8" else 1.0)
        if cache.quantized:
            fill(cache.k_scale)
            fill(cache.v_scale)
    return cache, prefix


def _keys(kv_dtype):
    return ("k", "v") + (("k_scale", "v_scale") if kv_dtype else ())


# ---------------------------------------------------------------------------
# host tier unit behavior
# ---------------------------------------------------------------------------

class TestHostKVTier:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_spill_pop_round_trip(self, kv_dtype):
        cache, _ = _pool(kv_dtype=kv_dtype, fill_seed=3)
        tier = HostKVTier(cache, 16, async_transfer=False)
        want = cache.export_request_pages([2, 5], 2 * cache.block_size)
        tier.spill_blocks([(2, b"h" * 20), (5, b"g" * 20)])
        got = tier.pop_prefix(b"h" * 20)
        for key in _keys(kv_dtype):
            np.testing.assert_array_equal(got[key], want[key][:, :1])
        got2 = tier.pop_prefix(b"g" * 20)
        np.testing.assert_array_equal(got2["k"], want["k"][:, 1:2])
        assert tier.pop_prefix(b"h" * 20) is None  # pop removes
        tier.close()

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_import_round_trip_restores_pool(self, kv_dtype):
        src, _ = _pool(kv_dtype=kv_dtype, fill_seed=11)
        dst, _ = _pool(kv_dtype=kv_dtype)
        ptrs = [t.data_ptr() for t in dst.k + dst.v + dst.k_scale]
        tier = HostKVTier(src, 16, async_transfer=False)
        tier.spill_blocks([(3, b"x" * 20)])
        pages = tier.pop_prefix(b"x" * 20)
        dst.import_request_pages([6], pages)
        got = dst.export_request_pages([6], dst.block_size)
        want = src.export_request_pages([3], src.block_size)
        for key in _keys(kv_dtype):
            np.testing.assert_array_equal(got[key], want[key])
        # written in place: every pool tensor is where it was
        assert [t.data_ptr() for t in dst.k + dst.v + dst.k_scale] == ptrs
        tier.close()

    def test_spill_survives_block_reuse(self):
        """The snapshot is taken when the spill is made: writing the block
        afterwards (its next owner) does not reach the spilled copy."""
        cache, _ = _pool(fill_seed=12)
        tier = HostKVTier(cache, 16, async_transfer=False)
        want = cache.export_request_pages([4], cache.block_size)
        tier.spill_blocks([(4, b"r" * 20)])
        for p in cache.k + cache.v:
            p[4].fill_(7.0)
        got = tier.pop_prefix(b"r" * 20)
        np.testing.assert_array_equal(got["k"], want["k"])
        np.testing.assert_array_equal(got["v"], want["v"])
        tier.close()

    def test_lru_eviction_order_under_pressure(self):
        cache, _ = _pool(fill_seed=1)
        tier = HostKVTier(cache, 2, async_transfer=False)
        before = obs_metrics.REGISTRY.get(
            "serving_kv_host_evictions_total")
        base = before.value(instance=None) if before else 0.0
        tier.spill_blocks([(1, b"a" * 20)])
        tier.spill_blocks([(2, b"b" * 20)])
        assert tier.has_prefix(b"a" * 20)       # touch: a becomes MRU
        tier.spill_blocks([(3, b"c" * 20)])     # evicts b, NOT a
        assert tier.has_prefix(b"a" * 20)
        assert not tier.has_prefix(b"b" * 20)
        assert tier.has_prefix(b"c" * 20)
        assert tier.host_blocks_in_use == 2
        after = obs_metrics.REGISTRY.get(
            "serving_kv_host_evictions_total").value(instance=None)
        assert after >= base + 1
        tier.close()

    def test_oversized_entry_rejected_whole(self):
        cache, _ = _pool(fill_seed=2)
        tier = HostKVTier(cache, 1, async_transfer=False)
        ok = tier.spill_request(0, [1, 2, 3], 3 * cache.block_size)
        assert not ok                       # 3 blocks > 1-block budget
        assert tier.host_blocks_in_use == 0
        tier.close()

    def test_kv_spill_fault_site_degrades_to_no_spill(self):
        cache, _ = _pool(fill_seed=4)
        tier = HostKVTier(cache, 16, async_transfer=False)
        with fi.inject("serve.kv_spill") as inj:
            tier.spill_blocks([(1, b"a" * 20)])
            assert not tier.spill_request(7, [2], cache.block_size)
        assert inj.fires == 2
        assert not tier.has_prefix(b"a" * 20)
        assert tier.peek_request(7) is None
        assert tier.host_blocks_in_use == 0
        tier.close()

    def test_transfer_thread_materializes(self):
        """With the transfer thread the payload is the same; a closed tier
        joins its thread."""
        cache, _ = _pool(fill_seed=5)
        tier = HostKVTier(cache, 16)
        want = cache.export_request_pages([1, 2], 2 * cache.block_size)
        assert tier.spill_request(9, [1, 2, 3], 2 * cache.block_size)
        got = tier.peek_request(9)
        np.testing.assert_array_equal(got["k"], want["k"])
        assert got["covered"] == 2 * cache.block_size
        thread = tier._thread
        tier.close()
        assert not thread.is_alive()


# ---------------------------------------------------------------------------
# spilled shared blocks: refcounts + chain identity across demote/revive
# ---------------------------------------------------------------------------

class TestSharedBlockIdentity:
    def test_spill_preserves_chain_and_refcounts_on_revival(self):
        cache, prefix = _pool(num_blocks=6, block_size=4, fill_seed=9)
        alloc = cache.allocator
        tier = HostKVTier(cache, 16, async_transfer=False)
        prefix.on_spill = tier.spill_blocks

        tokens = np.arange(1, 10, dtype=np.int32)
        blocks = alloc.allocate(2)
        prefix.register(tokens, blocks, 8)
        chain_hashes = [prefix._block_hash[b] for b in blocks]
        payload_before = cache.export_request_pages(blocks, 8)
        alloc.free(blocks)                  # refcount 0 -> reusable park

        # exhaust the pool: the reclaim wave demotes BOTH registered
        # blocks to the tier under their chain hashes in one batch
        grabbed = alloc.allocate(alloc.num_free)
        for h in chain_hashes:
            assert tier.has_prefix(h)
        dev_blocks, covered, host = prefix.match_with_tier(tokens, tier)
        assert dev_blocks == [] and covered == 0
        assert host == chain_hashes

        alloc.free(grabbed[:2])
        revived = alloc.allocate(2)
        for nb, h in zip(revived, host):
            pages = tier.pop_prefix(h)
            cache.import_request_pages([nb], pages)
            prefix.adopt(nb, h)
        dev2, cov2, host2 = prefix.match_with_tier(tokens, tier)
        assert dev2 == revived and cov2 == 8 and host2 == []
        alloc.acquire(revived)   # a second sharer joins the reviver
        assert all(alloc.ref(b) == 2 for b in revived)
        payload_after = cache.export_request_pages(revived, 8)
        np.testing.assert_array_equal(payload_before["k"],
                                      payload_after["k"])
        np.testing.assert_array_equal(payload_before["v"],
                                      payload_after["v"])
        tier.close()


# ---------------------------------------------------------------------------
# engine-level: revival is bit-exact vs a never-evicted reference
# ---------------------------------------------------------------------------

def _waves(cfg, seed=21):
    """Two shared-prefix waves around a long unique 'flusher' prompt that
    makes the small pool reclaim the wave-1 prefix blocks; wave 2 revives
    them from the host tier."""
    wave1 = shared_prompts(cfg, 12, [4, 6, 5], seed=seed)
    flusher = unique_prompts(cfg, [40], seed=seed + 1)
    wave2 = shared_prompts(cfg, 12, [3, 7], seed=seed)
    return [wave1, flusher, wave2]


TIER_KW = dict(block_size=4, max_batch_size=3, enable_prefix_cache=True,
               device="cpu", ingest_async=False)


def _run(model, waves, n_new=6, **kw):
    with LLMEngine(model, **{**TIER_KW, **kw}) as eng:
        outs = [o for wave in waves for o in eng.generate(
            wave, SamplingParams(max_new_tokens=n_new))]
        return outs, eng.metrics()


class TestTieredEngineBitExact:
    def test_prefix_revival_bit_exact_vs_never_evicted(self, model):
        waves = _waves(model.config)
        refs, rm = _run(model, waves, num_blocks=96)
        assert rm["kv_spills"] == 0
        got, em = _run(model, waves, num_blocks=14, kv_host_blocks=64)
        assert em["kv_spills"] > 0, "pool pressure never spilled"
        assert em["kv_revives"] > 0, "no revisit revived from host"
        assert em["kv_spill_bytes"] > 0 and em["kv_revive_bytes"] > 0
        assert em["kv_host_evictions"] == 0  # budget was ample
        for a, b in zip(got, refs):
            np.testing.assert_array_equal(a, b)

    def test_prefix_revival_bit_exact_int8(self, model):
        waves = _waves(model.config, seed=33)
        refs, _ = _run(model, waves, num_blocks=96, kv_dtype="int8")
        got, em = _run(model, waves, num_blocks=14, kv_host_blocks=64,
                       kv_dtype="int8")
        assert em["kv_spills"] > 0 and em["kv_revives"] > 0
        for a, b in zip(got, refs):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("window", [1, 4])
    def test_preempted_request_revived_without_reprefill(self, model,
                                                         window):
        """Decode pressure evicts a request; its pages spill and its
        re-admission imports them: every revived eviction saves its
        re-prefill, the pools stay where they were, and the tokens are
        ``generate``'s."""
        prompts = unique_prompts(model.config, [8, 8, 8], seed=5)
        refs = [model.generate(torch.from_numpy(p[None].astype(np.int64)),
                               max_new_tokens=20).numpy()[0]
                for p in prompts]
        with LLMEngine(model, num_blocks=5, block_size=8, max_batch_size=2,
                       kv_host_blocks=32, device="cpu", ingest_async=False,
                       decode_steps_per_sync=window) as eng:
            ptrs = [t.data_ptr() for t in eng.cache.k + eng.cache.v]
            outs = eng.generate(prompts, SamplingParams(max_new_tokens=20))
            em = eng.metrics()
            stats = eng.stats()
            assert [t.data_ptr() for t in eng.cache.k + eng.cache.v] == ptrs
        assert stats["evictions"] >= 1
        assert em["kv_spills"] >= 1 and em["kv_revives"] == em["kv_spills"]
        assert em["revive_misses"] == 0
        assert em["prefills"] == len(prompts) + stats["evictions"] - \
            em["kv_revives"]
        for got, ref in zip(outs, refs):
            np.testing.assert_array_equal(got, ref)

    def test_kv_spill_injection_degrades_to_recompute(self, model):
        waves = _waves(model.config, seed=44)
        refs, _ = _run(model, waves, num_blocks=96)
        with fi.inject("serve.kv_spill"):
            got, em = _run(model, waves, num_blocks=14, kv_host_blocks=64)
        assert em["kv_spills"] == 0 and em["kv_revives"] == 0
        for a, b in zip(got, refs):
            np.testing.assert_array_equal(a, b)

    def test_tier_metric_names_registered(self, model):
        waves = _waves(model.config, seed=55)
        _, em = _run(model, waves, num_blocks=14, kv_host_blocks=64)
        for name in ("serving_kv_spills_total", "serving_kv_revives_total",
                     "serving_kv_spill_bytes_total",
                     "serving_kv_revive_bytes_total",
                     "serving_kv_host_evictions_total",
                     "serving_kv_host_blocks",
                     "serving_kv_spill_ms", "serving_kv_revive_ms",
                     "serving_prefix_store_saved_total",
                     "serving_prefix_store_loaded_total",
                     "serving_prefix_store_rejected_total"):
            assert obs_metrics.REGISTRY.get(name) is not None, name
        for key in ("kv_spills", "kv_revives", "kv_spill_bytes",
                    "kv_revive_bytes", "kv_host_evictions",
                    "kv_host_blocks", "kv_spill_ms", "kv_revive_ms",
                    "prefix_store_saved", "prefix_store_loaded",
                    "prefix_store_rejected",
                    "prefix_store_rejected_by_reason", "revive_misses"):
            assert key in em, key
        assert em["kv_spill_ms"]["count"] > 0


# ---------------------------------------------------------------------------
# persistent prefix store
# ---------------------------------------------------------------------------

class TestPrefixStore:
    def _entries(self, kv_dtype=None, n=3, seed=17):
        cache, _ = _pool(kv_dtype=kv_dtype, fill_seed=seed)
        return [(bytes([i]) * 20,
                 cache.export_request_pages([i + 1], cache.block_size))
                for i in range(n)]

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_save_load_round_trip(self, tmp_path, kv_dtype):
        path = str(tmp_path / "prefix.pdstream")
        entries = self._entries(kv_dtype)
        n = save_prefix_store(path, entries, fingerprint="fp",
                              geometry={"block_size": 4})
        assert n == len(entries)
        got = load_prefix_store(path, fingerprint="fp",
                                geometry={"block_size": 4})
        assert [h for h, _ in got] == [h for h, _ in entries]
        for (_, a), (_, b) in zip(got, entries):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])

    def test_missing_store_is_a_clean_first_boot(self, tmp_path):
        assert load_prefix_store(str(tmp_path / "none.pdstream"),
                                 fingerprint="fp", geometry={}) is None

    def test_corrupt_store_rejected_whole(self, tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        save_prefix_store(path, self._entries(), fingerprint="fp",
                          geometry={})
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        rej = obs_metrics.REGISTRY.get(
            "serving_prefix_store_rejected_total").value(
                instance=None, reason="corrupt")
        with pytest.raises(PrefixStoreMismatch) as ei:
            load_prefix_store(path, fingerprint="fp", geometry={})
        assert ei.value.reason == "corrupt"
        assert obs_metrics.REGISTRY.get(
            "serving_prefix_store_rejected_total").value(
                instance=None, reason="corrupt") >= rej + 1

    def test_fingerprint_and_geometry_gates(self, tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        save_prefix_store(path, self._entries(), fingerprint="fp",
                          geometry={"block_size": 4})
        with pytest.raises(PrefixStoreMismatch) as ei:
            load_prefix_store(path, fingerprint="OTHER",
                              geometry={"block_size": 4})
        assert ei.value.reason == "fingerprint"
        with pytest.raises(PrefixStoreMismatch) as ei:
            load_prefix_store(path, fingerprint="fp",
                              geometry={"block_size": 8})
        assert ei.value.reason == "geometry"

    def test_store_write_failure_preserves_previous_store(self, tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        save_prefix_store(path, self._entries(n=2), fingerprint="fp",
                          geometry={})
        before = open(path, "rb").read()
        with fi.inject("serve.store_write") as inj:
            with pytest.raises(OSError):
                save_prefix_store(path, self._entries(n=3),
                                  fingerprint="fp", geometry={})
        assert inj.fires == 1
        assert open(path, "rb").read() == before
        assert load_prefix_store(path, fingerprint="fp",
                                 geometry={}) is not None

    def test_weights_fingerprint_tracks_weights(self, model):
        fp1 = weights_fingerprint(model)
        assert fp1 == weights_fingerprint(model)  # deterministic
        m2 = copy.deepcopy(model)
        with torch.no_grad():
            next(iter(m2.parameters())).add_(1.0)
        assert weights_fingerprint(m2) != fp1


STORE_KW = dict(num_blocks=14, block_size=4, max_batch_size=3,
                enable_prefix_cache=True, kv_host_blocks=64)


def _serve(eng, waves, new, sampling=SamplingParams):
    return [o for w in waves for o in eng.generate(
        w, sampling(max_new_tokens=new))]


class TestWarmRestart:
    def test_engine_warm_restart_bit_exact(self, model, tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        waves = _waves(model.config, seed=66)
        kw = dict(STORE_KW, prefix_store_path=path, device="cpu")
        with LLMEngine(model, **kw) as eng:
            cold = _serve(eng, waves, 6)
        assert os.path.exists(path)
        with LLMEngine(model, **kw) as eng:
            em0 = eng.metrics()
            assert em0["prefix_store_loaded"] > 0
            warm = _serve(eng, waves, 6)
            em = eng.metrics()
        assert em["kv_revives"] > 0
        for a, b in zip(warm, cold):
            np.testing.assert_array_equal(a, b)

    def test_store_save_failure_at_close_is_contained(self, model,
                                                      tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        waves = _waves(model.config, seed=77)
        kw = dict(STORE_KW, prefix_store_path=path, device="cpu")
        with fi.inject("serve.store_write"):
            with pytest.warns(RuntimeWarning):
                with LLMEngine(model, **kw) as eng:
                    eng.generate(waves[0],
                                 SamplingParams(max_new_tokens=4))
        assert not os.path.exists(path)  # nothing torn was published

    def test_reload_weights_with_new_fingerprint_cold_starts(
            self, model, tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        waves = _waves(model.config, seed=88)
        kw = dict(STORE_KW, prefix_store_path=path, device="cpu")
        with LLMEngine(model, **kw) as eng:
            for w in waves:
                eng.generate(w, SamplingParams(max_new_tokens=4))
        m2 = copy.deepcopy(model)
        with torch.no_grad():
            next(iter(m2.parameters())).add_(0.25)
        art = str(tmp_path / "model2")
        save_llama_artifact(m2, art)
        m3 = copy.deepcopy(model)
        with LLMEngine(m3, **kw) as eng:
            assert eng.metrics()["prefix_store_loaded"] > 0
            eng.reload_weights(art)
            # the old fingerprint's pages were dropped and the store on
            # disk does not match the new one: no stale chain survives
            assert eng.kv_tier.host_blocks_in_use == 0
            assert len(eng.prefix_cache) == 0
            assert eng._store_fingerprint == weights_fingerprint(m2)

    def test_store_requires_prefix_cache_and_tier(self, model, tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        with pytest.raises(ValueError):
            LLMEngine(model, enable_prefix_cache=True, device="cpu",
                      prefix_store_path=path)  # no tier
        with pytest.raises(ValueError):
            LLMEngine(model, kv_host_blocks=8, device="cpu",
                      prefix_store_path=path)  # no prefix cache
        with pytest.raises(ValueError, match="saves nowhere"):
            LLMEngine(model, device="cpu", prefix_store_autosave_chains=2)
        with pytest.raises(ValueError, match=">= 0"):
            LLMEngine(model, device="cpu", kv_host_blocks=-1)

    def test_autosave_publishes_after_new_chains(self, model, tmp_path):
        path = str(tmp_path / "prefix.pdstream")
        waves = _waves(model.config, seed=99)
        with LLMEngine(model, **dict(STORE_KW, prefix_store_path=path,
                                     prefix_store_autosave_chains=2,
                                     device="cpu")) as eng:
            eng.generate(waves[0], SamplingParams(max_new_tokens=4))
            assert os.path.exists(path)
            assert eng.metrics()["prefix_store_saved"] > 0


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_fingerprint_equal_across_packages(dtype):
    """The same numpy weights give the same digest in both packages (bf16
    weights as bf16: the name "bfloat16", the bits as bytes)."""
    paddle.seed(11)
    jm = JaxLlama(jax_tiny())
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
    tm = LlamaForCausalLM(llama_tiny(), device="cpu",
                          dtype=getattr(torch, dtype))
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    assert next(tm.parameters()).dtype == getattr(torch, dtype)
    assert weights_fingerprint(tm) == jax_fingerprint(jm)


def _jax_serve(jm, path, waves, new):
    eng = JaxEngine(jm, prefix_store_path=path, **STORE_KW)
    try:
        return _serve(eng, waves, new, JaxSampling), eng.metrics()
    finally:
        eng.close()


def _port_serve(tm, path, waves, new):
    with LLMEngine(tm, prefix_store_path=path, device="cpu",
                   **STORE_KW) as eng:
        return _serve(eng, waves, new), eng.metrics()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_boots_the_other_package(models, tmp_path, writer):
    """A store one package's engine saved boots the other's: loaded, it
    revives chains and serves the writer's own warm run's tokens."""
    jm, tm = models
    waves = _waves(tm.config, seed=101)
    own = str(tmp_path / "own.pdstream")
    other = str(tmp_path / "other.pdstream")
    serve_own, serve_other = ((_jax_serve, _port_serve) if writer == "jax"
                              else (_port_serve, _jax_serve))
    model_own, model_other = (jm, tm) if writer == "jax" else (tm, jm)
    cold, _ = serve_own(model_own, own, waves, 5)
    shutil.copyfile(own, other)
    warm, wm = serve_own(model_own, own, waves, 5)
    got, gm = serve_other(model_other, other, waves, 5)
    assert wm["prefix_store_loaded"] > 0 and wm["kv_revives"] > 0
    assert gm["prefix_store_loaded"] == wm["prefix_store_loaded"]
    assert gm["prefix_store_rejected"] == 0 and gm["kv_revives"] > 0
    for a, b, c in zip(got, warm, cold):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_stream_shards_are_byte_identical(tmp_path):
    """``write_stream_shard`` of the same records writes the same bytes
    in both packages, and each reads the other's shard."""
    rng = np.random.RandomState(0)
    records = [(rng.standard_normal((3, 4)).astype(np.float32),
                np.arange(5, dtype=np.int64)) for _ in range(3)]
    records.append(b"raw payload")
    a, b = str(tmp_path / "port.pdstream"), str(tmp_path / "jax.pdstream")
    assert write_stream_shard(a, records) == jax_write_shard(b, records) \
        == 4
    assert open(a, "rb").read() == open(b, "rb").read()
    got = read_stream_shard(b, decode_fn=bytes)
    assert got == jax_read_shard(a, decode_fn=bytes)
    assert got[-1] == b"raw payload"


def _jax_sealed_store(jm, path, waves):
    """A store the JAX engine saved with page checksums armed: every
    entry sealed."""
    eng = JaxEngine(jm, prefix_store_path=path, kv_page_checksums=True,
                    **STORE_KW)
    try:
        _serve(eng, waves[:1], 3, JaxSampling)
    finally:
        eng.close()
    entries = load_prefix_store(path, fingerprint=jax_fingerprint(jm),
                                geometry=_geometry(jm))
    assert entries and all("crc" in pg for _, pg in entries)
    return len(entries)


def _geometry(jm):
    from paddle_tpu.inference.serving import pool_geometry as jax_geometry

    je = JaxEngine(jm, **STORE_KW)
    try:
        return jax_geometry(je.cache, jm.config)
    finally:
        je.close()


def test_sealed_store_is_verified_and_served(models, tmp_path):
    """The port's engine boots a store the JAX engine sealed, verifies each
    entry as it revives it, and serves the tokens of a run with no
    store."""
    jm, tm = models
    path = str(tmp_path / "sealed.pdstream")
    waves = _waves(tm.config, seed=111)
    n = _jax_sealed_store(jm, path, waves)
    with LLMEngine(tm, device="cpu", **STORE_KW) as eng:
        cold = _serve(eng, waves[:1], 3)
    with LLMEngine(tm, prefix_store_path=path, device="cpu",
                   **STORE_KW) as eng:
        assert eng.metrics()["prefix_store_loaded"] == n
        warm = _serve(eng, waves[:1], 3)
        m = eng.metrics()
    assert m["kv_revives"] > 0
    assert m["kv_pages_verified"] == m["kv_revives"]
    assert m["kv_pages_rejected"] == 0
    for a, b in zip(warm, cold):
        np.testing.assert_array_equal(a, b)


def test_sealed_store_is_refused(models, tmp_path):
    """A sealed store with a flipped byte in the file fails its frame CRC:
    the port's engine rejects it whole as ``"corrupt"`` and cold-starts."""
    jm, tm = models
    path = str(tmp_path / "sealed.pdstream")
    waves = _waves(tm.config, seed=111)
    _jax_sealed_store(jm, path, waves)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        eng = LLMEngine(tm, prefix_store_path=path, device="cpu",
                        **STORE_KW)
    try:
        m = eng.metrics()
        assert m["prefix_store_loaded"] == 0
        assert m["prefix_store_rejected_by_reason"] == {"corrupt": 1}
        assert len(eng.kv_tier) == 0
    finally:
        eng.close()


def test_sealed_store_flipped_entry_is_rejected_at_revive(models,
                                                          tmp_path):
    """A sealed entry whose page bytes changed under a valid frame loads,
    and is rejected when it revives: freed, counted, re-prefilled, and the
    tokens still equal a run with no store."""
    jm, tm = models
    path = str(tmp_path / "sealed.pdstream")
    waves = _waves(tm.config, seed=111)
    n = _jax_sealed_store(jm, path, waves)
    recs = read_stream_shard(path, decode_fn=bytes)
    flipped = [recs[0]]
    for rec in recs[1:]:
        pages = unpack_kv_pages(rec[20:])
        pages["k"].view(np.uint8).flat[3] ^= 0x08
        flipped.append(rec[:20] + pack_kv_pages(pages))
    write_stream_shard(path, flipped)
    with LLMEngine(tm, device="cpu", **STORE_KW) as eng:
        cold = _serve(eng, waves[:1], 3)
    with LLMEngine(tm, prefix_store_path=path, device="cpu",
                   **STORE_KW) as eng:
        assert eng.metrics()["prefix_store_loaded"] == n
        with pytest.warns(RuntimeWarning, match="corrupt"):
            warm = _serve(eng, waves[:1], 3)
        m = eng.metrics()
    assert m["kv_pages_rejected"] > 0 and m["kv_revives"] == 0
    assert m["kv_pages_verified"] == 0
    for a, b in zip(warm, cold):
        np.testing.assert_array_equal(a, b)


def test_pool_geometry_matches_the_reference(models):
    jm, tm = models
    from paddle_tpu.inference.serving import pool_geometry as jax_geometry

    for kv in (None, "int8"):
        with LLMEngine(tm, device="cpu", kv_dtype=kv, **dict(
                STORE_KW, enable_prefix_cache=False,
                kv_host_blocks=0)) as eng:
            mine = pool_geometry(eng.cache, tm.config)
        je = JaxEngine(jm, kv_dtype=kv, num_blocks=14, block_size=4)
        try:
            assert mine == jax_geometry(je.cache, jm.config)
        finally:
            je.close()
