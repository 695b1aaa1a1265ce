"""The port's serving integrity on the CPU: the single-engine cases of
``tests/test_integrity.py`` proved again in the port (per-block page CRCs,
fp32 and int8 with the scale rows in the CRC; deterministic audit sampling;
the suspicion bucket; the host tier's read-back rejection degrading to
re-prefill; typed rejection of corrupt imported pages; the weight audit;
the prefix store's typed reasons; the metric names), plus the
cross-package cases: one fp32, int8 or bfloat16 payload seals to the same
CRCs in both packages and each verifies the other's seal, and a weight
flip moves both packages' fingerprints alike; and the port's own: the
seal over a reclaim wave's one-block views, the seal taken at snapshot
time, every flip in place (no ``data_ptr()`` moves), and
``reload_weights`` re-anchoring the audit."""

import os
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import integrity as jax_integrity
from paddle_tpu.inference.serving import \
    weights_fingerprint as jax_fingerprint
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import (
    HostKVTier, KVIntegrityError, LLMEngine, PagedKVCache,
    PrefixStoreMismatch, SamplingParams, save_llama_artifact,
    weights_fingerprint)
from paddle_tpu_torch.inference.serving import integrity
from paddle_tpu_torch.inference.serving.prefix_store import REJECT_REASONS
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.observability import metrics as obs_metrics


@pytest.fixture(scope="module")
def model():
    paddle.seed(7)
    jm = JaxLlama(jax_tiny())
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return tm


def engine(m, **kw):
    return LLMEngine(m, device="cpu", ingest_async=False, **kw)


def unique_prompts(cfg, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _filled_pool(num_blocks=8, block_size=4, kv_dtype=None, seed=3):
    cache = PagedKVCache(llama_tiny(), num_blocks, block_size,
                         kv_dtype=kv_dtype, device="cpu")
    rng = np.random.RandomState(seed)

    def fill(pools, scale=1.0):
        for p in pools:
            host = rng.standard_normal(tuple(p.shape)) * scale
            p.copy_(torch.from_numpy(host.astype(p.numpy().dtype)))

    fill(cache.k, 20.0 if kv_dtype == "int8" else 1.0)
    fill(cache.v, 20.0 if kv_dtype == "int8" else 1.0)
    if cache.quantized:
        fill(cache.k_scale)
        fill(cache.v_scale)
    return cache


# ---------------------------------------------------------------------------
# CRC seal / verify
# ---------------------------------------------------------------------------

class TestPageCRC:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_seal_verify_round_trip(self, kv_dtype):
        cache = _filled_pool(kv_dtype=kv_dtype)
        pages = integrity.seal_pages(
            cache.export_request_pages([2, 5], 2 * cache.block_size))
        assert pages["crc"].shape == (2,)
        before = integrity._M_PAGES_VERIFIED.value(instance=None)
        assert integrity.verify_pages(pages) == 2
        assert integrity._M_PAGES_VERIFIED.value(
            instance=None) == before + 2

    @pytest.mark.parametrize("plane", ["k", "v"])
    def test_flipped_code_plane_rejected(self, plane):
        cache = _filled_pool()
        pages = integrity.seal_pages(
            cache.export_request_pages([1, 3], 2 * cache.block_size))
        buf = np.asarray(pages[plane]).view(np.uint8)
        buf.flat[buf.size // 3] ^= 0x01
        before = integrity._M_PAGES_REJECTED.value(instance=None)
        with pytest.raises(KVIntegrityError) as ei:
            integrity.verify_pages(pages)
        assert ei.value.block in (0, 1)
        assert integrity._M_PAGES_REJECTED.value(
            instance=None) == before + 1

    @pytest.mark.parametrize("plane", ["k_scale", "v_scale"])
    def test_scale_sidecar_in_crc(self, plane):
        cache = _filled_pool(kv_dtype="int8")
        pages = integrity.seal_pages(
            cache.export_request_pages([2, 4], 2 * cache.block_size))
        np.asarray(pages[plane]).view(np.uint8).flat[0] ^= 0x80
        with pytest.raises(KVIntegrityError):
            integrity.verify_pages(pages)

    def test_unsealed_payload_passes_through(self):
        cache = _filled_pool()
        pages = cache.export_request_pages([0], cache.block_size)
        assert "crc" not in pages
        assert integrity.verify_pages(pages) == 0

    def test_malformed_seal_rejected(self):
        cache = _filled_pool()
        pages = integrity.seal_pages(
            cache.export_request_pages([1, 2], 2 * cache.block_size))
        pages["crc"] = pages["crc"][:1]
        with pytest.raises(KVIntegrityError, match="malformed"):
            integrity.verify_pages(pages)


def _payload(kind, seed=0):
    """The same page payload for both packages: (the port's, the JAX
    package's). bf16 is uint16 bits in the port, ml_dtypes bfloat16 in
    the JAX package."""
    rng = np.random.RandomState(seed)
    shape = (2, 3, 4, 2, 8)  # layers, blocks, block, kv heads, head dim
    base = {"covered": 12, "block_size": 4,
            "kv_dtype": "int8" if kind == "int8" else None}
    if kind == "int8":
        codes = {n: rng.randint(-127, 128, shape).astype(np.int8)
                 for n in ("k", "v")}
        scales = {n: rng.random_sample(shape[:-1]).astype(np.float32)
                  for n in ("k_scale", "v_scale")}
        port = dict(base, **codes, **scales)
        return port, dict(port)
    vals = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    if kind == "fp32":
        port = dict(base, **vals)
        return port, dict(port)
    bf = {n: v.astype(ml_dtypes.bfloat16) for n, v in vals.items()}
    return (dict(base, **{n: v.view(np.uint16) for n, v in bf.items()}),
            dict(base, **bf))


@pytest.mark.parametrize("kind", ["fp32", "int8", "bf16"])
def test_seals_match_the_reference(kind):
    """One payload seals to the same CRCs in both packages (bf16: the
    port's uint16 bits and the JAX package's bfloat16 are the same bytes),
    each package verifies the other's seal, and a flipped byte fails in
    both."""
    port, ref = _payload(kind)
    mine = integrity.seal_pages(dict(port))["crc"]
    theirs = jax_integrity.seal_pages(dict(ref))["crc"]
    np.testing.assert_array_equal(mine, theirs)
    assert mine.dtype == theirs.dtype == np.uint32
    assert integrity.verify_pages(dict(port, crc=theirs)) == 3
    assert jax_integrity.verify_pages(dict(ref, crc=mine)) == 3
    flipped = {k: (v.copy() if isinstance(v, np.ndarray) else v)
               for k, v in port.items()}
    flipped["v"].view(np.uint8).flat[-1] ^= 0x10
    with pytest.raises(KVIntegrityError) as ei:
        integrity.verify_pages(dict(flipped, crc=theirs))
    assert ei.value.block == 2


class TestAuditSampling:
    def test_deterministic_and_bounded(self):
        assert not any(integrity.audit_sampled(g, 0.0) for g in range(50))
        assert all(integrity.audit_sampled(g, 1.0) for g in range(50))
        picks = [integrity.audit_sampled(g, 0.3) for g in range(4000)]
        assert picks == [jax_integrity.audit_sampled(g, 0.3)
                         for g in range(4000)]
        frac = sum(picks) / len(picks)
        assert 0.25 < frac < 0.35, frac


class TestSuspicionScore:
    def test_threshold_crossing_fires_once_and_resets(self):
        t = [0.0]
        s = integrity.SuspicionScore(threshold=2, window_s=10.0,
                                     clock=lambda: t[0])
        assert not s.charge()
        assert s.charge()
        assert s.score() == 0
        assert not s.charge()

    def test_window_leak(self):
        t = [0.0]
        s = integrity.SuspicionScore(threshold=2, window_s=5.0,
                                     clock=lambda: t[0])
        assert not s.charge()
        t[0] = 6.0
        assert not s.charge()
        assert s.score() == 1

    def test_bulk_charge_and_validation(self):
        s = integrity.SuspicionScore(threshold=3)
        assert s.charge(3)
        with pytest.raises(ValueError):
            integrity.SuspicionScore(threshold=0)


# ---------------------------------------------------------------------------
# the host tier's read-back boundary
# ---------------------------------------------------------------------------

class TestHostTierChecksums:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_sealed_spill_pop_round_trip(self, kv_dtype):
        cache = _filled_pool(kv_dtype=kv_dtype, seed=11)
        cache.page_checksums = True
        want = cache.export_request_pages([2, 5], 2 * cache.block_size)
        tier = HostKVTier(cache, 16, async_transfer=False)
        try:
            tier.spill_blocks([(2, b"h" * 20), (5, b"g" * 20)])
            for i, h in enumerate((b"h" * 20, b"g" * 20)):
                got = tier.pop_prefix(h)
                assert got is not None
                # the one-block view carries its own block's seal
                np.testing.assert_array_equal(got["crc"],
                                              want["crc"][i:i + 1])
                for key in ("k", "v") + (("k_scale", "v_scale")
                                         if kv_dtype == "int8" else ()):
                    np.testing.assert_array_equal(got[key],
                                                  want[key][:, i:i + 1])
        finally:
            tier.close()

    @pytest.mark.parametrize("kv_dtype,plane", [
        (None, "k"), ("int8", "v"), ("int8", "k_scale")])
    def test_corrupt_resident_entry_dropped_not_served(self, kv_dtype,
                                                       plane):
        cache = _filled_pool(kv_dtype=kv_dtype, seed=5)
        cache.page_checksums = True
        tier = HostKVTier(cache, 16, async_transfer=False)
        try:
            tier.spill_blocks([(1, b"p" * 20)])
            with tier._lock:
                (key, entry), = tier._entries.items()
            pages = (entry if isinstance(entry, dict)
                     else entry.materialize())
            np.asarray(pages[plane]).view(np.uint8).flat[0] ^= 0x40
            before = integrity._M_PAGES_REJECTED.value(instance=None)
            with pytest.warns(RuntimeWarning, match="corrupt"):
                assert tier.pop_prefix(b"p" * 20) is None
            assert integrity._M_PAGES_REJECTED.value(
                instance=None) == before + 1
            with tier._lock:
                assert key not in tier._entries
            assert tier.host_blocks_in_use == 0
        finally:
            tier.close()

    def test_corrupt_spilled_request_is_a_revive_miss(self):
        """``peek_request`` of a flipped spill returns None and frees the
        entry: the scheduler counts a revive miss and re-prefills."""
        cache = _filled_pool(seed=9)
        cache.page_checksums = True
        tier = HostKVTier(cache, 16, async_transfer=False)
        try:
            assert tier.spill_request(7, [1, 2, 3], 10)
            pages = tier._entries[("req", 7)].materialize()
            pages["k"].view(np.uint8).flat[5] ^= 0x02
            with pytest.warns(RuntimeWarning, match="corrupt"):
                assert tier.peek_request(7) is None
            assert len(tier) == 0
        finally:
            tier.close()

    def test_seal_is_decided_at_snapshot_time(self):
        """The arming flag is read when the gathers are enqueued: a
        snapshot taken armed is sealed even if the flag drops before the
        copy, and one taken unarmed is not sealed after."""
        cache = _filled_pool(seed=2)
        cache.page_checksums = True
        armed = cache.snapshot_request_pages([1, 2], 8)
        cache.page_checksums = False
        unarmed = cache.snapshot_request_pages([1, 2], 8)
        cache.page_checksums = True
        assert "crc" in armed.materialize()
        assert "crc" not in unarmed.materialize()
        assert integrity.verify_pages(armed.view(1).materialize()) == 1


# ---------------------------------------------------------------------------
# engine read-back boundaries
# ---------------------------------------------------------------------------

class TestEngineChecksums:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_spill_revive_round_trip_bit_exact(self, model, kv_dtype):
        cfg = model.config
        prompts = unique_prompts(cfg, [8, 8, 8], seed=2)
        kw = dict(block_size=8, kv_dtype=kv_dtype)
        with engine(model, num_blocks=64, max_batch_size=3, **kw) as ref:
            want = ref.generate(prompts, SamplingParams(max_new_tokens=20))
        with engine(model, num_blocks=5, max_batch_size=2,
                    kv_host_blocks=32, kv_page_checksums=True,
                    **kw) as eng:
            got = eng.generate(prompts, SamplingParams(max_new_tokens=20))
            m = eng.metrics()
        assert m["kv_pages_verified"] >= 1, m
        assert m["kv_pages_rejected"] == 0, m
        assert m["kv_revives"] == m["kv_spills"] >= 1, m
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_corrupt_spill_degrades_to_reprefill(self, model):
        cfg = model.config
        prompts = unique_prompts(cfg, [8, 8, 8], seed=4)
        with engine(model, num_blocks=64, block_size=8,
                    max_batch_size=3) as ref:
            want = ref.generate(prompts, SamplingParams(max_new_tokens=20))
        eng = engine(model, num_blocks=5, block_size=8, max_batch_size=2,
                     kv_host_blocks=32, kv_page_checksums=True)
        try:
            rids = [eng.add_request(p, SamplingParams(max_new_tokens=20))
                    for p in prompts]
            flipped = None
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                while eng.has_work():
                    eng.step()
                    if flipped is None and eng.kv_tier._entries:
                        flipped = integrity.flip_bit(eng, "host_entry")
            assert flipped is not None
            got = [eng.output_tokens(r) for r in rids]
            m, st = eng.metrics(), eng.stats()
        finally:
            eng.close()
        assert m["kv_pages_rejected"] >= 1, m
        assert st["revive_misses"] >= 1, st
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_corrupt_imported_pages_rejected_typed(self, model):
        kw = dict(num_blocks=16, block_size=4, max_batch_size=2)
        with engine(model, prefill_only=True, **kw) as pre, \
                engine(model, **kw) as dec:
            prompt = unique_prompts(model.config, [9], seed=6)[0]
            rid = pre.add_request(prompt, SamplingParams(max_new_tokens=4))
            first = None
            while first is None:
                for out in pre.step():
                    first = out
            pages = integrity.seal_pages(pre.export_kv_pages(rid))
            pre.cancel(rid, reason="handoff")
            pre.release(rid)
            prompt2 = np.concatenate(
                [prompt, np.array([first.token], np.int32)])
            np.asarray(pages["k"]).view(np.uint8).flat[7] ^= 0x20
            free_before = dec.cache.allocator.num_free
            with pytest.raises(KVIntegrityError):
                dec.add_request_with_pages(
                    prompt2, pages, SamplingParams(max_new_tokens=3))
            assert dec.cache.allocator.num_free == free_before
            assert not dec.scheduler.waiting and not dec._requests
            assert dec.metrics()["kv_pages_rejected"] == 1

    def test_export_is_sealed_when_armed(self, model):
        with engine(model, prefill_only=True, num_blocks=16, block_size=4,
                    max_batch_size=2, kv_page_checksums=True) as pre:
            rid = pre.add_request(unique_prompts(model.config, [9])[0],
                                  SamplingParams(max_new_tokens=4))
            pre.step()
            pages = pre.export_kv_pages(rid)
            assert pages["crc"].shape == (3,)
            assert jax_integrity.verify_pages(pages) == 3


class TestWeightAudit:
    def _fresh(self):
        paddle.seed(11)
        jm = JaxLlama(jax_tiny())
        tm = LlamaForCausalLM(llama_tiny(), device="cpu")
        load_paddle_tpu_state_dict(
            tm, {k: np.asarray(v.numpy())
                 for k, v in jm.state_dict().items()})
        return jm, tm

    def test_flip_detected_and_restore_reanchors(self):
        _, m = self._fresh()
        saved = {k: v.clone() for k, v in m.state_dict().items()}
        with engine(m, num_blocks=8, block_size=4, max_batch_size=2,
                    weight_audit=True) as eng:
            assert eng.audit_weights()
            ptrs = {k: v.data_ptr() for k, v in m.state_dict().items()}
            flip = integrity.flip_bit(eng, "weights")
            assert flip and flip["flips"] >= 1
            assert {k: v.data_ptr()
                    for k, v in m.state_dict().items()} == ptrs
            assert not eng.audit_weights()
            m0 = eng.metrics()
            assert m0["weight_audit_failures"] >= 1, m0
            assert m0["weight_audits"] >= 2, m0
            with torch.no_grad():
                for k, v in m.state_dict().items():
                    v.copy_(saved[k])
            assert eng.audit_weights()

    def test_unarmed_engine_anchors_lazily(self, model):
        with engine(model, num_blocks=8, block_size=4,
                    max_batch_size=2) as eng:
            assert eng._weight_audit_ref is None
            assert eng.audit_weights()
            assert eng.audit_weights()
            assert eng.metrics()["weight_audits"] == 2

    def test_weight_flip_matches_the_reference(self):
        """The JAX package's and the port's weight flips change the same
        elements: the fingerprints agree before and after."""
        jm, tm = self._fresh()
        assert weights_fingerprint(tm) == jax_fingerprint(jm)
        je = JaxEngine(jm, num_blocks=8, block_size=4, max_batch_size=2,
                       ingest_async=False)
        try:
            with engine(tm, num_blocks=8, block_size=4,
                        max_batch_size=2) as te:
                a = jax_integrity.flip_bit(je, "weights")
                b = integrity.flip_bit(te, "weights")
                assert a == b
        finally:
            je.close()
        assert weights_fingerprint(tm) == jax_fingerprint(jm)

    def test_reload_weights_reanchors(self, tmp_path):
        """A flipped engine reloaded from its artifact audits clean again
        and decodes the tokens of before the flip, with every parameter
        written in place."""
        _, m = self._fresh()
        path = os.path.join(str(tmp_path), "tiny")
        save_llama_artifact(m, path)
        prompt = unique_prompts(m.config, [11], seed=8)
        with engine(m, num_blocks=16, block_size=4, max_batch_size=2,
                    weight_audit=True, decode_steps_per_sync=4) as eng:
            before = eng.generate(prompt, SamplingParams(max_new_tokens=8))
            ptrs = [p.data_ptr() for p in m.parameters()]
            integrity.flip_bit(eng, "weights")
            flipped = eng.generate(prompt,
                                   SamplingParams(max_new_tokens=8))
            assert not eng.audit_weights()
            eng.reload_weights(path)
            assert eng.audit_weights()
            after = eng.generate(prompt, SamplingParams(max_new_tokens=8))
            assert [p.data_ptr() for p in m.parameters()] == ptrs
            assert eng.metrics()["weight_audit_failures"] == 1
        np.testing.assert_array_equal(after[0], before[0])
        assert not np.array_equal(flipped[0], before[0])


class TestFlipInPlace:
    def test_kv_page_flip_lands_in_the_pool_unseen_by_crcs(self, model):
        with engine(model, num_blocks=8, block_size=4, max_batch_size=2,
                    kv_page_checksums=True) as eng:
            g = eng.cache._groups["k"]
            ptr = g.data_ptr()
            g.normal_()
            before = g[0, 3].clone()
            assert integrity.flip_bit(eng, "kv_page", block=3) == {
                "target": "kv_page", "block": 3}
            assert g.data_ptr() == ptr
            torch.testing.assert_close(g[0, 3], -before - 1, rtol=0,
                                       atol=0)
            # the pool has no seal: the flip is the fleet's audit's class
            assert eng.metrics()["kv_pages_rejected"] == 0

    def test_int8_kv_page_flip(self, model):
        with engine(model, num_blocks=8, block_size=4, max_batch_size=2,
                    kv_dtype="int8") as eng:
            k0 = eng.cache.k[0]
            k0.copy_(torch.randint(-127, 128, k0.shape, dtype=torch.int8))
            before = k0[2].clone()
            integrity.flip_bit(eng, "kv_page", block=2)
            assert torch.equal(k0[2], -before - 1)

    def test_host_entry_flip_needs_a_resident_entry(self, model):
        with engine(model, num_blocks=8, block_size=4,
                    max_batch_size=2) as eng:
            assert integrity.flip_bit(eng, "host_entry") is None
            with pytest.raises(ValueError, match="unknown bit-flip"):
                integrity.flip_bit(eng, "gremlins")


class TestMetricsRegistered:
    def test_new_integrity_metrics_registered(self, model):
        for name in ("serving_kv_pages_verified_total",
                     "serving_kv_pages_rejected_total",
                     "serving_weight_audit_failures_total",
                     "serving_deadline_expired_total",
                     "serving_quota_throttled_total",
                     "serving_batch_yields_total",
                     "serving_tenant_tokens_total"):
            assert obs_metrics.REGISTRY.get(name) is not None, name
        with engine(model, num_blocks=8, block_size=4, max_batch_size=2,
                    kv_page_checksums=True, weight_audit=True) as eng:
            m = eng.metrics()
            name = eng._name
        for key in ("kv_pages_verified", "kv_pages_rejected",
                    "weight_audits", "weight_audit_failures",
                    "deadline_expired", "quota_throttled", "batch_yields"):
            assert m[key] == 0, key
        snap = obs_metrics.REGISTRY.snapshot()
        for metric in ("serving_kv_pages_verified_total",
                       "serving_weight_audit_failures_total"):
            assert not any(name in k for k in snap[metric]["series"])


class TestPrefixStoreReasons:
    def test_typed_reasons(self):
        e = PrefixStoreMismatch("boom")
        assert e.reason == "corrupt"
        e = PrefixStoreMismatch("boom", reason="fingerprint")
        assert e.reason == "fingerprint"
        assert set(REJECT_REASONS) == {
            "corrupt", "version", "fingerprint", "geometry"}
        # the reference asserts; the port raises a typed error
        with pytest.raises(ValueError):
            PrefixStoreMismatch("boom", reason="gremlins")
