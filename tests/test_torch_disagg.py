"""The port's disaggregated prefill/decode handoff on the CPU: the
engine-level cases of ``tests/test_disagg.py`` proved again in the port
(page export, the wire format, import validation, disaggregated tokens
bit for bit the colocated engine's, prefill-only engines, lifecycle),
plus the pages crossing between the port and the JAX package both ways,
the in-place import under a decode-window engine, bf16 pages as bits, and
a payload the JAX package sealed: verified and served, or, flipped,
refused with ``KVIntegrityError``."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.inference.serving import pack_kv_pages as jax_pack
from paddle_tpu.inference.serving import unpack_kv_pages as jax_unpack
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import (
    EngineClosedError, LLMEngine, SamplingParams, pack_kv_pages,
    unpack_kv_pages)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)

# the reference's engine arguments (tests/test_disagg.py)
ENGINE_KW = dict(num_blocks=64, block_size=8, max_batch_size=4)
PORT_KW = dict(ENGINE_KW, device="cpu", ingest_async=False)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def tiny_model(models):
    return models[1]


def _prompts(n=3, seed=3, lens=(5, 11, 16)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, ln).astype(np.int32) for ln in lens[:n]]


def _prefill_one(pre, prompt, max_new, sampling=SamplingParams):
    """One prompt through a prefill-only engine (either package's):
    (its first StepOutput, its exported pages or None); the request is
    cancelled and released."""
    rid = pre.add_request(prompt, sampling(max_new_tokens=max_new))
    first = None
    while first is None:
        for out in pre.step():
            assert out.rid == rid
            first = out
    pages = None
    if not first.finished:
        pages = pre.export_kv_pages(rid)
        pre.cancel(rid, reason="handoff")
    pre.release(rid)
    return first, pages


def _handoff_prompt(prompt, first):
    return np.concatenate([prompt, [first.token]]).astype(np.int32)


def _decode_all(dec, p2, pages, max_new, sampling=SamplingParams):
    rid = dec.add_request_with_pages(p2, pages,
                                     sampling(max_new_tokens=max_new))
    toks = list(p2)
    for out in dec.stream():
        if out.rid == rid:
            toks.append(out.token)
    dec.release(rid)
    return np.asarray(toks, np.int32)


def _disagg_outputs(model, prompts, max_new, engine_kw, roundtrip=True,
                    dec_kw=None):
    """Two port engines in one process: a prefill-only engine exports each
    prompt's pages (through the wire format unless ``roundtrip`` is
    False), a second engine imports and decodes them."""
    pre = LLMEngine(model, prefill_only=True, **engine_kw)
    dec = LLMEngine(model, **{**engine_kw, **(dec_kw or {})})
    outs = []
    try:
        for p in prompts:
            first, pages = _prefill_one(pre, p, max_new)
            p2 = _handoff_prompt(p, first)
            if first.finished:
                outs.append(p2)
                continue
            if roundtrip:
                pages = unpack_kv_pages(pack_kv_pages(pages))
            outs.append(_decode_all(dec, p2, pages, max_new - 1))
    finally:
        pre.close()
        dec.close()
    return outs


def _colocated(model, prompts, max_new, **kw):
    with LLMEngine(model, **kw) as eng:
        return eng.generate(prompts, SamplingParams(max_new_tokens=max_new))


# ---------------------------------------------------------------------------
# page export / import / wire format
# ---------------------------------------------------------------------------

class TestPageWireFormat:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_pack_unpack_roundtrip(self, tiny_model, kv_dtype):
        pre = LLMEngine(tiny_model, prefill_only=True,
                        **dict(PORT_KW, kv_dtype=kv_dtype))
        try:
            _, pages = _prefill_one(pre, _prompts(1)[0], 4)
            back = unpack_kv_pages(pack_kv_pages(pages))
            assert back["covered"] == pages["covered"]
            assert back["block_size"] == pages["block_size"]
            assert back["kv_dtype"] == kv_dtype
            np.testing.assert_array_equal(back["k"], pages["k"])
            np.testing.assert_array_equal(back["v"], pages["v"])
            if kv_dtype == "int8":
                np.testing.assert_array_equal(back["k_scale"],
                                              pages["k_scale"])
                np.testing.assert_array_equal(back["v_scale"],
                                              pages["v_scale"])
        finally:
            pre.close()

    def test_unpack_rejects_garbage(self):
        with pytest.raises(ValueError):
            unpack_kv_pages(b"not a page payload")

    def test_import_validates_geometry(self, tiny_model):
        pre = LLMEngine(tiny_model, prefill_only=True, **PORT_KW)
        dec = LLMEngine(tiny_model, **dict(PORT_KW, kv_dtype="int8"))
        dec16 = LLMEngine(tiny_model, **dict(PORT_KW, block_size=16))
        try:
            first, pages = _prefill_one(pre, _prompts(1)[0], 4)
            p2 = _handoff_prompt(_prompts(1)[0], first)
            sp = SamplingParams(max_new_tokens=3)
            with pytest.raises(ValueError, match="kv_dtype"):
                dec.add_request_with_pages(p2, pages, sp)
            with pytest.raises(ValueError, match="block_size"):
                dec16.add_request_with_pages(p2, pages, sp)
            bad = dict(pages, covered=pages["covered"] + 1)
            with pytest.raises(ValueError, match="cover"):
                dec16.add_request_with_pages(p2, bad, sp)
            shaved = dict(pages)
            shaved["k"] = pages["k"][..., :4]
            with pytest.raises(ValueError, match="fit this pool"):
                pre.cache.import_request_pages([1, 2], shaved)
            # an int8 payload missing its scale rows: refused at
            # admission, before any pool moves, and by the wire format
            pre8 = LLMEngine(tiny_model, prefill_only=True,
                             **dict(PORT_KW, kv_dtype="int8"))
            try:
                f8, pages8 = _prefill_one(pre8, _prompts(1)[0], 4)
                p8 = _handoff_prompt(_prompts(1)[0], f8)
                bad8 = {k: v for k, v in pages8.items() if k != "k_scale"}
                with pytest.raises(ValueError, match="missing"):
                    dec.add_request_with_pages(p8, bad8, sp)
                with pytest.raises(ValueError, match="missing"):
                    unpack_kv_pages(pack_kv_pages(bad8))
            finally:
                pre8.close()
            assert not dec.scheduler.waiting and not dec16.scheduler.waiting
        finally:
            pre.close()
            dec.close()
            dec16.close()

    def test_import_refuses_another_element_type(self, tiny_model):
        """A payload whose element type is not the pool's is refused, not
        cast: fp32 pages into a bf16 pool, uint16 bits into an fp32
        pool."""
        pre = LLMEngine(tiny_model, prefill_only=True, **PORT_KW)
        bf = LlamaForCausalLM(llama_tiny(), device="cpu",
                              dtype=torch.bfloat16)
        dec_bf = LLMEngine(bf, **PORT_KW)
        dec32 = LLMEngine(tiny_model, **PORT_KW)
        try:
            first, pages = _prefill_one(pre, _prompts(1)[0], 4)
            p2 = _handoff_prompt(_prompts(1)[0], first)
            sp = SamplingParams(max_new_tokens=3)
            with pytest.raises(ValueError, match="would cast"):
                dec_bf.add_request_with_pages(p2, pages, sp)
            bits = dict(pages, k=pages["k"].view(np.uint16)[..., ::2],
                        v=pages["v"].view(np.uint16)[..., ::2])
            with pytest.raises(ValueError, match="would cast"):
                dec32.cache.validate_request_pages(bits)
            assert not dec_bf.scheduler.waiting
        finally:
            for e in (pre, dec_bf, dec32):
                e.close()


# ---------------------------------------------------------------------------
# engine-level handoff: greedy determinism
# ---------------------------------------------------------------------------

class TestEngineDisaggDeterminism:
    @pytest.mark.parametrize("kv_dtype,prefix", [
        (None, False), ("int8", False), (None, True), ("int8", True),
    ])
    def test_disagg_bit_exact_vs_colocated(self, tiny_model, kv_dtype,
                                           prefix):
        kw = dict(PORT_KW, kv_dtype=kv_dtype, enable_prefix_cache=prefix)
        prompts = _prompts(3)
        if prefix:
            # two prompts sharing a full-block prefix: later admissions
            # share IMPORTED blocks
            prompts[1] = np.concatenate(
                [prompts[0][:8], prompts[1]]).astype(np.int32)
            prompts[2] = np.concatenate(
                [prompts[0][:8], prompts[2][:5]]).astype(np.int32)
        refs = _colocated(tiny_model, prompts, 8, **kw)
        outs = _disagg_outputs(tiny_model, prompts, 8, kw)
        for o, r in zip(outs, refs):
            np.testing.assert_array_equal(o, r)

    def test_first_token_finishes_without_pages(self, tiny_model):
        refs = _colocated(tiny_model, _prompts(1), 1, **PORT_KW)
        pre = LLMEngine(tiny_model, prefill_only=True, **PORT_KW)
        try:
            first, pages = _prefill_one(pre, _prompts(1)[0], 1)
            assert first.finished and pages is None
            assert first.finish_reason == "length"
            np.testing.assert_array_equal(
                _handoff_prompt(_prompts(1)[0], first), refs[0])
        finally:
            pre.close()

    def test_preloaded_eviction_reprefills_bit_exact(self, tiny_model):
        prompts = _prompts(2, lens=(16, 12))
        max_new = 10
        refs = _colocated(tiny_model, prompts, max_new, **PORT_KW)
        pre = LLMEngine(tiny_model, prefill_only=True, **PORT_KW)
        # both requests admit, their growth forces an eviction
        dec = LLMEngine(tiny_model, **dict(PORT_KW, num_blocks=7))
        try:
            outs, rids = {}, {}
            for i, p in enumerate(prompts):
                first, pages = _prefill_one(pre, p, max_new)
                p2 = _handoff_prompt(p, first)
                rid = dec.add_request_with_pages(
                    p2, pages, SamplingParams(max_new_tokens=max_new - 1))
                rids[rid] = i
                outs[i] = list(p2)
            for out in dec.stream():
                outs[rids[out.rid]].append(out.token)
            assert dec.metrics()["evictions"] >= 1
            for i, r in enumerate(refs):
                np.testing.assert_array_equal(
                    np.asarray(outs[i], np.int32), r)
        finally:
            pre.close()
            dec.close()

    def test_preloaded_queues_on_exhaustion_then_admits(self, tiny_model):
        pre = LLMEngine(tiny_model, prefill_only=True, **PORT_KW)
        dec = LLMEngine(tiny_model,
                        **dict(PORT_KW, num_blocks=8, max_batch_size=2))
        try:
            p0 = _prompts(1, lens=(24,))[0]
            hog = dec.add_request(p0, SamplingParams(max_new_tokens=32))
            # run the hog until it holds 6 of the 7 usable blocks
            while dec.request(hog).num_tokens <= 41:
                dec.step()
            p1 = _prompts(1, seed=9, lens=(9,))[0]
            first, pages = _prefill_one(pre, p1, 4)
            p2 = _handoff_prompt(p1, first)
            rid = dec.add_request_with_pages(
                p2, pages, SamplingParams(max_new_tokens=3))
            dec.step()
            assert dec.request(rid).state == "waiting"
            assert dec.metrics()["queued_on_exhaustion"] >= 1
            toks = list(p2)
            for out in dec.stream():
                if out.rid == rid:
                    toks.append(out.token)
            assert dec.request(rid).finished
            assert len(toks) == len(p2) + 3
            dec.release(rid)
            dec.release(hog)
            assert dec.cache.allocator.num_free == 7
        finally:
            pre.close()
            dec.close()

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_import_in_place_under_decode_windows(self, tiny_model,
                                                  kv_dtype):
        """An import writes the live pools in place (every ``data_ptr()``
        kept, as the captured window graph on the card needs), and the
        decode windows after it decode the imported pages: tokens equal a
        colocated window engine's, and no prefill ran on the decode side."""
        kw = dict(PORT_KW, kv_dtype=kv_dtype, decode_steps_per_sync=4)
        prompts = _prompts(3)
        refs = _colocated(tiny_model, prompts, 9, **kw)
        pre = LLMEngine(tiny_model, prefill_only=True, **kw)
        dec = LLMEngine(tiny_model, **kw)
        pools = (dec.cache.k, dec.cache.v, dec.cache.k_scale,
                 dec.cache.v_scale)
        ptrs = [[t.data_ptr() for t in g] for g in pools]
        try:
            for p, r in zip(prompts, refs):
                first, pages = _prefill_one(pre, p, 9)
                got = _decode_all(dec, _handoff_prompt(p, first), pages, 8)
                np.testing.assert_array_equal(got, r)
            assert [[t.data_ptr() for t in g] for g in (
                dec.cache.k, dec.cache.v, dec.cache.k_scale,
                dec.cache.v_scale)] == ptrs
            m = dec.metrics()
            assert m["prefill_chunks"] == 0 and m["decode_steps"] > 0
            assert m["host_syncs"] * 4 == m["decode_steps"]
        finally:
            pre.close()
            dec.close()

    def test_bf16_pages_travel_as_bits(self, tiny_model):
        """bf16 pools export their uint16 bits, which cross the wire format
        and are reinterpreted (never cast) by the import: the handoff gives
        a colocated bf16 engine's tokens bit for bit."""
        bf = LlamaForCausalLM(llama_tiny(), device="cpu",
                              dtype=torch.bfloat16)
        bf.load_state_dict(tiny_model.state_dict())
        prompts = _prompts(2)
        refs = _colocated(bf, prompts, 6, **PORT_KW)
        pre = LLMEngine(bf, prefill_only=True, **PORT_KW)
        try:
            _, pages = _prefill_one(pre, prompts[0], 6)
            assert pages["k"].dtype == np.uint16 and pages["k"].any()
        finally:
            pre.close()
        outs = _disagg_outputs(bf, prompts, 6, PORT_KW)
        for o, r in zip(outs, refs):
            np.testing.assert_array_equal(o, r)


# ---------------------------------------------------------------------------
# prefill-only engine contract
# ---------------------------------------------------------------------------

class TestPrefillOnlyEngine:
    @pytest.mark.parametrize("window", [1, 8])
    def test_never_decodes(self, tiny_model, window):
        """Exactly one token (the prefill's) ever emerges; no decode
        iteration runs and no decode window (the captured graph on the
        card) is built."""
        pre = LLMEngine(tiny_model, prefill_only=True,
                        decode_steps_per_sync=window, **PORT_KW)
        try:
            rid = pre.add_request(_prompts(1)[0],
                                  SamplingParams(max_new_tokens=16))
            emitted = []
            for _ in range(6):
                emitted += list(pre.step())
            assert len(emitted) == 1 and emitted[0].rid == rid
            assert len(pre.request(rid).output_tokens) == 1
            m = pre.metrics()
            assert m["decode_steps"] == 0 and m["host_syncs"] == 0
            assert pre._window is None
            pre.cancel(rid)
            pre.release(rid)
            assert pre.cache.allocator.num_free == \
                ENGINE_KW["num_blocks"] - 1
        finally:
            pre.close()

    def test_rejects_draft_model_and_imported_pages(self, tiny_model):
        with pytest.raises(ValueError, match="prefill_only"):
            LLMEngine(tiny_model, prefill_only=True, draft_model=tiny_model,
                      **PORT_KW)
        pre = LLMEngine(tiny_model, prefill_only=True, **PORT_KW)
        try:
            with pytest.raises(ValueError, match="never decode"):
                pre.add_request_with_pages(
                    _prompts(1)[0], {"covered": 4},
                    SamplingParams(max_new_tokens=2))
        finally:
            pre.close()

    def test_export_requires_decode_ready(self, tiny_model):
        eng = LLMEngine(tiny_model, **PORT_KW)
        try:
            rid = eng.add_request(_prompts(1)[0],
                                  SamplingParams(max_new_tokens=4))
            with pytest.raises(ValueError, match="decode-ready"):
                eng.export_kv_pages(rid)  # still waiting, not prefilled
            eng.cancel(rid)
            eng.release(rid)
        finally:
            eng.close()


def test_engine_close_with_pending_pages_leaks_nothing(tiny_model):
    pre = LLMEngine(tiny_model, prefill_only=True, **PORT_KW)
    try:
        p = _prompts(1)[0]
        first, pages = _prefill_one(pre, p, 6)
    finally:
        pre.close()
    p2 = _handoff_prompt(p, first)
    dec = LLMEngine(tiny_model, **PORT_KW)
    rid = dec.add_request_with_pages(p2, pages,
                                     SamplingParams(max_new_tokens=5))
    dec.close()
    assert dec.cache.allocator.num_free == ENGINE_KW["num_blocks"] - 1
    assert rid is not None
    with pytest.raises(EngineClosedError):
        dec.add_request_with_pages(p2, pages,
                                   SamplingParams(max_new_tokens=5))
    with pytest.raises(EngineClosedError):
        dec.step()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _jax_colocated(jm, prompts, max_new, **kw):
    eng = JaxEngine(jm, ingest_async=False, **ENGINE_KW, **kw)
    try:
        return eng.generate(prompts, JaxSampling(max_new_tokens=max_new))
    finally:
        eng.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_port_pages_decode_in_the_jax_engine(models, kv_dtype):
    """The port's export, packed, unpacked by the JAX package and admitted
    by a JAX engine, decodes the JAX colocated engine's tokens."""
    jm, tm = models
    prompts = _prompts(3, seed=4)
    refs = _jax_colocated(jm, prompts, 7, kv_dtype=kv_dtype)
    pre = LLMEngine(tm, prefill_only=True, **dict(PORT_KW,
                                                   kv_dtype=kv_dtype))
    dec = JaxEngine(jm, ingest_async=False, kv_dtype=kv_dtype, **ENGINE_KW)
    try:
        for p, r in zip(prompts, refs):
            first, pages = _prefill_one(pre, p, 7)
            got = _decode_all(dec, _handoff_prompt(p, first),
                              jax_unpack(pack_kv_pages(pages)), 6,
                              sampling=JaxSampling)
            np.testing.assert_array_equal(got, r)
    finally:
        pre.close()
        dec.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_jax_pages_decode_in_the_port_engine(models, kv_dtype):
    """The JAX package's export, packed there and unpacked here, decodes
    in the port the tokens of the port's colocated engine (the JAX
    engine's too)."""
    jm, tm = models
    prompts = _prompts(3, seed=5)
    refs = _colocated(tm, prompts, 7, **dict(PORT_KW, kv_dtype=kv_dtype))
    jrefs = _jax_colocated(jm, prompts, 7, kv_dtype=kv_dtype)
    pre = JaxEngine(jm, ingest_async=False, prefill_only=True,
                    kv_dtype=kv_dtype, **ENGINE_KW)
    dec = LLMEngine(tm, **dict(PORT_KW, kv_dtype=kv_dtype))
    try:
        for p, r, jr in zip(prompts, refs, jrefs):
            first, pages = _prefill_one(pre, p, 7, sampling=JaxSampling)
            got = _decode_all(dec, _handoff_prompt(p, first),
                              unpack_kv_pages(jax_pack(pages)), 6)
            np.testing.assert_array_equal(got, r)
            np.testing.assert_array_equal(got, jr)
    finally:
        pre.close()
        dec.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_packed_pages_read_the_same_in_both_packages(models, kv_dtype):
    """``pack_kv_pages`` bytes of either package unpack to the same
    arrays in the other; the two packages' pages of one prompt are the
    same to within fp32 rounding (int8: the codes of rows that round
    alike)."""
    jm, tm = models
    p = _prompts(1, seed=6)[0]
    jpre = JaxEngine(jm, ingest_async=False, prefill_only=True,
                     kv_dtype=kv_dtype, **ENGINE_KW)
    tpre = LLMEngine(tm, prefill_only=True, **dict(PORT_KW,
                                                    kv_dtype=kv_dtype))
    try:
        _, jpages = _prefill_one(jpre, p, 4, sampling=JaxSampling)
        _, tpages = _prefill_one(tpre, p, 4)
    finally:
        jpre.close()
        tpre.close()
    a = jax_unpack(pack_kv_pages(tpages))
    b = unpack_kv_pages(jax_pack(jpages))
    keys = ("k", "v") + (("k_scale", "v_scale") if kv_dtype else ())
    for key in keys:
        np.testing.assert_array_equal(a[key], tpages[key])
        np.testing.assert_array_equal(b[key], jpages[key])
        assert a[key].dtype == b[key].dtype
    for key in ("covered", "block_size", "kv_dtype"):
        assert a[key] == b[key] == tpages[key] == jpages[key]
    if kv_dtype is None:
        np.testing.assert_allclose(a["k"], b["k"], rtol=1e-5, atol=1e-5)


def _jax_sealed_handoff(jm):
    """A handoff the JAX package's prefill engine sealed with per-block
    CRCs (``kv_page_checksums=True``), through its wire format: (the
    prompt plus its first token, the unpacked payload)."""
    pre = JaxEngine(jm, ingest_async=False, prefill_only=True,
                    kv_page_checksums=True, **ENGINE_KW)
    try:
        p = _prompts(1)[0]
        first, pages = _prefill_one(pre, p, 4, sampling=JaxSampling)
    finally:
        pre.close()
    pages = unpack_kv_pages(jax_pack(pages))
    assert "crc" in pages
    return _handoff_prompt(p, first), pages


def test_sealed_payload_is_verified_and_served(models):
    """A payload the JAX package sealed is verified on import (every block
    counted) and decodes the tokens of the same payload unsealed."""
    jm, tm = models
    p2, pages = _jax_sealed_handoff(jm)
    plain = {k: v for k, v in pages.items() if k != "crc"}
    dec = LLMEngine(tm, **PORT_KW)
    try:
        got = _decode_all(dec, p2, pages, 3)
        m = dec.metrics()
        want = _decode_all(dec, p2, plain, 3)
    finally:
        dec.close()
    assert m["kv_pages_verified"] == pages["k"].shape[1]
    assert m["kv_pages_rejected"] == 0
    np.testing.assert_array_equal(got, want)


def test_sealed_payload_is_refused(models):
    """A payload the JAX package sealed whose bytes then changed raises
    ``KVIntegrityError`` at ``add_request_with_pages``, before any block
    moves; nothing is admitted."""
    from paddle_tpu_torch.inference.serving import KVIntegrityError

    jm, tm = models
    p2, pages = _jax_sealed_handoff(jm)
    pages["v"].view(np.uint8).flat[pages["v"].nbytes // 2] ^= 0x04
    dec = LLMEngine(tm, **PORT_KW)
    try:
        with pytest.raises(KVIntegrityError, match="CRC mismatch"):
            dec.add_request_with_pages(p2, pages,
                                       SamplingParams(max_new_tokens=3))
        assert not dec.scheduler.waiting and not dec._requests
        assert dec.cache.allocator.num_free == ENGINE_KW["num_blocks"] - 1
        assert dec.metrics()["kv_pages_rejected"] == 1
    finally:
        dec.close()
