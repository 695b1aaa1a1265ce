"""The port's ``LLMEngine`` on the CPU: held against the JAX package's
engine (greedy tokens on the same weights and prompts), and against its
own invariants (batch-of-one equality, bit-exact re-prefill after forced
eviction, int8 KV determinism, prefix sharing, lifecycle)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import (
    BlockAllocator, EngineClosedError, LLMEngine, PagedKVCache, PrefixCache,
    SamplingParams)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)

LENGTHS = (5, 17, 33, 9)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, n).astype(np.int32) for n in lengths]


def _port(tm, prompts, new=8, **kw):
    kw = {"num_blocks": 64, "block_size": 4, "max_batch_size": 3, **kw}
    with LLMEngine(tm, device="cpu", **kw) as eng:
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=new))
        return outs, eng.metrics()


@pytest.mark.parametrize("chunk", [None, 8])
def test_greedy_tokens_match_jax_engine(models, chunk):
    jm, tm = models
    prompts = _prompts()
    je = JaxEngine(jm, num_blocks=64, block_size=4, max_batch_size=3,
                   max_prefill_tokens_per_step=chunk)
    try:
        want = je.generate(prompts, JaxSampling(max_new_tokens=8))
    finally:
        je.close()
    got, m = _port(tm, prompts, max_prefill_tokens_per_step=chunk)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    if chunk is not None:
        assert m["prefill_chunks"] > len(prompts)  # prompts were split


def test_engine_equals_batch_of_one(models):
    _, tm = models
    prompts = _prompts(seed=1)
    batched, _ = _port(tm, prompts, new=6)
    for p, b in zip(prompts, batched):
        single, _ = _port(tm, [p], new=6, max_batch_size=1)
        np.testing.assert_array_equal(single[0], b)


def test_forced_eviction_reprefill_is_bit_exact(models):
    _, tm = models
    prompts = _prompts((8, 8, 8), seed=2)
    roomy, m0 = _port(tm, prompts, new=12)
    assert m0["evictions"] == 0
    # 9 usable blocks x 4 tokens: three 20-token requests cannot all fit
    tight, m1 = _port(tm, prompts, new=12, num_blocks=10)
    assert m1["evictions"] > 0
    for a, b in zip(roomy, tight):
        np.testing.assert_array_equal(a, b)


def test_int8_kv_is_deterministic(models):
    _, tm = models
    prompts = _prompts(seed=3)
    a, m = _port(tm, prompts, kv_dtype="int8")
    b, _ = _port(tm, prompts, kv_dtype="int8")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert m["kv_bytes_saved"] > 0 and m["kv_dtype"] == "int8"


def test_int8_kv_matches_jax_engine(models):
    jm, tm = models
    prompts = _prompts(seed=4)
    je = JaxEngine(jm, num_blocks=64, block_size=4, max_batch_size=3,
                   kv_dtype="int8")
    try:
        want = je.generate(prompts, JaxSampling(max_new_tokens=8))
    finally:
        je.close()
    got, _ = _port(tm, prompts, kv_dtype="int8")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_prefix_cache_shares_blocks_and_keeps_tokens(models):
    _, tm = models
    rng = np.random.RandomState(5)
    shared = rng.randint(0, 512, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 512, n)]).astype(
        np.int32) for n in (3, 6, 9)]
    plain, _ = _port(tm, prompts, max_batch_size=1)
    cached, m = _port(tm, prompts, max_batch_size=1,
                      enable_prefix_cache=True)
    assert m["prefix_blocks_reused"] > 0
    for a, b in zip(plain, cached):
        np.testing.assert_array_equal(a, b)


def test_stream_cancel_release_close(models):
    _, tm = models
    eng = LLMEngine(tm, num_blocks=64, block_size=4, max_batch_size=2,
                    device="cpu")
    r1 = eng.add_request(_prompts((6,))[0], SamplingParams(max_new_tokens=4))
    r2 = eng.add_request(_prompts((7,), seed=1)[0],
                         SamplingParams(max_new_tokens=50))
    seen = []
    for out in eng.stream():
        seen.append(out)
        if out.rid == r1 and out.finished:
            assert eng.cancel(r2)
    assert [o.token for o in seen if o.rid == r1] == \
        list(eng.output_tokens(r1)[6:])
    assert eng.request(r2).finish_reason() == "cancelled"
    eng.release(r1)
    eng.close()
    with pytest.raises(EngineClosedError):
        eng.add_request([1, 2, 3])
    assert eng.cache.allocator.num_free == 63


def test_admission_limits(models):
    _, tm = models
    with LLMEngine(tm, num_blocks=8, block_size=4, device="cpu") as eng:
        with pytest.raises(ValueError, match="caps"):
            eng.add_request(np.zeros(20, np.int32),
                            SamplingParams(max_new_tokens=20))
    with pytest.warns(RuntimeWarning, match="rounding down"):
        eng = LLMEngine(tm, block_size=16, max_model_len=100, device="cpu")
    assert eng.max_model_len == 96
    eng.close()


def test_pools_live_on_the_device_and_copy_in_place():
    cache = PagedKVCache(llama_tiny(), 6, 4, kv_dtype="int8", device="cpu")
    assert cache.k[0].dtype == torch.int8 and cache.k_scale[0].shape == (
        6, 4, 2)
    cache.k[1][2] = 5
    cache.k_scale[1][2] = 0.5
    pool = cache.k[1]
    cache.copy_block(2, 4)
    assert cache.k[1] is pool  # same tensor, written in place
    assert bool((cache.k[1][4] == 5).all())
    assert bool((cache.k_scale[1][4] == 0.5).all())


def test_allocator_and_prefix_cache():
    a = BlockAllocator(4)
    got = a.allocate(3)
    assert sorted(got) == [1, 2, 3] and a.allocate(1) is None
    with pytest.raises(ValueError):
        a.free([got[0], got[0]])
    pc = PrefixCache(a, 2)
    toks = np.arange(5)
    pc.register(toks, got, 4)
    assert pc.match(toks) == (got[:2], 4)
    a.free(got)
    assert a.num_free == 3  # two registered blocks park as reusable
    assert pc.match(toks) == (got[:2], 4)
