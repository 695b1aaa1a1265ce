"""Speculative decoding in the port's ``LLMEngine`` on the CPU, proved
again from the reference's tests (``tests/test_serving.py``'s
``TestSpeculativeDecoding``: a self-draft accepts everything, an
independent 1-layer draft and forced full rejection stay bit-exact
against ``generate``, eviction under prefix sharing, eos inside the accept
window, ``do_sample`` and vocab mismatches refused, the metric series;
``tests/test_quantized_serving.py``'s int8 KV spec vs plain;
``tests/test_device_decode.py``'s exclusions), then held against the JAX
package's engine on the same fp32 ``llama_tiny`` weights: identical
tokens, ``spec_proposed`` and ``spec_accepted`` for a self-draft and for a
1-layer draft, with the fused catch-up and without. On the CPU the fused
catch-up runs eagerly; on the card ``chip_smoke.py`` replays it as a CUDA
graph per feed bucket and runs the verify's attention on kernel #2."""

import dataclasses

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import (BlockAllocator, LLMEngine,
                                                PagedKVCache, SamplingParams)
from paddle_tpu_torch.inference.serving.scheduler import Request, Scheduler
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.observability import metrics as om

V = 512


def carry(jm):
    tm = LlamaForCausalLM(dataclasses.replace(
        llama_tiny(), num_hidden_layers=jm.config.num_hidden_layers),
        device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return tm


@pytest.fixture(scope="module")
def jax_models():
    """The reference tests' target (seed 7) and 1-layer draft (seed 99)."""
    paddle.seed(7)
    target = JaxLlama(jax_tiny())
    target.eval()
    paddle.seed(99)
    draft = JaxLlama(dataclasses.replace(jax_tiny(), num_hidden_layers=1))
    draft.eval()
    return target, draft


@pytest.fixture(scope="module")
def model(jax_models):
    return carry(jax_models[0])


@pytest.fixture(scope="module")
def draft_model(jax_models):
    return carry(jax_models[1])


def prompts_fixed(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lengths]


def shared_prompts(shared_len, suffix_lens, seed=0):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, V, shared_len).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, V, n).astype(np.int32)])
            for n in suffix_lens]


def refs_of(model, prompts, new, **kw):
    return [model.generate(p[None], max_new_tokens=new, **kw).cpu().numpy()[0]
            for p in prompts]


def engine(model, **kw):
    return LLMEngine(model, device="cpu", **kw)


def test_self_draft_bit_exact_full_accept(model):
    prompts = prompts_fixed([5, 9, 3], seed=50)
    refs = refs_of(model, prompts, 9)
    with engine(model, num_blocks=64, block_size=8, max_batch_size=3,
                draft_model=model, spec_tokens=3) as eng:
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=9))
        em = eng.metrics()
        inst = em["instance"]
        assert om.REGISTRY.get("serving_spec_proposed_total").value(
            instance=inst) == em["spec_proposed"]
        assert om.REGISTRY.get("serving_spec_accepted_total").value(
            instance=inst) == em["spec_accepted"]
        assert om.REGISTRY.get("serving_spec_accept_ratio").value(
            instance=inst) == em["spec_accept_ratio"]
    for got, ref in zip(outs, refs):
        np.testing.assert_array_equal(got, ref)
    assert em["spec_proposed"] > 0
    assert em["spec_accepted"] > 0
    assert em["spec_accept_ratio"] is not None
    assert em["spec_accept_ratio"] > 0.5
    assert em["spec_verify_steps"] > 0


def test_independent_draft_bit_exact(model, draft_model):
    prompts = prompts_fixed([6, 11, 4, 8], seed=51)
    refs = refs_of(model, prompts, 8)
    with engine(model, num_blocks=64, block_size=8, max_batch_size=4,
                draft_model=draft_model, spec_tokens=2) as eng:
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        em = eng.metrics()
    for got, ref in zip(outs, refs):
        np.testing.assert_array_equal(got, ref)
    assert em["spec_proposed"] > 0


def test_forced_full_rejection_bit_exact(model, draft_model):
    prompts = prompts_fixed([5, 7], seed=52)
    refs = refs_of(model, prompts, 6)
    with engine(model, num_blocks=64, block_size=8, max_batch_size=2,
                draft_model=draft_model, spec_tokens=3) as eng:
        orig = eng._draft_propose

        def all_wrong(ready, tables):
            return (orig(ready, tables) + 1) % V

        eng._draft_propose = all_wrong
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=6))
        em = eng.metrics()
    for got, ref in zip(outs, refs):
        np.testing.assert_array_equal(got, ref)
    assert em["spec_accepted"] == 0
    assert em["spec_accept_ratio"] == 0.0


def test_spec_with_eviction_under_sharing(model, draft_model):
    prompts = shared_prompts(12, [4, 6, 5], seed=53)
    refs = refs_of(model, prompts, 8)
    with engine(model, num_blocks=12, block_size=4, max_batch_size=3,
                enable_prefix_cache=True, draft_model=draft_model,
                spec_tokens=2) as eng:
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        em = eng.metrics()
    assert em["evictions"] >= 1
    for got, ref in zip(outs, refs):
        np.testing.assert_array_equal(got, ref)


def test_eos_inside_accept_window_truncates(model):
    p = prompts_fixed([6], seed=54)[0]
    ref = refs_of(model, [p], 32)[0]
    eos = int(ref[len(p) + 2])  # the 3rd generated token ends it
    ref_eos = refs_of(model, [p], 32, eos_token_id=eos)[0]
    with engine(model, num_blocks=64, block_size=8, max_batch_size=2,
                draft_model=model, spec_tokens=4) as eng:
        rid = eng.add_request(p, SamplingParams(max_new_tokens=32,
                                                eos_token_id=eos))
        for _ in eng.stream():
            pass
        out = eng.output_tokens(rid)
        assert eng.request(rid).finish_reason() == "eos"
    np.testing.assert_array_equal(out, ref_eos)


def test_sampling_request_rejected_on_spec_engine(model):
    with engine(model, num_blocks=32, block_size=8, max_batch_size=2,
                draft_model=model, spec_tokens=2) as eng:
        with pytest.raises(ValueError, match="greedy-only"):
            eng.add_request(np.arange(1, 6, dtype=np.int32),
                            SamplingParams(max_new_tokens=4,
                                           do_sample=True))


def test_lookahead_counts_against_the_cap(model):
    # the verify writes spec_k positions past the last token
    with engine(model, num_blocks=5, block_size=8, max_batch_size=2,
                draft_model=model, spec_tokens=3) as eng:
        eng.add_request(np.arange(20, dtype=np.int32),
                        SamplingParams(max_new_tokens=9))
        with pytest.raises(ValueError, match="speculative lookahead"):
            eng.add_request(np.arange(20, dtype=np.int32),
                            SamplingParams(max_new_tokens=10))


@pytest.mark.parametrize("kw,match", [
    (dict(spec_tokens=0), "spec_tokens"),
    (dict(decode_steps_per_sync=2), "mutually exclusive"),
    (dict(in_graph_sampling=True), "verify step"),
])
def test_typed_rejections(model, kw, match):
    with pytest.raises(ValueError, match=match):
        engine(model, num_blocks=32, block_size=8, max_batch_size=2,
               ingest_async=False, draft_model=model, **kw)


def test_vocab_mismatch_rejected(model):
    bad = LlamaForCausalLM(dataclasses.replace(llama_tiny(), vocab_size=256),
                           device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        engine(model, num_blocks=16, block_size=8, draft_model=bad)


def test_draft_must_be_a_dense_llama(model):
    """A draft must be a llama; a Llama-MoE draft, once refused, serves
    now (the name is kept): its proposals leave the target's greedy
    tokens as they are."""
    with pytest.raises(TypeError, match="draft_model"):
        engine(model, num_blocks=16, block_size=8, draft_model=object())
    moe = LlamaForCausalLM(llama_tiny(num_experts=4), device="cpu")
    prompts = prompts_fixed([5, 9], seed=8)
    kw = dict(num_blocks=32, block_size=8, max_batch_size=2)
    with engine(model, draft_model=moe, **kw) as eng:
        spec = eng.generate(prompts, SamplingParams(max_new_tokens=6))
        assert eng.metrics()["spec_proposed"] > 0
    with engine(model, **kw) as eng:
        plain = eng.generate(prompts, SamplingParams(max_new_tokens=6))
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)


def test_spec_decode_bit_exact_vs_plain_int8(model):
    prompts = prompts_fixed([5, 9, 3], seed=6)
    kw = dict(num_blocks=96, block_size=8, max_batch_size=4,
              kv_dtype="int8")
    with engine(model, draft_model=model, spec_tokens=2, **kw) as eng:
        spec = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        assert eng.metrics()["spec_accepted"] >= 1
        assert eng.draft_cache.quantized
    with engine(model, **kw) as eng:
        plain = eng.generate(prompts, SamplingParams(max_new_tokens=8))
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)


def test_draft_pools_share_the_target_allocator(model, draft_model):
    with engine(model, num_blocks=16, block_size=8,
                draft_model=draft_model) as eng:
        assert eng.draft_cache.allocator is eng.cache.allocator
        assert len(eng.draft_cache.k) == 1
        assert eng.draft_cache.k[0].shape[0] == 16
    alloc = BlockAllocator(8)
    c = PagedKVCache(llama_tiny(), 8, 4, device="cpu", allocator=alloc)
    assert c.allocator is alloc
    assert PagedKVCache(llama_tiny(), 8, 4,
                        device="cpu").allocator is not alloc


def test_trim_to_capacity_keeps_the_next_window():
    alloc = BlockAllocator(16)
    sched = Scheduler(alloc, block_size=4, max_batch_size=1)
    req = Request(np.arange(6))
    sched.waiting.append(req)
    sched.pick_prefills()
    req.blocks += alloc.allocate(3)   # lookahead blocks of a window: 5
    free0, v0 = alloc.num_free, sched.version
    sched.trim_to_capacity(req, extra=3)   # 6 + 3 tokens: 3 blocks
    assert len(req.blocks) == 3 and alloc.num_free == free0 + 2
    assert sched.version == v0 + 1
    sched.trim_to_capacity(req, extra=3)   # nothing more to free
    assert sched.version == v0 + 1
    sched.trim_to_capacity(req)            # 6 tokens: 2 blocks
    assert len(req.blocks) == 2


def test_draft_cached_resets_on_admission_and_eviction():
    alloc = BlockAllocator(4)
    sched = Scheduler(alloc, block_size=4, max_batch_size=2)
    a, b = Request(np.arange(5)), Request(np.arange(3))
    sched.waiting.extend([a, b])
    sched.pick_prefills()
    a.draft_cached = 5
    sched.pick_prefills()
    assert a.draft_cached == 5 and b.draft_cached == 0
    b.prefilling, a.prefilling = False, False
    b.output_tokens.append(1)
    b.num_cached = 3
    b.draft_cached = 3
    b.output_tokens.append(2)
    sched.ensure_decode_room(extra=4)   # b needs a block: evicts a or b
    evicted = [r for r in (a, b) if r.state == "waiting"]
    assert evicted and all(r.draft_cached == 0 for r in evicted)


@pytest.fixture(scope="module")
def jax_spec_runs(jax_models):
    """The JAX engine's tokens and spec counters, per draft kind."""
    target, draft = jax_models
    prompts = prompts_fixed([5, 17, 9, 30], seed=60)
    out = {}
    for kind, d, k in (("self", target, 3), ("draft", draft, 2)):
        je = JaxEngine(target, num_blocks=64, block_size=8, max_batch_size=3,
                       draft_model=d, spec_tokens=k)
        try:
            toks = je.generate(prompts, JaxSampling(max_new_tokens=10))
            m = je.metrics()
        finally:
            je.close()
        out[kind] = ([np.asarray(t) for t in toks], m["spec_proposed"],
                     m["spec_accepted"])
    return prompts, out


def port_spec_run(model, draft_model, kind, fused, prompts):
    d, k = (model, 3) if kind == "self" else (draft_model, 2)
    with engine(model, num_blocks=64, block_size=8, max_batch_size=3,
                draft_model=d, spec_tokens=k,
                fuse_draft_catchup=fused) as eng:
        toks = eng.generate(prompts, SamplingParams(max_new_tokens=10))
        m = eng.metrics()
        buckets = sorted(eng._catchups)
    return toks, m, buckets


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kind", ["self", "draft"])
def test_spec_engine_matches_jax(model, draft_model, jax_spec_runs, kind,
                                 fused):
    prompts, runs = jax_spec_runs
    want, proposed, accepted = runs[kind]
    toks, m, buckets = port_spec_run(model, draft_model, kind, fused,
                                     prompts)
    for w, g in zip(want, toks):
        np.testing.assert_array_equal(g, w)
    assert m["spec_proposed"] == proposed
    assert m["spec_accepted"] == accepted
    # the fused catch-up ran (feeds of 2 after an accepted window)
    assert bool(buckets) == (fused and accepted > 0)


@pytest.mark.parametrize("kind", ["self", "draft"])
def test_fused_catchup_equals_unfused(model, draft_model, kind):
    prompts = shared_prompts(16, [3, 21, 8], seed=61)
    runs = [port_spec_run(model, draft_model, kind, fused, prompts)
            for fused in (True, False)]
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    for key in ("spec_proposed", "spec_accepted", "spec_verify_steps",
                "host_syncs"):
        assert runs[0][1][key] == runs[1][1][key], key
    # padding feeds run only in the fused buckets
    assert runs[0][1]["spec_draft_steps"] >= runs[1][1]["spec_draft_steps"]
