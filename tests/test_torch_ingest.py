"""Asynchronous request staging in the port's ``LLMEngine`` on the CPU,
proved again from the reference's tests (``tests/test_serving.py``: ingest
death flushes the queued requests, a submit after the death is not
stranded, the synchronous path, ``close`` joins the ingest thread), then
held against the JAX package's engine (both with their default
``ingest_async=True``) on the same fp32 ``llama_tiny`` weights. On the card
the thread pads into pinned memory and copies on the engine's staging
stream (``chip_smoke.py`` holds async against sync tokens there)."""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import (EngineClosedError, LLMEngine,
                                                SamplingParams)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(7)
    m = JaxLlama(jax_tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()})
    return tm


def prompts_fixed(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, n).astype(np.int32) for n in lengths]


def refs_of(model, prompts, new):
    return [model.generate(p[None], max_new_tokens=new).cpu().numpy()[0]
            for p in prompts]


def engine(model, **kw):
    return LLMEngine(model, num_blocks=32, block_size=8, max_batch_size=2,
                     device="cpu", **kw)


def test_async_is_the_default(model):
    with engine(model) as eng:
        assert eng._ingest is not None
        assert eng._ingest._thread.is_alive()
    with engine(model, ingest_async=False) as eng:
        assert eng._ingest is None


def test_submit_after_ingest_death_not_stranded(model):
    prompts = prompts_fixed([5, 6], seed=22)
    refs = refs_of(model, prompts, 3)
    with engine(model) as eng:
        def boom(req):
            raise RuntimeError("boom")

        eng._ingest._stage = boom
        with pytest.warns(RuntimeWarning, match="ingest thread died"):
            r1 = eng.add_request(prompts[0],
                                 SamplingParams(max_new_tokens=3))
            eng._ingest._thread.join(timeout=5.0)
            assert not eng._ingest._thread.is_alive()
            r2 = eng.add_request(prompts[1],
                                 SamplingParams(max_new_tokens=3))
            assert eng._ingest._q.empty()  # nothing stranded in _q
            for _ in eng.stream():
                pass
        np.testing.assert_array_equal(eng.output_tokens(r1), refs[0])
        np.testing.assert_array_equal(eng.output_tokens(r2), refs[1])


def test_ingest_death_flushes_queued_requests(model):
    prompts = prompts_fixed([5, 7], seed=14)
    refs = refs_of(model, prompts, 4)
    with engine(model) as eng:
        real_stage = eng._ingest._stage
        calls = {"n": 0}

        def dying_stage(req):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("boom")
            real_stage(req)

        eng._ingest._stage = dying_stage
        with pytest.warns(RuntimeWarning, match="ingest thread died"):
            r1 = eng.add_request(prompts[0],
                                 SamplingParams(max_new_tokens=4))
            r2 = eng.add_request(prompts[1],
                                 SamplingParams(max_new_tokens=4))
            for _ in eng.stream():
                pass
        np.testing.assert_array_equal(eng.output_tokens(r1), refs[0])
        np.testing.assert_array_equal(eng.output_tokens(r2), refs[1])


def test_sync_ingest_path(model):
    prompts = prompts_fixed([5, 7], seed=9)
    refs = refs_of(model, prompts, 4)
    with engine(model, ingest_async=False) as eng:
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=4))
    for got, ref in zip(outs, refs):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_async_equals_sync(model, spec):
    prompts = prompts_fixed([5, 19, 9, 12], seed=31)
    kw = dict(draft_model=model, spec_tokens=2) if spec else {}
    outs = []
    for ingest_async in (True, False):
        with engine(model, ingest_async=ingest_async, **kw) as eng:
            outs.append(eng.generate(prompts,
                                     SamplingParams(max_new_tokens=6)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_staged_ids_are_the_padded_prompt(model):
    p = prompts_fixed([11], seed=4)[0]
    with engine(model, ingest_async=False) as eng:
        rid = eng.add_request(p, SamplingParams(max_new_tokens=2))
        st = eng.request(rid)._staged
        assert (st.bucket, st.length) == (16, 11)
        assert st.ids.dtype == torch.int64
        np.testing.assert_array_equal(st.ids[0, :11].numpy(), p)
        assert (st.ids[0, 11:] == 0).all()
        assert st.ready is None and st.host is None  # CPU: no stream


def test_cancel_while_on_the_ingest_thread(model):
    with engine(model) as eng:
        gate = threading.Event()
        real_stage = eng._ingest._stage

        def slow_stage(req):
            gate.wait(timeout=10.0)
            real_stage(req)

        eng._ingest._stage = slow_stage
        rid = eng.add_request(np.arange(1, 6, dtype=np.int32),
                              SamplingParams(max_new_tokens=3))
        assert eng.has_work()  # in flight on the thread
        assert eng.cancel(rid)
        gate.set()
        for _ in eng.stream():
            pass
        assert eng.request(rid).finish_reason() == "cancelled"
        assert not eng.has_work()
        assert eng.scheduler.waiting == type(eng.scheduler.waiting)()


def test_close_frees_blocks_joins_ingest_and_guards(model):
    eng = engine(model)
    free0 = eng.cache.allocator.num_free
    eng.add_request(np.arange(1, 9, dtype=np.int32),
                    SamplingParams(max_new_tokens=20))
    eng.step()  # admitted: blocks held
    assert eng.cache.allocator.num_free < free0
    eng.close()
    assert eng.cache.allocator.num_free == free0
    assert eng._ingest._thread.is_alive() is False
    for call in (eng.step, lambda: next(iter(eng.stream())),
                 lambda: eng.add_request(np.arange(3, dtype=np.int32)),
                 lambda: eng.generate([np.arange(3, dtype=np.int32)])):
        with pytest.raises(EngineClosedError):
            call()
    eng.close()  # idempotent


def test_async_engine_matches_jax(jax_model, model):
    prompts = prompts_fixed([5, 17, 33, 9], seed=13)
    je = JaxEngine(jax_model, num_blocks=64, block_size=8, max_batch_size=3)
    try:
        want = je.generate(prompts, JaxSampling(max_new_tokens=8))
    finally:
        je.close()
    with LLMEngine(model, num_blocks=64, block_size=8, max_batch_size=3,
                   device="cpu") as eng:
        assert eng._ingest is not None
        got = eng.generate(prompts, SamplingParams(max_new_tokens=8))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
