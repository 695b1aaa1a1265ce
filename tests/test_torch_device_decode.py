"""Device-resident decode in the port's ``LLMEngine`` on the CPU: in-graph
greedy sampling and fused ``decode_steps_per_sync`` windows, proved again
from ``tests/test_device_decode.py`` (greedy tokens bit-exact against the
per-step host path across eviction, prefix sharing, int8 KV and chunked
prefill; host syncs k-fold fewer; mid-window EOS; one window for every
batch mix; the typed rejections; ``capture_logits``), and held against the
JAX package's window engine on the same fp32 ``llama_tiny`` weights. On
the CPU the window function runs eagerly; on the card ``chip_smoke.py``
replays it as a CUDA graph."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.inference.serving import (BlockAllocator, LLMEngine,
                                                SamplingParams)
from paddle_tpu_torch.inference.serving.scheduler import Request, Scheduler
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.models.llama import (greedy_tokens_in_graph,
                                           sample_next_tokens)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(llama_tiny(), device="cpu", seed=7)


def prompts_fixed(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, n).astype(np.int32) for n in lengths]


def _engine(model, **kw):
    # synchronous staging, as the reference's tests: admission order (and
    # so co-admission) does not depend on the ingest thread's timing
    kw = {"num_blocks": 96, "block_size": 8, "max_batch_size": 4,
          "ingest_async": False, **kw}
    return LLMEngine(model, device="cpu", **kw)


def _generate(model, prompts, sampling, **kw):
    with _engine(model, **kw) as eng:
        outs = eng.generate(prompts, sampling)
        return [np.asarray(o) for o in outs], eng.metrics()


def test_greedy_head_matches_host_sampler():
    # sample_next_tokens argmaxes a float64 view (an exact, monotone cast
    # of fp32): the device argmax picks the same index, first on ties
    rng = np.random.RandomState(0)
    logits = rng.randn(5, 64).astype(np.float32)
    logits[1, 7] = logits[1, 3] = logits[1].max() + 1.0
    host = sample_next_tokens(logits)
    dev = greedy_tokens_in_graph(torch.from_numpy(logits)).numpy()
    assert dev.dtype == np.int32
    np.testing.assert_array_equal(host, dev)
    assert dev[1] == 3


def test_in_graph_sampling_is_bit_exact_and_fetches_tokens(model):
    prompts = prompts_fixed([5, 12, 9, 17], seed=3)
    sp = SamplingParams(max_new_tokens=9)
    ref, mref = _generate(model, prompts, sp)
    ing, ming = _generate(model, prompts, sp, in_graph_sampling=True)
    for a, b in zip(ref, ing):
        np.testing.assert_array_equal(a, b)
    B, V = 4, 512
    assert mref["host_syncs"] > 0
    assert mref["decode_fetch_bytes"] == mref["host_syncs"] * B * V * 4
    assert ming["host_syncs"] == mref["host_syncs"]
    assert ming["decode_fetch_bytes"] == ming["host_syncs"] * B * 4


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("variant", [
    "plain", "eviction", "prefix", "int8", "chunked"])
def test_window_bit_exact_vs_per_step(model, k, variant):
    prompts = prompts_fixed([5, 12, 9, 17], seed=5)
    sp = SamplingParams(max_new_tokens=11)
    kw = {}
    if variant == "eviction":
        # lockstep 9-token requests over 5 usable blocks: both slots want
        # their third block on the same step, in every arm
        prompts = prompts_fixed([9, 9, 9], seed=5)
        kw = dict(num_blocks=6, max_batch_size=2)
    elif variant == "prefix":
        shared = prompts_fixed([16], seed=15)[0]
        prompts = [shared] + [np.concatenate([shared, p])
                              for p in prompts[1:]]
        kw = dict(enable_prefix_cache=True)
    elif variant == "int8":
        kw = dict(kv_dtype="int8")
    elif variant == "chunked":
        prompts = prompts_fixed([5, 29, 9, 23], seed=5)
        kw = dict(max_prefill_tokens_per_step=8, max_prefills_per_step=4)
    ref, mref = _generate(model, prompts, sp, **kw)
    win, mwin = _generate(model, prompts, sp, decode_steps_per_sync=k,
                          in_graph_sampling=True, **kw)
    for a, b in zip(ref, win):
        np.testing.assert_array_equal(a, b)
    if variant == "eviction":
        assert mref["evictions"] >= 1 and mwin["evictions"] >= 1
    if variant == "prefix":
        assert mwin["prefix_blocks_reused"] >= 1
    if variant == "chunked":
        assert mwin["prefill_chunks"] > len(prompts)
    if k > 1:
        assert mwin["host_syncs"] < mref["host_syncs"]


@pytest.mark.parametrize("extra,cow_blocks", [(0, [2]), (3, [2, 3])])
def test_decode_room_lookahead_grows_and_guards_the_window(extra,
                                                          cow_blocks):
    # 9 prompt tokens + 1 output over blocks of 4: the next decode writes
    # position 9 (block 2); a lookahead of 3 also writes 10..12 (block 3)
    alloc = BlockAllocator(16)
    sched = Scheduler(alloc, block_size=4, max_batch_size=2)
    req = Request(np.arange(9))
    sched.waiting.append(req)
    sched.pick_prefills()
    req.prefilling, req.num_cached = False, 9
    req.output_tokens.append(1)
    extra_block = alloc.allocate(1)
    req.blocks.append(extra_block[0])  # block 3 already held
    alloc.acquire(req.blocks[1:4])     # blocks 1..3 seen by another holder
    before = list(req.blocks)
    waiting = Request(np.arange(3))
    sched.waiting.append(waiting)
    sched.pick_prefills()              # a prefilling peer: no lookahead
    peer_blocks = list(waiting.blocks)
    sched.ensure_decode_room(extra_for=lambda r: extra)
    assert [src for src, _ in sched.pending_cow] == [before[i]
                                                     for i in cow_blocks]
    for i in range(4):
        assert (req.blocks[i] != before[i]) == (i in cow_blocks)
    assert waiting.blocks == peer_blocks


def test_host_syncs_reduced_k_fold(model):
    # a co-admitted pair: the first token comes from prefill, the other 24
    # from decode
    prompts = prompts_fixed([4, 4], seed=6)
    sp = SamplingParams(max_new_tokens=25)
    kw = dict(max_batch_size=2, max_prefills_per_step=2)
    _, m1 = _generate(model, prompts, sp, in_graph_sampling=True, **kw)
    _, m8 = _generate(model, prompts, sp, decode_steps_per_sync=8, **kw)
    assert m1["host_syncs"] == 24
    assert m8["host_syncs"] == 3
    assert m8["decode_fetch_bytes"] == 3 * 2 * 8 * 4  # [B=2, k=8] int32
    assert m8["decode_steps"] == 3 * 8


def test_mid_window_eos_freezes_row(model):
    prompts = prompts_fixed([7, 13], seed=7)
    ref, _ = _generate(model, prompts, SamplingParams(max_new_tokens=12))
    eos = int(ref[0][len(prompts[0]) + 4])  # the 5th generated token
    sp = SamplingParams(max_new_tokens=12, eos_token_id=eos)
    stop, _ = _generate(model, prompts, sp)
    win, _ = _generate(model, prompts, sp, decode_steps_per_sync=8)
    for a, b in zip(stop, win):
        np.testing.assert_array_equal(a, b)
    assert len(win[0]) < len(ref[0])


def test_window_built_once_and_per_step_decode_never_runs(model,
                                                          monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the per-step decode ran")

    sp = SamplingParams(max_new_tokens=7)
    with _engine(model, decode_steps_per_sync=4) as eng:
        monkeypatch.setattr(eng, "_decode_forward", refuse)
        eng.generate(prompts_fixed([4, 7], seed=9), sp)
        window = eng._window
        assert window is not None and window.graph is None  # CPU: eager
        eng.generate(prompts_fixed([3, 9, 5, 6], seed=10), sp)
        assert eng._window is window
        alloc = eng.cache.allocator
        assert alloc.num_free == eng.cache.num_blocks - 1


def test_defaults_keep_host_path(model):
    with _engine(model, max_batch_size=2) as eng:
        assert eng._decode_window == 1 and not eng._in_graph
        eng.generate(prompts_fixed([5], seed=11),
                     SamplingParams(max_new_tokens=3))
        assert eng._window is None
        m = eng.metrics()
        assert m["decode_fetch_bytes"] == m["host_syncs"] * 2 * 512 * 4


def test_do_sample_keeps_host_path_with_one_warning(model):
    prompts = prompts_fixed([6, 10], seed=4)
    sp = SamplingParams(max_new_tokens=6, do_sample=True, temperature=1.3,
                        top_k=16, seed=11)
    ref, _ = _generate(model, prompts, sp)
    with pytest.warns(RuntimeWarning, match="host sampling path") as rec:
        got, m = _generate(model, prompts, sp, decode_steps_per_sync=4)
    assert sum("host sampling path" in str(w.message) for w in rec) == 1
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert m["decode_fetch_bytes"] % (512 * 4) == 0


@pytest.mark.parametrize("kw,match", [
    (dict(decode_steps_per_sync=0), "decode_steps_per_sync"),
    (dict(in_graph_sampling=False, decode_steps_per_sync=4),
     "in_graph_sampling"),
    (dict(capture_logits=True, decode_steps_per_sync=2), "capture_logits"),
    (dict(capture_logits=True, in_graph_sampling=True), "capture_logits"),
])
def test_typed_rejections(model, kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(model, num_blocks=32, max_batch_size=2, **kw)


def test_capture_logits_off_by_default_and_opt_in(model):
    p = prompts_fixed([6], seed=12)[0]
    rows = []
    for capture in (False, True):
        with _engine(model, num_blocks=32, max_batch_size=2,
                     capture_logits=capture) as eng:
            rid = eng.add_request(p, SamplingParams(max_new_tokens=2))
            for _ in eng.stream():
                pass
            rows.append(eng.request(rid).last_logits)
    assert rows[0] is None
    assert rows[1] is not None and rows[1].shape == (512,)
    assert rows[1].dtype == np.float32


def test_window_tokens_match_jax_window_engine():
    paddle.seed(7)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    prompts = prompts_fixed([5, 17, 33, 9], seed=13)
    je = JaxEngine(jm, num_blocks=64, block_size=8, max_batch_size=3,
                   decode_steps_per_sync=8)
    try:
        want = je.generate(prompts, JaxSampling(max_new_tokens=12))
    finally:
        je.close()
    with LLMEngine(tm, num_blocks=64, block_size=8, max_batch_size=3,
                   decode_steps_per_sync=8, device="cpu") as eng:
        got = eng.generate(prompts, SamplingParams(max_new_tokens=12))
        assert eng.metrics()["host_syncs"] < 11 * len(prompts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
