"""Serving the Llama-MoE through the port's ``LLMEngine`` on the CPU, held
against the JAX package's engine on fp32 ``llama_tiny(num_experts=4)``
with the same weights (the reference's, from its seed, carried across as
numpy).

At the default capacity factor 1.25 choices drop, and a request's tokens
depend on the rows it shares a forward with (capacity is shared across
the batch), so the comparisons hold one schedule fixed (synchronous
staging on both sides): the port's tokens equal the reference's per step
and in windows of 8, per-step logits within ``LOGIT_ATOL`` (fp32 sums in
another order), and the test asserts that choices were dropped. At the
no-drop factor 2.0 (``num_experts / num_experts_per_tok``) the guarantees
that compare two schedules hold: a request served alone equals it served
in a batch, windows equal per step, and speculative decoding (a
self-draft and a MoE draft) equals plain decoding. ``PT_FUSED_MOE=1``
takes #9's plain version on the CPU with no launch. ``generate`` and
``cached_step`` are held against the reference's, the fp32 and int8
artifacts round-trip and the reference reads the port's, and #9's device
tally is read and reset as its C entry says."""

import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jsrv
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.models.llama import StaticKVCache as JaxCache
from paddle_tpu_torch.inference import serving as srv
from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.models import (LlamaForCausalLM, StaticKVCache,
                                     llama_tiny, load_paddle_tpu_state_dict)
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.ops.cuda import moe_ffn as MF

LOGIT_ATOL = 1e-5
ENGINE = dict(num_blocks=64, block_size=8, max_batch_size=4,
              ingest_async=False)
NEW = 12
# the reference comparisons: requests of their own lengths, so that rows
# freeze in the middle of windows beside rows that still decode
NEWS = (12, 5, 9, 3, 14, 7, 10)
WINDOW = 8
NODROP = 2.0   # num_experts / num_experts_per_tok: capacity = rows
MOE = dict(num_experts=4)


def _prompts(lengths=(5, 17, 33, 9, 21, 12, 28), seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, n).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def weights():
    paddle.seed(7)
    jm = JaxLlama(jax_tiny(**MOE))
    jm.eval()
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port(state, factor=1.25, seed=0):
    tm = LlamaForCausalLM(llama_tiny(**MOE, moe_capacity_factor=factor),
                          device="cpu", seed=seed)
    if state is not None:
        load_paddle_tpu_state_dict(tm, state)
    return tm


def _pools(eng):
    """Every layer's K and V pool, null block included, as numpy."""
    c = eng.cache
    return [np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
            for t in list(c.k) + list(c.v)]


def _serve(eng, prompts, news=NEWS):
    """Tokens and, per step, the logits row each token was sampled from
    (``capture_logits``), request by request (``news[i]`` new tokens for
    prompt i); works on both packages' engines."""
    sampling = (SamplingParams if isinstance(eng, LLMEngine)
                else jsrv.SamplingParams)
    rids = [eng.add_request(p, sampling(max_new_tokens=n))
            for p, n in zip(prompts, news)]
    logits = {r: [] for r in rids}
    while eng.has_work():
        for out in eng.step():
            row = eng.request(out.rid).last_logits
            if out.token >= 0 and row is not None:
                logits[out.rid].append(np.array(row))
    return ([np.asarray(eng.output_tokens(r)) for r in rids],
            [np.stack(logits[r]) if logits[r] else None for r in rids])


@pytest.fixture
def drops(monkeypatch):
    """Choices dropped by every MoE forward of the port (a host read, so
    only on the CPU)."""
    seen = []
    gate = torch_llama.top_k_capacity_gating

    def counted(probs, top_k, capacity):
        out = gate(probs, top_k, capacity)
        seen.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(torch_llama, "top_k_capacity_gating", counted)
    return seen


@pytest.fixture(scope="module")
def reference_runs(weights):
    """The reference engine per step (logits captured) and in windows."""
    jm, _ = weights
    out = {}
    for k in (1, WINDOW):
        eng = jsrv.LLMEngine(jm, decode_steps_per_sync=k,
                             capture_logits=k == 1, **ENGINE)
        try:
            out[k] = _serve(eng, _prompts()) + (_pools(eng),)
        finally:
            eng.close()
    return out


@pytest.mark.parametrize("k", [1, WINDOW], ids=["per_step", "window"])
def test_port_engine_equals_reference_with_drops(weights, reference_runs,
                                                 drops, k):
    """Tokens, logits and the pools afterwards, null block included: the
    rows that are not requests (idle slots, padding, a window's frozen
    rows) write there, so it holds what they were fed, and they take
    expert capacity in the same forwards as the real rows."""
    _, state = weights
    with LLMEngine(_port(state), device="cpu", decode_steps_per_sync=k,
                   capture_logits=k == 1, **ENGINE) as eng:
        toks, logits = _serve(eng, _prompts())
        pools = _pools(eng)
    want_toks, want_logits, want_pools = reference_runs[k]
    for g, w in zip(toks, want_toks):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(pools, want_pools):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL)
    if k == 1:
        for g, w in zip(logits, want_logits):
            assert g.shape == w.shape and g.shape[1] == 512
            np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL)
    assert sum(drops) > 0, "no choice dropped: the case proves nothing"


def test_window_feeds_frozen_rows_as_the_reference(weights, monkeypatch):
    """Inside a window a frozen row repeats its input id at its position
    and writes to the null block, and an idle slot feeds id 0 at position
    0, as the reference's window body does: these rows take expert
    capacity beside the decoding ones, so they must be the same rows."""
    _, state = weights
    fed = []
    with LLMEngine(_port(state), device="cpu",
                   decode_steps_per_sync=WINDOW, **ENGINE) as eng:
        body = eng._decode_layers

        def spy(ids, pos, blk, off, lens, tables, draft=False):
            fed.append((ids.clone(), pos.clone(), (blk == 0) & (off == 0),
                        (tables != 0).any(dim=1)))
            return body(ids, pos, blk, off, lens, tables, draft)

        monkeypatch.setattr(eng, "_decode_layers", spy)
        _serve(eng, _prompts())
    assert len(fed) % WINDOW == 0
    frozen = 0
    for w in range(0, len(fed), WINDOW):
        for (ids0, pos0, park0, held), (ids1, pos1, park1, _) in zip(
                fed[w:w + WINDOW - 1], fed[w + 1:w + WINDOW]):
            idle = ~held
            assert (ids0[idle] == 0).all() and (pos0[idle] == 0).all()
            stay = park0 & park1 & held
            frozen += int(stay.sum())
            assert torch.equal(ids1[stay], ids0[stay])
            assert torch.equal(pos1[stay], pos0[stay])
    assert frozen > 0


def test_window_and_per_step_differ_only_by_schedule(reference_runs):
    """At 1.25 the reference's own windows and per-step runs part ways on
    some request (capacity is shared across rows that differ between the
    schedules), which is why the schedule-comparing guarantees are held
    at the no-drop factor."""
    a, b = reference_runs[1][0], reference_runs[WINDOW][0]
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def _generate(model, prompts, **kw):
    with LLMEngine(model, device="cpu", **dict(ENGINE, **kw)) as eng:
        return [np.asarray(o) for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))]


def test_no_drop_batch_of_one_equals_batched(weights, drops):
    _, state = weights
    model = _port(state, NODROP)
    prompts = _prompts()
    batched = _generate(model, prompts)
    for p, b in zip(prompts, batched):
        np.testing.assert_array_equal(_generate(model, [p])[0], b)
    assert drops and sum(drops) == 0


def test_no_drop_windows_equal_per_step(weights, drops):
    _, state = weights
    model = _port(state, NODROP)
    prompts = _prompts(seed=4)
    for a, b in zip(_generate(model, prompts),
                    _generate(model, prompts, decode_steps_per_sync=WINDOW)):
        np.testing.assert_array_equal(a, b)
    assert sum(drops) == 0


def test_no_drop_self_draft_spec_equals_plain(weights):
    _, state = weights
    model = _port(state, NODROP)
    prompts = _prompts(seed=5)
    plain = _generate(model, prompts)
    with LLMEngine(model, device="cpu", draft_model=model, spec_tokens=3,
                   **ENGINE) as eng:
        spec = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
        assert eng.metrics()["spec_accepted"] >= 1
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_moe_draft_model_serves(weights, fused):
    """A MoE draft (other weights) proposes for a MoE target: the tokens
    are the target's plain greedy tokens, and the draft's proposals are
    mostly rejected."""
    _, state = weights
    model = _port(state, NODROP)
    draft = _port(None, NODROP, seed=3)
    prompts = _prompts(seed=6)
    plain = _generate(model, prompts)
    with LLMEngine(model, device="cpu", draft_model=draft, spec_tokens=2,
                   fuse_draft_catchup=fused, **ENGINE) as eng:
        spec = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
        m = eng.metrics()
    assert m["spec_proposed"] > m["spec_accepted"]
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)


def test_fused_switch_takes_the_plain_route_on_the_cpu(weights,
                                                      monkeypatch):
    _, state = weights
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("PT_FUSED_MOE", flag)
        MF.reset_launch_counts()
        with LLMEngine(_port(state), device="cpu", capture_logits=True,
                       **ENGINE) as eng:
            runs[flag] = _serve(eng, _prompts(seed=8))
        assert MF.launch_counts() == {"moe_ffn_cuda": 0}
    for a, b in zip(runs["0"][0], runs["1"][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(runs["0"][1], runs["1"][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)


def test_cached_step_and_generate_match_reference(weights):
    jm, state = weights
    tm = _port(state)
    rng = np.random.RandomState(9)
    b, s = 2, 9
    jc = JaxCache(jm.config, b, 64)
    tc = StaticKVCache(tm.config, b, 64, device="cpu")
    steps = [rng.randint(0, 512, (b, s)).astype(np.int32)] + [
        rng.randint(0, 512, (b, 1)).astype(np.int32) for _ in range(3)]
    for ids in steps:
        want = np.asarray(jm.cached_step(ids, jc))
        got = tm.cached_step(ids, tc).numpy()
        np.testing.assert_allclose(got, want, rtol=LOGIT_ATOL,
                                   atol=LOGIT_ATOL)
    ids = rng.randint(0, 512, (2, 11)).astype(np.int32)
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=8).numpy()
    got = tm.generate(ids, max_new_tokens=8).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_artifact_round_trip_and_reference_reads_it(weights, tmp_path,
                                                    quantize):
    _, state = weights
    tm = _port(state)
    art = str(tmp_path / "moe")
    srv.save_llama_artifact(tm, art, quantize=quantize)
    back = srv.load_llama_artifact(art, device="cpu")
    assert back.config.num_experts == 4
    ref = jsrv.load_llama_artifact(art)
    ref_state = {k: np.asarray(v.numpy())
                 for k, v in ref.state_dict().items()}
    got = {k: v.numpy() for k, v in back.state_dict().items()}
    assert sorted(got) == sorted(ref_state)
    for k, v in got.items():
        # fp32: the weights themselves; int8: both packages' dequant
        np.testing.assert_array_equal(v, ref_state[k], err_msg=k)
        if quantize is None:
            np.testing.assert_array_equal(v, state[k], err_msg=k)
    if quantize == "int8":
        scales = srv.quantize_state_dict(tm.state_dict())[1]
        for stack in ("gate_w", "up_w", "down_w"):
            name = f"llama.layers.1.mlp.{stack}"
            # the 3-D expert stacks: one scale per last-axis channel
            assert scales[name].shape == (state[name].shape[-1],)
    prompts = _prompts(seed=10)[:3]
    toks = _generate(back, prompts)
    if quantize is None:
        for a, b in zip(toks, _generate(tm, prompts)):
            np.testing.assert_array_equal(a, b)


def test_device_tally_bookkeeping(monkeypatch):
    """``device_tally`` reads the C entry's two slots in ``TALLIED``'s
    order and asks it to reset only when told; every body of the source
    adds to its own slot, and the slots number the bodies."""
    calls = []

    class FakeLib:
        def moe_ffn_tally(self, out, reset):
            calls.append(reset)
            for i in range(len(MF.TALLIED)):
                out[i] = 10 * (i + 1)
            return 0

    monkeypatch.setattr(MF, "_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    assert MF.device_tally() == {"moe_ffn_kernel": 10,
                                 "moe_ffn_bf16_kernel": 20}
    MF.device_tally(reset=True)
    assert calls == [0, 1]

    class Failing(FakeLib):
        def moe_ffn_tally(self, out, reset):
            return 700

    monkeypatch.setattr(MF, "_lib", lambda: Failing())
    with pytest.raises(RuntimeError, match="cudaError 700"):
        MF.device_tally()
    src = open(MF.__file__.replace("ops/cuda/moe_ffn.py",
                                   "csrc/moe_ffn.cu")).read()
    assert f"g_tally[{len(MF.TALLIED)}]" in src
    assert "int moe_ffn_tally(unsigned long long* out, int reset)" in src
    for slot, name in enumerate(MF.TALLIED):
        body = re.search(
            rf"{name}\(.*?\{{(.*?)\n}}\n", src, re.S).group(1)
        assert body.count("tally(") == 1 and f"tally({slot});" in body, name
