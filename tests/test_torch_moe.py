"""The Llama-MoE of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (seeded) go through the JAX package's capacity
gating, dispatch and combine and through the port's: the integer outputs
(expert, slot, keep) agree exactly, including a capacity factor of 0.5
that drops tokens and rows with forced ties; the dispatched buffer is
exact (one writer per kept slot). Then, for the slice as a whole, three
``fused_train_step`` AdamW steps on fp32 ``llama_tiny(num_experts=4)``
(GQA 4/2, head_dim 32, MoE every 2nd layer): the JAX side runs with its
fused switches off, the port with ``PT_FUSED_MOE``, ``PT_FUSED_NORM`` and
``PT_FUSED_ROPE`` on (on the CPU the kernels' plain versions, the same
function). JAX matmuls at "highest"; tolerances: weights and aux 1e-6
(fp32 sums in another order), losses rtol 1e-5, parameters atol 1e-5 after
three steps (as tests/test_torch_training.py, with Adam's epsilon 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jax_moe
from paddle_tpu.models import llama as jax_llama
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import (load_paddle_tpu_state_dict,
                                     to_numpy_state_dict)
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import moe_ffn as MF
from paddle_tpu_torch.ops.cuda import rms_norm as RN

WEIGHT_ATOL = 1e-6
LOSS_RTOL = 1e-5
STATE_ATOL = 1e-5
SWITCHES = ("PT_FUSED_MOE", "PT_FUSED_NORM", "PT_FUSED_ROPE")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _np(t):
    return np.asarray(t.numpy())


def _probs(seed, t, e, ties=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randint(0, 3, (t, e)) if ties
              else rng.randn(t, e) * 2).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _gate_both(probs, top_k, capacity):
    want = jax_moe.top_k_capacity_gating(jnp.asarray(probs), top_k, capacity)
    got = moe_layer.top_k_capacity_gating(torch.from_numpy(probs), top_k,
                                          capacity)
    return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_gating_matches_jax_exactly(factor, ties, top_k):
    t, e = 61, 8
    probs = _probs(7 + top_k, t, e, ties)
    if ties:  # most rows tie at their largest probability
        assert sum(np.sum(r == r.max()) >= 2 for r in probs) > t // 2
    cap = moe_layer.moe_capacity(t, e, top_k, factor)
    assert cap == jax_moe.moe_capacity(t, e, top_k, factor)
    (ei, si, keep, w, aux), got = _gate_both(probs, top_k, cap)
    np.testing.assert_array_equal(got[0].numpy(), ei)
    np.testing.assert_array_equal(got[1].numpy(), si)
    np.testing.assert_array_equal(got[2].numpy(), keep)
    if factor < 1:
        assert not keep.all()  # tokens were dropped
    np.testing.assert_allclose(got[3].numpy(), w, rtol=0, atol=WEIGHT_ATOL)
    np.testing.assert_allclose(float(got[4]), float(aux), rtol=0,
                               atol=WEIGHT_ATOL)


def test_capacity_of_the_training_shape():
    assert moe_layer.moe_capacity(16384, 8, 2, 1.25) == 5120
    assert moe_layer.moe_capacity(3, 64, 1, 0.1) == 1


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_dispatch_and_combine_match_jax(factor):
    t, e, h, k = 45, 4, 24, 2
    probs = _probs(3, t, e)
    rng = np.random.RandomState(4)
    x = rng.randn(t, h).astype(np.float32)
    cap = moe_layer.moe_capacity(t, e, k, factor)
    (ei, si, keep, w, _), _ = _gate_both(probs, k, cap)
    want_in = jax_moe.dispatch_to_experts(jnp.asarray(x), ei, si, keep, e,
                                          cap)
    ti, ts, tk = (torch.tensor(a) for a in (ei, si, keep))
    got_in = moe_layer.dispatch_to_experts(torch.from_numpy(x), ti.long(),
                                           ts.long(), tk, e, cap)
    assert tuple(got_in.shape) == (e, cap, h)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    eo = rng.randn(e, cap, h).astype(np.float32)
    want = jax_moe.combine_from_experts(jnp.asarray(eo), ei, si, keep, w)
    got = moe_layer.combine_from_experts(torch.from_numpy(eo), ti.long(),
                                         ts.long(), tk, torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WEIGHT_ATOL)


def test_router_gradient_matches_jax():
    """Gradient of sum(weights * r) + aux with respect to the router
    logits: the weights are taken from the probabilities by index, and the
    aux term's one-hot carries no gradient."""
    t, e, k = 33, 8, 2
    rng = np.random.RandomState(9)
    logits = rng.randn(t, e).astype(np.float32)
    r = rng.randn(t, k).astype(np.float32)
    cap = moe_layer.moe_capacity(t, e, k, 1.25)

    def jloss(lg):
        _, _, _, w, aux = jax_moe.top_k_capacity_gating(
            jax.nn.softmax(lg, axis=-1), k, cap)
        return jnp.sum(w * r) + aux

    want = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    _, _, _, w, aux = moe_layer.top_k_capacity_gating(
        torch.softmax(lg, dim=-1), k, cap)
    ((w * torch.from_numpy(r)).sum() + aux).backward()
    np.testing.assert_allclose(lg.grad.numpy(), want, rtol=0,
                               atol=WEIGHT_ATOL)


def _moe_config(**kw):
    return dict(num_experts=4, **kw)


def _pair(seed=5):
    paddle.seed(seed)
    jm = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny(**_moe_config()))
    tm = torch_llama.LlamaForCausalLM(
        torch_llama.llama_tiny(**_moe_config()), device="cpu")
    load_paddle_tpu_state_dict(tm, {k: _np(v) for k, v in
                                    jm.state_dict().items()})
    return jm, tm


def test_moe_layers_and_state_dict_round_trip():
    """The MoE rule picks layer 1 of 2; the JAX state_dict (router [h, E],
    expert stacks [E, h, I] / [E, I, h]) carries across and back
    unchanged."""
    jm, tm = _pair()
    layers = tm.llama.layers
    assert isinstance(layers[0].mlp, torch_llama.LlamaMLP)
    assert isinstance(layers[1].mlp, torch_llama.LlamaMoE)
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    assert state["llama.layers.1.mlp.router.weight"].shape == (128, 4)
    assert state["llama.layers.1.mlp.gate_w"].shape == (4, 128, 384)
    assert state["llama.layers.1.mlp.down_w"].shape == (4, 384, 128)
    back = to_numpy_state_dict(tm)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], err_msg=k)


def test_engine_refuses_a_moe_model():
    """The engine once refused the Llama-MoE; it serves it now (the name
    is kept): greedy tokens of two prompts, each inside the vocabulary,
    with the MoE layer's routing run in every prefill chunk and decode
    step (tests/test_torch_moe_serving.py holds them to the reference)."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    tm = torch_llama.LlamaForCausalLM(
        torch_llama.llama_tiny(**_moe_config()), device="cpu")
    calls = []
    moe = tm.llama.layers[1].mlp
    moe.register_forward_hook(lambda m, a, out: calls.append(a[0].shape))
    prompts = [np.arange(5, dtype=np.int32), np.arange(9, dtype=np.int32)]
    with LLMEngine(tm, num_blocks=16, block_size=8, max_batch_size=2,
                   device="cpu") as eng:
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=4))
        m = eng.metrics()
    for p, o in zip(prompts, outs):
        assert len(o) == len(p) + 4 and ((o >= 0) & (o < 512)).all()
    assert len(calls) == m["prefill_chunks"] + m["decode_steps"]


def test_seeded_init_draws_the_expert_stacks():
    cfg = torch_llama.llama_tiny(**_moe_config())
    a = torch_llama.LlamaForCausalLM(cfg, device="cpu", seed=1)
    b = torch_llama.LlamaForCausalLM(cfg, device="cpu", seed=1)
    moe = a.llama.layers[1].mlp
    for name in ("gate_w", "up_w", "down_w", "router.weight"):
        w = moe.get_parameter(name).detach()
        assert torch.equal(w, b.llama.layers[1].mlp.get_parameter(name))
        assert abs(float(w.std()) - 0.02) < 2e-3, name


@pytest.mark.parametrize("fused", [False, True])
def test_moe_loss_with_aux_matches_jax(fused, monkeypatch):
    """The loss of the MoE model (cross-entropy plus 0.01 x the router's
    load-balancing loss) against the JAX model, with the port's switches
    off and on."""
    for name in SWITCHES:
        monkeypatch.setenv(name, "0")
    jm, tm = _pair()
    rng = np.random.RandomState(0)
    ids, labels = (rng.randint(0, 512, (2, 40)).astype(np.int64)
                   for _ in range(2))
    want, _ = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    for name in SWITCHES:
        monkeypatch.setenv(name, "1" if fused else "0")
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    aux = tm.llama.layers[1].mlp.l_aux
    assert aux is not None and float(aux) > 0
    np.testing.assert_allclose(float(got), float(_np(want)), rtol=LOSS_RTOL)


def test_three_fused_adamw_steps_match_jax(monkeypatch):
    """The slice as a whole: the port with its three switches on against
    the JAX ``FusedTrainStep`` (switches off, the same function), per-step
    losses and the final parameters, aux term included."""
    for name in SWITCHES:
        monkeypatch.setenv(name, "0")
    jm, tm = _pair()
    rng = np.random.RandomState(12)
    batches = [tuple(rng.randint(0, 512, (2, 48)).astype(np.int64)
                     for _ in range(2)) for _ in range(3)]
    jstep = paddle.incubate.fused_train_step(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, epsilon=1e-6, parameters=jm.parameters()))
    want = [float(_np(jstep(paddle.to_tensor(i), paddle.to_tensor(l))))
            for i, l in batches]
    for name in SWITCHES:
        monkeypatch.setenv(name, "1")
    step = incubate.fused_train_step(tm, optimizer.AdamW(
        learning_rate=1e-3, epsilon=1e-6, parameters=tm.parameters()))
    for mod in (FA, MF, RN):
        mod.reset_launch_counts()
    got = [float(step(torch.from_numpy(i), torch.from_numpy(l)))
           for i, l in batches]
    # the switched paths ran (plain versions on the CPU), no kernel did
    assert port_sdpa.LAST_PATH == "plain_rope"
    for mod in (FA, MF, RN):
        assert all(n == 0 for n in mod.launch_counts().values())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] != got[0]
    want_p = {k: _np(v) for k, v in jm.state_dict().items()}
    got_p = to_numpy_state_dict(tm)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)


# -- the bf16 tensor-core design of the MoE kernel, emulated on the CPU -----

# chip_smoke.py's kernel tolerance: |got - want| <= ATOL + RTOL * |want|
CHIP_ATOL, CHIP_RTOL = 1e-4, 2.0 ** -8


def _bf16_expert(seed, c, h, i):
    """x [1, C, h] ~ N(0, 1) and Wg, Wu [1, h, I], Wd [1, I, h] ~ N(0, 0.02)
    from a numpy seed, rounded to bf16 (as chip_smoke.py draws them)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(1, c, h).astype(np.float32))
    ws = [torch.from_numpy((rng.randn(1, *sh) * 0.02).astype(np.float32))
          for sh in ((h, i), (h, i), (i, h))]
    return x.bfloat16(), [w.bfloat16() for w in ws]


def _tensor_core_ffn(x, gw, uw, dw, split=True):
    """The bf16 body's arithmetic: g and u from exact bf16 products summed
    in fp32, act in fp32, then act split into bf16 hi + lo (or rounded to
    bf16 alone) and hi Wd + lo Wd summed in fp32, rounded to bf16."""
    g = torch.bmm(x.float(), gw.float())
    u = torch.bmm(x.float(), uw.float())
    act = g / (1.0 + torch.exp(-g)) * u
    hi = act.bfloat16().float()
    out = torch.bmm(hi, dw.float())
    if split:
        out = out + torch.bmm((act - hi).bfloat16().float(), dw.float())
    return out.bfloat16()


def _chip_excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - CHIP_ATOL - CHIP_RTOL
                  * want.abs()).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_tensor_core_down_split_keeps_the_chip_tolerance(seed):
    """At the Llama-MoE widths (h 768, I 2048), a few tokens of one expert:
    the split down projection stays inside chip_smoke.py's tolerance
    against the fp32 plain version; act rounded to bf16 alone does not."""
    x, (gw, uw, dw) = _bf16_expert(seed, 12, 768, 2048)
    want = MF.moe_ffn_plain(x.float(), gw.float(), uw.float(), dw.float())
    got = _tensor_core_ffn(x, gw, uw, dw)
    assert got.dtype == torch.bfloat16
    assert _chip_excess(got, want) <= 0
    assert _chip_excess(_tensor_core_ffn(x, gw, uw, dw, split=False),
                        want) > 0


def test_split_is_act_to_about_2_to_the_minus_16():
    rng = np.random.RandomState(3)
    act = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -3, 2, 4096)).astype(np.float32))
    hi = act.bfloat16().float()
    lo = (act - hi).bfloat16().float()
    rel = ((hi + lo - act).abs() / act.abs()).max()
    assert float(rel) <= 2.0 ** -16
    assert float(((hi - act).abs() / act.abs()).max()) > 2.0 ** -10


def test_moe_ffn_route_follows_the_dtype_alone():
    """bf16 takes the tensor-core body, fp32 the CUDA-core body; the choice
    needs no card and no shape."""
    assert MF.moe_ffn_route(torch.bfloat16) == "tensor_core"
    assert MF.moe_ffn_route(torch.float32) == "cuda_core"
    with pytest.raises(TypeError):
        MF.moe_ffn_route(torch.float16)
    x = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        MF.moe_ffn_cuda(x, torch.zeros(1, 128, 128, dtype=torch.bfloat16),
                        torch.zeros(1, 128, 128, dtype=torch.bfloat16),
                        torch.zeros(1, 128, 128, dtype=torch.bfloat16))
