"""The fused kernels of the Llama-MoE slice against the JAX package.

The same numpy inputs (seeded) go through the JAX package's Pallas
kernels in interpret mode (``moe_expert_ffn``, ``_fused_add_rms_norm_nd``,
the rope form of ``_fwd``/``_bwd`` and ``_flash_attention_rope_arrays``,
with ``jax.grad`` for the gradients) and through the port's entries on CPU
tensors, which take the plain PyTorch versions: what the CUDA kernels
compute. Tolerances are the reference tests': fp32 outputs atol 1e-5,
gradients 1e-4 x max|g| (fp32 sums in another order, with cancellation);
bf16 adds half an ulp of the output's rounding (2^-8 relative), since both
sides round an fp32 result that may differ in its last bits. JAX matmuls
at "highest".
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.models.llama import _rope_cache
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas import moe_ffn as jax_moe
from paddle_tpu.ops.pallas import rms_norm as jax_rms
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import moe_ffn as MF
from paddle_tpu_torch.ops.cuda import rms_norm as RN

OUT_ATOL = 1e-5
GRAD_FRAC = 1e-4
BF16_RTOL = 2.0 ** -8
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret_and_precision(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, dtype, frac=None):
    """|got - want| <= atol + rtol |want|: atol is OUT_ATOL, or
    ``frac`` x max|want| for a gradient; rtol is the bf16 rounding."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = OUT_ATOL if frac is None else frac * float(np.abs(want).max())
    rtol = BF16_RTOL if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _jt(x, dtype):
    return jnp.asarray(x).astype(DTYPES[dtype][2])


def _tt(x, dtype):
    return torch.from_numpy(np.array(x)).to(DTYPES[dtype][1])


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- MoE expert FFN ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,h,i,bi", [(3, 40, 128, 256, "128"),
                                        (2, 24, 128, 384, "512")])
def test_moe_expert_ffn_forward_and_grads_match_jax(dtype, e, c, h, i, bi,
                                                    monkeypatch):
    """``moe_expert_ffn`` forward and the gradients of x, gate_w, up_w and
    down_w (the JAX kernel accumulating over several I tiles where bi <
    I)."""
    monkeypatch.setenv("PT_MOE_BI", bi)
    rng = np.random.RandomState(e * c + i)
    arrs = [rng.randn(e, c, h) * 0.5, rng.randn(e, h, i) * 0.1,
            rng.randn(e, h, i) * 0.1, rng.randn(e, i, h) * 0.1]
    arrs = [a.astype(np.float32) for a in arrs]
    r = rng.randn(e, c, h).astype(np.float32)

    def jloss(*a):
        out = jax_moe.moe_expert_ffn(*a)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(_jt(a, dtype) for a in arrs))
    ts = [_tt(a, dtype).requires_grad_() for a in arrs]
    MF.reset_launch_counts()
    out = MF.moe_expert_ffn(*ts)
    (out.float() * torch.from_numpy(r)).sum().backward()
    assert MF.launch_counts() == {"moe_ffn_cuda": 0}
    assert out.dtype == DTYPES[dtype][1] and out.shape == (e, c, h)
    _close(out.detach().float().numpy(), _f32(jout), dtype)
    for t, g in zip(ts, jgrads):
        assert t.grad.dtype == t.dtype
        _close(t.grad.float().numpy(), _f32(g), dtype, GRAD_FRAC)


def test_moe_plain_is_the_fp32_composition():
    rng = np.random.RandomState(1)
    x, g, u = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((2, 5, 16), (2, 16, 24), (2, 16, 24)))
    d = torch.from_numpy(rng.randn(2, 24, 16).astype(np.float32))
    want = torch.einsum("eci,eih->ech", torch.nn.functional.silu(
        torch.einsum("ech,ehi->eci", x, g))
        * torch.einsum("ech,ehi->eci", x, u), d)
    torch.testing.assert_close(MF.moe_ffn_plain(x, g, u, d), want,
                               rtol=0, atol=OUT_ATOL)


def test_moe_switch_and_shape_rule(monkeypatch):
    monkeypatch.delenv("PT_FUSED_MOE", raising=False)
    assert not MF.use_fused_moe_ffn()
    monkeypatch.setenv("PT_FUSED_MOE", "1")
    assert MF.use_fused_moe_ffn()
    assert MF.moe_ffn_shapes_ok(768, 2048)
    assert not MF.moe_ffn_shapes_ok(768, 2000)
    assert not MF.moe_ffn_shapes_ok(96, 256)


# -- fused add + RMSNorm ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_rms_norm_forward_and_grads_match_jax(dtype):
    rng = np.random.RandomState(3)
    x, y, r1, r2 = (rng.randn(2, 24, 256).astype(np.float32)
                    for _ in range(4))
    w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    eps = 1e-5

    def jloss(x, y, w):
        out, res = jax_rms._fused_add_rms_norm_nd(x, y, w, eps)
        return (jnp.sum(out.astype(jnp.float32) * r1)
                + jnp.sum(res.astype(jnp.float32) * r2)), (out, res)

    (_, (jout, jres)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        _jt(x, dtype), _jt(y, dtype), _jt(w, dtype))
    ts = [_tt(a, dtype).requires_grad_() for a in (x, y, w)]
    RN.reset_launch_counts()
    out, res = RN.fused_add_rms_norm(*ts, epsilon=eps)
    ((out.float() * torch.from_numpy(r1)).sum()
     + (res.float() * torch.from_numpy(r2)).sum()).backward()
    assert RN.launch_counts() == {"fused_add_rms_norm_cuda": 0,
                                  "fused_add_layer_norm_cuda": 0}
    # the residual is x + y rounded once: exact on both sides
    np.testing.assert_array_equal(res.detach().float().numpy(), _f32(jres))
    _close(out.detach().float().numpy(), _f32(jout), dtype)
    for t, g in zip(ts, jgrads):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        _close(t.grad.float().numpy(), _f32(g), dtype, GRAD_FRAC)


def test_fused_add_rms_norm_norms_the_rounded_residual():
    """In bf16 the norm reads round(x + y), not the fp32 sum."""
    rng = np.random.RandomState(8)
    x, y = (torch.from_numpy(rng.randn(6, 128).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    w = torch.ones(128, dtype=torch.bfloat16)
    out, r = RN.fused_add_rms_norm_plain(x, y, w, 1e-6)
    assert torch.equal(r, (x.float() + y.float()).to(torch.bfloat16))
    want = F.rms_norm(r.float(), w.float(), 1e-6).to(torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.parametrize("case", ["residual", "bias", "norm_bias", "plain",
                                  "axis"])
def test_incubate_fused_rms_norm_matches_jax(case):
    """``incubate.nn.functional.fused_rms_norm``: the residual form (the
    kernel's route), with a bias, with a norm bias (not fusable: the
    composition), without a residual, and over two trailing axes."""
    rng = np.random.RandomState(4)
    x, res, bias = (rng.randn(2, 8, 128).astype(np.float32)
                    for _ in range(3))
    w = (1 + 0.1 * rng.randn(128)).astype(np.float32)
    nb = rng.randn(128).astype(np.float32)
    kw = {"residual": dict(residual=res), "bias": dict(residual=res,
                                                       bias=bias[0, 0]),
          "norm_bias": dict(residual=res), "plain": {}, "axis": {}}[case]
    norm_bias = nb if case == "norm_bias" else None
    axis = 1 if case == "axis" else 2
    wt = w if case != "axis" else np.tile(w, 8)
    want = JIF.fused_rms_norm(
        paddle.to_tensor(x), paddle.to_tensor(wt),
        None if norm_bias is None else paddle.to_tensor(norm_bias), 1e-6,
        axis, **{k: paddle.to_tensor(v) for k, v in kw.items()})
    got = IF.fused_rms_norm(
        torch.from_numpy(x), torch.from_numpy(wt),
        None if norm_bias is None else torch.from_numpy(norm_bias), 1e-6,
        axis, **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=OUT_ATOL)


def test_incubate_fused_rms_norm_refuses_quant():
    x = torch.zeros(2, 128)
    with pytest.raises(NotImplementedError):
        IF.fused_rms_norm(x, torch.ones(128), None, 1e-6, 1,
                          residual=x, quant_scale=1.0)


# -- rope-fused flash attention ---------------------------------------------

def _tables(s, d):
    cos, sin = _rope_cache(s, d, 10000.0)
    return cos, sin


ROPE_CASES = [(2, 64, True), (2, 96, True), (3, 64, False), (1, 96, False)]


@pytest.mark.parametrize("bh,s,causal", ROPE_CASES)
def test_rope_plain_versions_match_pallas(bh, s, causal):
    """The plain rope forward, dq and dkv against the JAX kernels' rope
    form (``_fwd``/``_bwd`` with ``rope_cs``), tiles of 32 so both loops
    run over several."""
    d = 32
    rng = np.random.RandomState(s + bh)
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32) for _ in range(4))
    cos, sin = _tables(s, d)
    c2, s2 = jax_fa._widen_tables(jnp.asarray(cos), jnp.asarray(sin))
    scale = 1 / math.sqrt(d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jax_fa._fwd(jq, jk, jv, scale, causal, 32, 32,
                           rope_cs=(c2, s2))
    dq, dk, dv = jax_fa._bwd(scale, causal, 32, 32, (jq, jk, jv, out, lse),
                             jdo, rope_cs=(c2, s2))
    tc2, ts2 = FA.widen_tables(torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_array_equal(tc2.numpy(), np.asarray(c2))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    got_out, got_lse = FA.flash_attention_rope_fwd_plain(*t[:3], tc2, ts2,
                                                         scale, causal)
    _close(got_out.numpy(), out, "float32")
    _close(got_lse.numpy(), np.asarray(lse)[:, 0], "float32")
    res = (*t[:3], torch.from_numpy(np.array(out)),
           torch.from_numpy(np.array(lse))[:, 0], t[3], tc2, ts2, scale,
           causal)
    _close(FA.flash_attention_rope_bwd_dq_plain(*res).numpy(), dq, "float32",
           GRAD_FRAC)
    got_dk, got_dv = FA.flash_attention_rope_bwd_dkv_plain(*res)
    _close(got_dk.numpy(), dk, "float32", GRAD_FRAC)
    _close(got_dv.numpy(), dv, "float32", GRAD_FRAC)


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_rope_array_entry_forward_and_grads_match_jax(hkv, causal,
                                                      monkeypatch):
    """``flash_attention_rope`` on pre-rotary [B, S, H, D] (MHA 4/4 and
    GQA 4/2) against ``_flash_attention_rope_arrays`` and ``jax.grad``."""
    monkeypatch.setenv("PT_FA_BQ", "32")
    monkeypatch.setenv("PT_FA_BK", "32")
    b, s, h, d = 2, 64, 4, 32
    rng = np.random.RandomState(21 + hkv)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k, v = (rng.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    w = rng.randn(b, s, h, d).astype(np.float32)
    cos, sin = _tables(s, d)

    def jloss(q, k, v):
        out = jax_fa._flash_attention_rope_arrays.raw_fn(
            q, k, v, jnp.asarray(cos), jnp.asarray(sin), causal=causal)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    FA.reset_launch_counts()
    out = FA.flash_attention_rope(*ts, torch.from_numpy(cos),
                                  torch.from_numpy(sin), causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    assert all(n == 0 for n in FA.launch_counts().values())
    _close(out.detach().numpy(), jout, "float32")
    for t, g in zip(ts, jgrads):
        assert t.grad.shape == t.shape
        _close(t.grad.numpy(), g, "float32", GRAD_FRAC)


def test_rope_function_saves_pre_rotary_q_and_k():
    b, s, h, d = 1, 16, 2, 32
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .requires_grad_() for _ in range(3))
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    out = FA.flash_attention_rope(q, k, v, cos, sin)
    saved = out.grad_fn.saved_tensors
    assert torch.equal(saved[0], q.detach().transpose(1, 2).reshape(
        b * h, s, d))
    assert torch.equal(saved[1], k.detach().transpose(1, 2).reshape(
        b * h, s, d))


def test_rope_bf16_rotates_in_fp32():
    """The fused path rotates bf16 q/k in fp32 (the kernels' math); the
    unfused path multiplies in bf16, a different function."""
    b, s, h, d = 1, 32, 2, 64
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    got = FA.flash_attention_rope(q, k, v, cos, sin)
    c2, s2 = FA.widen_tables(cos, sin)

    def rot(x):  # fp32 rotation on [B, S, H, D]
        return FA.rope_rotate(x.transpose(1, 2), c2, s2).transpose(1, 2)

    want = F.sdpa_reference(rot(q), rot(k), v.float(), causal=True)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want.numpy(), "bfloat16")


def test_fused_rope_gate(monkeypatch):
    s, d = 16, 32
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(1, s, 2, d).astype(np.float32))
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    monkeypatch.setenv("PT_FUSED_ROPE", "0")
    assert not F.fused_rope_attention_enabled(1, s, 2, d)
    assert F.fused_rope_attention(q, q, q, cos, sin) is None
    monkeypatch.setenv("PT_FUSED_ROPE", "1")
    assert F.fused_rope_attention_enabled(1, s, 2, d)
    assert not F.fused_rope_attention_enabled(1, s, 2, 48)  # no kernel
    out = F.fused_rope_attention(q, q, q, cos, sin)
    assert out is not None and port_sdpa.LAST_PATH == "plain_rope"
    assert F.fused_rope_attention(q.half(), q.half(), q.half(), cos,
                                  sin) is None
    assert F.fused_rope_attention(q, q[:, :8], q[:, :8], cos, sin) is None
    assert F.fused_rope_attention(q, q, q, cos[:8], sin[:8]) is None


# -- the decoder with the switches ------------------------------------------

@pytest.mark.parametrize("switch", ["PT_FUSED_NORM", "PT_FUSED_ROPE",
                                    "PT_FUSED_MOE"])
def test_decoder_switches_keep_the_function(switch, monkeypatch):
    """Within the port, in fp32: each switch changes the route of the
    decoder (MoE model, GQA) but not its loss or gradients."""
    for name in ("PT_FUSED_NORM", "PT_FUSED_ROPE", "PT_FUSED_MOE"):
        monkeypatch.setenv(name, "0")
    cfg = torch_llama.llama_tiny(num_experts=4)
    model = torch_llama.LlamaForCausalLM(cfg, device="cpu", seed=3)
    rng = np.random.RandomState(2)
    ids, labels = (torch.from_numpy(rng.randint(0, 512, (2, 24)))
                   for _ in range(2))
    res = []
    for flag in ("0", "1"):
        monkeypatch.setenv(switch, flag)
        model.zero_grad()
        loss, _ = model(ids, labels)
        loss.backward()
        res.append((float(loss.detach()), [p.grad.clone() for p in
                                  model.parameters()]))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    for a, b in zip(res[1][1], res[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_FRAC * float(
            b.abs().max()) + 1e-9)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 16, 128)
    w = torch.zeros(2, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        MF.moe_ffn_cuda(x, w, w, w)
    with pytest.raises(ValueError, match="CUDA"):
        RN.fused_add_rms_norm_cuda(x[0], x[0], x[0, 0], 1e-6)
    q = torch.zeros(2, 16, 32)
    lse = torch.zeros(2, 16)
    c2 = torch.zeros(16, 32)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_rope_fwd_cuda(q, q, q, c2, c2, 1.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_rope_bwd_dq_cuda(q, q, q, q, lse, q, c2, c2, 1.0,
                                            True)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_rope_bwd_dkv_cuda(q, q, q, q, lse, q, c2, c2, 1.0,
                                             True)
