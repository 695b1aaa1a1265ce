"""The fused add + LayerNorm of the BERT slice, and LayerNorm, against the
JAX package.

The same numpy inputs (seeded) go through the JAX package (the Pallas
kernel ``_fused_add_layer_norm_nd`` in interpret mode, with ``jax.grad``
for its gradients; ``incubate.nn.functional.fused_layer_norm``;
``nn.functional.layer_norm``) and through the port's entries on CPU
tensors, which take the plain PyTorch versions: what the CUDA kernel
computes. Tolerances are those of tests/test_torch_fused_kernels.py: fp32
outputs atol 1e-5, gradients 1e-4 x max|g| (fp32 sums in another order,
with cancellation); bf16 adds half an ulp of the output's rounding (2^-8
relative), since both sides round an fp32 result that may differ in its
last bits. The residual is x + y rounded once: exact on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import rms_norm as jax_rms
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import rms_norm as RN

OUT_ATOL = 1e-5
GRAD_FRAC = 1e-4
BF16_RTOL = 2.0 ** -8
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


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
    return jnp.asarray(x).astype(DTYPES[dtype][1])


def _tt(x, dtype):
    return torch.from_numpy(np.array(x)).to(DTYPES[dtype][0])


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _inputs(seed, shape, h):
    rng = np.random.RandomState(seed)
    # an offset mean makes the two-pass variance matter
    x, y, r1, r2 = (rng.randn(*shape, h).astype(np.float32) + 3.0
                    for _ in range(4))
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    return x, y, w, b, r1, r2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,h", [((2, 24), 256), ((40,), 128)])
def test_fused_add_layer_norm_forward_and_grads_match_jax(dtype, shape, h):
    """``fused_add_layer_norm``: out and resid, and the gradients of x, y,
    the weight and the bias, through a loss reading both outputs."""
    x, y, w, b, r1, r2 = _inputs(5, shape, h)
    eps = 1e-12

    def jloss(x, y, w, b):
        out, res = jax_rms._fused_add_layer_norm_nd(x, y, w, b, eps)
        return (jnp.sum(out.astype(jnp.float32) * r1)
                + jnp.sum(res.astype(jnp.float32) * r2)), (out, res)

    (_, (jout, jres)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(_jt(a, dtype) for a in (x, y, w, b)))
    ts = [_tt(a, dtype).requires_grad_() for a in (x, y, w, b)]
    RN.reset_launch_counts()
    out, res = RN.fused_add_layer_norm(*ts, epsilon=eps)
    ((out.float() * torch.from_numpy(r1)).sum()
     + (res.float() * torch.from_numpy(r2)).sum()).backward()
    assert not any(RN.launch_counts().values())
    assert out.dtype == ts[0].dtype and out.shape == (*shape, h)
    np.testing.assert_array_equal(res.detach().float().numpy(), _f32(jres))
    _close(out.detach().float().numpy(), _f32(jout), dtype)
    for t, g in zip(ts, jgrads):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        _close(t.grad.float().numpy(), _f32(g), dtype, GRAD_FRAC)


def test_fused_add_layer_norm_norms_the_rounded_residual():
    """In bf16 the norm reads round(x + y), not the fp32 sum, and the
    result is the LayerNorm of it in fp32, rounded once."""
    rng = np.random.RandomState(8)
    x, y = (torch.from_numpy(rng.randn(6, 128).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    w = torch.from_numpy(1 + 0.1 * rng.randn(128).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.randn(128).astype(np.float32))
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    out, r = RN.fused_add_layer_norm_plain(x, y, wb, bb, 1e-12)
    assert torch.equal(r, (x.float() + y.float()).to(torch.bfloat16))
    want = F.layer_norm(r.float(), 128, wb.float(), bb.float(), 1e-12)
    assert torch.equal(out, want.to(torch.bfloat16))


def test_fused_add_layer_norm_backward_is_the_reference_vjp():
    """Within the port, fp32: the Function's gradients equal autograd
    through the plain composition (add, then LayerNorm), to the fp32 sums'
    order (GRAD_FRAC x max|g|)."""
    x, y, w, b, r1, r2 = _inputs(6, (3, 10), 128)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, y, w, b)]
    ref = [t.detach().clone().requires_grad_() for t in ts]
    out, res = RN.fused_add_layer_norm(*ts, epsilon=1e-5)
    r = ref[0] + ref[1]
    want = F.layer_norm(r, 128, ref[2], ref[3], 1e-5)
    for o, rr, tt in ((out, res, ts), (want, r, ref)):
        ((o * torch.from_numpy(r1)).sum()
         + (rr * torch.from_numpy(r2)).sum()).backward()
    for a, b_ in zip(ts, ref):
        torch.testing.assert_close(a.grad, b_.grad, rtol=0, atol=GRAD_FRAC
                                   * float(b_.grad.abs().max()))


@pytest.mark.parametrize("case", ["residual", "bias", "no_norm_bias",
                                  "plain", "axis"])
def test_incubate_fused_layer_norm_matches_jax(case):
    """``incubate.nn.functional.fused_layer_norm``: the residual form (the
    kernel's route), with a bias, without a norm bias (not fusable: the
    composition), without a residual, and over two trailing axes."""
    rng = np.random.RandomState(4)
    x, res, bias = (rng.randn(2, 8, 128).astype(np.float32)
                    for _ in range(3))
    axis = 1 if case == "axis" else 2
    n = 128 if case != "axis" else 8 * 128
    w = (1 + 0.1 * rng.randn(n)).astype(np.float32)
    nb = None if case == "no_norm_bias" else rng.randn(n).astype(np.float32)
    kw = {"residual": dict(residual=res),
          "bias": dict(residual=res, bias=bias[0, 0]),
          "no_norm_bias": dict(residual=res), "plain": {}, "axis": {}}[case]
    want = JIF.fused_layer_norm(
        paddle.to_tensor(x), paddle.to_tensor(w),
        None if nb is None else paddle.to_tensor(nb), 1e-5, axis,
        **{k: paddle.to_tensor(v) for k, v in kw.items()})
    got = IF.fused_layer_norm(
        torch.from_numpy(x), torch.from_numpy(w),
        None if nb is None else torch.from_numpy(nb), 1e-5, axis,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (2 if "residual" in kw else 1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=OUT_ATOL)


def test_incubate_fused_layer_norm_refuses_quant():
    x = torch.zeros(2, 128)
    with pytest.raises(NotImplementedError):
        IF.fused_layer_norm(x, torch.ones(128), torch.zeros(128), 1e-5, 1,
                            residual=x, quant_scale=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalized", [[96], [4, 96]])
def test_layer_norm_matches_jax(dtype, normalized):
    """``layer_norm`` over one and two trailing axes, with and without
    the affine terms: fp32 statistics, cast back to the input dtype."""
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 4, 96) * 2 + 5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(*normalized)).astype(np.float32)
    b = (0.1 * rng.randn(*normalized)).astype(np.float32)
    for affine in (True, False):
        args = (w, b) if affine else (None, None)
        want = JF.layer_norm(
            paddle.to_tensor(_jt(x, dtype)), normalized,
            *(None if a is None else paddle.to_tensor(_jt(a, dtype))
              for a in args), epsilon=1e-5)
        got = F.layer_norm(_tt(x, dtype), normalized,
                           *(None if a is None else _tt(a, dtype)
                             for a in args), epsilon=1e-5)
        assert got.dtype == DTYPES[dtype][0]
        _close(got.float().numpy(), _f32(want._data), dtype)


def test_layer_norm_layer_matches_jax_and_keeps_its_names():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 64).astype(np.float32)
    paddle.seed(0)
    jl = paddle.nn.LayerNorm(64, 1e-12)
    tl = LayerNorm(64, 1e-12, device="cpu")
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == [
        "bias", "weight"]
    assert torch.equal(tl.weight, torch.ones(64))
    assert torch.equal(tl.bias, torch.zeros(64))
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(1 + 0.1 * rng.randn(64)))
        tl.bias.copy_(torch.from_numpy(0.1 * rng.randn(64)))
    jl.set_state_dict({k: paddle.to_tensor(v.numpy())
                       for k, v in tl.state_dict().items()})
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), rtol=0,
                               atol=OUT_ATOL)


def test_layer_norm_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        RN.fused_add_layer_norm_cuda(x, x, x[0], x[0], 1e-12)
