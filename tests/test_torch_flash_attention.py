"""Flash attention of the PyTorch port against the JAX package.

The same numpy inputs (seeded; [B*H, S, D] with S 64-128 and D 32, causal
and not, tiles smaller than S so the JAX kernels loop over several) go
through the JAX package's Pallas kernels in interpret mode (``_fwd``,
``_bwd`` and ``_flash_attention_arrays`` with ``jax.grad``) and through the
port's plain PyTorch versions, which are what a CPU tensor reaches and what
the CUDA kernels compute. fp32 throughout, JAX matmuls at "highest";
tolerances: atol 1e-5 on out and lse, 1e-4 x max|g| on gradients (sums in
another order, with cancellation between terms of both signs).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa
from paddle_tpu_torch.ops.cuda import flash_attention as FA

OUT_ATOL = 1e-5
GRAD_FRAC = 1e-4
BLOCK = 32


@pytest.fixture(autouse=True)
def _interpret_and_precision(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    with jax.default_matmul_precision("highest"):
        yield


def _arrays(seed, *shape, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_grad(got, want):
    want = np.asarray(want)
    tol = GRAD_FRAC * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


CASES = [(2, 64, True), (2, 128, True), (3, 128, False), (1, 96, False)]


@pytest.mark.parametrize("bh,s,causal", CASES)
def test_plain_forward_matches_pallas_fwd(bh, s, causal):
    q, k, v, _ = _arrays(s + bh, bh, s, 32)
    scale = 1 / math.sqrt(32)
    want_out, want_lse = jax_fa._fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale, causal, BLOCK,
                                     BLOCK)
    out, lse = FA.flash_attention_fwd_plain(_t(q), _t(k), _t(v), scale,
                                            causal)
    assert out.dtype == torch.float32 and tuple(lse.shape) == (bh, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0],
                               rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("bh,s,causal", CASES)
def test_plain_backward_matches_pallas_bwd(bh, s, causal):
    q, k, v, do = _arrays(7 * s + bh, bh, s, 32)
    scale = 1 / math.sqrt(32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jax_fa._fwd(jq, jk, jv, scale, causal, BLOCK, BLOCK)
    dq, dk, dv = jax_fa._bwd(scale, causal, BLOCK, BLOCK,
                             (jq, jk, jv, out, lse), jdo)
    res = (_t(q), _t(k), _t(v), _t(out), _t(lse)[:, 0], _t(do))
    got_dq = FA.flash_attention_bwd_dq_plain(*res, scale, causal)
    got_dk, got_dv = FA.flash_attention_bwd_dkv_plain(*res, scale, causal)
    _close_grad(got_dq.numpy(), dq)
    _close_grad(got_dk.numpy(), dk)
    _close_grad(got_dv.numpy(), dv)


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_array_entry_forward_and_grad_match_jax(hkv, causal):
    """``flash_attention`` on [B, S, H, D] (MHA 4/4 and GQA 4/2) on the
    CPU against ``_flash_attention_arrays`` and ``jax.grad``."""
    b, s, h, d = 2, 64, 4, 32
    rng = np.random.RandomState(11 + hkv)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    w = rng.randn(b, s, h, d).astype(np.float32)

    def jloss(q, k, v):
        out = jax_fa._flash_attention_arrays.raw_fn(q, k, v, causal=causal)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    FA.reset_launch_counts()
    out = FA.flash_attention(tq, tk, tv, causal=causal)
    (out * _t(w)).sum().backward()
    assert all(n == 0 for n in FA.launch_counts().values())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=OUT_ATOL)
    for got, want in zip((tq, tk, tv), jgrads):
        assert got.grad.shape == got.shape
        _close_grad(got.grad.numpy(), want)


@pytest.mark.parametrize("hkv", [4, 2])
def test_function_on_cpu_equals_plain_sdpa_through_autograd(hkv):
    """On CPU tensors the autograd Function runs the plain versions, and
    its gradients equal those of the plain dense attention
    (``sdpa_reference``) differentiated by autograd."""
    b, s, h, d = 1, 80, 4, 32
    rng = np.random.RandomState(5)
    arrs = [rng.randn(b, s, n, d).astype(np.float32) for n in (h, hkv, hkv)]
    w = _t(rng.randn(b, s, h, d).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: FA.flash_attention(q, k, v, causal=True),
               lambda q, k, v: F.sdpa_reference(q, k, v, causal=True)):
        ts = [_t(a).requires_grad_() for a in arrs]
        out = fn(*ts)
        (out * w).sum().backward()
        grads.append([out.detach()] + [t.grad for t in ts])
    np.testing.assert_allclose(grads[0][0].numpy(), grads[1][0].numpy(),
                               rtol=0, atol=OUT_ATOL)
    for got, want in zip(grads[0][1:], grads[1][1:]):
        _close_grad(got.numpy(), want.numpy())


def test_sdpa_routes_by_device_and_raises_on_the_rest():
    rng = np.random.RandomState(2)
    q, k, v = (_t(rng.randn(1, 16, 2, 32).astype(np.float32))
               for _ in range(3))
    F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert port_sdpa.LAST_PATH == "plain"
    mask = torch.ones(1, 1, 16, 16, dtype=torch.bool).tril()
    F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    assert port_sdpa.LAST_PATH == "reference"
    F.scaled_dot_product_attention(q, k[:, :8], v[:, :8])
    assert port_sdpa.LAST_PATH == "reference"
    # training-mode dropout: the plain dense attention with its keep mask
    F.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
    assert port_sdpa.LAST_PATH == "reference"
    F.scaled_dot_product_attention(q, k, v, dropout_p=0.1, training=False)
    assert port_sdpa.LAST_PATH == "plain"
    # on the card: the kernels for their head dims and dtypes, the plain
    # dense attention (as the reference's _sdpa_ref) for every other shape
    route = port_sdpa.sdpa_route
    assert route("cuda", torch.bfloat16, 64, False, True) == "cuda"
    assert route("cuda", torch.float32, 128, False, True) == "cuda"
    assert route("cuda", torch.bfloat16, 96, False, True) == "reference"
    assert route("cuda", torch.float32, 16, False, True) == "reference"
    assert route("cuda", torch.float16, 64, False, True) == "reference"
    assert route("cuda", torch.bfloat16, 64, True, True) == "reference"
    assert route("cuda", torch.bfloat16, 64, False, False) == "reference"
    assert route("cpu", torch.float16, 96, False, True) == "plain"
    assert route("cpu", torch.float32, 64, True, True) == "reference"
    assert route("cuda", torch.bfloat16, 64, False, True, True) == \
        "reference"


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 16, 32)
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_fwd_cuda(q, q, q, 1.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd_dq_cuda(q, q, q, q, lse, q, 1.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd_dkv_cuda(q, q, q, q, lse, q, 1.0, True)
