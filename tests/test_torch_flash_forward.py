"""Numerics of the flash-attention forward's bf16 tensor-core body.

The bf16 forward kernel (``flash_route`` -> "tensor_core") forms every
product on bf16 tensor cores with fp32 sums. This file emulates that
arithmetic in plain PyTorch and holds it against the fp32 plain versions
(``flash_attention[_rope]_fwd_plain`` on the exactly upcast inputs) under
``chip_smoke.py``'s tolerances: out ``1e-4 + 2^-8 |want|`` (bf16), lse
``1e-4``.

* S = q k^T is an exact bf16 x bf16 product with fp32 sums, and the scale
  multiplies the fp32 scores (q stays an exact bf16 value);
* the online softmax runs in the exp2 domain over chunks of keys (64 at
  D <= 64; 32 at D 128, the kernel's ``Cfg<D>::NC``): per chunk the row max
  m2 of s scale log2e, p = 2^(t - m2), the correction 2^(m2_old - m2)
  rescales l and the accumulator; masked scores are NEG_INF, their p 0;
* P is an fp32 value: it is split into bf16 hi + lo, so P V takes two
  products;
* with rope the rotated q and k are fp32 values too: each is split, and S
  takes hi.hi + hi.lo + lo.hi (lo.lo dropped);
* out = acc / max(l, 1e-30) rounded to bf16, lse = m2 ln 2 + log(max(l,
  1e-30)).

Each emulation passes with the split and fails with the same operand
rounded to bf16 alone, which is why the kernel splits. The emulation is
also held against the JAX package's Pallas forward (interpret mode) on the
same inputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch.models.llama import _rope_cache
from paddle_tpu_torch.ops.cuda import flash_attention as FA

ATOL, RTOL, LSE_ATOL = 1e-4, 2.0 ** -8, 1e-4   # chip_smoke.py's bf16 forward
LOG2E = 1.4426950408889634


def _bf(x):
    return x.bfloat16().float()


def _split(x, split):
    """(hi, lo) bf16 parts of an fp32 tensor (lo = 0 when rounded alone)."""
    hi = _bf(x)
    return hi, (_bf(x - hi) if split else torch.zeros_like(x))


def _inputs(seed, bh, s, d):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
            .bfloat16() for _ in range(3)]


def _tables(s, d):
    cos, sin = (torch.from_numpy(t) for t in _rope_cache(s, d, 10000.0))
    return FA.widen_tables(cos, sin)


def tensor_core_forward(q, k, v, scale, causal, tables=None, split_p=True,
                        split_qk=True):
    """(out in bf16, lse in fp32) as the tensor-core body computes them.
    ``split_p``: P split into hi + lo (else rounded to bf16); ``split_qk``:
    with ``tables``, the rotated q and k split likewise."""
    if tables is None:
        (qh, ql), (kh, kl) = (q.float(), None), (k.float(), None)
    else:
        qh, ql = _split(FA.rope_rotate(q, *tables), split_qk)
        kh, kl = _split(FA.rope_rotate(k, *tables), split_qk)
    t = lambda x: x.transpose(-1, -2)    # noqa: E731
    s = qh @ t(kh)
    if tables is not None:
        s = s + qh @ t(kl) + ql @ t(kh)
    n, d = q.shape[-2], q.shape[-1]
    visible = torch.ones(n, n, dtype=torch.bool)
    if causal:
        visible = visible.tril()
    s = (s * (scale * LOG2E)).masked_fill(~visible, FA.NEG_INF)
    m2 = torch.full(q.shape[:-1] + (1,), FA.NEG_INF)
    l, acc, vf = torch.zeros_like(m2), torch.zeros(q.shape), v.float()
    nc = 64 if d <= 64 else 32
    for c0 in range(0, n, nc):
        sc, vis = s[..., c0:c0 + nc], visible[:, c0:c0 + nc]
        m_new = torch.maximum(m2, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - m_new).masked_fill(~vis, 0.0)
        corr = torch.exp2(m2 - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        ph, pl = _split(p, split_p)
        acc = acc * corr + ph @ vf[..., c0:c0 + nc, :] + pl @ vf[
            ..., c0:c0 + nc, :]
        m2 = m_new
    den = l.clamp_min(1e-30)
    return (acc / den).bfloat16(), (m2 * math.log(2.0) + den.log())[..., 0]


def _worst(seed, bh, s, d, causal, rope, **split):
    """(out's largest excess over its tolerance, lse's largest excess)."""
    q, k, v = _inputs(seed, bh, s, d)
    scale = d ** -0.5
    tables = _tables(s, d) if rope else None
    up = [x.float() for x in (q, k, v)]
    if rope:
        want, w_lse = FA.flash_attention_rope_fwd_plain(*up, *tables, scale,
                                                        causal)
    else:
        want, w_lse = FA.flash_attention_fwd_plain(*up, scale, causal)
    out, lse = tensor_core_forward(q, k, v, scale, causal, tables, **split)
    x_out = float(((out.float() - want).abs()
                   - (ATOL + RTOL * want.abs())).max())
    return x_out, float((lse - w_lse).abs().max()) - LSE_ATOL


CASES = [  # (bh, S, D, causal): ragged S, D 64 and 128
    (4, 256, 64, True), (4, 200, 64, False), (2, 300, 128, True),
    (2, 136, 128, False)]


@pytest.mark.parametrize("bh,s,d,causal", CASES)
@pytest.mark.parametrize("rope", [False, True])
def test_split_keeps_the_chip_tolerance(bh, s, d, causal, rope):
    """out and lse of the emulated body lie inside the tolerances."""
    assert max(_worst(s + d, bh, s, d, causal, rope)) <= 0


@pytest.mark.parametrize("bh,s,d,causal", CASES)
@pytest.mark.parametrize("rope", [False, True])
def test_p_rounded_alone_fails(bh, s, d, causal, rope):
    """P rounded to bf16 without its lo part: out (a few dominant
    probabilities times v, cancelling) leaves the tolerance, so the kernel
    keeps the P lo product."""
    x_out, x_lse = _worst(s + d, bh, s, d, causal, rope, split_p=False)
    assert x_out > 0
    assert x_lse <= 0          # l is summed from the fp32 P


@pytest.mark.parametrize("bh,s,d,causal", CASES)
def test_rotated_qk_rounded_alone_fail(bh, s, d, causal):
    """With rope, the rotated q and k rounded to bf16 alone: the scores,
    and with them out and lse, leave the tolerances."""
    x_out, x_lse = _worst(s + d, bh, s, d, causal, True, split_qk=False)
    assert x_out > 0 and x_lse > 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [False, True])
def test_emulation_matches_the_pallas_forward(monkeypatch, causal, rope):
    """The emulated body against the JAX package's own kernel (``_fwd``,
    its rope form with ``_widen_tables``; Pallas in interpret mode, fp32
    matmuls at "highest") on the same bf16-valued inputs, under the same
    tolerances."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    bh, s, d, block = 2, 128, 64, 32
    q, k, v = _inputs(11 + causal + 2 * rope, bh, s, d)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (q, k, v))
    cos, sin = _rope_cache(s, d, 10000.0)
    rope_cs = (jax_fa._widen_tables(jnp.asarray(cos), jnp.asarray(sin))
               if rope else None)
    with jax.default_matmul_precision("highest"):
        want, w_lse = jax_fa._fwd(jq, jk, jv, scale, causal, block, block,
                                  rope_cs=rope_cs)
    want = torch.from_numpy(np.array(want))
    w_lse = torch.from_numpy(np.array(w_lse))[:, 0]
    out, lse = tensor_core_forward(q, k, v, scale, causal,
                                   _tables(s, d) if rope else None)
    assert float(((out.float() - want).abs()
                  - (ATOL + RTOL * want.abs())).max()) <= 0
    assert float((lse - w_lse.reshape(lse.shape)).abs().max()) <= LSE_ATOL


class _FakeLib:
    """Records the arguments of each ``flash_attention_*_launch`` call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("kernel", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_kernel_passes_the_route(monkeypatch, kernel, rope, dtype):
    """``_launch`` hands the C entry of the forward, dq and dk/dv, with and
    without rope, tensor_core = 1 for bf16 and 0 for fp32 (the argument
    before the stream)."""
    lib = _FakeLib()
    monkeypatch.setattr(FA, "_lib", lambda: lib)
    monkeypatch.setattr(FA, "_stream", lambda t: 0)
    q = torch.zeros(2, 8, 64, dtype=dtype)
    tables = (torch.zeros(8, 64), torch.zeros(8, 64)) if rope else None
    FA._launch(kernel, q, [0, 0], tables, 0.125, True)
    (name, args), = lib.calls
    assert name == ("flash_attention_" + ("rope_" if rope else "")
                    + kernel + "_launch")
    assert args[-2] == int(dtype == torch.bfloat16)


@pytest.mark.parametrize("kernel", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("dtype,head_dim", [
    (torch.float16, 64), (torch.bfloat16, 96), (torch.float32, 16),
    (torch.int8, 64)])
def test_every_kernel_refuses_what_no_body_takes(monkeypatch, kernel, dtype,
                                                  head_dim):
    """A dtype or head_dim without a body raises before any launch."""
    lib = _FakeLib()
    monkeypatch.setattr(FA, "_lib", lambda: lib)
    monkeypatch.setattr(FA, "_stream", lambda t: 0)
    with pytest.raises((TypeError, ValueError)):
        FA._launch(kernel, torch.zeros(2, 8, head_dim, dtype=dtype), [0, 0],
                   None, 0.125, True)
    assert lib.calls == []


def test_flash_bwd_route_is_gone():
    """One function names the body of all three kernels: no alias."""
    assert not hasattr(FA, "flash_bwd_route")
    assert "flash_route" in FA.__all__
