"""Numerics of the flash-attention backward's bf16 tensor-core bodies.

The bf16 dq and dk/dv kernels (``flash_bwd_route`` -> "tensor_core") form
every product on bf16 tensor cores with fp32 sums. This file emulates that
arithmetic in plain PyTorch and holds it against the fp32 plain versions
(``flash_attention[_rope]_bwd_*_plain``) under ``chip_smoke.py``'s gradient
tolerance, ``2^-8 |want| + 1e-4 max|want|``, with the forward's out (bf16)
and lse shared by both sides, as ``chip_smoke.py`` passes them:

* S = q k^T and dP = dO v^T are exact bf16 x bf16 products with fp32 sums,
  and the scale multiplies the fp32 scores (q stays an exact bf16 value);
* P and dS are fp32 values: each is split into bf16 hi + lo, so dq = dS k,
  dk = dS^T q and dv = P^T dO take two products each;
* with rope the rotated q and k are fp32 values too: each is split, and
  S, dq and dk take hi.hi + hi.lo + lo.hi (lo.lo dropped).

Each emulation passes with the split and fails with the same operand
rounded to bf16 alone, which is why the kernels split.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.llama import _rope_cache
from paddle_tpu_torch.ops.cuda import flash_attention as FA

CHIP_RTOL, GRAD_FRAC = 2.0 ** -8, 1e-4   # chip_smoke.py's bf16 gradients


def _bf(x):
    return x.bfloat16().float()


def _split(x, split):
    """(hi, lo) bf16 parts of an fp32 tensor (lo = 0 when rounded alone)."""
    hi = _bf(x)
    return hi, (_bf(x - hi) if split else torch.zeros_like(x))


def _inputs(seed, bh, s, d):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
            .bfloat16() for _ in range(4)]


def _tables(s, d):
    cos, sin = (torch.from_numpy(t) for t in _rope_cache(s, d, 10000.0))
    return FA.widen_tables(cos, sin)


def tensor_core_grads(q, k, v, out, lse, dout, scale, causal, tables=None,
                      split_p=True, split_qk=True):
    """(dq, dk, dv) in bf16 as the tensor-core bodies compute them.
    ``split_p``: P and dS split into hi + lo (else rounded to bf16);
    ``split_qk``: with ``tables``, the rotated q and k split likewise."""
    if tables is None:
        (qh, ql), (kh, kl) = (q.float(), 0.0), (k.float(), 0.0)
    else:
        qh, ql = _split(FA.rope_rotate(q, *tables), split_qk)
        kh, kl = _split(FA.rope_rotate(k, *tables), split_qk)
    t = lambda x: x.transpose(-1, -2)    # noqa: E731
    s = (qh @ t(kh) + (0.0 if tables is None else qh @ t(kl) + ql @ t(kh)))
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        n = q.shape[-2]
        p = p.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), 0.0)
    dof = dout.float()
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dof @ t(v.float()) - delta) * scale
    (ph, pl), (dsh, dsl) = _split(p, split_p), _split(ds, split_p)
    dq = dsh @ kh + dsl @ kh
    dk = t(dsh) @ qh + t(dsl) @ qh
    if tables is not None:
        dq = FA.rope_rotate(dq + dsh @ kl, tables[0], -tables[1])
        dk = FA.rope_rotate(dk + t(dsh) @ ql, tables[0], -tables[1])
    dv = t(ph) @ dof + t(pl) @ dof
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _excess(got, want):
    """Largest |got - want| beyond chip_smoke.py's gradient tolerance."""
    want = want.float()
    tol = CHIP_RTOL * want.abs() + GRAD_FRAC * float(want.abs().max())
    return float(((got.float() - want).abs() - tol).max())


def _worst(seed, bh, s, d, causal, rope, **split):
    q, k, v, do = _inputs(seed, bh, s, d)
    scale = d ** -0.5
    tables = _tables(s, d) if rope else None
    # the forward's bf16 out and lse; the plain backward in fp32 on the
    # exactly upcast values (chip_smoke.py's comparison)
    up = [x.float() for x in (q, k, v)]
    if rope:
        out, lse = FA.flash_attention_rope_fwd_plain(q, k, v, *tables, scale,
                                                     causal)
        res = (*up, out.float(), lse, do.float(), *tables)
        want = (FA.flash_attention_rope_bwd_dq_plain(*res, scale, causal),
                *FA.flash_attention_rope_bwd_dkv_plain(*res, scale, causal))
    else:
        out, lse = FA.flash_attention_fwd_plain(q, k, v, scale, causal)
        res = (*up, out.float(), lse, do.float())
        want = (FA.flash_attention_bwd_dq_plain(*res, scale, causal),
                *FA.flash_attention_bwd_dkv_plain(*res, scale, causal))
    got = tensor_core_grads(q, k, v, out, lse, do, scale, causal, tables,
                            **split)
    return [_excess(g, w) for g, w in zip(got, want)]


CASES = [  # (bh, S, D, causal): ragged S, D 64 and 128
    (4, 256, 64, True), (4, 200, 64, False), (2, 300, 128, True),
    (2, 136, 128, False)]


@pytest.mark.parametrize("bh,s,d,causal", CASES)
@pytest.mark.parametrize("rope", [False, True])
def test_split_keeps_the_chip_tolerance(bh, s, d, causal, rope):
    """dq, dk and dv of the emulated bodies lie inside the tolerance."""
    assert max(_worst(s + d, bh, s, d, causal, rope)) <= 0


@pytest.mark.parametrize("bh,s,d,causal", CASES)
@pytest.mark.parametrize("rope", [False, True])
def test_p_and_ds_rounded_alone_fail(bh, s, d, causal, rope):
    """P and dS rounded to bf16 without their lo parts: dk and dv (sums
    of p or dS over many query rows) leave the tolerance."""
    assert max(_worst(s + d, bh, s, d, causal, rope, split_p=False)) > 0


@pytest.mark.parametrize("bh,s,d,causal", CASES)
def test_rotated_qk_rounded_alone_fail(bh, s, d, causal):
    """With rope, the rotated q and k rounded to bf16 alone: the scores
    and dq/dk leave the tolerance."""
    assert max(_worst(s + d, bh, s, d, causal, True, split_qk=False)) > 0


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
    (torch.float32, 32, "cuda_core"),
    (torch.float32, 64, "cuda_core"),
    (torch.float32, 128, "cuda_core"),
])
def test_flash_bwd_route(dtype, head_dim, want):
    """The backward wrappers' body, from the dtype and head_dim alone."""
    assert FA.flash_bwd_route(dtype, head_dim) == want


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.float16, 64), (torch.bfloat16, 96), (torch.float32, 16)])
def test_flash_bwd_route_refuses_what_no_body_takes(dtype, head_dim):
    with pytest.raises((TypeError, ValueError)):
        FA.flash_bwd_route(dtype, head_dim)
