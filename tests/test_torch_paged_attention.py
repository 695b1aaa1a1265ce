"""Paged attention of the PyTorch port against the JAX package.

The same numpy inputs (seeded; GQA H=4/Hkv=2, D=32, block 4, ragged
lengths; fp32 and int8 pools) go through the JAX function — its Pallas
kernel in interpret mode and its lax fallback — and through the port's
plain PyTorch version, which is what a CPU tensor reaches. Tolerance:
rtol = atol = 1e-5 (fp32 throughout; only summation order differs), on
the valid rows only (padding rows of the multi-query path are undefined).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import paged_attention as jax_pa
from paddle_tpu.inference.serving.kv_cache import (
    quantize_kv_rows as jax_quantize)
from paddle_tpu_torch.inference.serving import (
    paged_decode_attention, paged_multiquery_attention, quantize_kv_rows)
from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention_cuda, paged_multiquery_attention_cuda)

B, H, HKV, D, BLOCK, P, N = 3, 4, 2, 32, 4, 6, 24
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(kv, seed, T=None):
    """(q, k_pool, v_pool, k_scale, v_scale, tables, lens, starts) as
    numpy; ``starts``/``T`` only for the multi-query form."""
    rng = np.random.RandomState(seed)
    shape = (N, BLOCK, HKV, D)
    if kv == "int8":
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    tables = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P)
    tables = tables.astype(np.int32)
    if T is None:
        lens = rng.randint(1, P * BLOCK + 1, B).astype(np.int32)
        lens[0] = 1
        q = rng.randn(B, 1, H, D).astype(np.float32)
        return q, kp, vp, ks, vs, tables, lens, None
    starts = rng.randint(0, P * BLOCK - T + 1, B).astype(np.int32)
    starts[0] = 0
    valid = rng.randint(1, T + 1, B).astype(np.int32)
    valid[1] = T
    q = rng.randn(B, T, H, D).astype(np.float32)
    return q, kp, vp, ks, vs, tables, starts + valid, starts


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _jax_decode(route, q, kp, vp, ks, vs, tables, lens, monkeypatch):
    scale = 1.0 / np.sqrt(D)
    if route == "pallas":
        monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
        from paddle_tpu.ops.pallas.paged_attention import (
            paged_decode_attention_pallas)

        out = paged_decode_attention_pallas(
            _j(q[:, 0]), _j(kp), _j(vp), _j(tables), _j(lens), scale,
            k_scale=_j(ks), v_scale=_j(vs))[:, None]
    else:
        out = jax_pa._lax_fallback(_j(q), _j(kp), _j(vp), _j(tables),
                                   _j(lens), scale, k_scale=_j(ks),
                                   v_scale=_j(vs))
    return np.asarray(out, np.float32)


def _jax_mq(route, q, kp, vp, ks, vs, tables, lens, starts, monkeypatch):
    scale = 1.0 / np.sqrt(D)
    if route == "pallas":
        monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
        from paddle_tpu.ops.pallas.paged_attention import (
            paged_multiquery_attention_pallas)

        out = paged_multiquery_attention_pallas(
            _j(q), _j(kp), _j(vp), _j(tables), _j(lens), _j(starts), scale,
            k_scale=_j(ks), v_scale=_j(vs))
    else:
        out = jax_pa._lax_multiquery_fallback(
            _j(q), _j(kp), _j(vp), _j(tables), _j(lens), _j(starts), scale,
            k_scale=_j(ks), v_scale=_j(vs))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("route", ["pallas", "lax"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_decode_matches_jax(route, kv, monkeypatch):
    q, kp, vp, ks, vs, tables, lens, _ = _case(kv, seed=1)
    want = _jax_decode(route, q, kp, vp, ks, vs, tables, lens, monkeypatch)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                 _t(lens), k_scale=_t(ks), v_scale=_t(vs))
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("route", ["pallas", "lax"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("T", [1, 5, 8])
def test_multiquery_matches_jax(route, kv, T, monkeypatch):
    q, kp, vp, ks, vs, tables, lens, starts = _case(kv, seed=2 + T, T=T)
    want = _jax_mq(route, q, kp, vp, ks, vs, tables, lens, starts,
                   monkeypatch)
    got = paged_multiquery_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lens), _t(starts),
        k_scale=_t(ks), v_scale=_t(vs)).numpy()
    assert got.shape == q.shape
    for b in range(B):
        valid = lens[b] - starts[b]
        np.testing.assert_allclose(got[b, :valid], want[b, :valid], **TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_multiquery_t1_equals_decode(kv):
    q, kp, vp, ks, vs, tables, lens, _ = _case(kv, seed=9)
    dec = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                 _t(lens), k_scale=_t(ks), v_scale=_t(vs))
    mq = paged_multiquery_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lens), _t(lens - 1),
        k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(mq.numpy(), dec.numpy(), **TOL)


def test_quantize_rows_matches_jax():
    x = np.random.RandomState(4).randn(5, 3, HKV, D).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero row: scale floors at 1e-8, codes 0
    jc, js = jax_quantize(jnp.asarray(x))
    tc, ts = quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: a CPU tensor raises
    before anything is built or launched (no silent plain fallback)."""
    q, kp, vp, _, _, tables, lens, _ = _case("float32", seed=3)
    args = (_t(q[:, 0]), _t(kp), _t(vp), _t(tables), _t(lens))
    before = paged_decode_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_cuda(*args, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        paged_multiquery_attention_cuda(_t(q), *args[1:], _t(lens - 1), 0.1)
    assert paged_decode_attention_cuda.launches == before


# -- the tensor-core design of the multi-query kernel, emulated on the CPU --

CHIP_ATOL, CHIP_RTOL = 1e-4, 2.0 ** -8   # chip_smoke.py's bf16 tolerance
TC_TILE = 64                             # tokens per K/V tile of the kernel


def _bf16_case(kv, seed, *, b=2, t=80, h=4, hkv=2, d=128, block=16, p=12):
    """q [B, T, H, D] ~ N(0, 1) in bf16 and a pool as chip_smoke.py draws
    it (bf16 N(0, 1), or int8 codes with scales in [1e-3, 2.1e-2]), from a
    numpy seed; request 0 starts at 0 with padding rows, request 1 later."""
    rng = np.random.RandomState(seed)
    n = b * p + 1
    shape = (n, block, hkv, d)
    q = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).bfloat16()
    if kv == "int8":
        kp, vp = (torch.from_numpy(rng.randint(-127, 128, shape)
                                   .astype(np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy((rng.rand(*shape[:-1]) * 0.02 + 1e-3)
                                   .astype(np.float32)) for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                  .bfloat16() for _ in range(2))
        ks = vs = None
    tables = torch.from_numpy(rng.permutation(np.arange(1, n))[:b * p]
                              .reshape(b, p).astype(np.int32))
    starts = torch.tensor([0, 37], dtype=torch.int32)[:b]
    lens = starts + torch.tensor([t - 23, t], dtype=torch.int32)[:b]
    return q, kp, vp, ks, vs, tables, lens, starts


def _tensor_core_multiquery(q, kp, vp, ks, vs, tables, lens, starts, scale,
                            split=True):
    """The tensor-core body's arithmetic: per (request, kv head) and tile of
    64 tokens, S = q K (exact bf16 products, fp32 sums) times scale and
    k_scale; the online softmax in fp32; P with v_scale folded in, split
    into bf16 hi + lo (or rounded alone); O += hi V + lo V on the codes;
    O / l rounded to bf16. Padding rows are left at 0."""
    b, t, h, d = q.shape
    hkv = kp.shape[2]
    g = h // hkv
    out = torch.zeros(b, t, h, d)
    kg = _gather_codes(kp, tables).float()       # [B, S, Hkv, D]
    vg = _gather_codes(vp, tables).float()
    kscale = None if ks is None else _gather_codes(ks, tables)
    vscale = None if vs is None else _gather_codes(vs, tables)
    for bi in range(b):
        ctx, st = int(lens[bi]), int(starts[bi])
        for hk in range(hkv):
            qr = q[bi, :, hk * g:(hk + 1) * g].float().reshape(t * g, d)
            row_t = torch.arange(t * g) // g
            m = torch.full((t * g,), -1e30)
            l = torch.zeros(t * g)
            o = torch.zeros(t * g, d)
            for t0 in range(0, ctx, TC_TILE):
                tok = torch.arange(t0, min(t0 + TC_TILE, ctx))
                s = qr @ kg[bi, tok, hk].T * scale
                if kscale is not None:
                    s = s * kscale[bi, tok, hk]
                ok = tok[None, :] <= st + row_t[:, None]
                s = torch.where(ok, s, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.max(1).values)
                pr = torch.where(ok, torch.exp(s - m_new[:, None]),
                                 torch.tensor(0.0))
                corr = torch.exp(m - m_new)
                l = l * corr + pr.sum(1)
                m = m_new
                if vscale is not None:
                    pr = pr * vscale[bi, tok, hk]
                hi = pr.bfloat16().float()
                pv = hi @ vg[bi, tok, hk]
                if split:
                    pv = pv + (pr - hi).bfloat16().float() @ vg[bi, tok, hk]
                o = o * corr[:, None] + pv
            res = (o / torch.clamp(l, min=1e-30)[:, None]).reshape(t, g, d)
            out[bi, :, hk * g:(hk + 1) * g] = res
    return out.bfloat16()


def _gather_codes(pool, tables):
    """[B, P*block, ...] of the pool's rows (codes stay codes)."""
    b, p = tables.shape
    g = pool[tables.long()]
    return g.reshape(b, p * pool.shape[1], *pool.shape[2:])


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_tensor_core_multiquery_keeps_the_chip_tolerance(kv):
    """The split P (with v_scale folded in for int8 pools) keeps the
    kernel's arithmetic inside chip_smoke.py's tolerance against the fp32
    plain version on the valid rows; P rounded to bf16 alone does not."""
    from paddle_tpu_torch.inference.serving.paged_attention import (
        _torch_multiquery_fallback)

    q, kp, vp, ks, vs, tables, lens, starts = _bf16_case(kv, seed=11)
    scale = q.shape[-1] ** -0.5
    up = (kp, vp) if kv == "int8" else (kp.float(), vp.float())
    want = _torch_multiquery_fallback(q.float(), *up, tables, lens, starts,
                                      scale, k_scale=ks, v_scale=vs)
    excess = {}
    for split in (True, False):
        got = _tensor_core_multiquery(q, kp, vp, ks, vs, tables, lens,
                                      starts, scale, split=split)
        worst = -1.0
        for bi in range(q.shape[0]):
            n = int(lens[bi] - starts[bi])
            diff = (got[bi, :n].float() - want[bi, :n]).abs()
            worst = max(worst, float((diff - CHIP_ATOL - CHIP_RTOL
                                      * want[bi, :n].abs()).max()))
        excess[split] = worst
    assert excess[True] <= 0
    assert excess[False] > 0


@pytest.mark.parametrize("q_dtype,kv_dtype,t,d,want", [
    (torch.bfloat16, torch.bfloat16, 2048, 128, "tensor_core"),
    (torch.bfloat16, torch.int8, 16, 64, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 2, 32, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 1, 128, "decode"),      # decode step
    (torch.float32, torch.int8, 1, 64, "decode"),
    (torch.float32, torch.float32, 512, 128, "cuda_core"),
    (torch.float32, torch.int8, 512, 128, "cuda_core"),
    (torch.bfloat16, torch.float32, 512, 128, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 512, 96, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 512, 256, "cuda_core"),
])
def test_multiquery_route(q_dtype, kv_dtype, t, d, want):
    """The multi-query wrapper's body, from dtypes, T and head_dim alone."""
    from paddle_tpu_torch.ops.cuda.paged_attention import multiquery_route

    assert multiquery_route(q_dtype, kv_dtype, t, d) == want
