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
