"""ctypes wrappers of the paged-attention CUDA kernels
(``paddle_tpu_torch/csrc/paged_attention.cu``).

* :func:`paged_decode_attention_cuda` replaces the Pallas ``_kernel``
  (``paddle_tpu/ops/pallas/paged_attention.py``, ``pallas_call`` at :157);
* :func:`paged_multiquery_attention_cuda` replaces ``_mq_kernel``
  (``pallas_call`` at :278).

The decode kernel is bound by the K/V bytes it streams on an H100 (3.35
TB/s): each block reads every visible K/V row of its (request, kv head)
once; a long prefill chunk is bound by operations. The multi-query wrapper
takes one of two bodies, chosen by :func:`multiquery_route` from q's and
the pool's dtypes, T and head_dim alone (never on a failure): bf16 q over
a bf16 or int8 pool with T > 1 and head_dim in ``TC_HEAD_DIMS`` takes the
tensor-core body (``mma.sync``, P split into bf16 hi + lo); every other
call, T = 1 included, the decode kernel's CUDA-core body. Both count in
``paged_multiquery_attention_cuda.launches``. Each
wrapper checks device, dtype, contiguity, alignment and shapes and raises
on anything the kernel does not take, allocates the output with
``torch.empty``, launches on the current stream and raises if the launch
was refused. ``launches`` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load

__all__ = ["paged_decode_attention_cuda", "paged_multiquery_attention_cuda",
           "multiquery_route", "multiquery_tc_smem_bytes",
           "reset_launch_counts", "launch_counts", "MAX_ROWS",
           "TC_HEAD_DIMS"]

#: query rows (query tile x GQA group) one block holds; at head_dim 256
#: that is 206 KB of shared memory, inside Hopper's 227 KB per block
MAX_ROWS = 64
#: head dims the multi-query tensor-core body is built for
TC_HEAD_DIMS = (32, 64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("paged_attention")
    if not getattr(lib, "_pa_typed", False):
        lib.paged_decode_attention_launch.argtypes = (
            [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P])
        lib.paged_decode_attention_launch.restype = _I
        lib.paged_multiquery_attention_launch.argtypes = (
            [_P] * 9 + [_I] * 11 + [ctypes.c_float, _P])
        lib.paged_multiquery_attention_launch.restype = _I
        lib.paged_multiquery_tc_smem_bytes.argtypes = [_I, _I]
        lib.paged_multiquery_tc_smem_bytes.restype = ctypes.c_long
        lib._pa_typed = True
    return lib


def _check(name, t, dtypes, ndim, device, aligned=False):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _common(q, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale,
            q_ndim):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, q is on {dev}")
    _check("q", q, (torch.float32, torch.bfloat16), q_ndim, dev, True)
    _check("k_pool", k_pool, (torch.float32, torch.bfloat16, torch.int8), 4,
           dev, True)
    _check("v_pool", v_pool, (k_pool.dtype,), 4, dev, True)
    _check("block_tables", block_tables, (torch.int32,), 2, dev)
    _check("context_lens", context_lens, (torch.int32,), 1, dev)
    n, block_size, hkv, d = k_pool.shape
    h = q.shape[-2]
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if q.shape[-1] != d:
        raise ValueError(f"q head_dim {q.shape[-1]} != pool head_dim {d}")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d} must be a multiple of 8 and <= 256")
    if h % hkv:
        raise ValueError(f"{h} query heads do not divide over {hkv} kv heads")
    if h // hkv > MAX_ROWS:
        raise ValueError(f"GQA group {h // hkv} exceeds {MAX_ROWS}")
    b = q.shape[0]
    if block_tables.shape[0] != b or context_lens.shape[0] != b:
        raise ValueError("block_tables/context_lens batch must match q")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8 pools need k_scale and v_scale; float pools "
                         "take neither")
    if quantized:
        for nm, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(nm, s, (torch.float32,), 3, dev)
            if tuple(s.shape) != (n, block_size, hkv):
                raise ValueError(f"{nm} {tuple(s.shape)} != "
                                 f"{(n, block_size, hkv)}")
    return b, h, hkv, d, block_size, block_tables.shape[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables,
                                context_lens, scale, k_scale=None,
                                v_scale=None):
    """q [B, H, D]; pools [N, block, Hkv, D] (f32/bf16, or int8 with
    ``k_scale``/``v_scale`` [N, block, Hkv] f32); block_tables [B, P]
    int32; context_lens [B] int32. Returns [B, H, D] in q's dtype."""
    b, h, hkv, d, bs, p = _common(q, k_pool, v_pool, block_tables,
                                  context_lens, k_scale, v_scale, 3)
    out = torch.empty_like(q)
    err = _lib().paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), b, h, hkv, d, bs, p, _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pool.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_decode_attention")
    paged_decode_attention_cuda.launches += 1
    return out


def multiquery_route(q_dtype, kv_dtype, t, head_dim):
    """The multi-query body a call takes: ``"tensor_core"`` for bf16 q
    over a bf16 or int8 pool with ``t`` > 1 query rows and ``head_dim`` in
    ``TC_HEAD_DIMS``, else ``"cuda_core"`` (the decode kernel's body)."""
    if (q_dtype == torch.bfloat16 and t > 1 and head_dim in TC_HEAD_DIMS
            and kv_dtype in (torch.bfloat16, torch.int8)):
        return "tensor_core"
    return "cuda_core"


def multiquery_tc_smem_bytes(head_dim, kv_dtype):
    """Dynamic shared memory of one block of the tensor-core body."""
    return _lib().paged_multiquery_tc_smem_bytes(head_dim,
                                                  _DTYPE_CODE[kv_dtype])


def _query_tile(t, groups):
    return max(1, min(t, MAX_ROWS // groups))


def paged_multiquery_attention_cuda(q, k_pool, v_pool, block_tables,
                                    context_lens, q_start, scale,
                                    k_scale=None, v_scale=None):
    """q [B, T, H, D] at positions ``q_start[b] + t`` (q_start [B]
    int32); the rest as :func:`paged_decode_attention_cuda`. Returns
    [B, T, H, D]; rows that see no token are 0. Padding rows (past
    ``context_lens - q_start``) are unspecified: the CUDA-core body gives
    0, the tensor-core body 0 in a tile of 64 rows that holds only padding
    and an attention over the whole context otherwise."""
    b, h, hkv, d, bs, p = _common(q, k_pool, v_pool, block_tables,
                                  context_lens, k_scale, v_scale, 4)
    _check("q_start", q_start, (torch.int32,), 1, q.device)
    if q_start.shape[0] != b:
        raise ValueError("q_start batch must match q")
    t = q.shape[1]
    tq = _query_tile(t, h // hkv)
    tensor_core = multiquery_route(q.dtype, k_pool.dtype, t,
                                   d) == "tensor_core"
    out = torch.empty_like(q)
    err = _lib().paged_multiquery_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), context_lens.data_ptr(),
        q_start.data_ptr(), out.data_ptr(), b, t, h, hkv, d, bs, p, tq,
        int(tensor_core), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_multiquery_attention")
    paged_multiquery_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
paged_multiquery_attention_cuda.launches = 0
_WRAPPERS = (paged_decode_attention_cuda, paged_multiquery_attention_cuda)


def reset_launch_counts():
    """Set every wrapper's ``launches`` to 0."""
    for w in _WRAPPERS:
        w.launches = 0


def launch_counts():
    """``{wrapper name: launches}``."""
    return {w.__name__: w.launches for w in _WRAPPERS}
