"""Flash attention: the CUDA kernels of
``paddle_tpu_torch/csrc/flash_attention.cu``, their plain PyTorch versions,
and the ``torch.autograd.Function`` around them.

The port of ``paddle_tpu/ops/pallas/flash_attention.py`` (without rope):

* :func:`flash_attention_fwd_cuda` replaces ``_fwd_kernel`` (``_fwd``,
  ``pallas_call`` at :136);
* :func:`flash_attention_bwd_dq_cuda` replaces ``_bwd_dq_kernel`` (``_bwd``,
  ``pallas_call`` at :280);
* :func:`flash_attention_bwd_dkv_cuda` replaces ``_bwd_dkv_kernel``
  (``_bwd``, ``pallas_call`` at :296).

Kernels and plain versions work on ``[B*H, S, D]`` (bf16 or fp32; lse
``[B*H, S]`` fp32) and compute the same functions from the same residuals;
the plain versions materialise the full S x S scores in fp32. The
dispatchers (:func:`flash_attention_fwd` etc.) take the plain version only
for a tensor on the CPU; a CUDA tensor launches the kernel or raises.
:func:`flash_attention` is the array-level entry (``_flash_attention_arrays``)
on ``[B, S, H, D]``. Each CUDA wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import load

__all__ = ["flash_attention", "FlashAttentionFunction",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv",
           "flash_attention_fwd_plain", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv_plain",
           "flash_attention_fwd_cuda", "flash_attention_bwd_dq_cuda",
           "flash_attention_bwd_dkv_cuda",
           "reset_launch_counts", "launch_counts", "HEAD_DIMS", "NEG_INF"]

NEG_INF = -1e30
#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------

def _scores(q, k, scale, causal):
    """(s, visible): s = (q*scale) k^T in fp32 with masked scores at
    NEG_INF, and the visibility mask (None when not causal)."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if not causal:
        return s, None
    n = q.shape[-2]
    visible = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~visible, NEG_INF), visible


def _probs(q, k, lse, scale, causal):
    s, visible = _scores(q, k, scale, causal)
    p = torch.exp(s - lse[..., None])
    return p if visible is None else p.masked_fill(~visible, 0.0)


def flash_attention_fwd_plain(q, k, v, scale, causal):
    """(out, lse): out = softmax(s) v in q's dtype, lse = logsumexp(s) in
    fp32 (the kernel's m + log(max(l, 1e-30)))."""
    s, _ = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return out.to(q.dtype), lse


def _ds(q, k, v, out, lse, dout, scale, causal):
    """(p, dS) of the backward: delta = rowsum(dO * O) in fp32 from the
    stored O; dS = p (dO v^T - delta) scale."""
    p = _probs(q, k, lse, scale, causal)
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta) * scale


def flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, scale, causal):
    """dq = dS k, in q's dtype."""
    _, ds = _ds(q, k, v, out, lse, dout, scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, scale, causal):
    """(dk, dv) = (dS^T q, p^T dO), in k's and v's dtypes."""
    p, ds = _ds(q, k, v, out, lse, dout, scale, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = load("flash_attention")
    if not getattr(lib, "_fa_typed", False):
        lib.flash_attention_fwd_launch.argtypes = (
            [_P] * 5 + [_I] * 4 + [ctypes.c_float, _I, _P])
        lib.flash_attention_bwd_dq_launch.argtypes = (
            [_P] * 7 + [_I] * 4 + [ctypes.c_float, _I, _P])
        lib.flash_attention_bwd_dkv_launch.argtypes = (
            [_P] * 8 + [_I] * 4 + [ctypes.c_float, _I, _P])
        for fn in (lib.flash_attention_fwd_launch,
                   lib.flash_attention_bwd_dq_launch,
                   lib.flash_attention_bwd_dkv_launch):
            fn.restype = _I
        lib._fa_typed = True
    return lib


def _check(q, *others, lse=None):
    """Validate [BH, S, D] operands for the kernels; returns (BH, S, D)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, q is on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q has dtype {q.dtype}; the kernels take "
                        "float32 and bfloat16")
    if q.dim() != 3:
        raise ValueError(f"q must be [B*H, S, D], got {tuple(q.shape)}")
    bh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"B*H = {bh} exceeds the kernels' grid limit 65535")
    for name, t in (("q", q),) + tuple(others):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != (bh, s, d):
            raise ValueError(f"{name} {tuple(t.shape)} != q {(bh, s, d)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if lse is not None:
        if (lse.device != dev or lse.dtype != torch.float32
                or tuple(lse.shape) != (bh, s) or not lse.is_contiguous()):
            raise ValueError(f"lse must be contiguous float32 {(bh, s)} on "
                             f"{dev}, got {lse.dtype} {tuple(lse.shape)}")
    return bh, s, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def flash_attention_fwd_cuda(q, k, v, scale, causal):
    """Forward kernel: q, k, v [BH, S, D] -> (out [BH, S, D] in q's dtype,
    lse [BH, S] fp32)."""
    bh, s, d = _check(q, ("k", k), ("v", v))
    out = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, s, d, _DTYPE_CODE[q.dtype], float(scale),
        int(bool(causal)), _stream(q))
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


def flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, scale, causal):
    """dq kernel -> dq [BH, S, D] in q's dtype."""
    bh, s, d = _check(q, ("k", k), ("v", v), ("out", out), ("dout", dout),
                      lse=lse)
    dq = torch.empty_like(q)
    err = _lib().flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), bh, s, d,
        _DTYPE_CODE[q.dtype], float(scale), int(bool(causal)), _stream(q))
    _raise_on(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


def flash_attention_bwd_dkv_cuda(q, k, v, out, lse, dout, scale, causal):
    """dkv kernel -> (dk, dv) [BH, S, D] in k's dtype."""
    bh, s, d = _check(q, ("k", k), ("v", v), ("out", out), ("dout", dout),
                      lse=lse)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _lib().flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s,
        d, _DTYPE_CODE[q.dtype], float(scale), int(bool(causal)), _stream(q))
    _raise_on(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_fwd_cuda.launches = 0
flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches = 0
_WRAPPERS = (flash_attention_fwd_cuda, flash_attention_bwd_dq_cuda,
             flash_attention_bwd_dkv_cuda)


def reset_launch_counts():
    """Set every wrapper's ``launches`` to 0."""
    for w in _WRAPPERS:
        w.launches = 0


def launch_counts():
    """``{wrapper name: launches}``."""
    return {w.__name__: w.launches for w in _WRAPPERS}


# ---------------------------------------------------------------------------
# dispatch by device, the autograd Function and the array-level entry
# ---------------------------------------------------------------------------

def _on_cpu(t):
    return t.device.type == "cpu"


def flash_attention_fwd(q, k, v, scale, causal):
    """Forward on [BH, S, D]: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if _on_cpu(q):
        return flash_attention_fwd_plain(q, k, v, scale, causal)
    return flash_attention_fwd_cuda(q, k, v, scale, causal)


def flash_attention_bwd_dq(q, k, v, out, lse, dout, scale, causal):
    """dq on [BH, S, D], dispatched by device like the forward."""
    if _on_cpu(q):
        return flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, scale,
                                            causal)
    return flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, scale,
                                       causal)


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, scale, causal):
    """(dk, dv) on [BH, S, D], dispatched by device like the forward."""
    if _on_cpu(q):
        return flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, scale,
                                             causal)
    return flash_attention_bwd_dkv_cuda(q, k, v, out, lse, dout, scale,
                                        causal)


def _heads_first(x):
    """[B, S, H, D] -> contiguous [B*H, S, D] (a real copy, as the
    reference's swapaxes)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _heads_last(x, b, h):
    """[B*H, S, D] -> a [B, S, H, D] view."""
    return x.view(b, h, x.shape[1], x.shape[2]).transpose(1, 2)


class FlashAttentionFunction(torch.autograd.Function):
    """Self-attention on equal-head q, k, v [B, S, H, D] (the port of
    ``_flash_mha`` and its ``custom_vjp``). The forward saves exactly
    ``(q, k, v, out, lse)`` on [B*H, S, D]; the backward runs the dq kernel
    and then the dkv kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        b, _, h, _ = q.shape
        qt, kt, vt = _heads_first(q), _heads_first(k), _heads_first(v)
        out, lse = flash_attention_fwd(qt, kt, vt, scale, causal)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.scale, ctx.causal, ctx.bh = scale, causal, (b, h)
        return _heads_last(out, b, h)

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, out, lse = ctx.saved_tensors
        b, h = ctx.bh
        dot = _heads_first(dout)
        dq = flash_attention_bwd_dq(qt, kt, vt, out, lse, dot, ctx.scale,
                                    ctx.causal)
        dk, dv = flash_attention_bwd_dkv(qt, kt, vt, out, lse, dot,
                                         ctx.scale, ctx.causal)
        return (_heads_last(dq, b, h), _heads_last(dk, b, h),
                _heads_last(dv, b, h), None, None)


def flash_attention(q, k, v, causal=True, scale=None):
    """q [B, S, H, D], k/v [B, S, Hkv, D] -> [B, S, H, D] (the port of
    ``_flash_attention_arrays``). GQA repeats the kv heads first
    (``repeat_interleave``, ``jnp.repeat``'s mapping), so autograd sums
    each group's dK/dV. The default scale is 1/sqrt(D)."""
    h, hk = q.shape[2], k.shape[2]
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, float(s), bool(causal))
