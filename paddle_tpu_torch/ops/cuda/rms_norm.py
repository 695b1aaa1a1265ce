"""Fused residual add + RMSNorm: the CUDA kernel of
``paddle_tpu_torch/csrc/rms_norm.cu``, its plain PyTorch version, and the
``torch.autograd.Function`` around it.

The port of the RMSNorm half of ``paddle_tpu/ops/pallas/rms_norm.py``:
:func:`fused_add_rms_norm_cuda` replaces ``_fwd_kernel`` (``_fwd``,
``pallas_call`` at :66). Both compute, on rows of x and y [rows, h] and a
weight [h]::

    resid = round(x + y)                 (fp32 sum, rounded to x's dtype)
    out   = resid * rsqrt(mean(resid^2) + eps) * w     (fp32, then rounded)

and return ``(out, resid)``; the norm reads the rounded residual, as the
unfused composition does. The backward is the reference's ``_fused_bwd``
in plain PyTorch (fp32; dx = dy, dw summed over rows). The wrapper takes
the plain version for a CPU tensor and launches the kernel for a CUDA
tensor (or raises), and counts its launches in
``fused_add_rms_norm_cuda.launches``. :func:`use_fused_rms_norm`
(``PT_FUSED_NORM=1``, read at call time, default off) is the model's
switch. The LayerNorm half (``_ln_fwd_kernel``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ._build import load

__all__ = ["fused_add_rms_norm", "FusedAddRMSNormFunction",
           "fused_add_rms_norm_plain", "fused_add_rms_norm_cuda",
           "use_fused_rms_norm", "reset_launch_counts", "launch_counts"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def use_fused_rms_norm():
    """``PT_FUSED_NORM=1`` routes the decoder's post-attention norm here."""
    return os.environ.get("PT_FUSED_NORM", "0") == "1"


def fused_add_rms_norm_plain(x, y, w, eps):
    """The kernel's function in plain PyTorch on [rows, h] -> (out, resid)
    in x's dtype."""
    r = (x.float() + y.float()).to(x.dtype)
    rf = r.float()
    inv = torch.rsqrt(rf.square().mean(dim=-1, keepdim=True) + eps)
    return (rf * inv * w.float()).to(x.dtype), r


def _lib():
    lib = load("rms_norm")
    if not getattr(lib, "_rms_typed", False):
        lib.fused_add_rms_norm_launch.argtypes = (
            [_P] * 5 + [_I] * 3 + [ctypes.c_float, _P])
        lib.fused_add_rms_norm_launch.restype = _I
        lib._rms_typed = True
    return lib


def fused_add_rms_norm_cuda(x, y, w, eps):
    """The kernel on x, y [rows, h] and w [h] -> (out, resid) [rows, h]
    in x's dtype."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, x is on {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        "and bfloat16")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, h], got {tuple(x.shape)}")
    rows, h = x.shape
    for name, t, shape in (("x", x, (rows, h)), ("y", y, (rows, h)),
                           ("w", w, (h,))):
        if t.device != dev or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if rows * h >= 2 ** 31:
        raise ValueError(f"{rows} x {h} exceeds the kernel's 32-bit indexing")
    out = torch.empty_like(x)
    resid = torch.empty_like(x)
    err = _lib().fused_add_rms_norm_launch(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(),
        resid.data_ptr(), rows, h, _DTYPE_CODE[x.dtype], float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_add_rms_norm kernel launch failed: cudaError {err}")
    fused_add_rms_norm_cuda.launches += 1
    return out, resid


fused_add_rms_norm_cuda.launches = 0


def reset_launch_counts():
    fused_add_rms_norm_cuda.launches = 0


def launch_counts():
    return {"fused_add_rms_norm_cuda": fused_add_rms_norm_cuda.launches}


class FusedAddRMSNormFunction(torch.autograd.Function):
    """The port of ``_fused_add_rms_norm``'s ``custom_vjp`` on [rows, h]:
    saves the rounded residual and the weight; the backward recomputes
    rsqrt from them in fp32."""

    @staticmethod
    def forward(ctx, x, y, w, eps):
        if x.device.type == "cpu":
            out, r = fused_add_rms_norm_plain(x, y, w, eps)
        else:
            out, r = fused_add_rms_norm_cuda(x, y, w, eps)
        ctx.save_for_backward(r, w)
        ctx.eps = eps
        return out, r

    @staticmethod
    def backward(ctx, d_out, d_r):
        r, w = ctx.saved_tensors
        rf = r.float()
        dof = d_out.float()
        g = dof * w.float()
        inv = torch.rsqrt(rf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        dr = inv * g - rf * inv ** 3 * (g * rf).mean(dim=-1, keepdim=True)
        dr = dr + d_r.float()
        dw = (dof * rf * inv).sum(dim=0)
        dx = dr.to(r.dtype)
        return dx, dx, dw.to(w.dtype), None


def fused_add_rms_norm(x, y, weight, epsilon=1e-6):
    """``(normed, resid) = RMSNorm(x + y)`` over the last axis of x, y
    [..., h] with weight [h] (the reference's ``_fused_add_rms_norm_nd``)."""
    h = x.shape[-1]
    lead = x.shape[:-1]
    out, r = FusedAddRMSNormFunction.apply(
        x.reshape(-1, h).contiguous(), y.reshape(-1, h).contiguous(),
        weight.reshape(h).contiguous(), float(epsilon))
    return out.reshape(*lead, h), r.reshape(*lead, h)
