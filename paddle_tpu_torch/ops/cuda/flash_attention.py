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
the plain versions materialise the full S x S scores in fp32. Each
kernel entry is a ``torch.library`` op (:mod:`.library`; for example
``paddle_tpu_torch::flash_attention_fwd``) whose CUDA implementation is
the wrapper and whose CPU implementation is the plain version; the
dispatchers (:func:`flash_attention_fwd` etc.) call the op while a graph
is traced and its implementation directly when eager, so a CPU tensor
takes the plain version and a CUDA tensor launches the kernel or raises,
eagerly and inside a compiled or exported graph alike.
:func:`flash_attention` is the array-level entry (``_flash_attention_arrays``)
on ``[B, S, H, D]``. Each CUDA wrapper counts its launches in ``launches``.

Each of the three kernels has two bodies, chosen in Python by
:func:`flash_route` from the dtype alone: bf16 takes the tensor-core body
(bf16 tiles, ``mma.sync`` with fp32 sums, P, and in the backward dS,
split into bf16 hi + lo), fp32 the CUDA-core body (fp32 products, which
the card-vs-CPU training checks at 1e-5 rely on). A wrapper counts both
bodies in its one counter.

The rope variant (``_flash_mha_rope``, :348) is the same three kernels
built with rope inside (``flash_attention_rope_*_cuda``): q and k arrive
*before* the rotary embedding, with the tables widened to fp32 [S, D]
(:func:`widen_tables`, the reference's ``_widen_tables``). Each kernel
rotates every q and k tile it stages in fp32 (``x c + [-x2, x1] s``; q is
scaled after the rotation) and dq and dk are rotated back with the sin
negated. Its autograd Function saves the pre-rotary q and k.
:func:`flash_attention_rope` is the array-level entry
(``_flash_attention_rope_arrays``).

:func:`attention_block_bhsd` (``_attention_block_bhsd``, the reference's
``PT_ATTN_EINSUM=1`` block) runs the kernels without rope on the
head-major projections through :class:`FlashAttentionBHSDFunction`, the
[B*H, S, D] core it shares with :class:`FlashAttentionFunction`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...amp.amp_lists import maybe_cast
from ._build import load
from .library import define

__all__ = ["flash_attention", "FlashAttentionFunction",
           "FlashAttentionBHSDFunction", "attention_block_bhsd",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv",
           "flash_attention_fwd_plain", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv_plain",
           "flash_attention_fwd_cuda", "flash_attention_bwd_dq_cuda",
           "flash_attention_bwd_dkv_cuda",
           "flash_attention_rope", "FlashAttentionRopeFunction",
           "widen_tables", "rope_rotate",
           "flash_attention_rope_fwd_plain",
           "flash_attention_rope_bwd_dq_plain",
           "flash_attention_rope_bwd_dkv_plain",
           "flash_attention_rope_fwd_cuda", "flash_attention_rope_bwd_dq_cuda",
           "flash_attention_rope_bwd_dkv_cuda",
           "flash_route", "tc_smem_bytes",
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


def widen_tables(cos, sin):
    """[S, D/2] rope tables -> contiguous fp32 [S, D] (both halves)."""
    return (torch.cat([cos, cos], dim=-1).float().contiguous(),
            torch.cat([sin, sin], dim=-1).float().contiguous())


def rope_rotate(x, c2, s2):
    """x c2 + [-x2, x1] s2 in fp32 on x [..., S, D] with widened tables
    [S, D]; with -s2 it is the inverse rotation."""
    xf = x.float()
    d2 = xf.shape[-1] // 2
    return xf * c2 + torch.cat([-xf[..., d2:], xf[..., :d2]], dim=-1) * s2


def flash_attention_rope_fwd_plain(q, k, v, c2, s2, scale, causal):
    """(out, lse) of the rope kernel: q and k rotated in fp32, then the
    forward above; out in q's dtype."""
    out, lse = flash_attention_fwd_plain(
        rope_rotate(q, c2, s2), rope_rotate(k, c2, s2), v, scale, causal)
    return out.to(q.dtype), lse


def flash_attention_rope_bwd_dq_plain(q, k, v, out, lse, dout, c2, s2,
                                      scale, causal):
    """dq of the rope kernel: dS k_rot, rotated back (sin negated)."""
    kr = rope_rotate(k, c2, s2)
    _, ds = _ds(rope_rotate(q, c2, s2), kr, v, out, lse, dout, scale,
                causal)
    return rope_rotate(torch.matmul(ds, kr), c2, -s2).to(q.dtype)


def flash_attention_rope_bwd_dkv_plain(q, k, v, out, lse, dout, c2, s2,
                                       scale, causal):
    """(dk, dv) of the rope kernel: dk = dS^T q_rot rotated back, dv as
    without rope."""
    qr = rope_rotate(q, c2, s2)
    p, ds = _ds(qr, rope_rotate(k, c2, s2), v, out, lse, dout, scale,
                causal)
    dk = rope_rotate(torch.matmul(ds.transpose(-1, -2), qr), c2, -s2)
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def flash_route(dtype, head_dim):
    """The body the three kernels (forward, dq, dk/dv, with or without
    rope) take: ``"tensor_core"`` for bf16, ``"cuda_core"`` for fp32, at
    every head_dim in ``HEAD_DIMS``; anything else has no body and
    raises."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one of {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"dtype {dtype}: the kernels take float32 and bfloat16")


def _lib():
    lib = load("flash_attention")
    if not getattr(lib, "_fa_typed", False):
        # ... BH, S, D, dtype, scale, causal, tensor_core, stream
        tail = [_I] * 4 + [ctypes.c_float, _I, _I, _P]
        for name, n_ptr in (("fwd", 5), ("bwd_dq", 7), ("bwd_dkv", 8)):
            fn = getattr(lib, f"flash_attention_{name}_launch")
            fn.argtypes = [_P] * n_ptr + tail
            fn.restype = _I
            fn = getattr(lib, f"flash_attention_rope_{name}_launch")
            fn.argtypes = [_P] * (n_ptr + 2) + tail
            fn.restype = _I
        lib.flash_attention_tc_smem_bytes.argtypes = [_I, _I, _I]
        lib.flash_attention_tc_smem_bytes.restype = ctypes.c_long
        lib._fa_typed = True
    return lib


def tc_smem_bytes(which, head_dim, rope):
    """Dynamic shared memory of one block of a tensor-core body
    (``which``: "fwd", "dq" or "dkv")."""
    return _lib().flash_attention_tc_smem_bytes(
        {"fwd": 0, "dq": 1, "dkv": 2}[which], head_dim, int(bool(rope)))


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


def _check_tables(q, c2, s2):
    """The widened rope tables: contiguous fp32 [S, D] on q's device."""
    _, s, d = q.shape
    for name, t in (("cos", c2), ("sin", s2)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (s, d) or not t.is_contiguous()):
            raise ValueError(f"{name} table must be contiguous float32 "
                             f"{(s, d)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _launch(name, q, ptrs, tables, scale, causal):
    """Call ``flash_attention[_rope]_<name>_launch`` on the pointers of
    ``ptrs`` (then the tables' with rope) and raise on a failed launch;
    the kernel takes the body :func:`flash_route` names."""
    bh, s, d = q.shape
    tensor_core = int(flash_route(q.dtype, d) == "tensor_core")
    if tables is not None:
        _check_tables(q, *tables)
        ptrs = ptrs + [t.data_ptr() for t in tables]
        name = "rope_" + name
    fn = getattr(_lib(), f"flash_attention_{name}_launch")
    err = fn(*ptrs, bh, s, d, _DTYPE_CODE[q.dtype], float(scale),
             int(bool(causal)), tensor_core, _stream(q))
    _raise_on(err, f"flash_attention_{name}")


def _fwd_cuda(q, k, v, scale, causal, tables=None):
    bh, s, _ = _check(q, ("k", k), ("v", v))
    out = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _launch("fwd", q, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr()], tables, scale,
            causal)
    return out, lse


def _bwd_dq_cuda(q, k, v, out, lse, dout, scale, causal, tables=None):
    _check(q, ("k", k), ("v", v), ("out", out), ("dout", dout), lse=lse)
    dq = torch.empty_like(q)
    _launch("bwd_dq", q, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                          dq.data_ptr()], tables, scale, causal)
    return dq


def _bwd_dkv_cuda(q, k, v, out, lse, dout, scale, causal, tables=None):
    _check(q, ("k", k), ("v", v), ("out", out), ("dout", dout), lse=lse)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("bwd_dkv", q, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                           dk.data_ptr(), dv.data_ptr()], tables, scale,
            causal)
    return dk, dv


def flash_attention_fwd_cuda(q, k, v, scale, causal):
    """Forward kernel: q, k, v [BH, S, D] -> (out [BH, S, D] in q's dtype,
    lse [BH, S] fp32)."""
    res = _fwd_cuda(q, k, v, scale, causal)
    flash_attention_fwd_cuda.launches += 1
    return res


def flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, scale, causal):
    """dq kernel -> dq [BH, S, D] in q's dtype."""
    res = _bwd_dq_cuda(q, k, v, out, lse, dout, scale, causal)
    flash_attention_bwd_dq_cuda.launches += 1
    return res


def flash_attention_bwd_dkv_cuda(q, k, v, out, lse, dout, scale, causal):
    """dkv kernel -> (dk, dv) [BH, S, D] in k's dtype."""
    res = _bwd_dkv_cuda(q, k, v, out, lse, dout, scale, causal)
    flash_attention_bwd_dkv_cuda.launches += 1
    return res


def flash_attention_rope_fwd_cuda(q, k, v, c2, s2, scale, causal):
    """Rope forward kernel: pre-rotary q, k, v [BH, S, D] and widened
    tables c2/s2 [S, D] fp32 -> (out, lse)."""
    res = _fwd_cuda(q, k, v, scale, causal, (c2, s2))
    flash_attention_rope_fwd_cuda.launches += 1
    return res


def flash_attention_rope_bwd_dq_cuda(q, k, v, out, lse, dout, c2, s2, scale,
                                     causal):
    """Rope dq kernel (pre-rotary q, k) -> dq with respect to pre-rotary q."""
    res = _bwd_dq_cuda(q, k, v, out, lse, dout, scale, causal, (c2, s2))
    flash_attention_rope_bwd_dq_cuda.launches += 1
    return res


def flash_attention_rope_bwd_dkv_cuda(q, k, v, out, lse, dout, c2, s2, scale,
                                      causal):
    """Rope dkv kernel -> (dk with respect to pre-rotary k, dv)."""
    res = _bwd_dkv_cuda(q, k, v, out, lse, dout, scale, causal, (c2, s2))
    flash_attention_rope_bwd_dkv_cuda.launches += 1
    return res


_WRAPPERS = (flash_attention_fwd_cuda, flash_attention_bwd_dq_cuda,
             flash_attention_bwd_dkv_cuda, flash_attention_rope_fwd_cuda,
             flash_attention_rope_bwd_dq_cuda,
             flash_attention_rope_bwd_dkv_cuda)
for _w in _WRAPPERS:
    _w.launches = 0


def reset_launch_counts():
    """Set every wrapper's ``launches`` to 0."""
    for w in _WRAPPERS:
        w.launches = 0


def launch_counts():
    """``{wrapper name: launches}``."""
    return {w.__name__: w.launches for w in _WRAPPERS}


# ---------------------------------------------------------------------------
# the kernels as torch.library ops, dispatch by device, the autograd
# Functions and the array-level entry
# ---------------------------------------------------------------------------

def _fwd_fake(q, k, v, *rest):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _dq_fake(q, *rest):
    return q.new_empty(q.shape)


def _dkv_fake(q, k, v, *rest):
    return k.new_empty(k.shape), v.new_empty(v.shape)


_QKV = "Tensor q, Tensor k, Tensor v"
_BWD = f"{_QKV}, Tensor out, Tensor lse, Tensor dout"
_TAIL = "float scale, bool causal"
_TABLES = "Tensor c2, Tensor s2"
_fwd_op = define("flash_attention_fwd",
                 f"({_QKV}, {_TAIL}) -> (Tensor, Tensor)",
                 flash_attention_fwd_cuda, flash_attention_fwd_plain,
                 _fwd_fake)
_dq_op = define("flash_attention_bwd_dq", f"({_BWD}, {_TAIL}) -> Tensor",
                flash_attention_bwd_dq_cuda, flash_attention_bwd_dq_plain,
                _dq_fake)
_dkv_op = define("flash_attention_bwd_dkv",
                 f"({_BWD}, {_TAIL}) -> (Tensor, Tensor)",
                 flash_attention_bwd_dkv_cuda, flash_attention_bwd_dkv_plain,
                 _dkv_fake)
_rope_fwd_op = define(
    "flash_attention_rope_fwd",
    f"({_QKV}, {_TABLES}, {_TAIL}) -> (Tensor, Tensor)",
    flash_attention_rope_fwd_cuda, flash_attention_rope_fwd_plain, _fwd_fake)
_rope_dq_op = define(
    "flash_attention_rope_bwd_dq", f"({_BWD}, {_TABLES}, {_TAIL}) -> Tensor",
    flash_attention_rope_bwd_dq_cuda, flash_attention_rope_bwd_dq_plain,
    _dq_fake)
_rope_dkv_op = define(
    "flash_attention_rope_bwd_dkv",
    f"({_BWD}, {_TABLES}, {_TAIL}) -> (Tensor, Tensor)",
    flash_attention_rope_bwd_dkv_cuda, flash_attention_rope_bwd_dkv_plain,
    _dkv_fake)


def flash_attention_fwd(q, k, v, scale, causal):
    """Forward on [BH, S, D] through its op: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    return _fwd_op(q, k, v, float(scale), bool(causal))


def flash_attention_bwd_dq(q, k, v, out, lse, dout, scale, causal):
    """dq on [BH, S, D] through its op, dispatched by device like the
    forward."""
    return _dq_op(q, k, v, out, lse, dout, float(scale), bool(causal))


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, scale, causal):
    """(dk, dv) on [BH, S, D] through its op, dispatched by device like the
    forward."""
    return _dkv_op(q, k, v, out, lse, dout, float(scale), bool(causal))


def _heads_first(x):
    """[B, S, H, D] -> contiguous [B*H, S, D] (a real copy, as the
    reference's swapaxes)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _heads_last(x, b, h):
    """[B*H, S, D] -> a [B, S, H, D] view."""
    return x.view(b, h, x.shape[1], x.shape[2]).transpose(1, 2)


def _core_forward(ctx, qt, kt, vt, scale, causal):
    """The forward both autograd Functions share: the kernel (or its plain
    version) on [B*H, S, D]; saves exactly ``(q, k, v, out, lse)``."""
    out, lse = flash_attention_fwd(qt, kt, vt, scale, causal)
    ctx.save_for_backward(qt, kt, vt, out, lse)
    ctx.scale, ctx.causal = scale, causal
    return out


def _core_backward(ctx, dot):
    """(dq, dk, dv) on [B*H, S, D] from a contiguous ``dot``: the dq kernel,
    then the dkv kernel."""
    qt, kt, vt, out, lse = ctx.saved_tensors
    dq = flash_attention_bwd_dq(qt, kt, vt, out, lse, dot, ctx.scale,
                                ctx.causal)
    dk, dv = flash_attention_bwd_dkv(qt, kt, vt, out, lse, dot, ctx.scale,
                                     ctx.causal)
    return dq, dk, dv


class FlashAttentionBHSDFunction(torch.autograd.Function):
    """Self-attention on contiguous q, k, v [B*H, S, D], with no layout
    copy of its own (the core of :func:`attention_block_bhsd`); the
    incoming gradient is made contiguous, a no-op when it already is."""

    @staticmethod
    def forward(ctx, qt, kt, vt, scale, causal):
        return _core_forward(ctx, qt, kt, vt, scale, causal)

    @staticmethod
    def backward(ctx, dout):
        return (*_core_backward(ctx, dout.contiguous()), None, None)


class FlashAttentionFunction(torch.autograd.Function):
    """Self-attention on equal-head q, k, v [B, S, H, D] (the port of
    ``_flash_mha`` and its ``custom_vjp``): the core above between copies
    to [B*H, S, D] and views back."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        b, _, h, _ = q.shape
        ctx.bh = (b, h)
        out = _core_forward(ctx, _heads_first(q), _heads_first(k),
                            _heads_first(v), scale, causal)
        return _heads_last(out, b, h)

    @staticmethod
    def backward(ctx, dout):
        b, h = ctx.bh
        grads = _core_backward(ctx, _heads_first(dout))
        return (*(_heads_last(g, b, h) for g in grads), None, None)


def flash_attention(q, k, v, causal=True, scale=None):
    """q [B, S, H, D], k/v [B, S, Hkv, D] -> [B, S, H, D] (the port of
    ``_flash_attention_arrays``). GQA repeats the kv heads first
    (``repeat_interleave``, ``jnp.repeat``'s mapping), so autograd sums
    each group's dK/dV. The default scale is 1/sqrt(D).

    The kernels take q, k and v in one dtype (the CUDA wrappers raise
    ``ValueError`` on two). Under AMP this entry is the reference's
    ``flash_attention_pallas``, a white op: q, k and v arrive in the AMP
    dtype, so O1 and O2 hand the kernels one dtype and bf16 takes the
    tensor-core bodies (:func:`flash_route`)."""
    q, k, v = maybe_cast("flash_attention_pallas", (q, k, v))
    h, hk = q.shape[2], k.shape[2]
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, float(s), bool(causal))


def flash_attention_rope_fwd(q, k, v, c2, s2, scale, causal):
    """Rope forward on [BH, S, D] through its op, dispatched by device."""
    return _rope_fwd_op(q, k, v, c2, s2, float(scale), bool(causal))


def flash_attention_rope_bwd_dq(q, k, v, out, lse, dout, c2, s2, scale,
                                causal):
    """Rope dq on [BH, S, D] through its op, dispatched by device."""
    return _rope_dq_op(q, k, v, out, lse, dout, c2, s2, float(scale),
                       bool(causal))


def flash_attention_rope_bwd_dkv(q, k, v, out, lse, dout, c2, s2, scale,
                                 causal):
    """Rope (dk, dv) on [BH, S, D] through its op, dispatched by device."""
    return _rope_dkv_op(q, k, v, out, lse, dout, c2, s2, float(scale),
                        bool(causal))


class FlashAttentionRopeFunction(torch.autograd.Function):
    """Rope-fused self-attention on pre-rotary q, k and v [B, S, H, D]
    with widened tables c2/s2 [S, D] (the port of ``_flash_mha_rope`` and
    its ``custom_vjp``). The forward saves the *pre-rotary* q and k with
    v, out, lse and the tables; the tables get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, c2, s2, scale, causal):
        b, _, h, _ = q.shape
        qt, kt, vt = _heads_first(q), _heads_first(k), _heads_first(v)
        out, lse = flash_attention_rope_fwd(qt, kt, vt, c2, s2, scale, causal)
        ctx.save_for_backward(qt, kt, vt, out, lse, c2, s2)
        ctx.scale, ctx.causal, ctx.bh = scale, causal, (b, h)
        return _heads_last(out, b, h)

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, out, lse, c2, s2 = ctx.saved_tensors
        b, h = ctx.bh
        dot = _heads_first(dout)
        res = (qt, kt, vt, out, lse, dot, c2, s2, ctx.scale, ctx.causal)
        dq = flash_attention_rope_bwd_dq(*res)
        dk, dv = flash_attention_rope_bwd_dkv(*res)
        return (_heads_last(dq, b, h), _heads_last(dk, b, h),
                _heads_last(dv, b, h), None, None, None, None)


def flash_attention_rope(q, k, v, cos, sin, causal=True, scale=None):
    """Pre-rotary q [B, S, H, D], k/v [B, S, Hkv, D] and rope tables
    cos/sin [S, D/2] -> [B, S, H, D] (the port of
    ``_flash_attention_rope_arrays``). GQA repeats the kv heads first, as
    :func:`flash_attention` does; the default scale is 1/sqrt(D)."""
    h, hk = q.shape[2], k.shape[2]
    if h != hk:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    c2, s2 = widen_tables(cos, sin)
    return FlashAttentionRopeFunction.apply(q, k, v, c2, s2, float(s),
                                            bool(causal))


def attention_block_bhsd(x, wq, wk, wv, wo, cos, sin, num_heads,
                         num_kv_heads, causal=True):
    """The whole attention block in head-major layout (the port of
    ``_attention_block_bhsd``): x [B, S, K]; wq [K, H*D], wk/wv
    [K, Hkv*D], wo [H*D, K] (``Linear.weight`` layout); cos/sin [S, D/2]
    -> [B, S, K]. The projections produce [B, H, S, D] by einsum, rope
    rotates q and k in fp32 in that layout (cast back to their dtype), GQA
    repeats the kv heads, the flash kernels (their plain versions on the
    CPU) take a [B*H, S, D] view through :class:`FlashAttentionBHSDFunction`,
    and the output projection contracts [B, H, S, D] back to [B, S, K].
    ``reshape`` copies where the einsum's result is not laid out head-major
    (torch.einsum returns a permuted view of one GEMM)."""
    b, s, kdim = x.shape
    h, hk = num_heads, num_kv_heads
    d = wq.shape[1] // h
    q = torch.einsum("bsk,khd->bhsd", x, wq.view(kdim, h, d))
    k = torch.einsum("bsk,khd->bhsd", x, wk.view(kdim, hk, d))
    v = torch.einsum("bsk,khd->bhsd", x, wv.view(kdim, hk, d))
    c2, s2 = widen_tables(cos, sin)
    q = rope_rotate(q, c2, s2).to(x.dtype)
    k = rope_rotate(k, c2, s2).to(x.dtype)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    out = FlashAttentionBHSDFunction.apply(
        q.reshape(b * h, s, d), k.reshape(b * h, s, d),
        v.reshape(b * h, s, d), 1.0 / math.sqrt(d), bool(causal))
    return torch.einsum("bhsd,hdk->bsk", out.view(b, h, s, d),
                        wo.view(h, d, kdim))
