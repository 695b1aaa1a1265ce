#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line per result:

1. card: name and power limit (``nvidia-smi``); builds every CUDA source
   of the port with ``nvcc`` (one process per source, all at once) and
   prints the build time and each source's registers and spills;
2. kernels against their plain PyTorch versions: the paged-attention
   kernels at the serving path's shapes (llama_1b MHA and a GQA case;
   bf16, fp32 and int8 pools; decode and multi-query with T in {1, 16,
   512}, q_start > 0 and padding rows), and the flash-attention forward,
   dq and dkv kernels at the training shape (llama_125m: B 16, H 12,
   S 1024, D 64, bf16, causal), at llama_1b's heads (D 128, S 2048), in
   fp32 at D 32, 64 and 128, non-causal, at a ragged S = 1000, and GQA
   32/8 through the autograd Function;
3. times (CUDA events, median after warm-up) of each kernel, its plain
   version and the PyTorch library call computing the same function,
   beside the least time the card could take;
4. serving end to end: ``LLMEngine`` serves llama_1b (bf16, random weights
   from a seed) to 8 greedy requests; the paged kernels' launch counts
   over that run must equal layers x decode steps and layers x prefill
   chunks; one profiled repeat;
5. training end to end: ``fused_train_step`` with AdamW(1e-4) trains
   llama_125m (bf16, random weights from a seed) on one fixed 16 x 1024
   batch, 2 warm-up and 10 timed steps through ``FusedTrainStep.drive``;
   the loss must be finite and fall, and each flash kernel must launch
   exactly layers x steps times; tokens/s, ms/step, MFU, peak memory and
   one profiled step;
6. card against CPU: the port engine on fp32 llama_tiny gives identical
   greedy tokens on the CPU (plain versions) and on the card (kernels),
   and three fused AdamW steps on fp32 llama_tiny give the same losses and
   parameters on both.

Then one JSON line with every kernel's numbers, the card line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without CUDA it exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, 700 W
# kernel vs plain version (evaluated in fp32 on the same, exactly upcast,
# values): |got - want| <= ATOL + RTOL[q dtype] * |want|. ATOL covers fp32
# summation order; RTOL is the kernel's final rounding of its fp32 result
# to the output dtype (half an ulp: 2^-8 relative for bf16, exact in fp32).
ATOL = 1e-4
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# flash-attention lse (fp32 on both sides): summation order only
LSE_ATOL = 1e-4
# flash-attention gradients: RTOL[dtype]*|want| (the output rounding) plus
# GRAD_FRAC * max|want|: fp32 sums of terms of both signs in another order,
# whose cancellation makes an error relative to the element meaningless
GRAD_FRAC = 1e-4
SEED = 0
# card vs CPU training on fp32 llama_tiny: losses rtol, parameters atol
# after three AdamW(lr 1e-3, epsilon 1e-6) steps -- cuBLAS and the CPU
# sum in other orders; epsilon 1e-6 keeps a gradient near zero from
# flipping its update (tests/test_torch_training.py makes the same choice)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-5


def say(*parts):
    print(*parts, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, warmup=3, iters=20):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


class Case:
    """Random paged-attention inputs on the card: pools [N, bs, Hkv, D]
    (N = B*P + 1, block 0 left as the null block), a random permutation
    of the other blocks as block tables, ragged context lengths."""

    def __init__(self, gen, *, B, H, Hkv, D, bs, P, q_dtype, kv, lens,
                 T=None, starts=None):
        import torch

        dev = "cuda"
        n = B * P + 1
        shape = (n, bs, Hkv, D)
        self.kv = kv
        if kv == "int8":
            self.k = torch.randint(-127, 128, shape, generator=gen,
                                   device=dev).to(torch.int8)
            self.v = torch.randint(-127, 128, shape, generator=gen,
                                   device=dev).to(torch.int8)
            self.ks = torch.rand(shape[:-1], generator=gen, device=dev) \
                * 0.02 + 1e-3
            self.vs = torch.rand(shape[:-1], generator=gen, device=dev) \
                * 0.02 + 1e-3
        else:
            dt = getattr(torch, kv)
            self.k = torch.randn(shape, generator=gen, device=dev).to(dt)
            self.v = torch.randn(shape, generator=gen, device=dev).to(dt)
            self.ks = self.vs = None
        perm = torch.randperm(n - 1, generator=gen, device=dev) + 1
        self.tables = perm[:B * P].view(B, P).to(torch.int32).contiguous()
        self.lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        qshape = (B, H, D) if T is None else (B, T, H, D)
        self.q = torch.randn(qshape, generator=gen, device=dev).to(
            getattr(torch, q_dtype))
        self.starts = (None if starts is None else
                       torch.tensor(starts, dtype=torch.int32, device=dev))
        self.scale = D ** -0.5
        self.H, self.Hkv, self.D, self.T = H, Hkv, D, T

    def pools(self, upcast=False):
        """(k, v, k_scale, v_scale); ``upcast`` gives float pools as fp32
        (exact for bf16) for the plain version's fp32 reference."""
        if upcast and self.kv != "int8":
            return self.k.float(), self.v.float(), None, None
        return self.k, self.v, self.ks, self.vs

    def kv_bytes(self, tokens):
        """Bytes of K and V rows (plus int8 scales) for ``tokens`` rows
        per kv head."""
        row = self.D * self.k.element_size() + (4 if self.kv == "int8"
                                                else 0)
        return 2 * tokens * self.Hkv * row


def decode_kernel(c):
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_decode_attention_cuda)

    k, v, ks, vs = c.pools()
    return paged_decode_attention_cuda(c.q, k, v, c.tables, c.lens, c.scale,
                                       k_scale=ks, v_scale=vs)


def decode_plain(c, upcast=False):
    from paddle_tpu_torch.inference.serving.paged_attention import (
        _torch_fallback)

    k, v, ks, vs = c.pools(upcast)
    q = c.q.float() if upcast else c.q
    return _torch_fallback(q[:, None], k, v, c.tables, c.lens, c.scale,
                           k_scale=ks, v_scale=vs)[:, 0]


def mq_kernel(c):
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_multiquery_attention_cuda)

    k, v, ks, vs = c.pools()
    return paged_multiquery_attention_cuda(c.q, k, v, c.tables, c.lens,
                                           c.starts, c.scale, k_scale=ks,
                                           v_scale=vs)


def mq_plain(c, upcast=False):
    from paddle_tpu_torch.inference.serving.paged_attention import (
        _torch_multiquery_fallback)

    k, v, ks, vs = c.pools(upcast)
    q = c.q.float() if upcast else c.q
    return _torch_multiquery_fallback(q, k, v, c.tables, c.lens, c.starts,
                                      c.scale, k_scale=ks, v_scale=vs)


def library_call(c):
    """``scaled_dot_product_attention`` on K/V gathered (outside the
    timed call) from the pages, with the same visibility mask."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.inference.serving.paged_attention import _gather_kv

    k, v, ks, vs = c.pools()
    kg = _gather_kv(k, ks, c.tables).to(c.q.dtype)
    vg = _gather_kv(v, vs, c.tables).to(c.q.dtype)
    if c.H != c.Hkv:
        kg = kg.repeat_interleave(c.H // c.Hkv, dim=2)
        vg = vg.repeat_interleave(c.H // c.Hkv, dim=2)
    kt = kg.transpose(1, 2).contiguous()
    vt = vg.transpose(1, 2).contiguous()
    pos = torch.arange(kt.shape[2], device="cuda")
    if c.T is None:
        qt = c.q[:, :, None]
        mask = (pos[None] < c.lens[:, None].long())[:, None, None]
    else:
        qt = c.q.transpose(1, 2).contiguous()
        row = torch.arange(c.T, device="cuda")
        mask = ((pos[None, None] <= c.starts.long()[:, None, None]
                 + row[None, :, None])
                & (pos[None, None] < c.lens.long()[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  scale=c.scale)


def compare(got, want, q_dtype):
    """(max abs error, max excess over the tolerance) of got vs want."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    excess = diff - (ATOL + RTOL[q_dtype] * want.abs())
    return float(diff.max()), float(excess.max())


def phase_kernels(gen):
    """Phase 2. Returns {kernel: max abs error over every case}."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    worst = {"paged_decode_attention": 0.0,
             "paged_multiquery_attention": 0.0}
    B, bs, P, D = 8, 16, 128, 128
    for H, Hkv in ((16, 16), (32, 8)):
        for q_dtype, kv in (("bfloat16", "bfloat16"), ("float32", "float32"),
                            ("bfloat16", "int8"), ("float32", "int8")):
            tol = f"{ATOL:g} + {RTOL[q_dtype]:g}*|want|"
            lens = rng.randint(1, bs * P + 1, B)
            lens[0], lens[1] = 1, bs * P
            c = Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                     q_dtype=q_dtype, kv=kv, lens=lens)
            got = decode_kernel(c)
            err, excess = compare(got, decode_plain(c, upcast=True), q_dtype)
            say(f"kernel decode H={H} Hkv={Hkv} q={q_dtype} kv={kv}: "
                f"max_abs_err {err:.3e} (tol {tol})")
            check(excess <= 0, f"decode {H}/{Hkv} {q_dtype}/{kv}")
            worst["paged_decode_attention"] = max(
                worst["paged_decode_attention"], err)
            # T = 1 multi-query at q_start = ctx - 1 is the decode step
            c1 = Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                      q_dtype=q_dtype, kv=kv, lens=lens, T=1,
                      starts=lens - 1)
            c1.k, c1.v, c1.ks, c1.vs, c1.tables = c.k, c.v, c.ks, c.vs, \
                c.tables
            c1.q = c.q[:, None].contiguous()
            same = float((mq_kernel(c1)[:, 0].float() - got.float())
                         .abs().max())
            say(f"kernel mq T=1 vs decode H={H} q={q_dtype} kv={kv}: "
                f"max_abs_diff {same:.3e} (tol 0)")
            check(same == 0.0, "mq T=1 equals decode")
            for T in (1, 16, 512):
                valid = rng.randint(1, T + 1, B)
                valid[0] = T
                if T > 1:
                    valid[1] = max(1, T // 3)   # padding rows
                starts = np.array([rng.randint(0, bs * P - T + 1)
                                   for _ in range(B)])
                starts[0] = 0
                ctx = starts + valid
                c = Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                         q_dtype=q_dtype, kv=kv, lens=ctx, T=T,
                         starts=starts)
                got = mq_kernel(c)
                want = mq_plain(c, upcast=True)
                err = excess = -1.0
                for b in range(B):
                    e, x = compare(got[b, :valid[b]], want[b, :valid[b]],
                                   q_dtype)
                    err, excess = max(err, e), max(excess, x)
                say(f"kernel mq T={T} H={H} Hkv={Hkv} q={q_dtype} kv={kv}: "
                    f"max_abs_err {err:.3e} (tol {tol}, valid rows only)")
                check(excess <= 0, f"mq T={T} {H}/{Hkv} {q_dtype}/{kv}")
                worst["paged_multiquery_attention"] = max(
                    worst["paged_multiquery_attention"], err)
    return worst


def phase_times(gen):
    """Phase 3, at the llama_1b serving shapes in bf16: the decode batch
    (B=8, ragged ctx up to 2048) and the longest prompt's prefill chunk
    (T=2048 bucket rows, 1536 real, q_start 0)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 1)
    H = Hkv = 16
    D, bs, P = 128, 16, 128
    out = {}
    lens = rng.randint(64, bs * P + 1, 8)
    dc = Case(gen, B=8, H=H, Hkv=Hkv, D=D, bs=bs, P=P, q_dtype="bfloat16",
              kv="bfloat16", lens=lens)
    tokens = int(lens.sum())
    byt = dc.kv_bytes(tokens) + 2 * dc.q.numel() * 2 \
        + 4 * (int(np.ceil(lens / bs).sum()) + 8)
    ops = 4 * tokens * H * D
    out["paged_decode_attention"] = dict(
        ms=time_ms(lambda: decode_kernel(dc)),
        plain_ms=time_ms(lambda: decode_plain(dc)),
        library_ms=time_ms(library_call(dc)), bytes=byt, ops=ops,
        library="sdpa on gathered K/V",
        shape=f"B=8 H={H} D={D} bs={bs} ctx_sum={tokens} bf16")
    T, real = 2048, 1536
    mc = Case(gen, B=1, H=H, Hkv=Hkv, D=D, bs=bs, P=P, q_dtype="bfloat16",
              kv="bfloat16", lens=[real], T=T, starts=[0])
    pairs = real * (real + 1) // 2          # causal pairs of the real rows
    byt = mc.kv_bytes(real) + 2 * real * H * D * 2 \
        + 4 * (-(-real // bs) + 2)
    ops = 4 * pairs * H * D
    out["paged_multiquery_attention"] = dict(
        ms=time_ms(lambda: mq_kernel(mc)),
        plain_ms=time_ms(lambda: mq_plain(mc)),
        library_ms=time_ms(library_call(mc)), bytes=byt, ops=ops,
        library="sdpa on gathered K/V",
        shape=f"B=1 T={T} (real {real}) q_start=0 H={H} D={D} bf16")
    return report_times(out)


def report_times(out):
    """Add each kernel's bound (the larger of bytes / 3.35 TB/s and
    operations / the bf16 peak) to its timing record and print it."""
    for name, r in out.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_OPS_PER_S["bfloat16"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        say(f"time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
            f"({r['library']}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bytes']} B, {r['ops']} ops)")
    return out


# -- flash attention --------------------------------------------------------

FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")


def flash_inputs(gen, bh, s, d, dtype):
    """q, k, v, dO [B*H, S, D] on the card, standard normal."""
    import torch

    return [torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]


def compare_grad(got, want, dtype):
    """(max abs error, max excess) of a flash gradient against its plain
    version: tolerance RTOL[dtype]*|want| + GRAD_FRAC*max|want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = RTOL[dtype] * want.abs() + GRAD_FRAC * float(want.abs().max())
    return float(diff.max()), float((diff - tol).max())


def phase_flash_kernels(gen):
    """Phase 2b: each flash kernel against its plain version (evaluated in
    fp32 on the exactly upcast inputs; the backward's plain versions take
    the kernel's own out and lse). Returns {kernel: max abs error}."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as K

    worst = dict.fromkeys(FLASH, 0.0)
    cases = [  # (B, H, S, D, dtype, causal, what)
        (16, 12, 1024, 64, "bfloat16", True, "llama_125m training"),
        (2, 16, 2048, 128, "bfloat16", True, "llama_1b heads"),
        (2, 4, 512, 32, "float32", True, "fp32 D=32"),
        (2, 4, 512, 64, "float32", True, "fp32 D=64"),
        (2, 8, 512, 64, "bfloat16", False, "non-causal"),
        (2, 4, 1000, 64, "bfloat16", True, "ragged S"),
        (1, 4, 1000, 128, "float32", False, "ragged S fp32 D=128")]
    for b, h, s, d, dt, causal, what in cases:
        q, k, v, do = flash_inputs(gen, b * h, s, d, getattr(torch, dt))
        scale = d ** -0.5
        up = [t.float() for t in (q, k, v, do)]
        out, lse = K.flash_attention_fwd_cuda(q, k, v, scale, causal)
        w_out, w_lse = K.flash_attention_fwd_plain(*up[:3], scale, causal)
        e_out, x_out = compare(out, w_out, dt)
        e_lse = float((lse - w_lse).abs().max())
        del w_out, w_lse
        res = (*up[:3], out.float(), lse, up[3])
        dq = K.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do, scale,
                                           causal)
        e_dq, x_dq = compare_grad(dq, K.flash_attention_bwd_dq_plain(
            *res, scale, causal), dt)
        dk, dv = K.flash_attention_bwd_dkv_cuda(q, k, v, out, lse, do, scale,
                                                causal)
        w_dk, w_dv = K.flash_attention_bwd_dkv_plain(*res, scale, causal)
        e_dk, x_dk = compare_grad(dk, w_dk, dt)
        e_dv, x_dv = compare_grad(dv, w_dv, dt)
        torch.cuda.synchronize()
        say(f"kernel flash B={b} H={h} S={s} D={d} {dt} causal={causal} "
            f"({what}): out {e_out:.3e} (tol {ATOL:g} + {RTOL[dt]:g}*|want|)"
            f", lse {e_lse:.3e} (tol {LSE_ATOL:g}), dq {e_dq:.3e}, dk "
            f"{e_dk:.3e}, dv {e_dv:.3e} (tol {RTOL[dt]:g}*|want| + "
            f"{GRAD_FRAC:g}*max|want|)")
        check(x_out <= 0 and e_lse <= LSE_ATOL, f"flash fwd {what}")
        check(x_dq <= 0, f"flash dq {what}")
        check(x_dk <= 0 and x_dv <= 0, f"flash dkv {what}")
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"],
                                           e_out)
        worst["flash_attention_bwd_dq"] = max(
            worst["flash_attention_bwd_dq"], e_dq)
        worst["flash_attention_bwd_dkv"] = max(
            worst["flash_attention_bwd_dkv"], e_dk, e_dv)
        del q, k, v, do, up, res, out, lse, dq, dk, dv, w_dk, w_dv
        torch.cuda.empty_cache()
    flash_gqa_check(gen)
    return worst


def flash_gqa_check(gen):
    """GQA 32/8 through the autograd Function (kernels, fp32) against the
    plain dense attention differentiated by autograd on the card."""
    import torch

    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention

    b, s, h, hkv, d = 1, 512, 32, 8, 128
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    arrs = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    w = torch.randn(b, s, h, d, generator=gen, device="cuda")
    got = []
    for fn in (lambda q, k, v: flash_attention(q, k, v, causal=True),
               lambda q, k, v: sdpa_reference(q, k, v, causal=True)):
        ts = [a.clone().requires_grad_() for a in arrs]
        out = fn(*ts)
        (out * w).sum().backward()
        got.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    e_out, x_out = compare(got[0][0], got[1][0], "float32")
    errs = [compare_grad(a, b_, "float32") for a, b_ in zip(got[0][1:],
                                                            got[1][1:])]
    say(f"kernel flash GQA {h}/{hkv} S={s} D={d} fp32 through the autograd "
        f"Function vs plain sdpa + autograd: out {e_out:.3e}, dq/dk/dv "
        f"{', '.join(f'{e:.3e}' for e, _ in errs)}")
    check(x_out <= 0 and all(x <= 0 for _, x in errs), "flash GQA")


def phase_flash_times(gen):
    """Phase 3b, at the training shape (llama_125m: B 16, H 12, S 1024,
    D 64, bf16, causal). Library: ``scaled_dot_product_attention`` forward
    on [B, H, S, D], and its autograd backward (dq, dk and dv together)
    beside dq and dkv."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as K

    b, h, s, d = 16, 12, 1024, 64
    bh, scale, el = b * h, d ** -0.5, 2
    q, k, v, do = flash_inputs(gen, bh, s, d, torch.bfloat16)
    out, lse = K.flash_attention_fwd_cuda(q, k, v, scale, True)
    lib = [t.view(b, h, s, d).clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
    lib_do = do.view(b, h, s, d)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib, lib_do, retain_graph=True))
    fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *lib, is_causal=True))
    pairs = bh * s * (s + 1) // 2               # causal visible pairs
    tile = bh * s * d * el                      # one [B*H, S, D] tensor
    shape = f"B={b} H={h} S={s} D={d} bf16 causal"
    res = (q, k, v, out, lse, do, scale, True)
    times = {
        "flash_attention_fwd": dict(
            ms=time_ms(lambda: K.flash_attention_fwd_cuda(q, k, v, scale,
                                                          True)),
            plain_ms=time_ms(lambda: K.flash_attention_fwd_plain(
                q, k, v, scale, True)),
            library_ms=fwd_ms, library="sdpa forward",
            bytes=4 * tile + bh * s * 4, ops=4 * d * pairs),
        "flash_attention_bwd_dq": dict(
            ms=time_ms(lambda: K.flash_attention_bwd_dq_cuda(*res)),
            plain_ms=time_ms(lambda: K.flash_attention_bwd_dq_plain(*res)),
            library_ms=bwd_ms, library="sdpa backward, dq+dk+dv",
            bytes=6 * tile + bh * s * 4, ops=6 * d * pairs),
        "flash_attention_bwd_dkv": dict(
            ms=time_ms(lambda: K.flash_attention_bwd_dkv_cuda(*res)),
            plain_ms=time_ms(lambda: K.flash_attention_bwd_dkv_plain(*res)),
            library_ms=bwd_ms, library="sdpa backward, dq+dk+dv",
            bytes=7 * tile + bh * s * 4, ops=8 * d * pairs)}
    for r in times.values():
        r["shape"] = shape
    report_times(times)
    bwd = (times["flash_attention_bwd_dq"]["ms"]
           + times["flash_attention_bwd_dkv"]["ms"])
    say(f"time flash backward: dq + dkv kernels {bwd:.4f} ms vs sdpa "
        f"backward {bwd_ms:.4f} ms")
    del q, k, v, do, out, lse, lib, lib_out
    torch.cuda.empty_cache()
    return times


def phase_serve():
    """Phase 4: llama_1b through LLMEngine; returns the paged kernels'
    launch counts over the measured run."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_1b
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    cfg = llama_1b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    engine = LLMEngine(model, num_blocks=2048, block_size=16,
                       max_batch_size=8, max_model_len=2048, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"serve setup: llama_1b bf16 ({n_params} params) + 2048-block "
        f"pool in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED + 2)
    # warm-up request (cuBLAS handles, allocator), outside the counted run
    engine.generate([rng.randint(0, cfg.vocab_size, 64)],
                    SamplingParams(max_new_tokens=2))
    engine.reset_metrics()
    lens = rng.randint(64, 1537, 8)
    lens[0] = 1536
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    new = 32
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, SamplingParams(max_new_tokens=new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    m = engine.metrics()
    device_profile(lambda: engine.generate(
        prompts, SamplingParams(max_new_tokens=new)),
        "serve (same batch again)", mark=("paged_",))
    engine.close()
    L = cfg.num_hidden_layers
    for p, o in zip(prompts, outs):
        check(len(o) == len(p) + new, "every request finished")
        gen_toks = o[len(p):]
        check(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all(),
              "tokens inside the vocab")
    check(m["finished"] == len(prompts), "all requests finished")
    check(counts["paged_decode_attention_cuda"] == L * m["decode_steps"]
          and m["decode_steps"] > 0,
          f"decode launches {counts} == {L} x {m['decode_steps']} steps")
    check(counts["paged_multiquery_attention_cuda"]
          == L * m["prefill_chunks"] and m["prefill_chunks"] > 0,
          f"multi-query launches {counts} == {L} x {m['prefill_chunks']}")
    toks = len(prompts) * new
    say(f"serve llama_1b: {len(prompts)} requests, prompts "
        f"{sorted(int(x) for x in lens)}, {new} new tokens each: wall "
        f"{wall:.3f} s, {toks / wall:.1f} tokens/s, ttft p50 "
        f"{m['ttft_ms'].get('p50')} ms, itl p50 {m['itl_ms'].get('p50')} "
        f"ms, decode steps {m['decode_steps']}, prefill chunks "
        f"{m['prefill_chunks']}, launches {counts}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return counts


def device_profile(run, label, top=8, mark=None):
    """``run()`` once under ``torch.profiler``: the device's busy time (the
    union of its kernel and copy intervals, so nothing is counted twice)
    and idle share of the wall time, and the top kernels by device time.
    ``mark`` names kernels whose shares are printed as well. Returns
    ``{kernel name: device us}``, or None when the profiler recorded no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        say(f"profile {label}: the profiler recorded no device time "
            "(not measured)")
        return None
    busy, reach, by_name = 0.0, spans[0][0], {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
        n = by_name.setdefault(name, [0.0, 0])
        n[0] += b - a
        n[1] += 1
    total = sum(us for us, _ in by_name.values())
    say(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms = {busy / wall_us:.3f} of wall (idle share "
        f"{1 - busy / wall_us:.3f}); {len(spans)} device ops, "
        f"{total / 1e3:.1f} ms of device time")
    rows = sorted(((us, name, cnt) for name, (us, cnt) in by_name.items()),
                  reverse=True)
    for us, name, cnt in rows[:top]:
        say(f"  {us / total:.3f} of device time, {us / 1e3:.2f} ms, "
            f"{cnt} calls: {name[:90]}")
    for key in mark or ():
        us = sum(u for u, name, _ in rows if key in name)
        say(f"  {key}*: {us / total:.3f} of device time, {us / 1e3:.2f} ms")
    return {name: us for us, name, _ in rows}


def phase_card_vs_cpu():
    """Phase 6: identical greedy tokens on the CPU and on the card."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         load_paddle_tpu_state_dict,
                                         llama_tiny)

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 3)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 77, 130)]
    for chunk in (None, 32):
        outs = {}
        for dev in ("cpu", "cuda"):
            m = LlamaForCausalLM(cfg, device=dev)
            load_paddle_tpu_state_dict(m, state)
            with LLMEngine(m, num_blocks=64, block_size=16,
                           max_batch_size=3, max_prefill_tokens_per_step=chunk,
                           device=dev) as eng:
                outs[dev] = eng.generate(prompts,
                                         SamplingParams(max_new_tokens=16))
        same = all((a == b).all() for a, b in zip(outs["cpu"],
                                                  outs["cuda"]))
        say(f"card vs cpu llama_tiny fp32 (chunk budget {chunk}): greedy "
            f"tokens identical: {same}")
        check(same, "card and CPU greedy tokens agree")


def phase_train():
    """Phase 5: llama_125m (bf16, full width and depth, random weights
    from a seed) trained by ``fused_train_step`` with AdamW(1e-4) on one
    fixed 16 x 1024 batch: 2 warm-up and 10 timed steps through
    ``FusedTrainStep.drive``, then one profiled step. Returns the flash
    kernels' launch counts over the 12 steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_125m
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops.cuda import flash_attention as K
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_125m()
    batch, seq, warmup, steps = 16, 1024, 2, 10
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=1e-4,
                                         parameters=model.parameters()))
    rng = np.random.RandomState(SEED + 4)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (batch, seq))).cuda()
                   for _ in range(2))
    n_params = sum(p.numel() for p in model.parameters())
    # PaLM-appendix accounting, as bench.py's _train_flops_per_token
    flops_per_token = 6.0 * n_params + 12.0 * cfg.num_hidden_layers \
        * cfg.hidden_size * seq
    torch.cuda.synchronize()
    say(f"train setup: llama_125m bf16 ({n_params} params), batch "
        f"{batch} x {seq}, in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    first = step.drive([(ids, labels)] * warmup, log_every=warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = step.drive([(ids, labels)] * steps, log_every=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    losses = first["loss"] + hist["loss"]
    L = cfg.num_hidden_layers
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls {losses}")
    for name in FLASH:
        check(counts[name + "_cuda"] == L * (warmup + steps),
              f"{name} launches {counts} == {L} x {warmup + steps} steps")
    tokens = batch * seq * steps
    tok_s = tokens / wall
    gauge = metrics.REGISTRY.get("train_items_per_sec").value(
        instance=step._stats_name)
    say(f"train llama_125m: losses {[round(x, 4) for x in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {tok_s:.0f} tokens/s (train_items_per_sec {gauge:.0f}), "
        f"MFU {tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']:.4f} "
        f"({flops_per_token / 1e6:.1f} MFLOP/token vs 989 TFLOP/s), peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {counts}")
    device_profile(lambda: step(ids, labels), "train (one step)", top=10,
                   mark=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    del model, step
    torch.cuda.empty_cache()
    return counts


def phase_train_card_vs_cpu():
    """Phase 6b: three fused AdamW steps on fp32 llama_tiny (GQA 4/2,
    head_dim 32) from the same numpy weights and batches, on the card
    (kernels) and on the CPU (plain versions)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         load_paddle_tpu_state_dict,
                                         llama_tiny, to_numpy_state_dict)
    from paddle_tpu_torch.ops.cuda import flash_attention as K
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 5)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    batches = [tuple(rng.randint(0, cfg.vocab_size, (4, 128))
                     for _ in range(2)) for _ in range(3)]
    losses, params = {}, {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(model, state)
        step = fused_train_step(model, AdamW(
            learning_rate=1e-3, epsilon=1e-6, parameters=model.parameters()))
        K.reset_launch_counts()
        losses[dev] = [float(step(*(torch.from_numpy(x).to(dev)
                                    for x in b))) for b in batches]
        if dev == "cuda":
            counts = K.launch_counts()
            check(all(counts[n + "_cuda"] == 3 * cfg.num_hidden_layers
                      for n in FLASH), f"tiny launches {counts}")
        params[dev] = to_numpy_state_dict(model)
    dl = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
    dp = max(float(np.abs(params["cuda"][k] - params["cpu"][k]).max())
             for k in params["cpu"])
    say(f"card vs cpu training llama_tiny fp32, 3 AdamW steps: losses cuda "
        f"{losses['cuda']} cpu {losses['cpu']}, max rel diff {dl:.2e} (tol "
        f"{TRAIN_LOSS_RTOL:g}); parameters max abs diff {dp:.2e} (tol "
        f"{TRAIN_PARAM_ATOL:g})")
    check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
          "card and CPU training agree")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for stem, (_, log) in built.items():
        regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
        spills = sum("0 bytes spill stores" not in line
                     for line in log.splitlines() if "spill stores" in line)
        say(f"  ptxas {stem}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{spills} with spills")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = phase_kernels(gen)
    worst.update(phase_flash_kernels(gen))
    times = phase_times(gen)
    times.update(phase_flash_times(gen))
    counts = phase_serve()
    counts.update(phase_train())
    phase_card_vs_cpu()
    phase_train_card_vs_cpu()
    sources = {"paged": "paddle_tpu_torch/csrc/paged_attention.cu",
               "flash": "paddle_tpu_torch/csrc/flash_attention.cu"}
    replaces = {
        "paged_decode_attention": "paddle_tpu/ops/pallas/paged_attention.py:157",
        "paged_multiquery_attention":
            "paddle_tpu/ops/pallas/paged_attention.py:278",
        "flash_attention_fwd": "paddle_tpu/ops/pallas/flash_attention.py:136",
        "flash_attention_bwd_dq":
            "paddle_tpu/ops/pallas/flash_attention.py:280",
        "flash_attention_bwd_dkv":
            "paddle_tpu/ops/pallas/flash_attention.py:296"}
    kernels = [dict(name=name, route="cuda",
                    source=sources[name.split("_")[0]],
                    replaces=replaces[name],
                    launches=counts[name + "_cuda"],
                    max_abs_err=worst[name], ms=times[name]["ms"],
                    plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"])
               for name in replaces]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
