#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line per result:

1. card: name and power limit (``nvidia-smi``); builds every CUDA source
   of the port with ``nvcc`` (one process per source, all at once) and
   prints the build time, each source's registers and spills, and each
   tensor-core kernel's registers, spills and dynamic shared memory;
2. kernels against their plain PyTorch versions: the paged-attention
   kernels at the serving path's shapes (llama_1b MHA and a GQA case;
   bf16, fp32 and int8 pools; decode with contexts of 1, kSplit,
   kSplit + 1 and the whole table, each request decoded alone equal to
   its row of the batch (tolerance 0); multi-query with T in {1, 16,
   512}, q_start > 0 and padding rows, T = 1 equal to decode); the
   flash-attention forward, dq
   and dkv kernels, without rope and in their rope form (pre-rotary q and
   k, the llama tables), at the training shape (B 16, H 12, S 1024, D 64,
   bf16, causal), at llama_1b's heads (D 128, S 2048), in bf16 at D 32
   (with D 64 and 128 above: the bf16 tensor-core bodies of all three
   kernels at every head dim), in fp32 at D 32, 64 and 128 (the CUDA-core
   bodies),
   non-causal, at BERT-base's shape (B 128, H 12, S 128, D 64, bf16,
   non-causal), at a ragged S = 1000, and GQA 32/8 through the autograd
   Function; the MoE expert FFN at the Llama-MoE shape (E 8,
   C 5120, h 768, I 2048) in bf16 and fp32 and at ragged small shapes in
   both dtypes (bf16: the tensor-core body, fp32: the CUDA-core body); the
   fused add + RMSNorm and the fused add + LayerNorm at 16384 x 768 in bf16
   and fp32 and at ragged shapes (the residual bit for bit);
3. times (CUDA events, median after warm-up) of each kernel, its plain
   version and the PyTorch library call computing the same function,
   beside the least time the card could take, with the achieved TFLOP/s
   (and, for the MoE kernel, the bytes its design reads through L2); the
   decode kernel also over an int8 pool, each decode line naming its
   body;
4. serving end to end: ``LLMEngine`` serves llama_1b (bf16, random weights
   from a seed) to 8 greedy requests; the paged kernels' launch counts
   over that run must equal layers x decode steps and layers x prefill
   chunks; one profiled repeat;
5. training end to end: ``fused_train_step`` with AdamW(1e-4) trains
   llama_125m (bf16, random weights from a seed) on one fixed 16 x 1024
   batch, 2 warm-up and 10 timed steps through ``FusedTrainStep.drive``;
   the loss must be finite and fall, and each flash kernel must launch
   exactly layers x steps times; tokens/s, ms/step, MFU, peak memory and
   one profiled step; then the same for the Llama-MoE of
   scripts/bench_moe_ffn.py (8 layers, 8 experts, top-2, MoE every 2nd
   layer) with ``PT_FUSED_MOE``, ``PT_FUSED_NORM`` and ``PT_FUSED_ROPE``
   set for that run only: the MoE kernel launches MoE layers x steps
   times, the fused norm and each rope flash kernel layers x steps, the
   flash kernels without rope never; then BERT-base sequence-
   classification fine-tuning as ``bench.py bert`` sets it up (bf16, both
   dropouts 0, AdamW(2e-5), 128 x 128 random ids and labels) with
   ``PT_FUSED_NORM`` set for that run only: the fused add + LayerNorm
   launches 2 x layers x steps times, each flash kernel without rope
   layers x steps, every other kernel never;
6. card against CPU: the port engine on fp32 llama_tiny gives identical
   greedy tokens on the CPU (plain versions) and on the card (kernels);
   three fused AdamW steps on fp32 llama_tiny give the same losses and
   parameters on both; and so do three on fp32 llama_tiny with 4 experts
   and the three switches, after the first batch's top-k routing is found
   identical on both; three on fp32 bert_tiny with ``PT_FUSED_NORM``, and
   one padded (masked) ``BertModel`` forward.

Then one JSON line with every kernel's numbers, the card line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without CUDA it exits 1.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
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


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms():
    """The rate of ``torch.cuda._sleep``, measured once with CUDA events."""
    import torch

    cycles = 10_000_000
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def time_ms(fn, warmup=3, iters=20):
    """Median device time of one call of ``fn``, after ``warmup`` calls,
    between two CUDA events. Each timed call is queued behind a device-side
    sleep twice as long as the host takes to issue it (at most 50 ms), so
    the start event fires when the call's work is already queued: without
    it a kernel shorter than the host's launch overhead would be timed at
    that overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(min(2 * issue_ms, 50.0) * sleep_cycles_per_ms())
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
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


def one_request(c, b):
    """Case ``c`` cut to its request ``b`` alone (same pools)."""
    import copy

    one = copy.copy(c)
    one.q, one.tables, one.lens = (t[b:b + 1].contiguous()
                                   for t in (c.q, c.tables, c.lens))
    if c.starts is not None:
        one.starts = c.starts[b:b + 1].contiguous()
    return one


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

    from paddle_tpu_torch.ops.cuda.paged_attention import split_tokens

    rng = np.random.RandomState(SEED)
    worst = {"paged_decode_attention": 0.0,
             "paged_multiquery_attention": 0.0}
    B, bs, P, D = 8, 16, 128, 128
    split = split_tokens()
    for H, Hkv in ((16, 16), (32, 8)):
        for q_dtype, kv in (("bfloat16", "bfloat16"), ("float32", "float32"),
                            ("bfloat16", "int8"), ("float32", "int8")):
            tol = f"{ATOL:g} + {RTOL[q_dtype]:g}*|want|"
            lens = rng.randint(1, bs * P + 1, B)
            lens[0], lens[1] = 1, bs * P
            lens[2], lens[3] = split, split + 1   # a span's edge
            c = Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                     q_dtype=q_dtype, kv=kv, lens=lens)
            got = decode_kernel(c)
            err, excess = compare(got, decode_plain(c, upcast=True), q_dtype)
            say(f"kernel decode H={H} Hkv={Hkv} q={q_dtype} kv={kv}: "
                f"max_abs_err {err:.3e} (tol {tol}; contexts "
                f"{sorted(int(x) for x in lens)}, kSplit {split})")
            check(excess <= 0, f"decode {H}/{Hkv} {q_dtype}/{kv}")
            # each request decoded alone is its row of the batch
            alone = max(float((decode_kernel(one_request(c, b))[0].float()
                               - got[b].float()).abs().max())
                        for b in range(B))
            say(f"kernel decode alone vs batch H={H} q={q_dtype} kv={kv}: "
                f"max_abs_diff {alone:.3e} over {B} requests (tol 0)")
            check(alone == 0.0, "decode alone equals decode in a batch")
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

    from paddle_tpu_torch.ops.cuda import paged_attention as K

    rng = np.random.RandomState(SEED + 1)
    H = Hkv = 16
    D, bs, P = 128, 16, 128
    out = {}
    lens = rng.randint(64, bs * P + 1, 8)
    dc = Case(gen, B=8, H=H, Hkv=Hkv, D=D, bs=bs, P=P, q_dtype="bfloat16",
              kv="bfloat16", lens=lens)
    tokens = int(lens.sum())
    ops = 4 * tokens * H * D
    body = (f"{K.multiquery_route(dc.q.dtype, dc.k.dtype, 1, D)} body: "
            f"split-KV, kSplit {K.split_tokens()}, then the combine")
    for name, c in (("paged_decode_attention", dc),
                    ("paged_decode_attention int8",
                     Case(gen, B=8, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                          q_dtype="bfloat16", kv="int8", lens=lens))):
        byt = c.kv_bytes(tokens) + 2 * c.q.numel() * 2 \
            + 4 * (int(np.ceil(lens / bs).sum()) + 8)
        out[name] = dict(
            ms=time_ms(lambda: decode_kernel(c)),
            plain_ms=time_ms(lambda: decode_plain(c)),
            library_ms=time_ms(library_call(c)), bytes=byt, ops=ops,
            library="sdpa on gathered K/V",
            shape=f"B=8 H={H} D={D} bs={bs} ctx_sum={tokens} bf16 q, "
                  f"{c.kv} pool", note=body)
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
        shape=f"B=1 T={T} (real {real}) q_start=0 H={H} D={D} bf16",
        note=f"{K.multiquery_route(mc.q.dtype, mc.k.dtype, T, D)} body")
    return report_times(out)


def report_times(out):
    """Add each kernel's bound (the larger of bytes / 3.35 TB/s and
    operations / the bf16 peak) to its timing record and print it."""
    for name, r in out.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_OPS_PER_S["bfloat16"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = ("not available" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        say(f"time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} "
            f"({r['library']}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bytes']} B, {r['ops']} ops); achieved "
            f"{r['ops'] / r['ms'] / 1e9:.1f} TFLOP/s"
            + (f"; {r['note']}" if r.get("note") else ""))
    return out


# -- flash attention --------------------------------------------------------

FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")
ROPE = tuple(n.replace("attention_", "attention_rope_") for n in FLASH)


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


def rope_tables(s, d):
    """The llama rope tables for S positions, widened to fp32 [S, D] on
    the card, as ``flash_attention_rope`` passes them to the kernels."""
    import torch

    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops.cuda.flash_attention import widen_tables

    cos, sin = (torch.from_numpy(t).cuda() for t in _rope_cache(s, d,
                                                                 10000.0))
    return widen_tables(cos, sin)


def flash_calls(rope, s, d):
    """(fwd, dq, dkv, plain fwd, plain dq, plain dkv) of the flash kernels
    without or with rope, all taking (q, k, v[, out, lse, dout], scale,
    causal); the rope forms get the llama tables for S and D."""
    from paddle_tpu_torch.ops.cuda import flash_attention as K

    if not rope:
        return (K.flash_attention_fwd_cuda, K.flash_attention_bwd_dq_cuda,
                K.flash_attention_bwd_dkv_cuda, K.flash_attention_fwd_plain,
                K.flash_attention_bwd_dq_plain,
                K.flash_attention_bwd_dkv_plain)
    c2, s2 = rope_tables(s, d)

    def bind(fn, n):  # the tables go after the first n arguments
        return lambda *a: fn(*a[:n], c2, s2, *a[n:])

    return (bind(K.flash_attention_rope_fwd_cuda, 3),
            bind(K.flash_attention_rope_bwd_dq_cuda, 6),
            bind(K.flash_attention_rope_bwd_dkv_cuda, 6),
            bind(K.flash_attention_rope_fwd_plain, 3),
            bind(K.flash_attention_rope_bwd_dq_plain, 6),
            bind(K.flash_attention_rope_bwd_dkv_plain, 6))


def phase_flash_kernels(gen, rope=False):
    """Phase 2b: each flash kernel (``rope``: its rope form, on pre-rotary
    q and k with the llama tables) against its plain version (evaluated in
    fp32 on the exactly upcast inputs; the backward's plain versions take
    the kernel's own out and lse). Returns {kernel: max abs error}."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as K

    names = ROPE if rope else FLASH
    worst = dict.fromkeys(names, 0.0)
    cases = [  # (B, H, S, D, dtype, causal, what)
        (16, 12, 1024, 64, "bfloat16", True, "llama_125m training"),
        (2, 16, 2048, 128, "bfloat16", True, "llama_1b heads"),
        (2, 4, 512, 32, "bfloat16", True, "bf16 D=32"),
        (2, 4, 512, 32, "float32", True, "fp32 D=32"),
        (2, 4, 512, 64, "float32", True, "fp32 D=64"),
        (2, 8, 512, 64, "bfloat16", False, "non-causal"),
        (128, 12, 128, 64, "bfloat16", False, "BERT-base training"),
        (2, 4, 1000, 64, "bfloat16", True, "ragged S"),
        (1, 4, 1000, 128, "float32", False, "ragged S fp32 D=128")]
    tag = "flash rope" if rope else "flash"
    for b, h, s, d, dt, causal, what in cases:
        fwd, bdq, bdkv, p_fwd, p_dq, p_dkv = flash_calls(rope, s, d)
        q, k, v, do = flash_inputs(gen, b * h, s, d, getattr(torch, dt))
        scale = d ** -0.5
        up = [t.float() for t in (q, k, v, do)]
        out, lse = fwd(q, k, v, scale, causal)
        w_out, w_lse = p_fwd(*up[:3], scale, causal)
        e_out, x_out = compare(out, w_out, dt)
        e_lse = float((lse - w_lse).abs().max())
        del w_out, w_lse
        res = (*up[:3], out.float(), lse, up[3])
        dq = bdq(q, k, v, out, lse, do, scale, causal)
        e_dq, x_dq = compare_grad(dq, p_dq(*res, scale, causal), dt)
        dk, dv = bdkv(q, k, v, out, lse, do, scale, causal)
        w_dk, w_dv = p_dkv(*res, scale, causal)
        e_dk, x_dk = compare_grad(dk, w_dk, dt)
        e_dv, x_dv = compare_grad(dv, w_dv, dt)
        torch.cuda.synchronize()
        route = K.flash_route(getattr(torch, dt), d)
        check(route == ("tensor_core" if dt == "bfloat16" else "cuda_core"),
              f"{tag} forward and backward route {route} for {dt}")
        say(f"kernel {tag} B={b} H={h} S={s} D={d} {dt} causal={causal} "
            f"({what}; forward, dq and dkv {route}): out {e_out:.3e} "
            f"(tol {ATOL:g} + "
            f"{RTOL[dt]:g}*|want|)"
            f", lse {e_lse:.3e} (tol {LSE_ATOL:g}), dq {e_dq:.3e}, dk "
            f"{e_dk:.3e}, dv {e_dv:.3e} (tol {RTOL[dt]:g}*|want| + "
            f"{GRAD_FRAC:g}*max|want|)")
        check(x_out <= 0 and e_lse <= LSE_ATOL, f"{tag} fwd {what}")
        check(x_dq <= 0, f"{tag} dq {what}")
        check(x_dk <= 0 and x_dv <= 0, f"{tag} dkv {what}")
        for name, e in zip(names, (e_out, e_dq, max(e_dk, e_dv))):
            worst[name] = max(worst[name], e)
        del q, k, v, do, up, res, out, lse, dq, dk, dv, w_dk, w_dv
        torch.cuda.empty_cache()
    flash_gqa_check(gen, rope)
    if not rope:
        sdpa_route_check(gen)
    return worst


def sdpa_route_check(gen):
    """On the card, ``F.scaled_dot_product_attention`` at a head_dim or
    dtype the flash kernels are not built for (96 in bf16, 64 in fp16)
    takes the plain dense attention, as the reference's ``_sdpa_ref``, and
    equals it."""
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa

    for d, dt in ((96, torch.bfloat16), (64, torch.float16)):
        q, k, v = (torch.randn(2, 256, 4, d, generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        path = sdpa.LAST_PATH
        want = F.sdpa_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        say(f"kernel sdpa route D={d} {dt}: {path}")
        check(path == "reference" and torch.equal(got, want),
              f"sdpa at D={d} {dt} takes the plain dense attention")


def flash_gqa_check(gen, rope=False):
    """GQA 32/8 through the autograd Function (kernels, fp32) against the
    plain dense attention differentiated by autograd on the card; with
    ``rope`` the pre-rotary q and k are rotated in fp32 on the plain
    side."""
    import torch

    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.cuda import flash_attention as K

    b, s, h, hkv, d = 1, 512, 32, 8, 128
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    arrs = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    w = torch.randn(b, s, h, d, generator=gen, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in _rope_cache(s, d,
                                                                 10000.0))
    c2, s2 = K.widen_tables(cos, sin)

    def rot(x):  # fp32 rope on [B, S, H, D]
        return K.rope_rotate(x.transpose(1, 2), c2, s2).transpose(1, 2)

    if rope:
        fns = (lambda q, k, v: K.flash_attention_rope(q, k, v, cos, sin),
               lambda q, k, v: sdpa_reference(rot(q), rot(k), v,
                                              causal=True))
    else:
        fns = (lambda q, k, v: K.flash_attention(q, k, v, causal=True),
               lambda q, k, v: sdpa_reference(q, k, v, causal=True))
    got = []
    for fn in fns:
        ts = [a.clone().requires_grad_() for a in arrs]
        out = fn(*ts)
        (out * w).sum().backward()
        got.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    e_out, x_out = compare(got[0][0], got[1][0], "float32")
    errs = [compare_grad(a, b_, "float32") for a, b_ in zip(got[0][1:],
                                                            got[1][1:])]
    tag = "flash rope" if rope else "flash"
    say(f"kernel {tag} GQA {h}/{hkv} S={s} D={d} fp32 through the autograd "
        f"Function vs plain sdpa + autograd: out {e_out:.3e}, dq/dk/dv "
        f"{', '.join(f'{e:.3e}' for e, _ in errs)}")
    check(x_out <= 0 and all(x <= 0 for _, x in errs), f"{tag} GQA")


def phase_flash_times(gen, rope=False):
    """Phase 3b, at the training shape (llama_125m: B 16, H 12, S 1024,
    D 64, bf16, causal), without or with rope. Library:
    ``scaled_dot_product_attention`` forward on [B, H, S, D] (with rope, on
    q and k rotated beforehand, outside the timed call), and its autograd
    backward (dq, dk and dv together) beside dq and dkv. With rope the
    bound adds the two fp32 [S, D] tables to the bytes and the rotation of
    q and k (6 operations an element) to the operations."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda.flash_attention import rope_rotate

    b, h, s, d = 16, 12, 1024, 64
    bh, scale, el = b * h, d ** -0.5, 2
    fwd, bdq, bdkv, p_fwd, p_dq, p_dkv = flash_calls(rope, s, d)
    q, k, v, do = flash_inputs(gen, bh, s, d, torch.bfloat16)
    out, lse = fwd(q, k, v, scale, True)
    qk = (q, k)
    if rope:
        c2, s2 = rope_tables(s, d)
        qk = tuple(rope_rotate(t, c2, s2).to(t.dtype) for t in qk)
    lib = [t.view(b, h, s, d).clone().requires_grad_() for t in (*qk, v)]
    lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
    lib_do = do.view(b, h, s, d)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib, lib_do, retain_graph=True))
    fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *lib, is_causal=True))
    pairs = bh * s * (s + 1) // 2               # causal visible pairs
    tile = bh * s * d * el                      # one [B*H, S, D] tensor
    extra_b = 2 * s * d * 4 if rope else 0      # the fp32 tables
    extra_o = 2 * 6 * bh * s * d if rope else 0  # rotating q and k
    shape = f"B={b} H={h} S={s} D={d} bf16 causal" + (" rope" if rope
                                                      else "")
    res = (q, k, v, out, lse, do, scale, True)
    names = ROPE if rope else FLASH
    times = {
        names[0]: dict(
            ms=time_ms(lambda: fwd(q, k, v, scale, True)),
            plain_ms=time_ms(lambda: p_fwd(q, k, v, scale, True)),
            library_ms=fwd_ms, library="sdpa forward",
            bytes=4 * tile + bh * s * 4 + extra_b, ops=4 * d * pairs
            + extra_o),
        names[1]: dict(
            ms=time_ms(lambda: bdq(*res)),
            plain_ms=time_ms(lambda: p_dq(*res)),
            library_ms=bwd_ms, library="sdpa backward, dq+dk+dv",
            bytes=6 * tile + bh * s * 4 + extra_b, ops=6 * d * pairs
            + extra_o),
        names[2]: dict(
            ms=time_ms(lambda: bdkv(*res)),
            plain_ms=time_ms(lambda: p_dkv(*res)),
            library_ms=bwd_ms, library="sdpa backward, dq+dk+dv",
            bytes=7 * tile + bh * s * 4 + extra_b, ops=8 * d * pairs
            + extra_o)}
    for r in times.values():
        r["shape"] = shape
    report_times(times)
    # the forward's bf16 tensor-core products per visible pair: S (2 D;
    # with rope 3 products, the rotated q and k split: 6 D) and P V (P
    # split: 4 D)
    tc_fwd = (10 if rope else 6) * d
    f = times[names[0]]
    say(f"time {'flash rope' if rope else 'flash'} forward: kernel "
        f"{f['ms']:.4f} ms vs sdpa forward {fwd_ms:.4f} ms; achieved "
        f"{f['ops'] / f['ms'] / 1e9:.1f} TFLOP/s of the counted work; "
        f"tensor-core work with the splits ({tc_fwd // d}*D a pair): "
        f"{tc_fwd * pairs / f['ms'] / 1e9:.1f} TFLOP/s")
    bwd = times[names[1]]["ms"] + times[names[2]]["ms"]
    # the bf16 tensor-core bodies' products per visible pair: S, dP and
    # dq (dS split: 2 products) = 8 D; S, dP, dv and dk (P, dS split) =
    # 12 D; with rope S, dq and dk take 3 products (rotated q, k split)
    tc_ops = (14 * d, 18 * d) if rope else (8 * d, 12 * d)
    rates = [(times[n]["ops"] / times[n]["ms"] / 1e9,
              per * pairs / times[n]["ms"] / 1e9)
             for n, per in zip(names[1:], tc_ops)]
    say(f"time {'flash rope' if rope else 'flash'} backward: dq + dkv "
        f"kernels {bwd:.4f} ms vs sdpa backward {bwd_ms:.4f} ms; achieved "
        f"dq {rates[0][0]:.1f}, dkv {rates[1][0]:.1f} TFLOP/s of the counted "
        f"work; tensor-core work with the splits ({tc_ops[0] // d}*D, "
        f"{tc_ops[1] // d}*D a pair): dq {rates[0][1]:.1f}, dkv "
        f"{rates[1][1]:.1f} TFLOP/s")
    del q, k, v, do, out, lse, lib, lib_out, qk
    torch.cuda.empty_cache()
    return times


# -- MoE expert FFN, fused add + RMSNorm and fused add + LayerNorm ---------

MOE_SHAPE = (8, 5120, 768, 2048)     # Llama-MoE training: E, C, h, I
RMS_SHAPE = (16384, 768)             # 16 x 1024 tokens, hidden 768
RMS_EPS = 1e-5
LN_SHAPE = (16384, 768)              # BERT-base: 128 x 128 tokens, hidden 768
LN_EPS = 1e-12                       # BertConfig.layer_norm_eps


def moe_inputs(gen, e, c, h, i, dtype):
    """x [E, C, h] standard normal and Wg, Wu [E, h, I], Wd [E, I, h]
    from N(0, 0.02), as the model draws them, on the card."""
    import torch

    x = torch.randn(e, c, h, generator=gen, device="cuda").to(dtype)
    ws = [(torch.randn(*sh, generator=gen, device="cuda") * 0.02).to(dtype)
          for sh in ((e, h, i), (e, h, i), (e, i, h))]
    return x, ws


def rms_inputs(gen, rows, h, dtype):
    import torch

    x, y = (torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    return x, y, w


def ln_inputs(gen, rows, h, dtype):
    """x, y with a mean of 1 (so the variance's two passes matter), the
    weight near 1 and the bias near 0, on the card."""
    import torch

    x, y, w = rms_inputs(gen, rows, h, dtype)
    b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    return x + 1, y, w, b


def phase_fused_kernels(gen):
    """Phase 2c: the MoE expert FFN kernel and the fused add + RMSNorm
    kernel against their plain versions (fp32 on the exactly upcast
    inputs), at the Llama-MoE training shapes and at small ragged ones.
    Returns {kernel: max abs error}."""
    import torch

    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import rms_norm as RN

    worst = {"moe_ffn": 0.0, "fused_add_rms_norm": 0.0,
             "fused_add_layer_norm": 0.0}
    for (e, c, h, i), dt, what in ((MOE_SHAPE, "bfloat16", "training"),
                                   (MOE_SHAPE, "float32", "training fp32"),
                                   ((2, 20, 128, 384), "float32",
                                    "ragged C"),
                                   ((3, 20, 128, 100), "float32",
                                    "ragged C and I"),
                                   ((2, 20, 128, 384), "bfloat16",
                                    "ragged C"),
                                   ((3, 20, 128, 100), "bfloat16",
                                    "ragged C and I")):
        x, ws = moe_inputs(gen, e, c, h, i, getattr(torch, dt))
        got = MF.moe_ffn_cuda(x, *ws)
        err, excess = compare(got, MF.moe_ffn_plain(
            x.float(), *(w.float() for w in ws)), dt)
        torch.cuda.synchronize()
        say(f"kernel moe_ffn E={e} C={c} h={h} I={i} {dt} ({what}): "
            f"max_abs_err {err:.3e} (tol {ATOL:g} + {RTOL[dt]:g}*|want|)")
        check(excess <= 0, f"moe_ffn {what}")
        worst["moe_ffn"] = max(worst["moe_ffn"], err)
        del x, ws, got
    for (rows, h), dt in ((RMS_SHAPE, "bfloat16"), (RMS_SHAPE, "float32"),
                          ((37, 256), "bfloat16")):
        x, y, w = rms_inputs(gen, rows, h, getattr(torch, dt))
        out, r = RN.fused_add_rms_norm_cuda(x, y, w, RMS_EPS)
        _, w_r = RN.fused_add_rms_norm_plain(x, y, w, RMS_EPS)
        same_r = bool(torch.equal(r, w_r))
        # the norm in fp32 from the rounded residual, unrounded
        w_out, _ = RN.fused_add_rms_norm_plain(
            w_r.float(), torch.zeros_like(w_r, dtype=torch.float32),
            w.float(), RMS_EPS)
        err, excess = compare(out, w_out, dt)
        torch.cuda.synchronize()
        say(f"kernel fused_add_rms_norm {rows}x{h} {dt}: out max_abs_err "
            f"{err:.3e} (tol {ATOL:g} + {RTOL[dt]:g}*|want|), residual "
            f"identical: {same_r}")
        check(excess <= 0 and same_r, f"fused_add_rms_norm {rows}x{h} {dt}")
        worst["fused_add_rms_norm"] = max(worst["fused_add_rms_norm"], err)
    for (rows, h), dt in ((LN_SHAPE, "bfloat16"), (LN_SHAPE, "float32"),
                          ((37, 200), "bfloat16"), ((9, 13000), "float32")):
        x, y, w, b = ln_inputs(gen, rows, h, getattr(torch, dt))
        out, r = RN.fused_add_layer_norm_cuda(x, y, w, b, LN_EPS)
        _, w_r = RN.fused_add_layer_norm_plain(x, y, w, b, LN_EPS)
        same_r = bool(torch.equal(r, w_r))
        # the norm in fp32 from the rounded residual, unrounded
        w_out, _ = RN.fused_add_layer_norm_plain(
            w_r.float(), torch.zeros_like(w_r, dtype=torch.float32),
            w.float(), b.float(), LN_EPS)
        err, excess = compare(out, w_out, dt)
        torch.cuda.synchronize()
        say(f"kernel fused_add_layer_norm {rows}x{h} {dt}: out max_abs_err "
            f"{err:.3e} (tol {ATOL:g} + {RTOL[dt]:g}*|want|), residual "
            f"identical: {same_r}")
        check(excess <= 0 and same_r,
              f"fused_add_layer_norm {rows}x{h} {dt}")
        worst["fused_add_layer_norm"] = max(worst["fused_add_layer_norm"],
                                            err)
    torch.cuda.empty_cache()
    return worst


def moe_l2_bytes(e, c, h, i):
    """(all, weights): bytes the MoE kernel's bf16 body reads through L2 in
    one call. Each cluster (64 tokens, 768 output columns) reads its
    expert's three bf16 weights once and its x tile once per 128-column I
    tile (csrc/moe_ffn.cu)."""
    clusters = e * -(-c // 64) * -(-h // 768)
    weights = clusters * 3 * h * i * 2
    return weights + clusters * 2 * -(-i // 128) * 64 * h * 2, weights


def phase_fused_times(gen):
    """Phase 3c, at the Llama-MoE and BERT-base training shapes in bf16.
    Library: the expert FFN's composition in three ``torch.bmm`` calls (the
    [E, C, I] intermediates in device memory), and the residual add
    followed by ``torch.nn.functional.rms_norm`` or ``layer_norm``."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import rms_norm as RN

    e, c, h, i = MOE_SHAPE
    x, (gw, uw, dw) = moe_inputs(gen, e, c, h, i, torch.bfloat16)

    def moe_library():
        return torch.bmm(F.silu(torch.bmm(x, gw)) * torch.bmm(x, uw), dw)

    times = {"moe_ffn": dict(
        ms=time_ms(lambda: MF.moe_ffn_cuda(x, gw, uw, dw)),
        plain_ms=time_ms(lambda: MF.moe_ffn_plain(x, gw, uw, dw)),
        library_ms=time_ms(moe_library), library="3 x torch.bmm",
        bytes=2 * (2 * e * c * h + 3 * e * h * i), ops=3 * 2 * e * c * h * i,
        shape=f"E={e} C={c} h={h} I={i} bf16",
        note=f"{MF.moe_ffn_route(x.dtype)} body, L2 reads %d B of which "
             "weights %d B" % moe_l2_bytes(e, c, h, i))}
    del x, gw, uw, dw
    rows, h = RMS_SHAPE
    x, y, w = rms_inputs(gen, rows, h, torch.bfloat16)
    lib_rms = getattr(F, "rms_norm", None)
    times["fused_add_rms_norm"] = dict(
        ms=time_ms(lambda: RN.fused_add_rms_norm_cuda(x, y, w, RMS_EPS)),
        plain_ms=time_ms(lambda: RN.fused_add_rms_norm_plain(x, y, w,
                                                             RMS_EPS)),
        library_ms=None if lib_rms is None else time_ms(
            lambda: lib_rms(x + y, (h,), w, RMS_EPS)),
        library="x + y, then F.rms_norm", bytes=2 * (4 * rows * h + h),
        ops=5 * rows * h, shape=f"{rows}x{h} bf16")
    del x, y, w
    rows, h = LN_SHAPE
    x, y, w, b = ln_inputs(gen, rows, h, torch.bfloat16)
    times["fused_add_layer_norm"] = dict(
        ms=time_ms(lambda: RN.fused_add_layer_norm_cuda(x, y, w, b, LN_EPS)),
        plain_ms=time_ms(lambda: RN.fused_add_layer_norm_plain(x, y, w, b,
                                                               LN_EPS)),
        library_ms=time_ms(lambda: F.layer_norm(x + y, (h,), w, b, LN_EPS)),
        library="x + y, then F.layer_norm", bytes=2 * (4 * rows * h + 2 * h),
        ops=8 * rows * h, shape=f"{rows}x{h} bf16")
    del x, y, w, b
    torch.cuda.empty_cache()
    return report_times(times)


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
        "serve (same batch again)",
        mark=("paged_decode", "paged_multiquery"))
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


# -- Llama-MoE training with the fused switches -----------------------------

SWITCHES = ("PT_FUSED_MOE", "PT_FUSED_NORM", "PT_FUSED_ROPE")


@contextlib.contextmanager
def fused_switches(names=SWITCHES):
    """Set the fused switches ``names`` to "1" inside a ``with`` block and
    restore what was there before, whatever happens inside."""
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(dict.fromkeys(names, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def llama_moe_config():
    """The Llama-MoE of scripts/bench_moe_ffn.py:55-60: llama_125m's width
    with 8 layers, 8 experts, top-2 routing, MoE every 2nd layer."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(hidden_size=768, intermediate_size=2048,
                       num_hidden_layers=8, num_attention_heads=12,
                       num_key_value_heads=12, vocab_size=32000,
                       max_position_embeddings=1024, num_experts=8,
                       num_experts_per_tok=2, moe_every=2)


def kernel_modules():
    from paddle_tpu_torch.ops.cuda import (flash_attention, moe_ffn,
                                           paged_attention, rms_norm)

    return flash_attention, moe_ffn, paged_attention, rms_norm


def all_launch_counts():
    out = {}
    for mod in kernel_modules():
        out.update(mod.launch_counts())
    return out


def reset_all_launch_counts():
    for mod in kernel_modules():
        mod.reset_launch_counts()


def launches_want(**nonzero):
    """Every kernel wrapper's expected count: ``nonzero`` as given (by
    wrapper name), 0 for the rest."""
    want = dict.fromkeys(all_launch_counts(), 0)
    want.update(nonzero)
    return want


def phase_train_moe():
    """Phase 5b: the Llama-MoE (bf16, full width and depth, random weights
    from a seed) trained by ``fused_train_step`` with AdamW(1e-4) on one
    fixed 16 x 1024 batch with the three fused switches on: 2 warm-up and
    10 timed steps through ``FusedTrainStep.drive``, then one profiled
    step. Every new kernel launches exactly as often as the model calls
    it; the flash kernels without rope not at all. Returns the launch
    counts over the 12 steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_moe_config()
    batch, seq, warmup, steps = 16, 1024, 2, 10
    L = cfg.num_hidden_layers
    n_moe = L // cfg.moe_every
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=1e-4,
                                         parameters=model.parameters()))
    rng = np.random.RandomState(SEED + 6)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (batch, seq))).cuda()
                   for _ in range(2))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 237_933_312, f"Llama-MoE parameters {n_params}")
    # each token runs top_k of the E experts: count those weights only
    expert = 3 * cfg.hidden_size * cfg.intermediate_size
    active = n_params - n_moe * (cfg.num_experts
                                 - cfg.num_experts_per_tok) * expert
    flops_per_token = 6.0 * active + 12.0 * L * cfg.hidden_size * seq
    torch.cuda.synchronize()
    say(f"train-moe setup: Llama-MoE bf16 ({n_params} params, {active} "
        f"active per token), batch {batch} x {seq}, capacity "
        f"{model.llama.layers[1].mlp.capacity_factor}, in "
        f"{time.perf_counter() - t0:.2f} s")
    with fused_switches():
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        first = step.drive([(ids, labels)] * warmup, log_every=warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = step.drive([(ids, labels)] * steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        device_profile(lambda: step(ids, labels), "train-moe (one step)",
                       top=10, mark=("moe_ffn", "fused_add_rms_norm",
                                     "flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"))
    losses = first["loss"] + hist["loss"]
    n = warmup + steps
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls {losses}")
    want = launches_want(moe_ffn_cuda=n_moe * n,
                         fused_add_rms_norm_cuda=L * n,
                         **{f"{k}_cuda": L * n for k in ROPE})
    check(counts == want, f"Llama-MoE launches {counts} == {want}")
    tok_s = batch * seq * steps / wall
    say(f"train-moe Llama-MoE: losses {[round(x, 4) for x in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {tok_s:.0f} tokens/s, MFU "
        f"{tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']:.4f} "
        f"({flops_per_token / 1e6:.1f} MFLOP/token on the active "
        f"parameters vs 989 TFLOP/s), peak memory {peak:.2f} GiB, launches "
        f"{counts}")
    del model, step
    torch.cuda.empty_cache()
    return counts


def phase_train_moe_card_vs_cpu():
    """Phase 6c: fp32 llama_tiny with 4 experts (GQA 4/2, head_dim 32) and
    the three fused switches on, from the same numpy weights and batches,
    on the card (kernels) and on the CPU (plain versions). The routing of
    the first batch is compared first, exactly: a flipped top-k choice is
    a routing difference, reported as such. Then three fused AdamW steps
    give the same losses and parameters on both."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        moe_capacity, top_k_capacity_gating)
    from paddle_tpu_torch.models import (LlamaForCausalLM, LlamaMoE,
                                         load_paddle_tpu_state_dict,
                                         llama_tiny, to_numpy_state_dict)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny(num_experts=4)
    rng = np.random.RandomState(SEED + 7)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    batches = [tuple(rng.randint(0, cfg.vocab_size, (4, 128))
                     for _ in range(2)) for _ in range(3)]
    losses, params, routes = {}, {}, {}
    with fused_switches():
        for dev in ("cpu", "cuda"):
            model = LlamaForCausalLM(cfg, device=dev)
            load_paddle_tpu_state_dict(model, state)
            seen = []
            hooks = [m.register_forward_hook(
                lambda m, a, out: seen.append((m, a[0].detach())))
                for m in model.modules() if isinstance(m, LlamaMoE)]
            with torch.no_grad():
                model(torch.from_numpy(batches[0][0]).to(dev))
            for h in hooks:
                h.remove()
            routes[dev] = []
            for m, x in seen:
                t = x.shape[0] * x.shape[1]
                probs = torch.softmax(m.router(x).reshape(t, -1).float(), -1)
                routes[dev].append(top_k_capacity_gating(
                    probs, m.top_k, moe_capacity(
                        t, m.num_experts, m.top_k,
                        m.capacity_factor))[0].cpu())
            step = fused_train_step(model, AdamW(
                learning_rate=1e-3, epsilon=1e-6,
                parameters=model.parameters()))
            reset_all_launch_counts()
            losses[dev] = [float(step(*(torch.from_numpy(x).to(dev)
                                        for x in b))) for b in batches]
            if dev == "cuda":
                counts = all_launch_counts()
                L = cfg.num_hidden_layers
                want = launches_want(
                    moe_ffn_cuda=3 * (L // cfg.moe_every),
                    fused_add_rms_norm_cuda=3 * L,
                    **{f"{k}_cuda": 3 * L for k in ROPE})
                check(counts == want, f"tiny MoE launches {counts}")
            params[dev] = to_numpy_state_dict(model)
    flipped = sum(int((a != b).sum()) for a, b in zip(routes["cpu"],
                                                      routes["cuda"]))
    say(f"card vs cpu llama_tiny MoE routing of the first batch: "
        f"{sum(r.numel() for r in routes['cpu'])} top-k choices, {flipped} "
        "differ")
    check(flipped == 0, f"routing difference: {flipped} top-k choices "
          "flipped between the card and the CPU")
    dl = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
    dp = max(float(np.abs(params["cuda"][k] - params["cpu"][k]).max())
             for k in params["cpu"])
    say(f"card vs cpu training llama_tiny MoE fp32 with the fused switches, "
        f"3 AdamW steps: losses cuda {losses['cuda']} cpu {losses['cpu']}, "
        f"max rel diff {dl:.2e} (tol {TRAIN_LOSS_RTOL:g}); parameters max "
        f"abs diff {dp:.2e} (tol {TRAIN_PARAM_ATOL:g})")
    check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
          "card and CPU MoE training agree")


# -- BERT-base fine-tuning with the fused add + LayerNorm -------------------

BERT_PARAMS = 109_483_778


def bert_tiny_state(model, rng):
    """Random fp32 weights for ``model``'s state dict: LayerNorm weights
    near one, everything else N(0, 0.02)."""
    import numpy as np

    return {k: ((1 + 0.1 * rng.standard_normal(v.shape)) if "norm" in k
                and k.endswith(".weight") else
                rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in model.state_dict().items()}


def phase_train_bert():
    """Phase 5c: BERT-base sequence classification (bf16, full width and
    depth, random weights from a seed) fine-tuned as ``bench.py bert`` sets
    it up (``bench.py:401-466``: both dropouts 0, AdamW(2e-5) through
    ``fused_train_step`` with loss ``o[0]`` and labels by keyword) on one
    fixed 128 x 128 batch of random ids and labels, with ``PT_FUSED_NORM``
    on for this run only: 2 warm-up and 10 timed steps through
    ``FusedTrainStep.drive`` (dict batches), then one profiled step. The
    fused add + LayerNorm launches twice a layer a step, each flash kernel
    without rope once; no other kernel. Returns the launch counts over the
    12 steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_base)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_base(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    batch, seq, warmup, steps = 128, 128, 2, 10
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = BertForSequenceClassification(cfg, device="cuda",
                                          dtype=torch.bfloat16, seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=2e-5,
                                         parameters=model.parameters()),
                            loss_fn=lambda out: out[0])
    rng = np.random.RandomState(SEED + 8)
    data = {"input_ids": torch.from_numpy(
                rng.randint(0, cfg.vocab_size, (batch, seq))).cuda(),
            "labels": torch.from_numpy(
                rng.randint(0, cfg.num_labels, batch)).cuda()}
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == BERT_PARAMS, f"BERT-base parameters {n_params}")
    # PaLM-appendix accounting, as bench.py's _train_flops_per_token
    flops_per_token = 6.0 * n_params + 12.0 * L * cfg.hidden_size * seq
    torch.cuda.synchronize()
    say(f"train-bert setup: BERT-base bf16 ({n_params} params), batch "
        f"{batch} x {seq}, in {time.perf_counter() - t0:.2f} s")
    with fused_switches(("PT_FUSED_NORM",)):
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        first = step.drive([data] * warmup, log_every=warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = step.drive([data] * steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        device_profile(lambda: step(**data), "train-bert (one step)",
                       top=10, mark=("fused_add_layer_norm", "flash_fwd",
                                     "flash_bwd_dq", "flash_bwd_dkv"))
    losses = first["loss"] + hist["loss"]
    n = warmup + steps
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    want = launches_want(fused_add_layer_norm_cuda=2 * L * n,
                         **{f"{k}_cuda": L * n for k in FLASH})
    check(counts == want, f"BERT-base launches {counts} == {want}")
    tok_s = batch * seq * steps / wall
    say(f"train-bert BERT-base: losses {[round(x, 4) for x in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {tok_s:.0f} tokens/s, MFU "
        f"{tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']:.4f} "
        f"({flops_per_token / 1e6:.1f} MFLOP/token vs 989 TFLOP/s), peak "
        f"memory {peak:.2f} GiB, launches {counts}")
    del model, step, data
    torch.cuda.empty_cache()
    return counts


def phase_bert_card_vs_cpu():
    """Phase 6d: fp32 bert_tiny with ``PT_FUSED_NORM`` from the same numpy
    weights and batches on the card (kernels) and on the CPU (plain
    versions): three fused AdamW steps give the same losses and
    parameters; then one ``BertModel`` forward of a padded batch (the
    additive mask; plain dense attention on both) gives the same hidden
    states and pooled output."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         BertModel, bert_tiny,
                                         load_paddle_tpu_state_dict,
                                         to_numpy_state_dict)
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 9)
    state = bert_tiny_state(BertForSequenceClassification(cfg, device="cpu"),
                            rng)
    batches = [(rng.randint(0, cfg.vocab_size, (4, 128)),
                rng.randint(0, cfg.num_labels, 4)) for _ in range(3)]
    losses, params = {}, {}
    with fused_switches(("PT_FUSED_NORM",)):
        for dev in ("cpu", "cuda"):
            model = BertForSequenceClassification(cfg, device=dev)
            load_paddle_tpu_state_dict(model, state)
            step = fused_train_step(model, AdamW(
                learning_rate=1e-3, epsilon=1e-6,
                parameters=model.parameters()), loss_fn=lambda out: out[0])
            reset_all_launch_counts()
            losses[dev] = [float(step(torch.from_numpy(i).to(dev),
                                      labels=torch.from_numpy(l).to(dev)))
                           for i, l in batches]
            if dev == "cuda":
                counts = all_launch_counts()
                want = launches_want(fused_add_layer_norm_cuda=3 * 2 * L,
                                     **{f"{k}_cuda": 3 * L for k in FLASH})
                check(counts == want, f"bert_tiny launches {counts}")
            params[dev] = to_numpy_state_dict(model)
    dl = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
    dp = max(float(np.abs(params["cuda"][k] - params["cpu"][k]).max())
             for k in params["cpu"])
    say(f"card vs cpu training bert_tiny fp32 with PT_FUSED_NORM, 3 AdamW "
        f"steps: losses cuda {losses['cuda']} cpu {losses['cpu']}, max rel "
        f"diff {dl:.2e} (tol {TRAIN_LOSS_RTOL:g}); parameters max abs diff "
        f"{dp:.2e} (tol {TRAIN_PARAM_ATOL:g})")
    check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
          "card and CPU BERT training agree")
    enc = bert_tiny_state(BertModel(cfg, device="cpu"), rng)
    ids = rng.randint(0, cfg.vocab_size, (4, 128))
    mask = np.ones((4, 128), np.int64)
    mask[1:, 96:] = 0       # padding in the last quarter
    mask[3, 64:] = 0
    outs = {}
    for dev in ("cpu", "cuda"):
        model = BertModel(cfg, device=dev)
        load_paddle_tpu_state_dict(model, enc)
        with torch.no_grad():
            outs[dev] = [t.cpu() for t in model(
                torch.from_numpy(ids).to(dev),
                attention_mask=torch.from_numpy(mask).to(dev))]
        check(sdpa.LAST_PATH == "reference", f"masked attention on {dev} "
              f"took {sdpa.LAST_PATH}")
    dh = max(float((a - b).abs().max()) for a, b in zip(outs["cuda"],
                                                        outs["cpu"]))
    say(f"card vs cpu BertModel bert_tiny fp32, padded batch (additive "
        f"mask, plain dense attention): hidden and pooled max abs diff "
        f"{dh:.2e} (tol {TRAIN_PARAM_ATOL:g})")
    check(dh <= TRAIN_PARAM_ATOL, "card and CPU masked BERT forward agree")


def tensor_core_ptxas(built):
    """Registers and spills (``ptxas -v``) of each tensor-core kernel (the
    ``tcr`` namespace of moe_ffn.cu, paged_attention.cu and
    flash_attention.cu), and their dynamic shared memory from the sources'
    size functions."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    for stem in ("moe_ffn", "paged_attention", "flash_attention"):
        for entry in built[stem][1].split("Compiling entry function '")[1:]:
            name = entry.split("'")[0]
            if "tcr" not in name:
                continue
            regs = entry.split("Used ")[1].split()[0]
            spill = next(ln.strip() for ln in entry.splitlines()
                         if "spill stores" in ln)
            say(f"  ptxas {name}: {regs} registers, {spill}")
    tc = ", ".join(f"D={d} {kv}: {K.multiquery_tc_smem_bytes(d, kv)} B"
                   for d in K.TC_HEAD_DIMS
                   for kv in (torch.bfloat16, torch.int8))
    fa = ", ".join(f"{w}{' rope' if r else ''} D={d}: "
                   f"{FA.tc_smem_bytes(w, d, r)} B"
                   for w in ("fwd", "dq", "dkv") for r in (False, True)
                   for d in FA.HEAD_DIMS)
    say(f"  dynamic shared memory: moe_ffn_bf16_kernel "
        f"{MF._lib().moe_ffn_smem_bytes(768, 1)} B; "
        f"paged_multiquery_tc_kernel {tc}; flash_*_tc_kernel {fa}")


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
    tensor_core_ptxas(built)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = phase_kernels(gen)
    worst.update(phase_flash_kernels(gen))
    worst.update(phase_flash_kernels(gen, rope=True))
    worst.update(phase_fused_kernels(gen))
    times = phase_times(gen)
    times.update(phase_flash_times(gen))
    times.update(phase_flash_times(gen, rope=True))
    times.update(phase_fused_times(gen))
    # each kernel's launches from the main path that runs it
    counts = phase_serve()
    train = phase_train()
    counts.update({f"{n}_cuda": train[f"{n}_cuda"] for n in FLASH})
    moe = phase_train_moe()
    counts.update({k: moe[k] for k in ("moe_ffn_cuda",
                                       "fused_add_rms_norm_cuda",
                                       *(f"{n}_cuda" for n in ROPE))})
    bert = phase_train_bert()
    counts["fused_add_layer_norm_cuda"] = bert["fused_add_layer_norm_cuda"]
    phase_card_vs_cpu()
    phase_train_card_vs_cpu()
    phase_train_moe_card_vs_cpu()
    phase_bert_card_vs_cpu()
    sources = {"paged": "paddle_tpu_torch/csrc/paged_attention.cu",
               "flash": "paddle_tpu_torch/csrc/flash_attention.cu",
               "moe": "paddle_tpu_torch/csrc/moe_ffn.cu",
               "fused": "paddle_tpu_torch/csrc/rms_norm.cu"}
    fa = "paddle_tpu/ops/pallas/flash_attention.py"
    replaces = {
        "paged_decode_attention": "paddle_tpu/ops/pallas/paged_attention.py:157",
        "paged_multiquery_attention":
            "paddle_tpu/ops/pallas/paged_attention.py:278",
        "flash_attention_fwd": f"{fa}:136",
        "flash_attention_bwd_dq": f"{fa}:280",
        "flash_attention_bwd_dkv": f"{fa}:296",
        # the same three kernels with rope=True, under _flash_mha_rope
        "flash_attention_rope_fwd": f"{fa}:348",
        "flash_attention_rope_bwd_dq": f"{fa}:348",
        "flash_attention_rope_bwd_dkv": f"{fa}:348",
        "fused_add_rms_norm": "paddle_tpu/ops/pallas/rms_norm.py:66",
        "fused_add_layer_norm": "paddle_tpu/ops/pallas/rms_norm.py:155",
        "moe_ffn": "paddle_tpu/ops/pallas/moe_ffn.py:72"}
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
