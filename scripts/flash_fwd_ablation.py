#!/usr/bin/env python3
"""Where the flash-attention forward's bf16 tensor-core body spends its
time.

    python3 scripts/flash_fwd_ablation.py [--out DIR]

Needs one NVIDIA Hopper GPU and nvcc. Builds copies of
``paddle_tpu_torch/csrc/flash_attention.cu`` with parts of the tensor-core
forward's work cut out (the cuts of ``scripts/flash_bwd_ablation.py``
where the forward shares the backward's lines), and times the forward
kernel, without and with rope, at the dense training shape (B 16, H 12,
S 1024, D 64, bf16, causal) with chip_smoke.py's CUDA-event timer, two
rounds of the variants in turn:

    full        the kernel as it stands
    no_lo       without the lo products (P lo; with rope also the rotated
                q and k lo)
    no_exp      p = t - m2 itself: no exp2 in the online softmax
    no_stream   without the cp.async stream of the next K and V tiles
                (products on stale tiles)
    no_rope     with rope, without re-staging (rotating) the next K tile:
                the same tile is used again
    no_mma      without any tensor-core product

Only ``full`` computes the output: the others are wrong by design, and
only their times are read (each line prints the error against the plain
version all the same). The copies are built under ``--out`` (default
``paddle_tpu_torch/csrc/build/ablation_fwd``, which git ignores). Prints
the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import flash_bwd_ablation as bwd  # noqa: E402

EXP = (("float pr = exp2f(sc[nt][e] - mx[e >> 1]);",
        "float pr = sc[nt][e] - mx[e >> 1];"),)
CUTS = {"full": (), "no_lo": bwd.LO, "no_exp": EXP,
        "no_stream": bwd.STREAM[:1], "no_rope": bwd.ROPE[:1],
        "no_mma": bwd.MMA}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "paddle_tpu_torch", "csrc", "build", "ablation_fwd"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    libs = bwd.build(args.out, CUTS)
    b, h, s, d = 16, 12, 1024, 64
    bh, scale = b * h, d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, _ = cs.flash_inputs(gen, bh, s, d, torch.bfloat16)
    c2, s2 = cs.rope_tables(s, d)
    up = (q.float(), k.float(), v.float())
    want = {False: FA.flash_attention_fwd_plain(*up, scale, True)[0],
            True: FA.flash_attention_rope_fwd_plain(*up, c2, s2, scale,
                                                    True)[0]}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = ctypes.c_void_p
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for rope in (False, True):
            tabs = [t.data_ptr() for t in ((c2, s2) if rope else ())]
            pre = "flash_attention_rope_" if rope else "flash_attention_"
            fn = getattr(lib, f"{pre}fwd_launch")
            fn.argtypes = ([ptr] * (5 + len(tabs)) + [ctypes.c_int] * 4
                           + [ctypes.c_float] + [ctypes.c_int] * 2 + [ptr])
            out = torch.empty_like(q)
            lse = torch.empty(bh, s, dtype=torch.float32, device="cuda")
            ptrs = ([t.data_ptr() for t in (q, k, v, out, lse)] + tabs)

            def call(fn=fn, ptrs=ptrs, out=out):
                err = fn(*ptrs, bh, s, d, 1, scale, 1, 1, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return out

            calls[name, rope] = call
    for rnd in range(2):
        for (name, rope), call in calls.items():
            if name == "no_rope" and not rope:
                continue
            err, _ = cs.compare(call().nan_to_num(), want[rope], "bfloat16")
            ms = cs.time_ms(call)
            print(f"round {rnd} {name} fwd{' rope' if rope else ''}: "
                  f"{ms:.4f} ms (B={b} H={h} S={s} D={d} bf16 causal; "
                  f"max_abs_err {err:.3e})", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
