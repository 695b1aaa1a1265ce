#!/usr/bin/env python3
"""Where the split-KV paged decode body spends its time.

    python3 scripts/paged_decode_ablation.py [--out DIR]

Needs one NVIDIA Hopper GPU and nvcc. Builds copies of
``paddle_tpu_torch/csrc/paged_attention.cu`` with the decode body's
constants changed or a part of its work cut out, and times the decode
entry (split kernel and combine) at chip_smoke.py's phase-3 shape (B 8,
H = Hkv 16, D 128, block 16, P 128, ragged contexts summing to 9916
tokens, bf16 q; bf16 and int8 pools) with chip_smoke.py's CUDA-event
timer, two rounds of the variants in turn:

    full        the body as it stands (kSplit 256, 2 stages, 1 row of a
                sub-warp a stage, 16 elements a lane for one query head,
                the combine launched as a programmatic dependent)
    one_span    kSplit 2048: one block per (request, kv head), n_split 1
    one_stage   a ring of one stage: each warp waits for every copy
    stages_3    a ring of three stages
    rows_2      2 rows of a sub-warp in one stage (twice the bytes)
    lanes_8     8 elements a lane (16 B of bf16): twice the lanes a row
    split_128   kSplit 128
    split_512   kSplit 512
    no_pdl      the combine launched plainly, after the split kernel ends
    no_combine  without the combine kernel (out is not written)
    no_math     the stream alone: no score, softmax or P V
    no_stream   the arithmetic alone, on whatever shared memory holds

The last three are wrong by design and only their times are read; the
others compute the output. Each line prints its error against the plain
version. The copies are built under
``--out`` (default ``paddle_tpu_torch/csrc/build/ablation_decode``, which
git ignores). Prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from flash_bwd_ablation import build  # noqa: E402

SPLIT = "constexpr int kSplit = 256;"
STAGES = "constexpr int kStages = 2;"
ROWS = "constexpr int kRows = 1;"
LANES = ("return GR == 1 && sizeof(KVT) < 4 ? 16 : 8;", "return 8;")
MATH = ("    consume(j);\n", "")
STREAM = (("    if (j < n_steps) issue(j);\n", ""),
          ("    if (j + kStages - 1 < n_steps) issue(j + kStages - 1);\n", ""))
COMBINE = ("""  const cudaError_t e =
      p.q_dtype == kBF16
          ? cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<__nv_bfloat16>,
                               p, B)
          : cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<float>, p, B);
""", "  const cudaError_t e = cudaSuccess;\n")
PDL = ("attr[0].val.programmaticStreamSerializationAllowed = 1;",
       "attr[0].val.programmaticStreamSerializationAllowed = 0;")
CUTS = {"full": (),
        "one_span": ((SPLIT, SPLIT.replace("256", "2048")),),
        "one_stage": ((STAGES, STAGES.replace("2", "1")),),
        "stages_3": ((STAGES, STAGES.replace("2", "3")),),
        "rows_2": ((ROWS, ROWS.replace("1", "2")),),
        "lanes_8": (LANES,),
        "split_128": ((SPLIT, SPLIT.replace("256", "128")),),
        "split_512": ((SPLIT, SPLIT.replace("256", "512")),),
        "no_pdl": (PDL,),
        "no_combine": (COMBINE,),
        "no_math": (MATH,),
        "no_stream": STREAM}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "paddle_tpu_torch", "csrc", "build", "ablation_decode"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("paged_decode_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda.paged_attention import _DTYPE_CODE

    libs = build(args.out, CUTS, stem="paged_attention")
    H = Hkv = 16
    B, D, bs, P = 8, 128, 16, 128
    lens = np.random.RandomState(cs.SEED + 1).randint(64, bs * P + 1, B)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = {kv: cs.Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                         q_dtype="bfloat16", kv=kv, lens=lens)
             for kv in ("bfloat16", "int8")}
    want = {kv: cs.decode_plain(c, upcast=True) for kv, c in cases.items()}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.paged_decode_split_tokens.restype = i32
        fn = lib.paged_decode_attention_launch
        fn.argtypes = [ptr] * 9 + [i32] * 9 + [ctypes.c_float, ptr]
        n_split = -(-bs * P // lib.paged_decode_split_tokens())
        for kv, c in cases.items():
            k, v, ks, vs = c.pools()
            out = torch.zeros_like(c.q)
            work = torch.empty(B, H, n_split, D + 2, dtype=torch.float32,
                               device="cuda")
            ptrs = [c.q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if ks is None else ks.data_ptr(),
                    None if vs is None else vs.data_ptr(),
                    c.tables.data_ptr(), c.lens.data_ptr(), out.data_ptr(),
                    work.data_ptr()]

            def call(fn=fn, ptrs=ptrs, out=out, n_split=n_split, kv=kv):
                err = fn(*ptrs, B, H, Hkv, D, bs, P, n_split,
                         _DTYPE_CODE[torch.bfloat16],
                         _DTYPE_CODE[getattr(torch, kv)], D ** -0.5,
                         stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return out

            calls[name, kv] = call
    tokens = int(lens.sum())
    for rnd in range(2):
        for (name, kv), call in calls.items():
            err, _ = cs.compare(call().nan_to_num(), want[kv], "bfloat16")
            ms = cs.time_ms(call)
            row = D * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
            gbs = 2 * tokens * Hkv * row / ms / 1e6
            print(f"round {rnd} {name} {kv}: {ms:.4f} ms, {gbs:.1f} GB/s of "
                  f"K/V (B={B} H={H} D={D} bs={bs} ctx_sum={tokens}; "
                  f"max_abs_err {err:.3e})", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
