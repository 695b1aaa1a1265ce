#!/usr/bin/env python3
"""Where the flash-attention backward's bf16 tensor-core bodies spend their
time.

    python3 scripts/flash_bwd_ablation.py [--out DIR]

Needs one NVIDIA Hopper GPU and nvcc. Builds copies of
``paddle_tpu_torch/csrc/flash_attention.cu`` with parts of the tensor-core
bodies' work cut out, and times the dq and dk/dv kernels, without and with
rope, at the dense training shape (B 16, H 12, S 1024, D 64, bf16, causal)
with chip_smoke.py's CUDA-event timer, two rounds of the variants in turn:

    full        the kernels as they stand
    no_lo       without the lo products (P and dS lo; with rope also the
                rotated q and k lo)
    no_exp      p = the scaled score itself: no exp2 in the epilogue
    no_delta    dkv without its per-tile delta = rowsum(dO O)
    no_stream   without the cp.async stream of the next tile (products
                on stale tiles)
    no_rope     with rope, without re-staging (rotating) the next q or k
                tile: the same tile is used again
    no_mma      without any tensor-core product

Only ``full`` computes the gradients: the others are wrong by design, and
only their times are read (each line prints the error against the plain
version all the same). The copies are built under ``--out`` (default
``paddle_tpu_torch/csrc/build/ablation``, which git ignores). Prints the
card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LO = ("      tc::mma_bf16(acc[2 * dp], al, bb);\n",
      "      tc::mma_bf16(acc[2 * dp + 1], al, bb + 2);\n",
      "        dots<D, NC>(qw, kt + TILE + c0 * LD, sc);\n",
      "        dots<D, NC>(qw + TILE, kt + c0 * LD, sc);\n",
      "        dots<D, NC>(kw, qt + TILE + c0 * LD, sc);\n",
      "        dots<D, NC>(kw + TILE, qt + c0 * LD, sc);\n")
# (old, new) replacements; a plain string is cut out
EXP = (("float pr = exp2f(fmaf(sc[nt][e], sl2, -lse2_r[hf]));",
        "float pr = fmaf(sc[nt][e], sl2, -lse2_r[hf]);"),
       ("float pr = exp2f(fmaf(sc[nt][e], sl2, -lse_t[col] * kLog2e));",
        "float pr = fmaf(sc[nt][e], sl2, -lse_t[col] * kLog2e);"))
DELTA = "    row_deltas<D>(ob + st * TILE, dot, delta_s + st * kCols);\n"
STREAM = (("      if constexpr (!ROPE) issue_rows<D>(k, k0 + kCols, S, "
           "kb + (st ^ 1) * TILE);\n      issue_rows<D>(v, k0 + kCols, S, "
           "vb + (st ^ 1) * TILE);\n", ""),
          ("    if (j + 1 < n_tiles) issue(j + 1, st ^ 1);\n", ""))
ROPE = (("        stage_rope<D>(k, p.cs, p.sn, k0 + kCols, S, kn, kn + TILE);\n",
         ""),
        ("        stage_rope<D>(q, p.cs, p.sn, q0 + kCols, S, qn, qn + TILE);\n",
         ""))
MMA = (("// delta[r] = sum_d O[r, d] dO[r, d]",
        "__device__ __forceinline__ void mma_cut(float*, const uint32_t*,\n"
        "                                        const uint32_t*) {}\n\n"
        "// delta[r] = sum_d O[r, d] dO[r, d]"),
       ("tc::mma_bf16(", "mma_cut("))
CUTS = {"full": (), "no_lo": LO, "no_exp": EXP, "no_delta": (DELTA,),
        "no_stream": STREAM, "no_rope": ROPE, "no_mma": MMA}


def variant_source(src, cuts):
    for cut in cuts:
        old, new = (cut, "") if isinstance(cut, str) else cut
        if old not in src:
            raise RuntimeError(f"the source no longer holds {old.strip()!r}"
                               "; update this script")
        src = src.replace(old, new)
    return src


def build(out_dir, variants=None, stem="flash_attention"):
    """Build every variant ({name: cuts}, default ``CUTS``) of
    ``csrc/<stem>.cu`` at once; returns {name: library path}."""
    from paddle_tpu_torch.ops.cuda import _build

    src = open(os.path.join(_build.CSRC, stem + ".cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(_build.CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, f), out_dir)
    procs = {}
    for name, cuts in (CUTS if variants is None else variants).items():
        path = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, cuts))
        lib = path[:-3] + ".so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "paddle_tpu_torch", "csrc", "build", "ablation"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    libs = build(args.out)
    b, h, s, d = 16, 12, 1024, 64
    bh, scale = b * h, d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, do = cs.flash_inputs(gen, bh, s, d, torch.bfloat16)
    c2, s2 = cs.rope_tables(s, d)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = ctypes.c_void_p
    want, fwd = {}, {}
    for rope in (False, True):
        tabs = (c2, s2) if rope else ()
        fwd[rope] = (FA.flash_attention_rope_fwd_cuda(q, k, v, c2, s2,
                                                      scale, True) if rope
                     else FA.flash_attention_fwd_cuda(q, k, v, scale, True))
        out, lse = fwd[rope]
        up = (q.float(), k.float(), v.float(), out.float(), lse, do.float())
        plain = (FA.flash_attention_rope_bwd_dq_plain if rope
                 else FA.flash_attention_bwd_dq_plain)
        want[rope, "dq"] = plain(*up, *tabs, scale, True)
        plain = (FA.flash_attention_rope_bwd_dkv_plain if rope
                 else FA.flash_attention_bwd_dkv_plain)
        want[rope, "dkv"] = plain(*up, *tabs, scale, True)[0]  # dk
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for rope in (False, True):
            out, lse = fwd[rope]
            tabs = [t.data_ptr() for t in ((c2, s2) if rope else ())]
            pre = "flash_attention_rope_" if rope else "flash_attention_"
            for kind, n_out in (("dq", 1), ("dkv", 2)):
                fn = getattr(lib, f"{pre}bwd_{kind}_launch")
                fn.argtypes = ([ptr] * (6 + n_out + len(tabs))
                               + [ctypes.c_int] * 4
                               + [ctypes.c_float] + [ctypes.c_int] * 2
                               + [ptr])
                res = [torch.empty_like(q) for _ in range(n_out)]
                ptrs = ([t.data_ptr() for t in (q, k, v, out, do)]
                        + [lse.data_ptr()] + [t.data_ptr() for t in res]
                        + tabs)

                def call(fn=fn, ptrs=ptrs, res=res):
                    err = fn(*ptrs, bh, s, d, 1, scale, 1, 1, stream)
                    if err:
                        raise RuntimeError(f"launch failed: cudaError {err}")
                    return res[0]

                calls[name, rope, kind] = call
    for rnd in range(2):
        for (name, rope, kind), call in calls.items():
            if name == "no_rope" and not rope:
                continue
            if name == "no_delta" and kind == "dq":
                continue
            err, _ = cs.compare_grad(call().nan_to_num(), want[rope, kind],
                                     "bfloat16")
            ms = cs.time_ms(call)
            print(f"round {rnd} {name} {kind}{' rope' if rope else ''}: "
                  f"{ms:.4f} ms (B={b} H={h} S={s} D={d} bf16 causal; "
                  f"max_abs_err {err:.3e})", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
