#!/usr/bin/env python3
"""Where the MoE expert FFN kernel's bf16 body spends its time.

    python3 scripts/moe_ffn_ablation.py [--out DIR]

Needs one NVIDIA Hopper GPU and nvcc. Builds copies of
``paddle_tpu_torch/csrc/moe_ffn.cu`` with parts of the bf16 body's work
cut out, and times each at the Llama-MoE training shape (E 8, C 5120,
h 768, I 2048, bf16) with chip_smoke.py's CUDA-event timer, two rounds in
turn:

    full            the kernel as it stands
    no_lo           without the act_lo Wd products (the split's half)
    no_down         without any Wd product
    no_gu           without the g and u products
    no_mma          without any tensor-core product
    no_loads        without the cp.async stream (products on stale tiles)
    no_loads_no_mma ldmatrix, barriers and the epilogues only

Only ``full`` computes the FFN: the others are wrong by design, and only
their times are read (each line prints the error against the plain
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

LO = "              tc::mma_bf16(acc[mi][2 * np + hf], al[mi], b + 2 * hf);\n"
HI = "              tc::mma_bf16(acc[mi][2 * np + hf], ah[mi], b + 2 * hf);\n"
GU = ("            tc::mma_bf16(g[mi][ni], a[mi], bg + 2 * ni);\n"
      "            tc::mma_bf16(u[mi][ni], a[mi], bu + 2 * ni);\n")
LOADS = "    if (n + kStages - 1 < total) load_chunk(n + kStages - 1);"
CUTS = {"full": (), "no_lo": (LO,), "no_down": (LO, HI), "no_gu": (GU,),
        "no_mma": (LO, HI, GU), "no_loads": (LOADS,),
        "no_loads_no_mma": (LOADS, LO, HI, GU)}


def build(out_dir):
    """Build every variant at once; returns {name: library path}."""
    from paddle_tpu_torch.ops.cuda import _build

    src = open(os.path.join(_build.CSRC, "moe_ffn.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(_build.CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, f), out_dir)
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for cut in cuts:
            if cut not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{cut.strip()!r}; update this script")
            text = text.replace(cut, "")
        path = os.path.join(out_dir, f"moe_ffn_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
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
        print("moe_ffn_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF

    libs = build(args.out)
    e, c, h, i = cs.MOE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x, ws = cs.moe_inputs(gen, e, c, h, i, torch.bfloat16)
    want = MF.moe_ffn_plain(x.float(), *(w.float() for w in ws))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.moe_ffn_launch.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        out = torch.empty_like(x)

        def call(lib=lib, out=out):
            err = lib.moe_ffn_launch(*(t.data_ptr() for t in (x, *ws, out)),
                                     e, c, h, i, 1, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out

        calls[name] = call
    for rnd in range(2):
        for name, call in calls.items():
            err, _ = cs.compare(call().nan_to_num(), want, "bfloat16")
            ms = cs.time_ms(call)
            print(f"round {rnd} {name}: {ms:.4f} ms (E={e} C={c} h={h} "
                  f"I={i} bf16; max_abs_err {err:.3e})", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
