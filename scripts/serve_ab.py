#!/usr/bin/env python3
"""Serving end to end, two checkouts in turns on one card.

    python3 scripts/serve_ab.py DIR [DIR ...]

Needs one NVIDIA GPU and nvcc. Each DIR is a checkout of the repository
(say the parent commit unpacked by ``git archive`` into a git-ignored
directory, and this tree); give them in the order to run, for an A/B
``parent change change parent``. For each, in a fresh process with that
checkout's code, it builds the paged-attention kernels and runs
chip_smoke.py's serving phase (llama_1b, bf16, 8 greedy requests of 32
new tokens, launch-count checks and one profiled repeat), and prints that
phase's ``serve`` and ``profile serve`` lines under the directory's name.
Prints the card's name and power limit first. Host-bound runs spread
between processes, so compare only within one call, in turns.
"""

from __future__ import annotations

import os
import subprocess
import sys

RUN = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.ops.cuda import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all([_build.CSRC + "/paged_attention.cu"])
cs.phase_serve()
"""
KEEP = ("serve llama", "profile serve", "  paged_")


def main():
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                              capture_output=True, text=True, timeout=900)
        print(f"== {d} (exit {proc.returncode})", flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith(KEEP):
                print(line, flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
