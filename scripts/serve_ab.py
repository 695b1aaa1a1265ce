#!/usr/bin/env python3
"""One phase of chip_smoke.py end to end, two checkouts in turns on one
card.

    python3 scripts/serve_ab.py [--phase serve|deepfm] DIR [DIR ...]

Needs one NVIDIA GPU (and nvcc for ``serve``). Each DIR is a checkout of
the repository (say the parent commit unpacked by ``git archive`` into a
git-ignored directory, and this tree); give them in the order to run, for
an A/B ``parent change change parent``. For each, in a fresh process with
that checkout's code, it runs the phase and prints the phase's lines under
the directory's name:

- ``serve`` (the default): builds the paged-attention kernels and runs
  the serving phase (llama_1b, bf16, 8 greedy requests of 32 new tokens,
  launch-count checks and one profiled repeat): its ``serve`` and
  ``profile serve`` lines;
- ``deepfm``: phase 8a, DeepFM at the criteo width through ``drive``
  (lazy, dense, lazy, dense; no kernel of the repo's runs): its ``deepfm
  criteo`` and ``profile deepfm`` lines.

Prints the card's name and power limit first. Host-bound runs spread
between processes, so compare only within one call, in turns.
"""

from __future__ import annotations

import os
import subprocess
import sys

HEAD = """
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
"""
PHASES = {
    "serve": (HEAD + """
from paddle_tpu_torch.ops.cuda import _build
_build.build_all([_build.CSRC + "/paged_attention.cu"])
cs.phase_serve()
""", ("serve llama", "profile serve", "  paged_")),
    "deepfm": (HEAD + """
cs.phase_deepfm_criteo()
""", ("deepfm criteo", "profile deepfm")),
}


def main():
    args = sys.argv[1:]
    phase = "serve"
    if args[:1] == ["--phase"]:
        phase, args = args[1], args[2:]
    if not args or phase not in PHASES:
        print(__doc__, file=sys.stderr)
        return 2
    run, keep = PHASES[phase]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    for d in args:
        proc = subprocess.run([sys.executable, "-c", run], cwd=d,
                              capture_output=True, text=True, timeout=900)
        print(f"== {d} (exit {proc.returncode})", flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith(keep):
                print(line, flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
