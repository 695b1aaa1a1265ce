#!/usr/bin/env python3
"""How often ``torch.profiler`` misses kernel records of CUDA graph replays
on the card, and where in the run they go missing.

    python3 scripts/profiler_count_check.py [repeats]

Sets up ``chip_smoke.py`` phase 11a's decode engine (llama_1b bf16, the
serving cell's pool, windows of 8, eight handed-off requests) and profiles
its decode of the same pages ``repeats`` times (default 6) under each
setting, in turns: CPU + CUDA activity (``device_profile``'s), CUDA only,
CUDA only with a warm-up inside the profile before the run (one kernel, a
sync and 50 ms), and CUDA only with 50 ms after the run's sync before the
profile stops. Each line gives the split-KV decode kernel's launches the
wrapper counted (graph replays included) against the records the
profiler returned, the host-to-device copies it recorded (the run's page
imports come first), and the run's device ops. Needs one card.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402


def main(repeats=6):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_1b
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    if not torch.cuda.is_available():
        print("profiler_count_check: needs a CUDA device", file=sys.stderr)
        return 1
    print(S.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama_1b()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=S.SEED)
    prompts = S.serve_prompts(cfg.vocab_size)
    kw = dict(S.DISAGG_ENGINE, device="cuda")
    pre = LLMEngine(model, prefill_only=True, **kw)
    dec = LLMEngine(model, **kw)
    try:
        warm = [S.warmup_prompt(cfg.vocab_size)]
        S.decode_handoffs(dec, S.prefill_handoffs(pre, warm, "cuda")[0])
        handoffs, _ = S.prefill_handoffs(pre, prompts, "cuda")
        cuda = [ProfilerActivity.CUDA]
        sets = {"cpu+cuda": ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             False, False),
                "cuda": (cuda, False, False),
                "cuda+warm": (cuda, True, False),
                "cuda+tail": (cuda, False, True)}
        missed = dict.fromkeys(sets, 0)
        for k in range(repeats):
            for name, (acts, warm_up, tail) in sets.items():
                K.reset_launch_counts()
                with profile(activities=acts) as prof:
                    if warm_up:
                        torch.ones(1, device="cuda").add_(1)
                        torch.cuda.synchronize()
                        time.sleep(0.05)
                    S.decode_handoffs(dec, handoffs)
                    torch.cuda.synchronize()
                    if tail:
                        time.sleep(0.05)
                counted = K.launch_counts()["paged_decode_attention_cuda"]
                dev = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
                seen = sum("paged_decode_split_kernel" in e.name
                           for e in dev)
                h2d = sum("Memcpy HtoD" in e.name for e in dev)
                missed[name] += seen != counted
                print(f"repeat {k} {name}: wrapper {counted}, profiler "
                      f"{seen}, HtoD copies {h2d}, {len(dev)} device ops")
        print("runs with records missing: " + ", ".join(
            f"{name} {n} of {repeats}" for name, n in missed.items()))
    finally:
        pre.close()
        dec.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))
