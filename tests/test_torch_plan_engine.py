"""``LLMEngine(plan=)``: Megatron tensor parallelism over two gloo
processes on the CPU, held against the port's unplanned engine and the
reference's planned engine on fp32 llama_tiny with weights from a numpy
seed.

One launch of two rank processes (this file run as a script, joined by
``distributed.init_parallel_env`` over gloo, each group and process with
its own timeout) runs every multi-process case and writes each rank's
results; the tests read them. Tokens are held equal (greedy, fp32) and
logits within ``LOGIT_ATOL``: the row-parallel ``all_reduce`` sums the
two ranks' partial products in another order than one GEMM does. A
degree-1 plan runs in this process and must be the unplanned engine
exactly."""

import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 logits, the tp=2 engine against one process: the row-parallel
# partial sums change the summation order of o_proj, down_proj and the
# head (tokens stay equal)
LOGIT_ATOL = 1e-5
ENGINE = dict(num_blocks=16, block_size=8, max_batch_size=2,
              max_model_len=64, ingest_async=False)
NEW = 8
WORKER_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 60


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(1, 512, n).astype(np.int32) for n in (8, 13, 21)]


def _ref_state(seed):
    """A reference llama_tiny's weights (numpy), from ``paddle.seed``."""
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaForCausalLM, llama_tiny

    paddle.seed(seed)
    model = LlamaForCausalLM(llama_tiny())
    model.eval()
    return model, {k: np.asarray(v._data)
                   for k, v in model.state_dict().items()}


def _port_model(state, device="cpu", **cfg):
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         load_paddle_tpu_state_dict)

    model = LlamaForCausalLM(llama_tiny(**cfg), device=device, seed=0)
    load_paddle_tpu_state_dict(model, state)
    return model


def _ref_moe_state(seed):
    """A reference Llama-MoE llama_tiny's weights (4 experts, numpy)."""
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaForCausalLM, llama_tiny

    paddle.seed(seed)
    model = LlamaForCausalLM(llama_tiny(num_experts=4))
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _serve(eng, prompts, new=NEW, **sampling):
    """Tokens and the logits row each token was sampled from (per step,
    ``capture_logits``), request by request."""
    from paddle_tpu_torch.inference.serving import SamplingParams

    rids = [eng.add_request(p, SamplingParams(max_new_tokens=new,
                                              **sampling)) for p in prompts]
    logits = {r: [] for r in rids}
    while eng.has_work():
        for out in eng.step():
            row = eng.request(out.rid).last_logits
            if out.token >= 0 and row is not None:
                logits[out.rid].append(np.array(row))
    toks = [eng.output_tokens(r).tolist() for r in rids]
    for r in rids:
        eng.release(r)
    return toks, [np.stack(logits[r]).tolist() if logits[r] else []
                  for r in rids]


# ---------------------------------------------------------------------------
# the rank process
# ---------------------------------------------------------------------------

def _rank_main(rank, port, work):
    import torch

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         PlanMismatchError)
    from paddle_tpu_torch.distributed.plan import Plan, PlanError
    from paddle_tpu_torch.inference.serving import (LLMEngine,
                                                    SamplingParams)
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny)

    torch.set_num_threads(1)
    init_parallel_env(rank=rank, world_size=2,
                      init_method=f"tcp://127.0.0.1:{port}", device="cpu",
                      timeout_s=GROUP_TIMEOUT_S)
    state = dict(np.load(os.path.join(work, "weights.npz")))
    prompts = _prompts()
    out = {}

    def tp2():
        return Plan.build({"tp": 2}, ["tp"])

    # per step, logits captured
    model = _port_model(state)
    with LLMEngine(model, plan=tp2(), device="cpu", capture_logits=True,
                   **ENGINE) as eng:
        out["tokens"], out["logits"] = _serve(eng, prompts)
        attn = model.llama.layers[0].self_attn
        out["local"] = {
            "heads": attn.num_heads, "kv_heads": attn.num_kv_heads,
            "pool": list(eng.cache.k[0].shape),
            "q_proj": list(attn.q_proj.weight.shape),
            "o_proj": list(attn.o_proj.weight.shape),
            "embed": list(model.llama.embed_tokens.weight.shape),
            "lm_head": list(model.lm_head.weight.shape),
            "down": list(model.llama.layers[0].mlp.down_proj.weight.shape),
            "norm": list(model.llama.norm.weight.shape)}
        m = eng.metrics()
        out["metrics"] = {k: m[k] for k in ("decode_steps",
                                            "prefill_chunks")}
    # a Llama-MoE: the expert stacks and the router stay whole on each
    # rank (the tp rules name none of them); attention and the dense MLP
    # are cut
    moe_state = dict(np.load(os.path.join(work, "moe_weights.npz")))
    model = _port_model(moe_state, num_experts=4)
    with LLMEngine(model, plan=tp2(), device="cpu", **ENGINE) as eng:
        out["moe_tokens"] = [o.tolist() for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))]
        moe = model.llama.layers[1].mlp
        out["moe_local"] = {
            "gate_w": list(moe.gate_w.shape),
            "down_w": list(moe.down_w.shape),
            "router": list(moe.router.weight.shape),
            "down_proj": list(model.llama.layers[0].mlp.down_proj.weight
                              .shape)}
    # decode windows: on the CPU the window runs eagerly, collectives in
    with LLMEngine(_port_model(state), plan=tp2(), device="cpu",
                   decode_steps_per_sync=4, **ENGINE) as eng:
        out["window_tokens"] = [o.tolist() for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))]
    # lockstep clock: a live deadline and a tenant quota broadcast rank
    # 0's clock each step
    with LLMEngine(_port_model(state), plan=tp2(), device="cpu",
                   **ENGINE) as eng:
        eng.configure_tenant("t", rate_tokens_per_s=1e6)
        rids = [eng.add_request(p, SamplingParams(max_new_tokens=NEW),
                                deadline=4e9, tenant="t")
                for p in prompts]
        while eng.has_work():
            eng.step()
        out["clock_tokens"] = [eng.output_tokens(r).tolist() for r in rids]
    # seeded sampling: both ranks draw the same tokens
    with LLMEngine(_port_model(state), plan=tp2(), device="cpu",
                   **ENGINE) as eng:
        out["sampled"] = [o.tolist() for o in eng.generate(
            prompts[:2], SamplingParams(max_new_tokens=NEW, do_sample=True,
                                        temperature=0.8, top_k=20,
                                        seed=5))]
        try:
            eng.add_request(prompts[0], SamplingParams(do_sample=True))
            out["unseeded"] = None
        except ValueError as e:
            out["unseeded"] = str(e)
    # refusals at construction (the reference's ValueError text)
    refused = {}
    for name, kw in (("kv_host_blocks", dict(kv_host_blocks=4)),
                     ("prefix_store_path", dict(
                         enable_prefix_cache=True, kv_host_blocks=4,
                         prefix_store_path=os.path.join(work, "store"))),
                     ("draft_model", dict(draft_model=_port_model(state))),
                     ("prefill_only", dict(prefill_only=True))):
        try:
            LLMEngine(_port_model(state), plan=tp2(), device="cpu",
                      **ENGINE, **kw).close()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    # a tp degree that splits a KV head
    try:
        cfg = llama_tiny()
        cfg.num_key_value_heads = 1
        LLMEngine(LlamaForCausalLM(cfg, device="cpu", seed=1),
                  plan=tp2(), device="cpu", **ENGINE).close()
        refused["kv_heads"] = None
    except PlanError as e:
        refused["kv_heads"] = str(e)
    out["refused"] = refused
    # reload_weights: whole state, this rank's block, in place
    model = _port_model(state)
    with LLMEngine(model, plan=tp2(), device="cpu", weight_audit=True,
                   **ENGINE) as eng:
        ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
        mgr = CheckpointManager(os.path.join(work, "ckpt"))
        out["reload_step"] = eng.reload_weights(mgr)
        out["reload_ptrs_kept"] = all(
            p.data_ptr() == ptrs[n] for n, p in model.named_parameters())
        out["reload_audit"] = eng.audit_weights()
        out["reload_tokens"] = [o.tolist() for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))]
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        try:
            eng.reload_weights(CheckpointManager(os.path.join(work,
                                                              "stale")))
            out["stale"] = None
        except PlanMismatchError as e:
            out["stale"] = str(e)
        out["stale_untouched"] = all(
            torch.equal(p, before[n]) for n, p in model.named_parameters())
        eng.reload_weights(os.path.join(work, "artifact"))
        out["artifact_tokens"] = [o.tolist() for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))]
    return out


# ---------------------------------------------------------------------------
# the launch, once for the module
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results, the inputs they were given and the port's
    unplanned engine's tokens and logits on the same weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.plan import Plan
    from paddle_tpu_torch.inference.serving import (LLMEngine,
                                                    SamplingParams,
                                                    save_llama_artifact)

    work = str(tmp_path_factory.mktemp("tp2"))
    ref_model, state = _ref_state(5)
    _, state6 = _ref_state(6)
    np.savez(os.path.join(work, "weights.npz"), **state)
    moe_state = _ref_moe_state(7)
    np.savez(os.path.join(work, "moe_weights.npz"), **moe_state)
    prompts = _prompts()
    # what the ranks reload: a whole checkpoint recorded under tp=2, a
    # stale one recorded under tp=4, and an artifact (all seed-6 weights)
    other = _port_model(state6)
    pt.CheckpointManager(os.path.join(work, "ckpt")).save(
        1, model=other, plan=Plan.build({"tp": 2}, ["tp"], devices=[0, 1]))
    pt.CheckpointManager(os.path.join(work, "stale")).save(
        1, model=other, plan=Plan.build({"tp": 4}, ["tp"],
                                        devices=range(4)))
    save_llama_artifact(other, os.path.join(work, "artifact"))
    with LLMEngine(_port_model(state), device="cpu", capture_logits=True,
                   **ENGINE) as eng:
        base_tokens, base_logits = _serve(eng, prompts)
    with LLMEngine(_port_model(state6), device="cpu", **ENGINE) as eng:
        other_tokens = [o.tolist() for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))]
    with LLMEngine(_port_model(moe_state, num_experts=4), device="cpu",
                   **ENGINE) as eng:
        moe_tokens = [o.tolist() for o in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               TORCH_CPP_LOG_LEVEL="ERROR")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         work], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = []
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"ranks": ranks, "base_tokens": base_tokens,
            "base_logits": base_logits, "other_tokens": other_tokens,
            "moe_tokens": moe_tokens, "ref_model": ref_model,
            "prompts": prompts}


def test_tp2_tokens_equal_the_unplanned_engine(run):
    assert run["ranks"][0]["tokens"] == run["base_tokens"]


def test_tp2_tokens_equal_the_references_planned_engine(run):
    from paddle_tpu.distributed.plan import Plan as RefPlan
    from paddle_tpu.inference.serving import LLMEngine as RefEngine
    from paddle_tpu.inference.serving import SamplingParams as RefSampling

    eng = RefEngine(run["ref_model"], plan=RefPlan.build({"tp": 2}, ["tp"]),
                    **ENGINE)
    try:
        ref = eng.generate(run["prompts"],
                           RefSampling(max_new_tokens=NEW))
    finally:
        eng.close()
    assert run["ranks"][0]["tokens"] == [np.asarray(o).tolist()
                                         for o in ref]


def test_tp2_logits_within_tolerance(run):
    for got, want in zip(run["ranks"][0]["logits"], run["base_logits"]):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape == (NEW, 512)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_both_ranks_hold_the_same_tokens_and_logits(run):
    r0, r1 = run["ranks"]
    assert r0["tokens"] == r1["tokens"]
    assert r0["logits"] == r1["logits"]  # the all_reduce is bitwise shared
    assert r0["sampled"] == r1["sampled"]


def test_each_rank_holds_its_megatron_shard(run):
    # llama_tiny: hidden 128, 4 heads, 2 KV heads, head_dim 32,
    # intermediate 384, vocab 512
    for r in run["ranks"]:
        assert r["local"] == {
            "heads": 2, "kv_heads": 1, "pool": [16, 8, 1, 32],
            "q_proj": [128, 64], "o_proj": [64, 128],
            "embed": [256, 128], "lm_head": [128, 256],
            "down": [192, 128], "norm": [128]}


def test_tp2_serves_a_moe_model_with_whole_expert_stacks(run):
    """``adopt_plan`` takes a Llama-MoE under tp 2: the expert stacks and
    the router stay whole on each rank, the dense MLP is cut, and both
    ranks give the unplanned engine's tokens."""
    for r in run["ranks"]:
        assert r["moe_tokens"] == run["moe_tokens"]
        assert r["moe_local"] == {"gate_w": [4, 128, 384],
                                  "down_w": [4, 384, 128],
                                  "router": [128, 4],
                                  "down_proj": [192, 128]}


def test_eager_window_equals_per_step(run):
    assert run["ranks"][0]["window_tokens"] == run["base_tokens"]


def test_lockstep_clock_for_deadlines_and_quotas(run):
    assert run["ranks"][0]["clock_tokens"] == run["base_tokens"]
    assert run["ranks"][1]["clock_tokens"] == run["base_tokens"]


def test_every_refusal(run):
    for r in run["ranks"]:
        refused = r["refused"]
        # a prefix store needs the host tier, so the tier's refusal
        # comes first there, as in the reference
        for name, why in (("kv_host_blocks", "kv_host_blocks"),
                          ("prefix_store_path", "kv_host_blocks"),
                          ("draft_model", "draft_model"),
                          ("prefill_only", "prefill_only")):
            assert refused[name] is not None and \
                "a plan whose mesh spans multiple processes does not " \
                f"support {why}" in refused[name], (name, refused[name])
        assert "num_key_value_heads" in refused["kv_heads"]
        assert "seed" in r["unseeded"]


def test_reload_weights_in_place_under_the_plan(run):
    for r in run["ranks"]:
        assert r["reload_step"] == 1
        assert r["reload_ptrs_kept"] and r["reload_audit"]
        assert r["reload_tokens"] == run["other_tokens"]
        assert r["artifact_tokens"] == run["other_tokens"]


def test_stale_plan_fingerprint_is_refused(run):
    for r in run["ranks"]:
        assert r["stale"] is not None and "mesh" in r["stale"]
        assert r["stale_untouched"]


def test_degree_one_plan_is_the_unplanned_engine():
    from paddle_tpu_torch.distributed.plan import Plan
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    _, state = _ref_state(5)
    prompts = _prompts()
    runs = []
    for plan in (None, Plan.build({"tp": 1}, ["tp"])):
        K.reset_launch_counts()
        with LLMEngine(_port_model(state), plan=plan, device="cpu",
                       capture_logits=True, **ENGINE) as eng:
            toks, logits = _serve(eng, prompts)
            m = eng.metrics()
            runs.append((toks, logits, K.launch_counts(),
                         m["decode_steps"], m["prefill_chunks"],
                         eng.cache.k[0].shape))
    assert runs[0] == runs[1]


if __name__ == "__main__":
    rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    try:
        result = _rank_main(rank, port, work)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    sys.exit(0)
