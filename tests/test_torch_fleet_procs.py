"""The port's serving fleet with real replica worker processes on the CPU
(``engine_kwargs={"device": "cpu"}``), fp32 llama_tiny with the JAX
package's weights: one replica's tokens equal the port's in-process
engine bit for bit and the JAX engine's greedy tokens, with a clean
allocator and no registry series left after ``close``; a
``serve.replica_crash`` respawn whose replay is bit for bit; a
``["prefill", "decode"]`` fleet handing every request's pages over; a
zero-drop ``drain(then="reload")`` from a ``CheckpointManager``; and a
replica asking for CUDA on this card-less machine ending in
``ReplicaCrashLoopError`` instead of serving on the CPU.

A file of its own, so that ``--dist loadfile`` gives its processes a
worker to themselves."""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SamplingParams as JaxSampling
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.inference.serving import (
    LLMEngine, ReplicaCrashLoopError, SamplingParams, save_llama_artifact)
from paddle_tpu_torch.inference.serving.fleet import Router
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.observability import metrics as om

KW = dict(num_blocks=48, block_size=8, max_batch_size=2)
NEW = 8
LENS = (5, 11, 7, 16)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(artifact path, prompts, the port engine's outputs, the JAX
    engine's outputs) for llama_tiny with the JAX package's weights."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    root = tmp_path_factory.mktemp("fleet")
    artifact = str(root / "model")
    save_llama_artifact(tm, artifact)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in LENS]
    with LLMEngine(tm, ingest_async=False, device="cpu", **KW) as eng:
        port = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
    jeng = JaxEngine(jm, ingest_async=False, **KW)
    try:
        jax = jeng.generate(prompts, JaxSampling(max_new_tokens=NEW))
    finally:
        jeng.close()
    return {"artifact": artifact, "prompts": prompts, "port": port,
            "jax": jax, "model": tm, "root": root}


def fleet(setup, tmp_path, n=1, **kw):
    kw.setdefault("log_dir", str(tmp_path / "logs"))
    return Router(artifact=setup["artifact"], n_replicas=n,
                  engine_kwargs=dict(KW, device="cpu"), **kw)


def serve(f, prompts):
    gids = [f.submit(p, max_new=NEW) for p in prompts]
    f.join(timeout=60)
    return [f.result(g) for g in gids]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def assert_clean(f, i):
    s = f.replica_stats(i)
    assert s["blocks_free"] == KW["num_blocks"] - 1, s
    assert s["running"] == 0 and s["waiting"] == 0, s
    return s


def test_one_replica_matches_both_engines(setup, tmp_path):
    f = fleet(setup, tmp_path)
    name = f._name
    try:
        got = serve(f, setup["prompts"])
        assert_same(got, setup["port"])
        assert_same(got, setup["jax"])
        s = assert_clean(f, 0)
        assert s["tokens_out"] == NEW * len(LENS)
        # the plain versions served on the CPU: no kernel launched
        assert set(s["launches"].values()) == {0}
        assert f.metrics()["replicas_live"] == 1
    finally:
        f.close()
    snap = om.REGISTRY.snapshot()
    for metric in ("fleet_replicas_live", "fleet_redispatches_total",
                   "fleet_queue_depth", "fleet_replica_restarts_total"):
        series = snap.get(metric, {"series": {}})["series"]
        assert not any(name in k for k in series), metric


def test_crash_respawn_replays_bit_for_bit(setup, tmp_path):
    env = {"CHAOS_SERVE_SITE": "serve.replica_crash",
           "CHAOS_SERVE_REPLICA": "0", "CHAOS_SERVE_AFTER_STEPS": "3"}
    f = fleet(setup, tmp_path, n=2, env_extra=env, max_restarts=2)
    try:
        got = serve(f, setup["prompts"])
        assert_same(got, setup["port"])
        assert f.metrics()["redispatches"] >= 1
        # the respawn (after its backoff) rejoins clean
        f.supervisor.wait_ready(timeout=60)
        assert f.supervisor.handles[0].incarnation == 1
        assert f.metrics()["replica_restarts"] == 1
        deaths = f.supervisor.deaths
        assert [(d["replica"], d["reason"]) for d in deaths] == [
            (0, "crash")]
        assert deaths[0]["rc"] == -9
        assert deaths[0]["detected"] <= deaths[0]["handled"]
        h = f.supervisor.handles[0]
        assert h.spawn_time < h.ready_time
        assert_same(serve(f, setup["prompts"]), setup["port"])
        for i in (0, 1):
            assert_clean(f, i)
    finally:
        f.close()


def test_split_fleet_hands_every_request_over(setup, tmp_path):
    f = fleet(setup, tmp_path, n=2, roles=["prefill", "decode"])
    try:
        got = serve(f, setup["prompts"])
        assert_same(got, setup["port"])
        m = f.metrics()
        assert m["prefill_handoffs"] == len(LENS), m
        assert m["kv_transfer_retries"] == 0 and m["handoff_failovers"] == 0
        assert m["kv_pages_transferred"] >= len(LENS)
        pre, dec = (assert_clean(f, i) for i in (0, 1))
        assert (pre["role"], dec["role"]) == ("prefill", "decode")
        # every page byte the prefill replica sent reached the decode one
        assert pre["kv_sent_bytes"] == dec["kv_recv_bytes"] > 0
        assert pre["kv_send_ms"] > 0 and dec["kv_recv_ms"] > 0
        assert pre["kv_recv_bytes"] == dec["kv_sent_bytes"] == 0
    finally:
        f.close()


def test_drain_reload_drops_nothing(setup, tmp_path):
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root)
    mgr.save(7, model=setup["model"])
    mgr.tag_healthy(7)
    f = fleet(setup, tmp_path, n=2)
    try:
        gids = [f.submit(p, max_new=NEW) for p in setup["prompts"]]
        f.step()
        f.drain(0, then="reload", ckpt_root=root, wait=True, timeout=60)
        f.join(timeout=60)
        assert_same([f.result(g) for g in gids], setup["port"])
        assert f.reloads == [(0, 7)] and f.drains_completed == 1
        m = f.metrics()
        assert m["requests_shed"] == 0 and m["deadline_expired"] == 0
        # the reloaded replica serves the same weights
        assert_same(serve(f, setup["prompts"]), setup["port"])
    finally:
        f.close()


def test_cuda_replica_without_a_card_is_a_crash_loop(setup, tmp_path):
    # the replica sees no card here, and none on a machine with one
    with pytest.raises(ReplicaCrashLoopError) as ei:
        Router(artifact=setup["artifact"], n_replicas=1,
               engine_kwargs=dict(KW), max_restarts=0,
               env_extra={"CUDA_VISIBLE_DEVICES": ""},
               log_dir=str(tmp_path / "logs"))
    assert ei.value.replica == 0 and ei.value.exit_code != 0
    log = (tmp_path / "logs" / "replica.0.log").read_text()
    assert "torch.cuda.is_available() is False" in log


# ---------------------------------------------------------------------------
# tests/test_fleet.py:846 on: real multi-process replica groups, each slot
# a tp=2 group of two gloo processes (slow, as the reference marks them)
# ---------------------------------------------------------------------------

TP2_PLAN = {"axes": {"tp": 2}, "strategies": ["tp"]}


def group_fleet(setup, tmp_path, **kw):
    return fleet(setup, tmp_path, group_size=2, plan=TP2_PLAN, **kw)


@pytest.mark.slow
class TestRealGroupFleet:
    def test_group_bit_exact_stats_and_retire(self, setup, tmp_path):
        """A tp=2 group serves bit for bit the single-process engine's
        tokens; stats come through rank 0 (the group's one mouth);
        drain-then-retire ends every member process."""
        f = group_fleet(setup, tmp_path)
        try:
            assert f.supervisor.handles[0].ready_info["group_size"] == 2
            assert_same(serve(f, setup["prompts"]), setup["port"])
            stats = f.replica_stats(0)
            assert stats["blocks_free"] == KW["num_blocks"] - 1
            assert stats["running"] == 0 and stats["waiting"] == 0
            assert om.REGISTRY.get("fleet_group_members_live").value(
                instance=f._name, replica=0) == 2
            h = f.supervisor.handles[0]
            f.drain(0, then="retire", wait=True)
            assert h.retired
            assert h.proc.poll() is not None
            assert all(m.poll() is not None for m in h.members)
        finally:
            f.close()

    def test_group_member_crash_fells_group_and_replays(self, setup,
                                                       tmp_path):
        """A SIGKILL of rank 1 mid-burst: the supervisor fells the whole
        group and respawns it on a fresh coordination port; the
        redispatched requests replay bit for bit."""
        import json

        f = group_fleet(setup, tmp_path, max_restarts=2, env_extra={
            "CHAOS_SERVE_SITES": json.dumps(
                [{"site": "serve.group_member_crash", "replica": 0,
                  "rank": 1, "after": 3}])})
        try:
            port0 = f.supervisor.handles[0].coord_port
            assert_same(serve(f, setup["prompts"]), setup["port"])
            m = f.metrics()
            assert m["replica_restarts"] >= 1 and m["redispatches"] >= 1
            h = f.supervisor.handles[0]
            assert h.incarnation >= 1 and h.coord_port != port0
            assert f.supervisor.deaths[0]["rank"] == 1
            assert om.REGISTRY.get("fleet_group_restarts_total").value(
                instance=f._name) >= 1
        finally:
            f.close()

    def test_group_member_hang_watchdog_escalation(self, setup, tmp_path):
        """A wedged rank 1 stalls the group's collectives with no process
        exiting: only the watchdog (stale member heartbeats) fells the
        group; the respawn replays bit for bit."""
        import json

        f = group_fleet(setup, tmp_path, max_restarts=2, hang_timeout_s=4.0,
                        env_extra={"CHAOS_SERVE_SITES": json.dumps(
                            [{"site": "serve.group_member_hang",
                              "replica": 0, "rank": 1, "after": 3}])})
        try:
            gids = [f.submit(p, max_new=NEW) for p in setup["prompts"]]
            f.join(timeout=120)
            assert_same([f.result(g) for g in gids], setup["port"])
            assert f.metrics()["replica_restarts"] >= 1
            assert f.supervisor.deaths[0]["reason"] == "hang"
        finally:
            f.close()
