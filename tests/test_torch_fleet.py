"""The port's serving fleet on the CPU, with no subprocesses: the
reference's fake-supervisor matrix (``tests/test_fleet.py``,
``tests/test_disagg.py``, ``tests/test_qos.py``, ``tests/test_integrity.py``:
typed errors, placement, deadlines, redispatch, drain, lifecycle;
two-stage routing, session affinity, idle backoff, wiring; router QoS and
autoscale, supervisor autoscale; the router's audit and the
quarantine-reload drain) proved again on the port's ``Router`` and
``ReplicaSupervisor``; then one scripted event sequence through both
packages' routers over the same fake supervisor (the same commands,
results, metrics and error kinds), frames crossing between the packages,
and ``RestartBudget`` and ``ReplicaSupervisor.autoscale`` deciding as the
reference's do under an injected clock."""

from __future__ import annotations

import base64
import json
import time
import warnings
import zlib

import numpy as np
import pytest

from paddle_tpu_torch.inference.serving import (
    TIER_BATCH, TIER_LATENCY, DeadlineInfeasibleError, EngineClosedError,
    FleetOverloadedError, KVTransferError, ReplicaCrashLoopError,
    RequestTimeoutError, TenantQuotaExceededError,
)
from paddle_tpu_torch.inference.serving.fleet import Router
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.utils import fault_injection as fi

obs_metrics = om


# ---------------------------------------------------------------------------
# fakes: the Router's supervisor/handle contract, no processes (the union
# of the reference tests' fakes: roles, incarnations, a dead proc)
# ---------------------------------------------------------------------------

class _FakeProc:
    def poll(self):
        return 0  # "already dead": the kill branch must stay a no-op


class FakeHandle:
    def __init__(self, hid, role="both", incarnation=0):
        self.id = hid
        self.role = role
        self.incarnation = incarnation
        self.ready = True
        self.ready_info = {"e": "ready", "replica": hid, "role": role}
        self.alive = True
        self.retired = False
        self.sent = []
        self.inbox = []
        self.proc = _FakeProc()
        self.pid = -1

    def send(self, obj):
        if not self.alive:
            return False
        self.sent.append(obj)
        return True

    def events(self):
        out, self.inbox = self.inbox, []
        for ev in out:
            if ev.get("e") == "ready":
                self.ready = True
                self.ready_info = ev
        return out

    def ops(self, op):
        return [s for s in self.sent if s.get("op") == op]

    def submits(self):
        return self.ops("submit")

    def tenant_cfgs(self):
        return self.ops("configure_tenant")


class FakeSupervisor:
    """``n`` colocated replicas, or one replica a role of ``roles``."""

    def __init__(self, roles):
        if isinstance(roles, int):
            roles = ["both"] * roles
        self.handles = [FakeHandle(i, r) for i, r in enumerate(roles)]
        self.deaths = []
        self.shut = False
        self.crash_loop = None

    def check(self, now=None):
        if self.crash_loop is not None:
            raise self.crash_loop
        out, self.deaths = self.deaths, []
        return out

    def retire(self, i):
        h = self.handles[i]
        h.retired = True
        h.alive = False

    def shutdown(self):
        self.shut = True

    # test helpers -----------------------------------------------------
    def die(self, i, leftover=()):
        h = self.handles[i]
        h.alive = False
        self.deaths.append({"replica": i, "reason": "crash", "rc": -9,
                            "events": list(leftover)})
        # a respawn is a new incarnation, and not ready until its boot
        # ends: placement must route the replay to a healthy peer
        self.handles[i] = FakeHandle(i, h.role, h.incarnation + 1)
        self.handles[i].ready = False

    def feed(self, i, ev):
        self.handles[i].inbox.append(ev)


def make_fleet(n=2, sup=None, **kw):
    kw.setdefault("engine_kwargs", {"max_batch_size": 4})
    sup = sup or FakeSupervisor(n)
    return Router(supervisor=sup, **kw), sup


def make_split_fleet(roles=("prefill", "decode", "decode"), **kw):
    return make_fleet(sup=FakeSupervisor(list(roles)), **kw)


def tok_ev(gid, gen, toks, fin=False, reason=None):
    return {"e": "tok", "gid": gid, "gen": gen, "toks": list(toks),
            "fin": fin, "reason": reason if fin else None}


PROMPT = np.arange(1, 7, dtype=np.int32)


# ===========================================================================
# tests/test_fleet.py
# ===========================================================================

# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------

class TestTypedErrors:
    def test_hierarchy_and_exports(self):
        from paddle_tpu_torch.distributed.launch import (CrashLoopError,
                                                   RestartBudget)
        from paddle_tpu_torch.inference.serving import fleet as fleet_mod

        assert issubclass(ReplicaCrashLoopError, CrashLoopError)
        assert issubclass(RequestTimeoutError, TimeoutError)
        assert issubclass(FleetOverloadedError, RuntimeError)
        assert issubclass(EngineClosedError, RuntimeError)
        for name in ("Router", "ReplicaSupervisor", "RequestTimeoutError",
                     "FleetOverloadedError", "ReplicaCrashLoopError"):
            assert hasattr(fleet_mod, name)
        # the serving supervisor reuses the launcher's leaky bucket
        b = RestartBudget(2, window_s=100.0, backoff_base_s=0.0)
        assert b.try_acquire() and b.try_acquire() and not b.try_acquire()

    def test_crash_loop_error_fields(self):
        e = ReplicaCrashLoopError("boom", replica=3, exit_code=-9,
                                  restarts=4)
        assert e.replica == 3 and e.exit_code == -9 and e.restarts == 4


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

class TestPlacement:
    def test_least_loaded_spreads(self):
        fleet, sup = make_fleet(3)
        try:
            for _ in range(6):
                fleet.submit(PROMPT, max_new=4)
            fleet.step()
            counts = [len(h.submits()) for h in sup.handles]
            assert counts == [2, 2, 2]
        finally:
            fleet.close()

    def test_session_affinity_prefers_last_replica(self):
        fleet, sup = make_fleet(2)
        try:
            fleet.submit(PROMPT, max_new=4, session="tenant-a")
            fleet.step()
            first = next(i for i, h in enumerate(sup.handles)
                         if h.submits())
            # load the other replica less, then submit the session again:
            # affinity must beat least-loaded
            fleet.submit(PROMPT, max_new=4, session="tenant-a")
            fleet.step()
            assert len(sup.handles[first].submits()) == 2
        finally:
            fleet.close()

    def test_load_reports_break_ties(self):
        fleet, sup = make_fleet(2)
        try:
            # replica 0 reports hot gauges; equal inflight -> pick 1
            sup.feed(0, {"e": "load", "kv": 0.9, "occ": 0.9})
            fleet.step()
            fleet.submit(PROMPT, max_new=4)
            fleet.step()
            assert len(sup.handles[1].submits()) == 1
        finally:
            fleet.close()

    def test_inflight_cap_queues_then_shed_at_bound(self):
        fleet, sup = make_fleet(1, max_queue=2,
                                max_inflight_per_replica=1)
        try:
            fleet.submit(PROMPT, max_new=4)
            fleet.step()                      # placed (cap 1 reached)
            fleet.submit(PROMPT, max_new=4)   # queued 1
            fleet.submit(PROMPT, max_new=4)   # queued 2 = bound
            with pytest.raises(FleetOverloadedError) as ei:
                fleet.submit(PROMPT, max_new=4)
            assert ei.value.queue_depth == 2
            # registry truth: fleet_requests_shed_total + queue gauge
            inst = fleet._name
            assert om.REGISTRY.get("fleet_requests_shed_total").value(
                instance=inst) == 1
            fleet.step()
            assert om.REGISTRY.get("fleet_queue_depth").value(
                instance=inst) == 2
            assert fleet.metrics()["requests_shed"] == 1
        finally:
            fleet.close()


# ---------------------------------------------------------------------------
# deadlines (the edge matrix)
# ---------------------------------------------------------------------------

class TestRouterDeadlines:
    def test_expired_at_submit_rejected_before_queueing(self):
        fleet, _ = make_fleet(1)
        try:
            with pytest.raises(RequestTimeoutError):
                fleet.submit(PROMPT, max_new=4, deadline_s=0.0)
            assert fleet.pending() == []
            assert fleet.metrics()["deadline_expired"] == 1
        finally:
            fleet.close()

    def test_queued_expiry_surfaces_at_tick(self):
        fleet, sup = make_fleet(1)
        sup.handles[0].ready = False  # nothing placeable: stays queued
        try:
            gid = fleet.submit(PROMPT, max_new=4, deadline_s=0.01)
            time.sleep(0.03)
            fleet.step()
            with pytest.raises(RequestTimeoutError):
                fleet.result(gid)
            assert fleet.tokens(gid) == []
            # fleet_deadline_expired_total counts it
            assert om.REGISTRY.get("fleet_deadline_expired_total").value(
                instance=fleet._name) == 1
        finally:
            fleet.close()

    def test_placed_expiry_cancels_on_replica(self):
        fleet, sup = make_fleet(1)
        try:
            gid = fleet.submit(PROMPT, max_new=8, deadline_s=0.02)
            fleet.step()
            sup.feed(0, tok_ev(gid, 1, [7]))
            fleet.step()
            time.sleep(0.04)
            fleet.step()
            with pytest.raises(RequestTimeoutError):
                fleet.result(gid)
            # the partial stream survives; the replica was told to free
            assert fleet.tokens(gid) == [7]
            assert any(s.get("op") == "cancel" and s["gid"] == gid
                       for s in sup.handles[0].sent)
        finally:
            fleet.close()

    def test_deadline_survives_redispatch(self):
        """The replay inherits the ORIGINAL absolute deadline, not a
        fresh one."""
        fleet, sup = make_fleet(2)
        try:
            gid = fleet.submit(PROMPT, max_new=8, deadline_s=30.0)
            fleet.step()
            original = fleet.request(gid).deadline
            src = next(i for i, h in enumerate(sup.handles)
                       if h.submits())
            first_payload = sup.handles[src].submits()[0]
            assert first_payload["deadline"] == pytest.approx(original)
            sup.feed(src, tok_ev(gid, 1, [9, 11]))
            fleet.step()
            sup.die(src)
            fleet.step()
            other = 1 - src
            replay = sup.handles[other].submits()[0]
            assert replay["deadline"] == pytest.approx(original)
            assert fleet.request(gid).deadline == original
        finally:
            fleet.close()


# ---------------------------------------------------------------------------
# redispatch + dedup
# ---------------------------------------------------------------------------

class TestRedispatch:
    def test_replay_resumes_from_emitted_tokens(self):
        fleet, sup = make_fleet(2)
        try:
            gid = fleet.submit(PROMPT, max_new=6)
            fleet.step()
            src = next(i for i, h in enumerate(sup.handles)
                       if h.submits())
            # 2 tokens emitted, then the replica dies with one more token
            # stranded in its final (post-mortem drained) events
            sup.feed(src, tok_ev(gid, 1, [101, 102]))
            fleet.step()
            sup.die(src, leftover=[tok_ev(gid, 1, [103])])
            fleet.step()
            other = 1 - src
            replay = sup.handles[other].submits()[0]
            # replay = original prompt + ALL emitted (incl. the stranded
            # token) with the remaining budget
            assert replay["prompt"] == PROMPT.tolist() + [101, 102, 103]
            assert replay["max_new"] == 3
            assert replay["gen"] == 2
            assert fleet.metrics()["redispatches"] == 1
            assert om.REGISTRY.get("fleet_redispatches_total").value(
                instance=fleet._name) == 1
            # finish on the new replica; full stream = old + new tokens
            sup.feed(other, tok_ev(gid, 2, [104, 105, 106], fin=True,
                                   reason="length"))
            fleet.step()
            out = fleet.result(gid)
            assert out.tolist() == (PROMPT.tolist()
                                    + [101, 102, 103, 104, 105, 106])
        finally:
            fleet.close()

    def test_superseded_assignment_cannot_double_emit(self):
        fleet, sup = make_fleet(2)
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            src = next(i for i, h in enumerate(sup.handles)
                       if h.submits())
            sup.feed(src, tok_ev(gid, 1, [7]))
            fleet.step()
            sup.die(src)  # presumed dead -> replay on the other replica
            fleet.step()
            other = 1 - src
            # the "dead" replica's zombie incarnation keeps emitting with
            # the OLD generation — every token must be dropped
            sup.feed(src, tok_ev(gid, 1, [8, 9], fin=True,
                                 reason="length"))
            fleet.step()
            assert fleet.tokens(gid) == [7]
            assert not fleet.request(gid).finished
            sup.feed(other, tok_ev(gid, 2, [8, 9, 10], fin=True,
                                   reason="length"))
            fleet.step()
            assert fleet.result(gid).tolist() == (PROMPT.tolist()
                                                  + [7, 8, 9, 10])
        finally:
            fleet.close()

    def test_dispatch_fault_requeues_with_bumped_generation(self):
        fleet, sup = make_fleet(2)
        try:
            with fi.inject("serve.dispatch", max_fires=1):
                gid = fleet.submit(PROMPT, max_new=4)
                fleet.step()   # first dispatch attempt fails, requeued
                fleet.step()   # second attempt lands
            subs = [s for h in sup.handles for s in h.submits()]
            assert len(subs) == 1 and subs[0]["gen"] == 2
            assert fleet.metrics()["redispatches"] == 1
            assert fleet.request(gid).state == "placed"
        finally:
            fleet.close()

    def test_fully_emitted_request_finishes_without_replay(self):
        """max_new tokens already emitted when the replica died — only
        the fin event was lost; the router completes it locally."""
        fleet, sup = make_fleet(2)
        try:
            gid = fleet.submit(PROMPT, max_new=2)
            fleet.step()
            src = next(i for i, h in enumerate(sup.handles)
                       if h.submits())
            sup.die(src, leftover=[tok_ev(gid, 1, [5, 6])])
            fleet.step()
            assert fleet.result(gid).tolist() == PROMPT.tolist() + [5, 6]
            assert fleet.metrics()["redispatches"] == 0
        finally:
            fleet.close()

    def test_crash_loop_propagates(self):
        fleet, sup = make_fleet(1)
        sup.crash_loop = ReplicaCrashLoopError("gone", replica=0)
        with pytest.raises(ReplicaCrashLoopError):
            fleet.step()
        fleet.close()


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

class TestDrain:
    def test_drain_blocks_placement_until_resumed(self):
        fleet, sup = make_fleet(2)
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            src = next(i for i, h in enumerate(sup.handles)
                       if h.submits())
            fleet.drain(src, then="resume")
            # draining replica takes nothing new (session affinity too)
            fleet.submit(PROMPT, max_new=4, session="s")
            fleet.step()
            assert len(sup.handles[src].submits()) == 1
            assert om.REGISTRY.get("fleet_replicas_draining").value(
                instance=fleet._name) == 1
            # in-flight request finishes -> drain completes
            sup.feed(src, tok_ev(gid, 1, [1, 2, 3, 4], fin=True,
                                 reason="length"))
            fleet.step()
            assert fleet.drains_completed == 1
            assert fleet.metrics()["replicas_draining"] == 0
            fleet.submit(PROMPT, max_new=4)
            fleet.step()  # replica is placeable again
            assert sum(len(h.submits()) for h in sup.handles) == 3
        finally:
            fleet.close()

    def test_drain_reload_hot_swaps_weights(self):
        fleet, sup = make_fleet(1)
        try:
            gid = fleet.submit(PROMPT, max_new=2)
            fleet.step()
            fleet.drain(0, then="reload", ckpt_root="/ckpt/root")
            sup.feed(0, tok_ev(gid, 1, [1, 2], fin=True, reason="length"))
            fleet.step()
            reloads = [s for s in sup.handles[0].sent
                       if s.get("op") == "reload"]
            assert reloads == [{"op": "reload", "root": "/ckpt/root"}]
            assert fleet.metrics()["replicas_draining"] == 1  # awaiting ack
            sup.feed(0, {"e": "reloaded", "replica": 0, "step": 7})
            fleet.step()
            assert fleet.reloads == [(0, 7)]
            assert fleet.drains_completed == 1
        finally:
            fleet.close()

    def test_drain_retire_stops_the_replica(self):
        fleet, sup = make_fleet(2)
        try:
            fleet.drain(1, then="retire")
            fleet.step()
            assert sup.handles[1].retired
            fleet.submit(PROMPT, max_new=4)
            fleet.step()
            assert len(sup.handles[0].submits()) == 1
        finally:
            fleet.close()

    def test_drain_validates_arguments(self):
        fleet, _ = make_fleet(1)
        try:
            with pytest.raises(ValueError):
                fleet.drain(0, then="explode")
            with pytest.raises(ValueError):
                fleet.drain(99)
            with pytest.raises(ValueError):
                fleet.drain(0, then="reload")  # no ckpt_root anywhere
        finally:
            fleet.close()


# ---------------------------------------------------------------------------
# router lifecycle
# ---------------------------------------------------------------------------

class TestRouterLifecycle:
    def test_close_removes_registry_series_and_guards(self):
        fleet, sup = make_fleet(1)
        name = fleet._name
        fleet.submit(PROMPT, max_new=4)
        fleet.close()
        assert sup.shut
        for metric in ("fleet_redispatches_total",
                       "fleet_requests_shed_total",
                       "fleet_deadline_expired_total",
                       "fleet_queue_depth", "fleet_replicas_draining"):
            snap = om.REGISTRY.snapshot().get(metric, {"series": {}})
            assert not any(name in k for k in snap["series"]), metric
        with pytest.raises(EngineClosedError):
            fleet.submit(PROMPT, max_new=4)
        with pytest.raises(EngineClosedError):
            fleet.step()
        fleet.close()  # idempotent

    def test_replica_stats_routes_surrounding_events(self):
        """Events drained in the same batch as the stats reply must go
        through the normal pump — ``events()`` is destructive, so
        returning mid-batch used to drop live tokens forever."""
        fleet, sup = make_fleet(1)
        try:
            gid = fleet.submit(PROMPT, max_new=2)
            fleet.step()
            sup.feed(0, tok_ev(gid, 1, [5]))
            sup.feed(0, {"e": "stats", "replica": 0, "blocks_free": 47})
            sup.feed(0, tok_ev(gid, 1, [6], fin=True, reason="length"))
            stats = fleet.replica_stats(0)
            assert stats["blocks_free"] == 47
            assert fleet.result(gid).tolist() == PROMPT.tolist() + [5, 6]
        finally:
            fleet.close()

    def test_metrics_reads_injected_supervisors_instance(self):
        """Supervisor-owned gauges live under the SUPERVISOR's instance
        label; an injected supervisor keeps its own name."""
        from paddle_tpu_torch.inference.serving.fleet.supervisor import _G_LIVE

        sup = FakeSupervisor(2)
        sup.instance = "external-fleet"
        fleet = Router(supervisor=sup, engine_kwargs={"max_batch_size": 4})
        try:
            _G_LIVE.set(2, instance="external-fleet")
            assert fleet.metrics()["replicas_live"] == 2
        finally:
            _G_LIVE.remove(instance="external-fleet")
            fleet.close()

    def test_result_and_release_contract(self):
        fleet, sup = make_fleet(1)
        try:
            gid = fleet.submit(PROMPT, max_new=2)
            with pytest.raises(ValueError):
                fleet.release(gid)  # unfinished
            fleet.step()
            with pytest.raises(RuntimeError):
                fleet.result(gid)   # still running
            sup.feed(0, tok_ev(gid, 1, [3, 4], fin=True, reason="length"))
            fleet.step()
            assert fleet.result(gid).tolist() == PROMPT.tolist() + [3, 4]
            fleet.release(gid)
            assert fleet.pending() == []
        finally:
            fleet.close()


# ===========================================================================
# tests/test_disagg.py
# ===========================================================================

BLOB = (b"fake-kv-page-payload" * 37)


def frame_events(gid, hid, blob=BLOB, nframes=3, corrupt_seq=None,
                 first_tok=7, drop_seq=None):
    size = max(1, -(-len(blob) // nframes))
    chunks = [blob[i:i + size] for i in range(0, len(blob), size)]
    evs = []
    for seq, ch in enumerate(chunks):
        if seq == drop_seq:
            continue
        data = ch
        if seq == corrupt_seq:
            data = bytes([ch[0] ^ 0xFF]) + ch[1:]
        evs.append({"e": "kvpage", "gid": gid, "hid": hid, "seq": seq,
                    "total": len(chunks), "crc": zlib.crc32(ch),
                    "data": base64.b64encode(data).decode()})
    evs.append({"e": "kvdone", "gid": gid, "hid": hid,
                "first_tok": first_tok, "fin": False, "reason": None,
                "frames": len(chunks), "crc": zlib.crc32(blob)})
    return evs



class TestRouterTwoStage:
    def test_handoff_flow_end_to_end(self):
        fleet, sup = make_split_fleet()
        try:
            gid = fleet.submit(PROMPT, max_new=5, session="t1",
                               deadline_s=60.0)
            fleet.step()
            pf = sup.handles[0].ops("prefill")
            assert len(pf) == 1 and pf[0]["hid"] == 1 \
                and pf[0]["max_new"] == 5
            assert pf[0]["prompt"] == PROMPT.tolist()
            deadline = fleet.request(gid).deadline
            assert pf[0]["deadline"] == pytest.approx(deadline)
            for ev in frame_events(gid, 1):
                sup.feed(0, ev)
            fleet.step()
            # first token accepted, pages shipped to ONE decode replica
            assert fleet.tokens(gid) == [7]
            dec = next(h for h in sup.handles[1:] if h.ops("kvpage"))
            sub = dec.ops("submit_pages")
            assert len(sub) == 1
            assert sub[0]["prompt"] == PROMPT.tolist() + [7]
            assert sub[0]["max_new"] == 4
            # deadline carried UNCHANGED across the handoff
            assert sub[0]["deadline"] == pytest.approx(deadline)
            # frames CRC-consistent on the way down
            for f in dec.ops("kvpage"):
                assert zlib.crc32(base64.b64decode(f["data"])) == f["crc"]
            # session pinned to the DECODE replica
            assert fleet._sessions["t1"] == dec.id
            sup.feed(dec.id, tok_ev(gid, fleet.request(gid).generation,
                                    [8, 9, 10, 11], fin=True,
                                    reason="length"))
            fleet.step()
            assert fleet.result(gid).tolist() == \
                PROMPT.tolist() + [7, 8, 9, 10, 11]
            m = fleet.metrics()
            assert m["prefill_handoffs"] == 1
            assert m["kv_pages_transferred"] == 3
            assert m["handoff_failovers"] == 0
        finally:
            fleet.close()

    def test_kvdone_fin_completes_without_decode_stage(self):
        fleet, sup = make_split_fleet()
        try:
            gid = fleet.submit(PROMPT, max_new=1)
            fleet.step()
            sup.feed(0, {"e": "kvdone", "gid": gid, "hid": 1,
                         "first_tok": 42, "fin": True, "reason": "length",
                         "frames": 0, "crc": 0})
            fleet.step()
            assert fleet.result(gid).tolist() == PROMPT.tolist() + [42]
            assert not any(h.ops("submit_pages") for h in sup.handles)
            assert fleet.metrics()["prefill_handoffs"] == 1
        finally:
            fleet.close()

    def test_zombie_stale_hid_cannot_double_deliver(self):
        fleet, sup = make_split_fleet(("prefill", "prefill", "decode"))
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            src = next(i for i in (0, 1)
                       if sup.handles[i].ops("prefill"))
            # a couple of frames arrive, then the prefill worker dies
            evs = frame_events(gid, 1)
            for ev in evs[:2]:
                sup.feed(src, ev)
            fleet.step()
            sup.die(src)
            fleet.step()
            other = 1 - src
            assert sup.handles[other].ops("prefill")[0]["hid"] == 2
            assert fleet.metrics()["handoff_failovers"] == 1
            assert fleet.request(gid).frames == {}  # discarded atomically
            # the zombie's remaining frames + kvdone (stale hid 1) are
            # dropped — no token, no pages, no double handoff
            for ev in evs[2:]:
                sup.feed(src, ev)
            fleet.step()
            assert fleet.tokens(gid) == []
            assert fleet.metrics()["prefill_handoffs"] == 0
            # the re-driven transfer (hid 2) completes normally
            for ev in frame_events(gid, 2, first_tok=9):
                sup.feed(other, ev)
            fleet.step()
            assert fleet.tokens(gid) == [9]
            sup.feed(2, tok_ev(gid, fleet.request(gid).generation,
                               [1, 2, 3], fin=True, reason="length"))
            fleet.step()
            assert fleet.result(gid).tolist() == \
                PROMPT.tolist() + [9, 1, 2, 3]
        finally:
            fleet.close()

    def test_corrupt_frame_retries_then_typed_error(self):
        fleet, sup = make_split_fleet(max_kv_retries=2)
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            for attempt in range(1, 4):
                fleet.step()  # dispatch prefill (hid == attempt)
                assert sup.handles[0].ops("prefill")[-1]["hid"] == attempt
                for ev in frame_events(gid, attempt, corrupt_seq=1):
                    sup.feed(0, ev)
                fleet.step()  # corrupt frame -> handoff voided
            with pytest.raises(KVTransferError) as ei:
                fleet.result(gid)
            assert ei.value.retries == 3
            m = fleet.metrics()
            assert m["kv_transfer_retries"] == 2  # within-budget re-drives
            assert fleet.request(gid).state == "failed"
            # the registry series agrees
            assert om.REGISTRY.get(
                "fleet_kv_transfer_retries_total").value(
                instance=fleet._name) == 2
        finally:
            fleet.close()

    def test_missing_frame_voids_handoff(self):
        fleet, sup = make_split_fleet()
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            for ev in frame_events(gid, 1, drop_seq=1):
                sup.feed(0, ev)
            fleet.step()
            assert fleet.tokens(gid) == []  # incomplete -> no first token
            assert fleet.metrics()["kv_transfer_retries"] == 1
            assert sup.handles[0].ops("prefill")[-1]["hid"] == 2
        finally:
            fleet.close()

    def test_decode_side_rejection_redrives_prefill(self):
        """The decode worker's typed KVTransferError err event re-drives
        the prefill under the same budget — never fails the request
        outright on a transient."""
        fleet, sup = make_split_fleet()
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            for ev in frame_events(gid, 1):
                sup.feed(0, ev)
            fleet.step()
            dec = next(h for h in sup.handles[1:]
                       if h.ops("submit_pages"))
            sup.feed(dec.id, {"e": "err", "gid": gid,
                              "kind": "KVTransferError",
                              "msg": "payload CRC mismatch"})
            fleet.step()
            assert not fleet.request(gid).finished
            assert fleet.metrics()["kv_transfer_retries"] == 1
            # and the prefill was re-dispatched with a fresh handoff id
            assert sup.handles[0].ops("prefill")[-1]["hid"] == 2
        finally:
            fleet.close()

    def test_decode_side_rejections_exhaust_the_budget(self):
        """Regression: the budget re-arms only when a decode worker ACKS
        the pages (first tok), not at kvdone — a decode side that keeps
        rejecting deliveries must eventually exhaust the retry budget
        into a typed KVTransferError instead of re-driving the prefill
        forever."""
        fleet, sup = make_split_fleet(("prefill", "decode"),
                                      max_kv_retries=2)
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            for attempt in range(1, 4):
                fleet.step()
                hid = sup.handles[0].ops("prefill")[-1]["hid"]
                assert hid == attempt
                for ev in frame_events(gid, hid):
                    sup.feed(0, ev)
                fleet.step()  # complete handoff -> pages to the decoder
                sup.feed(1, {"e": "err", "gid": gid,
                             "kind": "KVTransferError",
                             "msg": "frames evicted under load"})
                fleet.step()
            with pytest.raises(KVTransferError) as ei:
                fleet.result(gid)
            assert ei.value.retries == 3
            assert fleet.metrics()["kv_transfer_retries"] == 2
        finally:
            fleet.close()

    def test_decode_death_replays_two_stage_with_same_deadline(self):
        fleet, sup = make_split_fleet(("prefill", "decode", "decode"))
        try:
            gid = fleet.submit(PROMPT, max_new=6, deadline_s=60.0)
            original = fleet.request(gid).deadline
            fleet.step()
            for ev in frame_events(gid, 1):
                sup.feed(0, ev)
            fleet.step()
            dec = next(h for h in sup.handles[1:]
                       if h.ops("submit_pages"))
            sup.feed(dec.id, tok_ev(gid, fleet.request(gid).generation,
                                    [8, 9]))
            fleet.step()
            sup.die(dec.id)
            fleet.step()
            # replay goes BACK through stage 1 (prompt + all emitted),
            # deadline unchanged
            replay = sup.handles[0].ops("prefill")[-1]
            assert replay["hid"] == 2
            assert replay["prompt"] == PROMPT.tolist() + [7, 8, 9]
            assert replay["max_new"] == 3
            assert replay["deadline"] == pytest.approx(original)
            assert fleet.metrics()["redispatches"] == 1
        finally:
            fleet.close()

    def test_degrade_to_colocated_when_no_prefill_healthy(self):
        fleet, sup = make_split_fleet(("prefill", "decode", "decode"))
        try:
            fleet.supervisor.retire(0)
            with pytest.warns(RuntimeWarning, match="no healthy prefill"):
                fleet.submit(PROMPT, max_new=4)
                fleet.step()
            # placed as a COLOCATED submit on a decode replica
            subs = [h for h in sup.handles[1:] if h.ops("submit")]
            assert len(subs) == 1
            assert not any(h.ops("prefill") for h in sup.handles)
            # one-shot: the second degrade does not warn again
            import warnings as _w

            with _w.catch_warnings():
                _w.simplefilter("error")
                fleet.submit(PROMPT, max_new=4)
                fleet.step()
        finally:
            fleet.close()

    def test_backpressure_pauses_transfers_then_sheds_typed(self):
        from paddle_tpu_torch.inference.serving import FleetOverloadedError

        fleet, sup = make_split_fleet(("prefill", "decode"),
                                      max_pending_handoffs=1, max_queue=1)
        try:
            g1 = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            # handoff 1 in flight; request 2 must NOT start a transfer
            g2 = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            assert len(sup.handles[0].ops("prefill")) == 1
            assert fleet.request(g2).state == "queued"
            # the bounded admission queue sheds the next one — typed,
            # never silent growth
            with pytest.raises(FleetOverloadedError):
                fleet.submit(PROMPT, max_new=4)
            # transfer completes -> the paused request proceeds
            for ev in frame_events(g1, 1):
                sup.feed(0, ev)
            fleet.step()
            sup.feed(1, tok_ev(g1, fleet.request(g1).generation,
                               [1, 2, 3], fin=True, reason="length"))
            fleet.step()
            fleet.step()
            assert len(sup.handles[0].ops("prefill")) == 2
        finally:
            fleet.close()

    def test_stage1_head_cannot_deadlock_stage2_behind_it(self):
        """Regression: a stage-1 replay requeued IN FRONT of a
        pages-ready request (decode-death ordering) must not deadlock —
        the stage-2 request behind the backpressure-blocked head is the
        only thing that can drain the pending-handoff count, so it
        places even from behind the head."""
        fleet, sup = make_split_fleet(("prefill", "decode"),
                                      max_pending_handoffs=1,
                                      max_inflight_per_replica=1)
        try:
            ga = fleet.submit(PROMPT, max_new=6)
            fleet.step()
            for ev in frame_events(ga, 1):
                sup.feed(0, ev)
            fleet.step()  # ga pages -> placed on the decode replica
            assert sup.handles[1].ops("submit_pages")
            sup.feed(1, tok_ev(ga, fleet.request(ga).generation, [8]))
            fleet.step()  # ack: ga's buffered pages dropped
            assert fleet.request(ga).pages is None
            gb = fleet.submit(PROMPT, max_new=6)
            fleet.step()  # pending handoffs 0 -> gb's prefill starts
            for ev in frame_events(gb, 1):
                sup.feed(0, ev)
            fleet.step()
            # decode replica full (inflight cap 1): gb waits QUEUED
            # with verified pages -> pending handoffs at the bound
            assert fleet.request(gb).state == "queued"
            assert fleet.request(gb).pages is not None
            # ga's decode replica dies: ga requeues as a stage-1 replay
            # IN FRONT of pages-ready gb; the respawn comes back ready
            sup.die(1)
            fleet.step()
            sup.handles[1].ready = True
            # pre-fix: head ga blocks on the pending-handoff count that
            # only gb (behind it) can reduce — the fleet wedges with a
            # healthy idle decode worker
            for _ in range(4):
                fleet.step()
            sub = sup.handles[1].ops("submit_pages")
            assert len(sub) == 1 and sub[0]["gid"] == gb
            sup.feed(1, tok_ev(gb, fleet.request(gb).generation,
                               [9, 10, 11, 12, 13], fin=True,
                               reason="length"))
            fleet.step()
            fleet.step()
            # ...which drained the buffer and unblocked ga's replay
            replays = sup.handles[0].ops("prefill")
            assert len(replays) == 3 and replays[-1]["gid"] == ga
            assert replays[-1]["prompt"] == PROMPT.tolist() + [7, 8]
            for ev in frame_events(ga, fleet.request(ga).hid,
                                   first_tok=20):
                sup.feed(0, ev)
            fleet.step()
            fleet.step()
            sup.feed(1, tok_ev(ga, fleet.request(ga).generation,
                               [21, 22, 23], fin=True, reason="length"))
            fleet.step()
            assert fleet.result(ga).tolist() == \
                PROMPT.tolist() + [7, 8, 20, 21, 22, 23]
            assert fleet.result(gb).tolist() == \
                PROMPT.tolist() + [7, 9, 10, 11, 12, 13]
        finally:
            fleet.close()

    def test_close_mid_transfer_typed_guards(self):
        fleet, sup = make_split_fleet()
        gid = fleet.submit(PROMPT, max_new=4)
        fleet.step()
        for ev in frame_events(gid, 1)[:2]:
            sup.feed(0, ev)
        fleet.step()
        fleet.close()
        assert sup.shut
        with pytest.raises(EngineClosedError):
            fleet.submit(PROMPT, max_new=4)
        with pytest.raises(EngineClosedError):
            fleet.step()
        for metric in ("fleet_kv_pages_transferred_total",
                       "fleet_kv_transfer_retries_total",
                       "fleet_prefill_handoffs_total",
                       "fleet_handoff_failovers_total"):
            snap = om.REGISTRY.snapshot().get(metric, {"series": {}})
            assert not any(fleet._name in k for k in snap["series"]), \
                metric


class TestSessionAffinityFixes:
    def test_sessions_invalidated_on_dead_replica(self):
        """A dead replica's session pins are dropped on recovery — the
        next session request places least-loaded instead of steering at
        the corpse/cold respawn."""
        fleet, sup = make_split_fleet(("both", "both"))
        try:
            gid = fleet.submit(PROMPT, max_new=4, session="s")
            fleet.step()
            src = next(i for i, h in enumerate(sup.handles)
                       if h.ops("submit"))
            assert fleet._sessions["s"] == src
            sup.feed(src, tok_ev(gid, 1, [1, 2, 3, 4], fin=True,
                                 reason="length"))
            fleet.step()
            sup.die(src)
            fleet.step()
            assert "s" not in fleet._sessions
            # respawn comes back ready but HOT (load report): without
            # invalidation the stale pin would beat least-loaded and
            # steer the session at the cold slot anyway
            sup.handles[src].ready = True
            sup.feed(src, {"e": "load", "kv": 0.9, "occ": 0.9})
            fleet.step()
            fleet.submit(PROMPT, max_new=4, session="s")
            fleet.step()
            assert len(sup.handles[1 - src].ops("submit")) == 1
        finally:
            fleet.close()

    def test_session_pin_never_points_at_prefill_worker(self):
        fleet, sup = make_split_fleet(("prefill", "decode"))
        try:
            # forge a stale pin at the prefill worker: placement must
            # ignore it (the prefix cache lives on decode replicas)
            fleet._sessions["s"] = 0
            gid = fleet.submit(PROMPT, max_new=4, session="s")
            fleet.step()
            for ev in frame_events(gid, 1):
                sup.feed(0, ev)
            fleet.step()
            assert sup.handles[1].ops("submit_pages")
            assert fleet._sessions["s"] == 1
        finally:
            fleet.close()


class TestIdleBackoff:
    def test_idle_join_sleeps_instead_of_spinning(self):
        """An idle join(timeout=...) must back off exponentially:
        bounded step() calls, not a 5 ms busy-poll (and
        certainly not a hot spin)."""
        fleet, sup = make_split_fleet(("both",),
                                      idle_backoff=(0.002, 0.05))
        try:
            fleet.submit(PROMPT, max_new=4)
            fleet.step()
            calls = {"n": 0}
            orig = fleet.step

            def counting_step():
                calls["n"] += 1
                return orig()

            fleet.step = counting_step
            t0 = time.perf_counter()
            with pytest.raises(TimeoutError):
                fleet.join(timeout=0.4)
            wall = time.perf_counter() - t0
            assert wall >= 0.35
            # a busy spin would make tens of thousands of calls; the
            # backoff caps it near wall/floor at worst, wall/ceiling
            # once saturated
            assert calls["n"] < 220, calls["n"]
        finally:
            fleet.close()

    def test_backoff_helper_floor_ceiling(self):
        from paddle_tpu_torch.inference.serving.fleet.router import _IdleBackoff

        b = _IdleBackoff(floor=0.001, ceiling=0.004)
        assert b._delay == 0.001
        b.idle()
        b.idle()
        b.idle()
        assert b._delay == 0.004  # clamped at the ceiling
        b.idle()
        assert b._delay == 0.004
        b.reset()
        assert b._delay == 0.001



# ---------------------------------------------------------------------------
# fault-site + roles registration
# ---------------------------------------------------------------------------

class TestWiring:
    def test_new_fault_sites_registered(self):
        from paddle_tpu_torch.utils import fault_injection as fi

        assert "serve.prefill_crash" in fi.SITES
        assert "serve.kv_transfer_corrupt" in fi.SITES
        # armable (boolean sites probed via should_fire)
        with fi.inject("serve.prefill_crash", every_n=3) as inj:
            assert not fi.should_fire("serve.prefill_crash")
            assert not fi.should_fire("serve.prefill_crash")
            assert fi.should_fire("serve.prefill_crash")
            assert inj.fires == 1
        with fi.inject("serve.kv_transfer_corrupt", max_fires=1):
            assert fi.should_fire("serve.kv_transfer_corrupt")
            assert not fi.should_fire("serve.kv_transfer_corrupt")

    def test_supervisor_validates_roles(self):
        from paddle_tpu_torch.inference.serving.fleet import ReplicaSupervisor

        # both raise BEFORE any worker process spawns
        with pytest.raises(ValueError, match="roles"):
            ReplicaSupervisor(2, {}, roles=["prefill"])
        with pytest.raises(ValueError, match="unknown replica roles"):
            ReplicaSupervisor(1, {}, roles=["llama"])

    def test_typed_error_exported(self):
        from paddle_tpu_torch.inference.serving import fleet as fleet_mod

        assert issubclass(KVTransferError, RuntimeError)
        assert hasattr(fleet_mod, "KVTransferError")
        e = KVTransferError("boom", gid=3, retries=4)
        assert e.gid == 3 and e.retries == 4


# ---------------------------------------------------------------------------
# slow tier: the storm + the bench acceptance


# ===========================================================================
# tests/test_qos.py
# ===========================================================================

class ScriptedAutoscaleSupervisor(FakeSupervisor):
    """FakeSupervisor whose autoscale() replays a scripted decision
    sequence (the router's tick contract, minus the real hysteresis —
    tested directly on ReplicaSupervisor below)."""

    def __init__(self, n, script=()):
        super().__init__(n)
        self.script = list(script)
        self.gauges = []

    def autoscale(self, mn, mx, *, queue_depth, occupancy, **kw):
        self.gauges.append((queue_depth, occupancy))
        if not self.script:
            return None
        act = self.script.pop(0)
        if act == "up":
            i = len(self.handles)
            self.handles.append(FakeHandle(i))
            return ("up", i)
        return act



class TestRouterQoS:
    def test_hard_quota_rejects_with_retry_after(self):
        fleet, _ = make_fleet(1)
        try:
            # demand = len(prompt) + max_new = 10; limit = 20 tokens/s
            fleet.configure_tenant("acme", rate_tokens_per_s=20)
            fleet.submit(PROMPT, max_new=4, tenant="acme")
            fleet.submit(PROMPT, max_new=4, tenant="acme")
            with pytest.raises(TenantQuotaExceededError) as ei:
                fleet.submit(PROMPT, max_new=4, tenant="acme")
            assert ei.value.tenant == "acme"
            assert ei.value.retry_after_s > 0
            # the abuser's quota never touches other tenants
            fleet.submit(PROMPT, max_new=4, tenant="other")
            assert fleet.metrics()["quota_rejections"] == 1
            assert om.REGISTRY.get("fleet_quota_rejections_total").value(
                instance=fleet._name) == 1
        finally:
            fleet.close()

    def test_rejected_submit_burns_no_quota(self):
        fleet, _ = make_fleet(1, max_queue=1)
        try:
            fleet.configure_tenant("acme", rate_tokens_per_s=1000)
            fleet.submit(PROMPT, max_new=4, tenant="acme")
            with pytest.raises(FleetOverloadedError):
                fleet.submit(PROMPT, max_new=4, tenant="acme")
            # the shed request must not have charged the bucket
            assert fleet._tenant_quota["acme"].used == 10
        finally:
            fleet.close()

    def test_queue_full_shed_carries_retry_after(self):
        fleet, sup = make_fleet(1, max_queue=2)
        sup.handles[0].ready = False  # nothing placeable: queue fills
        try:
            fleet.submit(PROMPT, max_new=4)
            fleet.submit(PROMPT, max_new=4)
            with pytest.raises(FleetOverloadedError) as ei:
                fleet.submit(PROMPT, max_new=4)
            # no completion history yet: the conservative 1s fallback
            assert ei.value.retry_after_s == pytest.approx(1.0)
            assert ei.value.queue_depth == 2
        finally:
            fleet.close()

    def test_tenant_flood_site_sheds_typed(self):
        fleet, _ = make_fleet(1)
        try:
            with fi.inject("serve.tenant_flood") as inj:
                with pytest.raises(FleetOverloadedError) as ei:
                    fleet.submit(PROMPT, max_new=4, tenant="ddos")
                assert inj.fires == 1
            assert ei.value.retry_after_s is not None
            assert fleet.metrics()["requests_shed"] == 1
            # unarmed again: the exact same submit sails through
            fleet.submit(PROMPT, max_new=4, tenant="ddos")
        finally:
            fleet.close()

    def test_slo_admission_rejects_infeasible_deadline(self):
        fleet, _ = make_fleet(1, slo_admission=True)
        try:
            # no completion history: never guess-reject
            gid = fleet.submit(PROMPT, max_new=4, deadline_s=0.001)
            assert gid in fleet._reqs
            # with a TTFT estimate in hand, an un-meetable deadline is
            # rejected at placement with a typed retry hint
            fleet._ttft_ema = 0.5
            with pytest.raises(DeadlineInfeasibleError) as ei:
                fleet.submit(PROMPT, max_new=4, deadline_s=0.01)
            assert ei.value.retry_after_s >= 0.05
            assert fleet.metrics()["deadline_infeasible"] == 1
            assert om.REGISTRY.get("fleet_deadline_infeasible_total").value(
                instance=fleet._name) == 1
            # batch-tier work has no TTFT SLO: it queues regardless
            fleet.submit(PROMPT, max_new=4, deadline_s=0.01,
                         tier=TIER_BATCH)
        finally:
            fleet.close()

    def test_slo_admission_off_by_default(self):
        fleet, _ = make_fleet(1)
        try:
            fleet._ttft_ema = 99.0
            fleet.submit(PROMPT, max_new=4, deadline_s=0.01)
        finally:
            fleet.close()

    def test_dispatch_carries_tenant_and_tier(self):
        fleet, sup = make_fleet(1)
        try:
            fleet.submit(PROMPT, max_new=4, tenant="acme",
                         tier=TIER_BATCH)
            fleet.step()
            (sub,) = sup.handles[0].submits()
            assert sub["tenant"] == "acme" and sub["tier"] == TIER_BATCH
        finally:
            fleet.close()

    def test_tenant_config_pushed_and_repushed_on_respawn(self):
        fleet, sup = make_fleet(2)
        try:
            fleet.configure_tenant("acme", weight=2.0,
                                   rate_tokens_per_s=50,
                                   host_blocks=8, prefix_blocks=4)
            fleet.step()
            for h in sup.handles:
                (cfg,) = h.tenant_cfgs()
                assert cfg["tenant"] == "acme"
                assert cfg["weight"] == 2.0 and cfg["rate"] == 50.0
                assert cfg["host_blocks"] == 8
                assert cfg["prefix_blocks"] == 4
            # a respawned incarnation must be re-configured once ready
            sup.die(0)
            fleet.step()
            assert sup.handles[0].tenant_cfgs() == []  # not ready yet
            sup.feed(0, {"e": "ready", "replica": 0})
            fleet.step()
            assert len(sup.handles[0].tenant_cfgs()) == 1
        finally:
            fleet.close()

    def test_invalid_tenant_and_tier_rejected(self):
        fleet, _ = make_fleet(1)
        try:
            with pytest.raises(ValueError):
                fleet.submit(PROMPT, max_new=4, tier="turbo")
            with pytest.raises(ValueError):
                fleet.configure_tenant("")
        finally:
            fleet.close()


class TestRouterAutoscale:
    def test_scale_up_registers_new_replica(self):
        sup = ScriptedAutoscaleSupervisor(1, script=["up"])
        fleet, _ = make_fleet(sup=sup)
        try:
            fleet.enable_autoscale(1, 3)
            fleet.step()
            assert fleet.scale_ups == 1
            assert len(sup.handles) == 2
            # the newcomer is immediately placeable
            for _ in range(4):
                fleet.submit(PROMPT, max_new=4)
            fleet.step()
            assert len(sup.handles[1].submits()) == 2
        finally:
            fleet.close()

    def test_scale_down_drains_then_retires_zero_drop(self):
        sup = ScriptedAutoscaleSupervisor(2, script=[("down", 1)])
        fleet, _ = make_fleet(sup=sup)
        try:
            fleet.enable_autoscale(1, 3)
            fleet.step()   # decision -> drain(1, then="retire")
            assert fleet.scale_downs == 1
            fleet.step()   # nothing in flight: drain completes
            assert sup.handles[1].retired
            assert fleet.drains_completed == 1
            # repeated "down" for an already-draining replica is a no-op
        finally:
            fleet.close()

    def test_scale_down_kill_site_fires_mid_drain(self):
        sup = ScriptedAutoscaleSupervisor(2, script=[("down", 1)])
        fleet, _ = make_fleet(sup=sup)
        try:
            fleet.enable_autoscale(1, 3)
            with fi.inject("serve.scale_down_kill") as inj:
                fleet.step()
            assert inj.fires == 1
            # the drain was still initiated — the SIGKILL rides the
            # normal crash-redispatch path, so nothing is dropped
            assert fleet.scale_downs == 1
        finally:
            fleet.close()

    def test_gauges_feed_the_tick(self):
        sup = ScriptedAutoscaleSupervisor(2)
        fleet, _ = make_fleet(sup=sup)
        sup.handles[0].ready = False
        sup.handles[1].ready = False
        try:
            fleet.enable_autoscale(1, 3)
            fleet.submit(PROMPT, max_new=4)  # stays queued: none ready
            fleet.step()
            (qd, occ) = sup.gauges[-1]
            assert qd == 1 and occ == 0.0
        finally:
            fleet.close()

    def test_enable_autoscale_validates_bounds(self):
        fleet, _ = make_fleet(1)
        try:
            with pytest.raises(ValueError):
                fleet.enable_autoscale(0, 3)
            with pytest.raises(ValueError):
                fleet.enable_autoscale(3, 2)
            fleet.enable_autoscale(1, 2)
            fleet.disable_autoscale()
            fleet.step()  # disabled: no tick, no crash
        finally:
            fleet.close()


# ---------------------------------------------------------------------------
# ReplicaSupervisor.autoscale: the real decision logic (spawn faked)
# ---------------------------------------------------------------------------

class _Slot:
    def __init__(self, i, incarnation=0):
        self.id = i
        self.incarnation = incarnation
        self.ready = True
        self.retired = False
        self.alive = True
        self.role = "both"
        self.spawn_time = 0.0

    def close(self):
        self.alive = False

    def kill(self, grace_s=0.0):
        self.alive = False


@pytest.fixture
def sup_factory(monkeypatch, tmp_path):
    from paddle_tpu_torch.inference.serving.fleet.supervisor import (
        ReplicaSupervisor)

    monkeypatch.setattr(ReplicaSupervisor, "_spawn",
                        lambda self, i, inc: _Slot(i, inc))

    made = []

    def make(n=1, **kw):
        kw.setdefault("log_dir", str(tmp_path / f"sup{len(made)}"))
        kw.setdefault("instance", f"qos-sup-{len(made)}")
        s = ReplicaSupervisor(n, {}, **kw)
        made.append(s)
        return s

    yield make
    for s in made:
        s.shutdown()


class TestSupervisorAutoscale:
    def test_up_down_and_floors(self, sup_factory):
        sup = sup_factory(1)
        # busy + queued + headroom: grow by one
        d = sup.autoscale(1, 3, queue_depth=4, occupancy=0.9, now=100.0)
        assert d == ("up", 1) and sup.n_active == 2
        # idle + empty queue above the floor: nominate the top slot
        d = sup.autoscale(1, 3, queue_depth=0, occupancy=0.1, now=200.0)
        assert d == ("down", 1)
        assert om.REGISTRY.get("fleet_scale_down_total").value(
            instance=sup.instance) == 1
        sup.retire(1)  # the CALLER drains then retires (zero-drop)
        assert sup.n_active == 1
        # at the floor: never below min_replicas
        assert sup.autoscale(1, 3, queue_depth=0, occupancy=0.0,
                             now=300.0) is None

    def test_ceiling_and_hysteresis_band(self, sup_factory):
        sup = sup_factory(2)
        # at max: no growth however hot
        assert sup.autoscale(1, 2, queue_depth=9, occupancy=1.0,
                             now=100.0) is None
        # inside the watermark band: hold steady both ways
        assert sup.autoscale(1, 3, queue_depth=9, occupancy=0.5,
                             now=100.0) is None
        assert sup.autoscale(1, 3, queue_depth=0, occupancy=0.5,
                             now=100.0) is None
        # queued-but-idle (prefill-bound blip): no scale-up either
        assert sup.autoscale(1, 3, queue_depth=3, occupancy=0.1,
                             now=100.0) is None

    def test_cooldown_spaces_scale_events(self, sup_factory):
        sup = sup_factory(1)
        assert sup.autoscale(1, 4, queue_depth=4, occupancy=0.9,
                             now=100.0) is not None
        # inside the cooldown: the next decision is suppressed
        assert sup.autoscale(1, 4, queue_depth=4, occupancy=0.9,
                             now=101.0, cooldown_s=5.0) is None
        assert sup.autoscale(1, 4, queue_depth=4, occupancy=0.9,
                             now=106.0, cooldown_s=5.0) is not None

    def test_scale_event_budget_pauses_autoscale(self, sup_factory):
        sup = sup_factory(1)
        kw = dict(cooldown_s=0.0, max_events=2, window_s=10_000.0)
        assert sup.autoscale(1, 9, queue_depth=4, occupancy=0.9,
                             now=100.0, **kw) is not None
        assert sup.autoscale(1, 9, queue_depth=4, occupancy=0.9,
                             now=200.0, **kw) is not None
        # budget exhausted: one warning, then quiet — flapping load must
        # not churn replicas forever
        with pytest.warns(RuntimeWarning, match="scale-event budget"):
            assert sup.autoscale(1, 9, queue_depth=4, occupancy=0.9,
                                 now=300.0, **kw) is None
        assert sup.autoscale(1, 9, queue_depth=4, occupancy=0.9,
                             now=400.0, **kw) is None  # still quiet

    def test_validation(self, sup_factory):
        sup = sup_factory(1)
        with pytest.raises(ValueError):
            sup.autoscale(0, 3, queue_depth=0, occupancy=0.0)
        with pytest.raises(ValueError):
            sup.autoscale(3, 1, queue_depth=0, occupancy=0.0)
        with pytest.raises(ValueError):
            sup.autoscale(1, 3, queue_depth=0, occupancy=0.0,
                          low_water=0.8, high_water=0.2)

    def test_add_replica_appends_slot(self, sup_factory):
        sup = sup_factory(2)
        i = sup.add_replica()
        assert i == 2 and sup.handles[2].id == 2
        assert sup.n_active == 3
        assert om.REGISTRY.get("fleet_scale_up_total").value(
            instance=sup.instance) == 1




# ===========================================================================
# tests/test_integrity.py
# ===========================================================================

# ---------------------------------------------------------------------------
# router: sampled output audit -> referee -> quarantine
# ---------------------------------------------------------------------------

class QSupervisor(FakeSupervisor):
    """FakeSupervisor + the real supervisor's quarantine contract:
    guard on retired/pending-respawn, return the death record, leave
    the slot pending until respawn() (auto_respawn collapses the two
    for tests that don't care about the window)."""

    def __init__(self, n, auto_respawn=True):
        super().__init__(n)
        self.quarantines = []
        self.auto_respawn = auto_respawn
        self._pending_respawn = {}

    def quarantine(self, i, now=None):
        h = self.handles[i]
        if h.retired or i in self._pending_respawn:
            return None
        self.quarantines.append(i)
        h.alive = False
        leftovers = list(h.inbox)
        h.inbox = []
        self._pending_respawn[i] = 0.0
        if self.auto_respawn:
            self.respawn(i)
        return {"replica": i, "reason": "quarantine", "rc": -9,
                "rank": None, "events": leftovers}

    def respawn(self, i):
        old = self.handles[i]
        self.handles[i] = FakeHandle(i, old.role, old.incarnation + 1)
        self._pending_respawn.pop(i, None)


def make_audit_fleet(n=3, sup=None, **kw):
    sup = sup or QSupervisor(n)
    kw.setdefault("engine_kwargs", {"max_batch_size": 4})
    return Router(supervisor=sup, **kw), sup


def _serve(fleet, sup, toks=(7, 8, 9), **submit_kw):
    """Submit + place + finish one request; returns (req, server_id)."""
    gid = fleet.submit(PROMPT, max_new=len(toks), **submit_kw)
    fleet.step()
    req = fleet.request(gid)
    assert req.replica is not None
    sup.feed(req.replica, {"e": "tok", "gid": gid, "gen": req.generation,
                           "toks": list(toks), "fin": True,
                           "reason": "length"})
    server = req.replica
    fleet.step()
    assert req.state == "done"
    return req, server


def _pending_audit(fleet):
    return next(r for r in fleet._reqs.values() if r.audit is not None)


def _finish_audit(fleet, sup, audit, toks):
    sup.feed(audit.replica, {"e": "tok", "gid": audit.gid,
                             "gen": audit.generation, "toks": list(toks),
                             "fin": True, "reason": "length"})
    fleet.step()


class TestRouterAudit:
    def test_clean_audit_on_different_replica(self):
        fleet, sup = make_audit_fleet(audit_fraction=1.0)
        try:
            req, server = _serve(fleet, sup)
            fleet.step()                      # place the audit replay
            audit = _pending_audit(fleet)
            assert audit.replica != server    # a DIFFERENT replica
            assert audit.tier == "batch"      # background work
            assert list(audit.prompt) == list(PROMPT)
            _finish_audit(fleet, sup, audit, (7, 8, 9))
            m = fleet.metrics()
            assert m["audits_run"] == 1 and m["audit_mismatches"] == 0
            assert fleet.audit_log[-1]["verdict"] == "match"
            assert audit.gid not in fleet._reqs   # audits self-release
            assert not fleet.pending()
        finally:
            fleet.close()

    def test_audit_fraction_zero_never_audits(self):
        fleet, sup = make_audit_fleet()             # default fraction 0.0
        try:
            _serve(fleet, sup)
            fleet.step()
            assert not any(r.audit for r in fleet._reqs.values())
            assert fleet.metrics()["audits_run"] == 0
        finally:
            fleet.close()

    def test_single_replica_fleet_skips_audits(self):
        fleet, sup = make_audit_fleet(n=1, audit_fraction=1.0)
        try:
            _serve(fleet, sup)
            fleet.step()
            assert not any(r.audit for r in fleet._reqs.values())
        finally:
            fleet.close()

    def _mismatch(self, fleet, sup, served=(5, 6, 7),
                  corrupt=(5, 6, 999)):
        req, server = _serve(fleet, sup, toks=served)
        fleet.step()
        audit = _pending_audit(fleet)
        auditor = audit.replica
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            _finish_audit(fleet, sup, audit, corrupt)
        return server, auditor

    def test_referee_votes_auditor_corrupt(self):
        fleet, sup = make_audit_fleet(audit_fraction=1.0)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                server, auditor = self._mismatch(fleet, sup)
                assert fleet.metrics()["audit_mismatches"] == 1
                fleet.step()                  # place the referee
                referee = _pending_audit(fleet)
                assert referee.audit["stage"] == "referee"
                assert referee.replica not in (server, auditor)
                _finish_audit(fleet, sup, referee, (5, 6, 7))  # = served
            m = fleet.metrics()
            assert m["replicas_quarantined"] == 1, m
            assert sup.quarantines == [auditor]
            assert fleet.audit_log[-1]["stage"] == "quarantine"
            assert fleet.audit_log[-2]["verdict"] == "auditor_corrupt"
        finally:
            fleet.close()

    def test_referee_votes_server_corrupt(self):
        fleet, sup = make_audit_fleet(audit_fraction=1.0)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                server, auditor = self._mismatch(fleet, sup)
                fleet.step()
                referee = _pending_audit(fleet)
                # referee reproduces the AUDIT stream -> the server
                # (majority 2-of-3 against it) is the corrupt one
                _finish_audit(fleet, sup, referee, (5, 6, 999))
            assert sup.quarantines == [server]
            assert fleet.audit_log[-2]["verdict"] == "server_corrupt"
        finally:
            fleet.close()

    def test_two_replica_mismatch_charges_both(self):
        # no third replica for a referee: both parties get ONE charge
        # each (threshold 2) — suspicion, not a verdict
        fleet, sup = make_audit_fleet(n=2, audit_fraction=1.0)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                server, auditor = self._mismatch(fleet, sup)
            assert sup.quarantines == []
            assert fleet._suspicion[server].score() == 1
            assert fleet._suspicion[auditor].score() == 1
        finally:
            fleet.close()

    def test_stale_incarnation_evidence_dropped(self):
        fleet, sup = make_audit_fleet(audit_fraction=1.0)
        try:
            fleet._charge_suspicion(1, 99, "stale", inc=7)  # wrong inc
            assert sup.quarantines == []
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                fleet._charge_suspicion(1, 99, "fresh",
                                        inc=sup.handles[1].incarnation)
            assert sup.quarantines == [1]
        finally:
            fleet.close()

    def test_weight_audit_events_charge_to_quarantine(self):
        fleet, sup = make_audit_fleet()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for _ in range(2):            # SuspicionScore threshold
                    fleet._handle_event_from(0, {
                        "e": "integrity", "kind": "weight_audit",
                        "replica": 0})
            assert sup.quarantines == [0]
            assert fleet.metrics()["replicas_quarantined"] == 1
        finally:
            fleet.close()


class TestQuarantineReloadDrain:
    def test_quarantine_mid_drain_redispatches_no_double_restart(self):
        sup = QSupervisor(3, auto_respawn=False)
        fleet, sup = make_audit_fleet(sup=sup, ckpt_root="/tmp/nonexistent")
        try:
            gid = fleet.submit(PROMPT, max_new=4)
            fleet.step()
            req = fleet.request(gid)
            victim = req.replica
            fleet.drain(victim, then="reload")
            assert victim in fleet._draining  # held open by the inflight
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for _ in range(2):
                    fleet._handle_event_from(victim, {
                        "e": "integrity", "kind": "weight_audit",
                        "replica": victim})
                assert sup.quarantines == [victim]
                # dying cancels the drain; the in-flight request rides
                # crash-redispatch to a healthy peer
                assert victim not in fleet._draining
                fleet.step()
            assert req.replica is not None and req.replica != victim
            assert req.redispatches == 1
            # more evidence during the respawn window must NOT burn a
            # second restart-budget slot
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for _ in range(2):
                    fleet._handle_event_from(victim, {
                        "e": "integrity", "kind": "weight_audit",
                        "replica": victim})
            assert sup.quarantines == [victim]
            assert fleet.metrics()["replicas_quarantined"] == 1
            sup.respawn(victim)
            # post-respawn, stale-incarnation evidence is dropped too
            fleet._charge_suspicion(victim, 99, "stale", inc=0)
            assert sup.quarantines == [victim]
        finally:
            fleet.close()

    def test_hot_swap_lands_while_peer_quarantined(self):
        sup = QSupervisor(3, auto_respawn=False)
        fleet, sup = make_audit_fleet(sup=sup, ckpt_root="/tmp/nonexistent")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for _ in range(2):
                    fleet._handle_event_from(2, {
                        "e": "integrity", "kind": "weight_audit",
                        "replica": 2})
            assert sup.quarantines == [2]     # 2 is down, respawn pending
            fleet.drain(0, then="reload")
            fleet.step()                      # no inflight -> reload now
            assert any(m.get("op") == "reload"
                       for m in sup.handles[0].sent)  # weights land
            fleet._handle_event_from(0, {"e": "reloaded", "step": 7})
            assert fleet.drains_completed == 1
            assert (0, 7) in fleet.reloads
            # the quarantine survived the hot-swap: still pending, still
            # exactly one restart charged
            assert 2 in sup._pending_respawn
            assert fleet.metrics()["replicas_quarantined"] == 1
            assert sup.quarantines == [2]
        finally:
            fleet.close()


# ===========================================================================
# parity with the JAX package
# ===========================================================================

class FakeClock:
    """Stands in for the router modules' ``time``: ``time()`` and
    ``perf_counter()`` read a clock the script advances, so deadlines and
    timestamps are equal in both packages' runs."""

    def __init__(self, t=1000.0):
        self.t = t

    def time(self):
        return self.t

    perf_counter = time

    def sleep(self, s):
        self.t += s


class RecordingSupervisor(QSupervisor):
    """QSupervisor that keeps every handle it ever made (respawns too), so
    the commands each replica incarnation received can be compared."""

    def __init__(self, roles):
        super().__init__(roles)
        self.made = list(self.handles)

    def die(self, i, leftover=()):
        super().die(i, leftover)
        self.made.append(self.handles[i])

    def respawn(self, i):
        super().respawn(i)
        self.made.append(self.handles[i])


PARITY_ROLES = ("prefill", "decode", "decode", "decode")


def run_script(router_cls, router_mod, fi_mod, monkeypatch):
    """One scripted event sequence through ``router_cls`` over a
    RecordingSupervisor: submits with a deadline, a tenant and a session;
    a clean and a corrupt page transfer; tok events; a decode replica's
    death with final events and the redispatch; typed refusals (expired,
    over quota, flood); audits, one mismatching, refereed into a
    quarantine; a drain-reload. Returns everything observable."""
    clock = FakeClock()
    monkeypatch.setattr(router_mod, "time", clock)
    sup = RecordingSupervisor(list(PARITY_ROLES))
    r = router_cls(supervisor=sup, engine_kwargs={"max_batch_size": 4},
                   audit_fraction=1.0, ckpt_root="/ckpt/root", max_queue=8)
    outcomes = []

    def attempt(label, prompt, **kw):
        try:
            gid = r.submit(prompt, **kw)
        except Exception as ex:  # the typed refusals under comparison
            outcomes.append((label, type(ex).__name__))
            return None
        outcomes.append((label, gid))
        return gid

    def req(gid):
        return r.request(gid)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        r.configure_tenant("acme", weight=2.0, rate_tokens_per_s=50.0,
                           window_s=60.0)
        a = attempt("a", PROMPT, max_new=6, deadline_s=30.0,
                    tenant="acme", session="s1")
        b = attempt("b", PROMPT + 10, max_new=3, session="s2",
                    tier="batch")
        attempt("expired", PROMPT, max_new=2, deadline_s=0.0)
        r.step()  # tenant envelopes pushed; a and b prefill on replica 0
        for ev in frame_events(a, req(a).hid, first_tok=7):
            sup.feed(0, ev)
        for ev in frame_events(b, req(b).hid, corrupt_seq=1, first_tok=9):
            sup.feed(0, ev)
        r.step()  # a's pages go to a decode replica; b's prefill re-drives
        clock.t += 0.5
        for ev in frame_events(b, req(b).hid, first_tok=9):
            sup.feed(0, ev)
        r.step()
        ra, rb = req(a).replica, req(b).replica
        sup.feed(ra, tok_ev(a, req(a).generation, [8]))
        r.step()
        sup.die(ra, leftover=[tok_ev(a, req(a).generation, [9])])
        r.step()  # a replays from prompt + [7, 8, 9]: a fresh prefill
        sup.feed(ra, {"e": "ready", "replica": ra, "incarnation": 1})
        for ev in frame_events(a, req(a).hid, first_tok=10):
            sup.feed(0, ev)
        r.step()
        attempt("big", PROMPT, max_new=3000, tenant="acme")
        attempt("over quota", PROMPT, max_new=2, tenant="acme")
        with fi_mod.inject("serve.tenant_flood", max_fires=1):
            attempt("flood", PROMPT, max_new=2)
        clock.t += 0.5
        sup.feed(req(b).replica, tok_ev(b, req(b).generation, [1, 2],
                                        fin=True, reason="length"))
        sup.feed(req(a).replica, tok_ev(a, req(a).generation, [11, 12],
                                        fin=True, reason="length"))
        r.step()  # both done; their audits queue
        r.step()  # and place
        audits = sorted((x for x in r._reqs.values() if x.audit),
                        key=lambda x: x.audit["of"])
        for au in audits:
            served = req(au.audit["of"]).emitted
            toks = served if au.audit["of"] == b else served[:-1] + [999]
            sup.feed(au.replica, tok_ev(au.gid, au.generation, toks,
                                        fin=True, reason="length"))
        r.step()  # a's mismatch spawns a referee
        r.step()
        for ref in [x for x in r._reqs.values() if x.audit]:
            sup.feed(ref.replica, tok_ev(ref.gid, ref.generation,
                                         req(a).emitted, fin=True,
                                         reason="length"))
        r.step()  # the referee sides with the server: auditor quarantined
        idle = next(h.id for h in sup.handles
                    if h.role == "decode" and h.alive and h.ready
                    and not r.inflight(h.id))
        r.drain(idle, then="reload")
        r.step()
        sup.feed(idle, {"e": "reloaded", "replica": idle, "step": 5})
        r.step()
    results = {gid: (x.state, list(x.emitted), x.finish_reason,
                     type(x.error).__name__ if x.error else None)
               for gid, x in r._reqs.items()}
    metrics = {k: v for k, v in r.metrics().items() if k != "instance"}
    out = {"outcomes": outcomes, "results": results, "metrics": metrics,
           "audit_log": r.audit_log, "reloads": r.reloads,
           "quarantines": sup.quarantines,
           "commands": [(h.id, h.incarnation, [json.dumps(c) for c in
                                               h.sent])
                        for h in sup.made]}
    r.close()
    return out


def test_router_parity_with_the_jax_package(monkeypatch):
    import paddle_tpu.inference.serving.fleet.router as jax_router_mod
    import paddle_tpu.utils.fault_injection as jax_fi
    import paddle_tpu_torch.inference.serving.fleet.router as router_mod

    ref = run_script(jax_router_mod.Router, jax_router_mod, jax_fi,
                     monkeypatch)
    got = run_script(Router, router_mod, fi, monkeypatch)
    assert got["commands"] == ref["commands"]
    assert got["results"] == ref["results"]
    assert got["metrics"] == ref["metrics"]
    assert got["outcomes"] == ref["outcomes"]
    assert got["audit_log"] == ref["audit_log"]
    assert got["reloads"] == ref["reloads"] == [(got["reloads"][0][0], 5)]
    # the script reached every branch it names
    m = got["metrics"]
    assert m["redispatches"] >= 1 and m["kv_transfer_retries"] == 1
    assert m["prefill_handoffs"] >= 3 and m["replicas_quarantined"] == 1
    assert m["audit_mismatches"] == 1 and m["drains_completed"] == 1
    assert m["quota_rejections"] == 1 and m["requests_shed"] == 1
    assert m["deadline_expired"] == 1
    assert dict(got["outcomes"])["over quota"] == "TenantQuotaExceededError"
    assert dict(got["outcomes"])["flood"] == "FleetOverloadedError"
    assert dict(got["outcomes"])["expired"] == "RequestTimeoutError"
    assert any(v[:2] == ("done", [7, 8, 9, 10, 11, 12])
               for v in got["results"].values())


@pytest.mark.parametrize("frame_bytes", [None, 7, 4096])
def test_frames_cross_between_the_packages(frame_bytes):
    from paddle_tpu.inference.serving.fleet import framing as jax_framing
    from paddle_tpu_torch.inference.serving.fleet import framing

    assert framing.FRAME_BYTES == jax_framing.FRAME_BYTES
    blob = np.random.RandomState(3).bytes(10_000)
    crc = zlib.crc32(blob)
    for enc, dec in ((framing, jax_framing), (jax_framing, framing)):
        chunks = enc.split_frames(blob, frame_bytes)
        assert chunks == dec.split_frames(blob, frame_bytes)
        frames = [enc.encode_frame(c) for c in chunks]
        assert frames == [dec.encode_frame(c) for c in chunks]
        got = {i: dec.decode_frame(f) for i, f in enumerate(frames)}
        assert dec.join_frames(got, len(chunks), crc) == (blob, None)
        bad = enc.encode_frame(chunks[0], corrupt=True)
        assert bad["crc"] == frames[0]["crc"] and bad != frames[0]
        assert dec.decode_frame(bad) is None
        assert dec.join_frames(dict(list(got.items())[1:]), len(chunks),
                               crc)[1] == (
            f"only {len(chunks) - 1}/{len(chunks)} frames arrived")
        assert dec.join_frames(got, len(chunks), crc ^ 1) == (
            None, "payload CRC mismatch")


def test_restart_budget_decides_as_the_reference():
    from paddle_tpu.distributed.launch.controllers import collective as ref
    from paddle_tpu_torch.distributed.launch.controllers import collective

    def script(mod):
        now = [0.0]
        slept = []
        b = mod.RestartBudget(3, window_s=10.0, backoff_base_s=0.5,
                              backoff_cap_s=1.5, clock=lambda: now[0],
                              sleep=slept.append)
        out = []
        for t, op in [(0, "acq"), (1, "back"), (1, "acq"), (2, "back"),
                      (3, "acq"), (3, "back"), (4, "acq"), (11.5, "used"),
                      (11.5, "acq"), (12, "back"), (13, "pre")] + \
                [(14 + k * 0.1, "pre") for k in range(17)] + \
                [(30, "pre"), (30, "used")]:
            now[0] = float(t)
            out.append({"acq": b.try_acquire, "back": b.backoff,
                        "pre": b.note_preemption,
                        "used": lambda: b.used}[op]())
        return out, slept, b.total_restarts, b.preemptions

    assert script(collective) == script(ref)
    assert collective.RestartBudget.PREEMPT_CAP_PER_WINDOW == \
        ref.RestartBudget.PREEMPT_CAP_PER_WINDOW


def test_restart_budget_reads_the_flags():
    import paddle_tpu_torch
    from paddle_tpu.distributed.launch.controllers.collective import (
        RestartBudget as RefBudget)
    from paddle_tpu_torch.distributed.launch import RestartBudget

    assert (RestartBudget(1).window_s, RestartBudget(1).backoff_base_s) \
        == (RefBudget(1).window_s, RefBudget(1).backoff_base_s) \
        == (3600.0, 1.0)
    before = paddle_tpu_torch.get_flags(["FLAGS_restart_window_s",
                                         "FLAGS_restart_backoff_s"])
    try:
        paddle_tpu_torch.set_flags({"FLAGS_restart_window_s": 5.0,
                                    "FLAGS_restart_backoff_s": 0.25})
        b = RestartBudget(2)
        assert (b.window_s, b.backoff_base_s) == (5.0, 0.25)
    finally:
        paddle_tpu_torch.set_flags(before)


def test_supervisor_autoscale_decides_as_the_reference(monkeypatch,
                                                       tmp_path):
    from paddle_tpu.inference.serving.fleet.supervisor import (
        ReplicaSupervisor as RefSupervisor)
    from paddle_tpu_torch.inference.serving.fleet.supervisor import (
        ReplicaSupervisor)

    gauges = [(4, 0.9), (4, 0.9), (0, 0.5), (3, 0.1), (0, 0.1), (0, 0.0),
              (5, 1.0), (5, 1.0), (5, 1.0), (0, 0.2), (0, 0.2), (2, 0.8),
              (2, 0.8), (0, 0.0), (0, 0.0)]

    def script(cls, name):
        monkeypatch.setattr(cls, "_spawn", lambda self, i, inc: _Slot(i, inc))
        sup = cls(1, {}, log_dir=str(tmp_path / name),
                  instance=f"parity-{name}")
        out = []
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                for k, (q, occ) in enumerate(gauges):
                    d = sup.autoscale(1, 3, queue_depth=q, occupancy=occ,
                                      now=100.0 + 2.0 * k, cooldown_s=3.0,
                                      max_events=5, window_s=50.0)
                    if d is not None and d[0] == "down":
                        sup.retire(d[1])
                    out.append((d, sup.n_active))
            out.append([str(x.message).split(":")[1] for x in w])
        finally:
            sup.shutdown()
        return out

    got, ref = script(ReplicaSupervisor, "port"), script(RefSupervisor,
                                                          "ref")
    assert got == ref
    assert {d[0] for d, _ in got[:-1] if d} == {"up", "down"}
    assert len(got[-1]) == 1  # the budget ran out once, warned once


def test_groups_and_plans_are_refused():
    # tp groups are ported (the group cases below and
    # tests/test_torch_fleet_procs.py); what stays refused, before any
    # process spawns: an axis other than tp (ROADMAP item 8) and a plan
    # whose ranks are not the group's processes
    from paddle_tpu_torch.inference.serving.fleet import ReplicaSupervisor

    with pytest.raises(NotImplementedError, match="item 8"):
        ReplicaSupervisor(1, {"plan": {"axes": {"dp": 2}}}, group_size=2)
    with pytest.raises(ValueError, match="group_size"):
        ReplicaSupervisor(1, {"plan": {"axes": {"tp": 2}}})
    with pytest.raises(NotImplementedError, match="item 8"):
        Router(artifact="unused", n_replicas=1, group_size=4,
               plan={"axes": {"tp": 2, "dp": 2}})


# ===========================================================================
# tests/test_fleet.py:618-845: model-parallel replica groups, the
# supervisor's unit matrix. GroupFakeHandle implements the group-handle
# contract (members_live, dead_member, the atomic kill), so the watchdog,
# budget and gauge logic run without subprocesses; real groups are
# tests/test_torch_fleet_procs.py's.
# ===========================================================================

class GroupFakeHandle:
    class _Proc:
        def poll(self):
            return None

    def __init__(self, hid, incarnation=0, group_size=2):
        self.id = int(hid)
        self.incarnation = int(incarnation)
        self.group_size = int(group_size)
        self.ready = True
        self.ready_info = {"e": "ready", "replica": hid}
        self.retired = False
        self.spawn_time = time.time()
        self.killed = False
        self.dead = None  # (rank, rc) set by tests
        self.proc = self._Proc()
        self.role = "both"

    @property
    def alive(self):
        return not self.retired and not self.killed and self.dead is None

    @property
    def members_live(self):
        if self.killed:
            return 0
        return self.group_size - (1 if self.dead is not None else 0)

    def dead_member(self):
        return self.dead

    def kill(self, grace_s=0.0):
        self.killed = True

    def final_events(self, timeout=2.0):
        return []

    def send(self, obj):
        return not self.killed

    def events(self):
        return []

    def close(self):
        self.killed = True


def make_group_supervisor(monkeypatch, n=1, group_size=2, cls=None, **kw):
    if cls is None:
        from paddle_tpu_torch.inference.serving.fleet.supervisor import (
            ReplicaSupervisor as cls)

    monkeypatch.setattr(
        cls, "_spawn",
        lambda self, i, inc: GroupFakeHandle(i, inc, self.group_size))
    kw.setdefault("instance", f"grouptest#{time.monotonic_ns()}")
    return cls(n, {"artifact": "unused"}, group_size=group_size, **kw)


class TestGroupSupervisor:
    def test_validates_group_size_and_prefill_roles(self):
        from paddle_tpu_torch.inference.serving.fleet.supervisor import (
            ReplicaSupervisor)

        with pytest.raises(ValueError, match="group_size"):
            ReplicaSupervisor(1, {}, group_size=0)
        # disaggregated prefill slots cannot be groups: the handoff
        # exports pages to one host
        with pytest.raises(ValueError, match="prefill"):
            ReplicaSupervisor(2, {}, group_size=2,
                              roles=["prefill", "decode"])

    def test_boot_grace_scales_with_group_size(self, monkeypatch):
        sup = make_group_supervisor(monkeypatch, group_size=2,
                                    boot_grace_s=10.0, hang_timeout_s=5.0)
        try:
            assert sup.boot_grace_s == 20.0
            h = sup.handles[0]
            h.ready = False
            now = time.time()
            h.spawn_time = now - 15.0  # inside the scaled grace
            assert not sup._hung(h, {}, now)
            h.spawn_time = now - 25.0  # past it: condemned
            assert sup._hung(h, {}, now)
        finally:
            sup.shutdown()
        sup1 = make_group_supervisor(monkeypatch, group_size=1,
                                     boot_grace_s=10.0, hang_timeout_s=5.0)
        try:
            assert sup1.boot_grace_s == 10.0
        finally:
            sup1.shutdown()

    def test_hang_judged_by_stalest_member_heartbeat(self, monkeypatch):
        sup = make_group_supervisor(monkeypatch, group_size=2,
                                    hang_timeout_s=5.0)
        try:
            h = sup.handles[0]
            now = time.time()
            fresh = {"0.0": {"time": now}, "0.1": {"time": now}}
            assert not sup._hung(h, fresh, now)
            stale1 = {"0.0": {"time": now}, "0.1": {"time": now - 10.0}}
            assert sup._hung(h, stale1, now)
            # a member that never beat is judged from spawn_time
            h.spawn_time = now - 10.0
            assert sup._hung(h, {"0.0": {"time": now}}, now)
        finally:
            sup.shutdown()

    def test_member_crash_fells_group_one_budget_slot(self, monkeypatch):
        sup = make_group_supervisor(monkeypatch, group_size=2,
                                    max_restarts=3)
        try:
            h = sup.handles[0]
            assert om.REGISTRY.get("fleet_group_members_live").value(
                instance=sup.instance, replica=0) == 2
            h.dead = (1, -9)  # a non-zero rank SIGKILLed
            now = time.time()
            deaths = sup.check(now=now)
            # the death names the failing rank; the survivors were felled
            assert deaths == [{"replica": 0, "reason": "crash", "rc": -9,
                               "rank": 1, "events": []}]
            assert h.killed
            assert om.REGISTRY.get("fleet_group_members_live").value(
                instance=sup.instance, replica=0) == 0
            # the whole-group restart charges exactly one budget slot
            assert sup._budgets[0].used == 1
            deaths = sup.check(now=now + 120.0)
            assert deaths == []
            assert sup.handles[0] is not h
            assert sup.handles[0].incarnation == 1
            assert om.REGISTRY.get("fleet_group_members_live").value(
                instance=sup.instance, replica=0) == 2
            assert om.REGISTRY.get("fleet_group_restarts_total").value(
                instance=sup.instance) == 1
            assert om.REGISTRY.get("fleet_replica_restarts_total").value(
                instance=sup.instance) == 1
        finally:
            sup.shutdown()
        # shutdown removes the per-replica member gauge series
        snap = om.REGISTRY.snapshot().get("fleet_group_members_live",
                                          {"series": {}})
        assert not any(sup.instance in k for k in snap["series"])

    def test_crash_loop_error_names_failing_rank(self, monkeypatch):
        sup = make_group_supervisor(monkeypatch, group_size=2,
                                    max_restarts=0)
        with pytest.raises(ReplicaCrashLoopError, match="at group rank 1"):
            sup.handles[0].dead = (1, -9)
            sup.check()

    def test_group_retire_zeroes_member_gauge(self, monkeypatch):
        sup = make_group_supervisor(monkeypatch, n=2, group_size=2)
        try:
            sup.retire(1)
            assert om.REGISTRY.get("fleet_group_members_live").value(
                instance=sup.instance, replica=1) == 0
            assert om.REGISTRY.get("fleet_group_members_live").value(
                instance=sup.instance, replica=0) == 2
        finally:
            sup.shutdown()

    @pytest.mark.parametrize("dead,stale", [((1, -9), False),
                                            ((0, 1), False),
                                            (None, True)])
    def test_group_deaths_equal_the_references(self, monkeypatch, dead,
                                               stale):
        """The same group fault through both supervisors: the same death
        record (reason, rc, rank), budget charge and member gauge."""
        from paddle_tpu.inference.serving.fleet.supervisor import (
            ReplicaSupervisor as RefSupervisor)
        from paddle_tpu.observability import metrics as ref_om

        got = []
        for cls, reg in ((None, om.REGISTRY), (RefSupervisor,
                                                ref_om.REGISTRY)):
            sup = make_group_supervisor(monkeypatch, group_size=2, cls=cls,
                                        hang_timeout_s=5.0)
            try:
                h = sup.handles[0]
                now = time.time()
                if stale:
                    h.spawn_time = now - 10.0  # no member ever beat
                h.dead = dead
                deaths = sup.check(now=now)
                got.append((deaths, sup._budgets[0].used, h.killed,
                            reg.get("fleet_group_members_live").value(
                                instance=sup.instance, replica=0)))
            finally:
                sup.shutdown()
        assert got[0] == got[1]
        assert got[0][0][0]["reason"] == ("hang" if stale else "crash")


class TestGroupRejoinGate:
    def test_reload_rejects_stale_plan_fingerprint(self, tmp_path):
        """The group rejoin gate: reloading from the fleet's checkpoint
        root refuses a checkpoint recorded under another sharding plan
        (typed PlanMismatchError) and writes nothing. One process here:
        the gate is the same for every plan (the tp=2 group's is
        tests/test_torch_plan_engine.py's)."""
        import torch

        import paddle_tpu_torch as pt
        from paddle_tpu_torch.distributed.plan import Plan
        from paddle_tpu_torch.inference.serving import LLMEngine
        from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

        model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=0)
        mgr = pt.CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(100, model=LlamaForCausalLM(llama_tiny(), device="cpu",
                                             seed=1),
                 plan=Plan.build({"tp": 4}, ["tp"], devices=range(4)))
        with LLMEngine(model, num_blocks=8, block_size=8,
                       max_batch_size=2, ingest_async=False, device="cpu",
                       plan=Plan.build({"tp": 1}, ["tp"])) as eng:
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            with pytest.raises(pt.PlanMismatchError, match="mesh"):
                eng.reload_weights(mgr)
            assert all(torch.equal(p, before[n])
                       for n, p in model.named_parameters())
