"""Replica worker process (counterpart of
``paddle_tpu/inference/serving/fleet/replica.py``): one ``LLMEngine``
behind a line-JSON RPC loop, runnable as
``python -m paddle_tpu_torch.inference.serving.fleet.replica``.

Config arrives in ``PADDLE_REPLICA_CONFIG`` (JSON: ``artifact`` path from
:func:`~..engine.save_llama_artifact`, ``engine`` kwargs, ``hb_dir``
heartbeat directory, optional ``ckpt_root``, optional ``role`` —
``"both"``/``"prefill"``/``"decode"``). One engine kwarg is the
replica's own: ``device`` (default ``cuda``; the artifact is loaded there
and the engine runs there, and without a card the boot raises, so the
supervisor surfaces a crash loop rather than serving on the CPU). The
model is built in the dtype the artifact's weights load in (a bfloat16
artifact serves in bfloat16). Protocol (stdin commands → stdout events,
one JSON object per line):

  {"op":"submit","gid":g,"gen":k,"prompt":[...],"max_new":n,
   "eos":t|null,"deadline":s|null}      -> tok events as tokens emerge
  {"op":"prefill","gid":g,"gen":k,"hid":h,...}  -> kvpage* + kvdone
  {"op":"kvpage","gid":g,"seq":i,"total":T,"crc":c,"data":b64}
  {"op":"submit_pages","gid":g,"gen":k,"prompt":[...],"frames":T,
   "crc":c,...}                         -> import pages, then tok events
  {"op":"cancel","gid":g}               -> blocks freed, slot recycled
  {"op":"reload","root":path}           -> {"e":"reloaded","step":s}
  {"op":"stats"}                        -> {"e":"stats",...}
  {"op":"configure_tenant","tenant":name,...}
  {"op":"reset_metrics"}
  {"op":"shutdown"}                     -> drain in-flight, {"e":"bye"}

Events: ``ready`` (engine built, weights loaded, window graph captured:
with the checkpoint step it rejoined from, when a ``ckpt_root`` was
given, and the slot's ``role``), ``tok`` (``{"gid","gen","toks":[...],
"fin","reason"}``; ``gen`` echoes the dispatch generation so the router
can drop emissions from a superseded assignment), ``load`` (KV
utilization and decode occupancy, the router's least-loaded signal),
``stats`` (with this process's paged-attention launch counts since
``ready`` or the last ``reset_metrics``, graph replays included, and its
handoff totals: page bytes sent and the ms of export, pack and frames on
the pipe; page bytes received and the ms from a handoff's first frame to
its ``submit_pages``),
``reloaded``, ``integrity``, ``err``, ``bye``.

Disaggregated handoff: a ``prefill``-role worker runs its engine with
``prefill_only=True``. On ``{"op":"prefill"}`` it admits the request, and
when the engine samples the request's first token it exports the KV
pages, streams them up as CRC-framed ``kvpage`` events (``hid`` echoes the
handoff id, so the router drops a zombie's stale frames) and a ``kvdone``
carrying the first token, the whole-payload CRC and the payload's bytes,
then frees the request's blocks. A decode-capable worker buffers ``kvpage`` command
frames, verifies each CRC, and on ``submit_pages`` imports the payload
through ``LLMEngine.add_request_with_pages``; a corrupt or incomplete
buffer is refused with a typed ``err`` event (kind ``KVTransferError``)
so the router re-drives the prefill. stdout carries only protocol lines;
everything chatty goes to stderr (the supervisor's per-replica log).

Heartbeats (``distributed.launch.heartbeat.write``) are written at every
loop tick, stepping or idle. Chaos sites, armed from the environment
(``CHAOS_SERVE_SITE`` + ``CHAOS_SERVE_REPLICA`` + optional
``CHAOS_SERVE_AFTER_STEPS``, or ``CHAOS_SERVE_SITES``: a JSON list of
``{"site","replica","after"}``) in incarnation 0 only, so a respawned
replica runs clean:

* ``serve.replica_crash`` — SIGKILL self at a busy loop head;
* ``serve.replica_hang`` — wedge forever without heartbeating;
* ``serve.prefill_crash`` — SIGKILL self between kvpage frames;
* ``serve.kv_transfer_corrupt`` — corrupt a frame after its CRC;
* ``serve.bit_flip`` — flip a bit in the weights, a host-tier entry or a
  pool page (``CHAOS_SERVE_BIT_FLIP_TARGET``); nothing raises.

``PADDLE_SERVE_WEIGHT_AUDIT_TICKS=N`` re-hashes the live weights every N
loop ticks; a mismatch emits ``{"e":"integrity","kind":"weight_audit"}``
and reloads the artifact's weights in place.

**Replica groups** (``PADDLE_REPLICA_GROUP_SIZE`` > 1, a ``plan`` in the
config: ``{"axes": {"tp": n}, "strategies": ["tp"]}``): every member
joins a ``torch.distributed`` group on the incarnation's fresh
coordination port (a ``TCPStore`` that rank 0 hosts; the backend is
gloo when the ranks share a card or run on the CPU, NCCL for a card a
rank), builds the plan over it and serves its shard of the engine in
SPMD lockstep. Rank 0 is the group's one mouth: it alone reads commands
and emits events, and publishes each busy tick's commands on the store
(:class:`_GroupChannel`, the counterpart of the reference's coordination
KV store) before applying them; members apply exactly those, in order,
so every collective lines up. Deadlines are stripped (the router
enforces them: a wall clock cannot be followed in lockstep). Every
member heartbeats under ``hb.<replica>.<rank>``, warms its engine and
passes a barrier before rank 0 reports ``ready``. The chaos sites take a
``"rank"`` (``CHAOS_SERVE_RANK``; default 0), and
``serve.group_member_crash``/``serve.group_member_hang`` kill or wedge
one member. The periodic weight audit is off in groups.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import sys
import threading
import time
import zlib

from .framing import decode_frame, encode_frame, join_frames, split_frames
from .supervisor import (ENV_CONFIG, ENV_COORD_PORT, ENV_GROUP_RANK,
                         ENV_GROUP_SIZE, ENV_ID, ENV_INCARNATION)

__all__ = ["replica_worker_main"]

# a group's non-zero ranks run the same engine in lockstep but own no RPC
# stream: rank 0 is the group's one mouth
_SILENT = [False]

#: seconds a group's store calls and collectives may block
GROUP_TIMEOUT_S = 300.0


def _emit(obj):
    if _SILENT[0]:
        return
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


class _GroupChannel:
    """Rank 0 → member command broadcast for a replica group, over the
    group's ``TCPStore``. The contract is SPMD lockstep: rank 0 publishes
    one ``fleet.tick.<seq>`` entry per busy loop iteration carrying
    exactly the commands it is about to apply; every member applies the
    same commands to an identical engine and then steps, so the
    collectives inside the step line up by construction. Idle iterations
    publish nothing; members poll with a timeout so their heartbeats stay
    fresh while idle. Consumed entries are deleted ``_GC_LAG`` ticks
    behind the publisher."""

    _GC_LAG = 512

    def __init__(self, store):
        self._store = store
        self._seq = 0

    def publish(self, cmds):
        self._store.set(f"fleet.tick.{self._seq}", json.dumps(cmds))
        old = self._seq - self._GC_LAG
        if old >= 0:
            self._store.delete_key(f"fleet.tick.{old}")
        self._seq += 1

    def fetch(self, timeout_ms=250):
        """The next tick's commands, or ``None`` on timeout (idle)."""
        import datetime

        import torch.distributed as dist

        key = f"fleet.tick.{self._seq}"
        try:
            self._store.wait([key],
                             datetime.timedelta(milliseconds=timeout_ms))
        except dist.DistStoreError:
            # the wait's timeout; a lost store (rank 0 gone) raises
            # DistNetworkError and ends this member
            return None
        self._seq += 1
        return json.loads(self._store.get(key))


def _join_group(group_size, group_rank, device):
    """Rendezvous on the incarnation's coordination port: rank 0 hosts
    the ``TCPStore``, every member joins the default process group over
    it (``init_parallel_env`` chooses the backend from the placement).
    Returns the store (the command channel's)."""
    import datetime

    import torch.distributed as dist

    from ....distributed import init_parallel_env

    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", int(os.environ[ENV_COORD_PORT]),
                          group_size, is_master=group_rank == 0,
                          timeout=timeout)
    init_parallel_env(rank=group_rank, world_size=group_size,
                      store=dist.PrefixStore("pg", store), device=device,
                      timeout_s=GROUP_TIMEOUT_S)
    return store


# the armed inject() context managers must outlive _arm_chaos: a collected
# contextmanager generator runs its finally block and disarms the site
_CHAOS_CMS: list = []


def _chaos_specs(replica_id, group_rank=0):
    """Armed (site, after, max_fires) specs for this process. Specs may
    carry a ``"rank"`` (default 0), so a group drill poisons one
    member."""
    multi = os.environ.get("CHAOS_SERVE_SITES")
    if multi:
        try:
            specs = json.loads(multi)
        except ValueError:
            return []
        return [(s["site"], int(s.get("after", 1) or 1),
                 s.get("max_fires")) for s in specs
                if str(s.get("replica")) == str(replica_id)
                and int(s.get("rank", 0) or 0) == int(group_rank)]
    site = os.environ.get("CHAOS_SERVE_SITE")
    if site and os.environ.get("CHAOS_SERVE_REPLICA") == str(replica_id) \
            and int(os.environ.get("CHAOS_SERVE_RANK", "0")
                    or 0) == int(group_rank):
        return [(site,
                 int(os.environ.get("CHAOS_SERVE_AFTER_STEPS", "1") or 1),
                 None)]
    return []


def _arm_chaos(replica_id, group_rank=0):
    if int(os.environ.get(ENV_INCARNATION, "0") or 0) != 0:
        return  # restarted incarnations run clean
    from ....utils import fault_injection as fi

    for site, after, max_fires in _chaos_specs(replica_id, group_rank):
        cm = fi.inject(site, every_n=after, max_fires=max_fires)
        cm.__enter__()
        _CHAOS_CMS.append(cm)


def replica_worker_main():
    replica_id = int(os.environ[ENV_ID])
    group_size = int(os.environ.get(ENV_GROUP_SIZE, "1") or 1)
    group_rank = int(os.environ.get(ENV_GROUP_RANK, "0") or 0)
    _SILENT[0] = group_rank != 0
    cfg = json.loads(os.environ[ENV_CONFIG])
    _arm_chaos(replica_id, group_rank)

    import numpy as np
    import torch

    from ....distributed.checkpoint.manager import CheckpointManager
    from ....distributed.launch import heartbeat as hb
    from ....ops.cuda import paged_attention as _kernels
    from ....utils import fault_injection as fi
    from .. import integrity as _integrity
    from ..engine import LLMEngine, load_llama_artifact
    from ..errors import RequestTimeoutError
    from ..kv_cache import pack_kv_pages, unpack_kv_pages
    from ..scheduler import SamplingParams

    role = cfg.get("role") or "both"
    engine_kw = dict(cfg.get("engine") or {})
    device = engine_kw.pop("device", None) or "cuda"
    store = None
    if group_size > 1:
        if (torch.device(device).type == "cuda"
                and torch.cuda.device_count() >= group_size):
            device = f"cuda:{group_rank}"  # a card a rank: NCCL
        store = _join_group(group_size, group_rank, device)
    model = load_llama_artifact(cfg["artifact"], device=device,
                                dtype="saved")
    plan_spec = cfg.get("plan")
    if plan_spec:
        # the plan from its JSON spec, over the group's ranks (or this
        # process alone)
        from ....distributed.plan import Plan

        engine_kw["plan"] = Plan.build(
            dict(plan_spec["axes"]),
            [s if isinstance(s, str) else tuple(s)
             for s in plan_spec.get("strategies") or ()])
    if engine_kw.get("prefix_store_path"):
        # each replica persists its own prefix-store shard: the fleet API
        # takes a ``{replica}`` template
        engine_kw["prefix_store_path"] = str(
            engine_kw["prefix_store_path"]).replace(
                "{replica}", str(replica_id))
    eng = LLMEngine(model, ingest_async=False,
                    prefill_only=(role == "prefill"), device=device,
                    **engine_kw)
    reloaded = None
    root = cfg.get("ckpt_root")
    if root:
        # rejoin contract: a (re)started replica serves the newest healthy
        # checkpoint, never the artifact's possibly stale weights
        mgr = CheckpointManager(root)
        if (mgr.latest_healthy_step() is not None
                or mgr.latest_valid_step() is not None):
            reloaded = eng.reload_weights(mgr)
    hb_dir = cfg.get("hb_dir")
    # group members heartbeat under hb.<replica>.<rank>: every member
    # beats, so the watchdog condemns the group when any member wedges
    hb_rank = (f"{replica_id}.{group_rank}" if group_size > 1
               else replica_id)
    hb.write(step=0, dir=hb_dir, rank=hb_rank)

    # Window engines warm before ready: the first window captures its
    # CUDA graph, which must not read as a hang to the watchdog, and the
    # boot grace (not the heartbeat) covers one-time work. Groups warm
    # too (every member runs the same warm-up, so its collectives line
    # up): their first collectives connect the group.
    if (eng._in_graph or group_size > 1) and role != "prefill":
        wid = eng.add_request(np.zeros(4, dtype=np.int64),
                              SamplingParams(max_new_tokens=2))
        while not any(o.rid == wid and o.finished for o in eng.step()):
            pass
        eng.release(wid)
        eng.reset_metrics()
        eng.reset_block_high_water()
        _kernels.reset_launch_counts()
        # the warm-up ran past the boot heartbeat: refresh it before ready
        hb.write(step=0, dir=hb_dir, rank=hb_rank)

    chan = None
    if group_size > 1:
        # ready only after every rank acks its warm-up: a group where one
        # rank is still building must not take traffic
        from ....distributed import barrier

        barrier()
        hb.write(step=0, dir=hb_dir, rank=hb_rank)
        chan = _GroupChannel(store)

    _emit({"e": "ready", "replica": replica_id, "role": role,
           "incarnation": int(os.environ.get(ENV_INCARNATION, "0") or 0),
           "reloaded_step": reloaded, "group_size": group_size})

    cmd_q: queue.Queue = queue.Queue()

    def _reader():
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                cmd_q.put(json.loads(line))
            except ValueError:
                continue
        cmd_q.put({"op": "shutdown"})  # EOF: the router is gone

    if group_rank == 0:
        # only rank 0 owns an RPC stream; a member's stdin is /dev/null
        threading.Thread(target=_reader, daemon=True).start()

    rid_of = {}    # gid -> engine rid
    meta = {}      # gid -> {"gen": k}
    handoff = {}   # gid -> {"gen","hid"}: op=prefill requests
    page_buf = {}  # gid -> {"frames": {seq: bytes}, "bad": reason|None}
    # handoff totals since ready / reset_metrics: sent by a prefill role,
    # received by a decode role (bytes, ms)
    kv_io = dict.fromkeys(("sent_bytes", "send_ms", "recv_bytes",
                           "recv_ms"), 0)
    steps = 0
    shutting = False
    audit_every = int(os.environ.get("PADDLE_SERVE_WEIGHT_AUDIT_TICKS",
                                     "0") or 0)
    if group_size > 1:
        # a reload after a failed audit is host-side state one rank would
        # take alone: the group's lockstep must not fork on it
        audit_every = 0

    def _sampling(cmd):
        return SamplingParams(max_new_tokens=int(cmd["max_new"]),
                              eos_token_id=cmd.get("eos"))

    def _stream_pages(gid, out):
        """Prefill finished for a handed-off request: export its pages,
        stream CRC-framed ``kvpage`` events (the mid-transfer chaos probes
        fire between frames), emit ``kvdone`` with the first sampled
        token, then free the request's blocks."""
        hm = handoff.pop(gid)
        rid = rid_of.pop(gid)
        if out.token < 0 or out.finished:
            # aborted before a first token (deadline), or the first token
            # already ends the request: nothing to transfer
            _emit({"e": "kvdone", "gid": gid, "hid": hm["hid"],
                   "first_tok": None if out.token < 0 else int(out.token),
                   "fin": True, "reason": out.finish_reason, "frames": 0,
                   "crc": 0})
            eng.release(rid)
            return
        t0 = time.perf_counter()
        pages = eng.export_kv_pages(rid)
        blob = pack_kv_pages(pages)
        frames = split_frames(blob)
        for seq, chunk in enumerate(frames):
            if fi.should_fire("serve.prefill_crash"):
                os.kill(os.getpid(), signal.SIGKILL)  # mid-transfer
            fr = encode_frame(
                chunk, corrupt=fi.should_fire("serve.kv_transfer_corrupt"))
            _emit({"e": "kvpage", "gid": gid, "hid": hm["hid"],
                   "seq": seq, "total": len(frames), **fr})
        _emit({"e": "kvdone", "gid": gid, "hid": hm["hid"],
               "first_tok": int(out.token), "fin": False, "reason": None,
               "frames": len(frames), "crc": zlib.crc32(blob),
               "nbytes": len(blob), "covered": int(pages["covered"])})
        kv_io["sent_bytes"] += len(blob)
        kv_io["send_ms"] += (time.perf_counter() - t0) * 1e3
        # delivered: this worker's part is done
        eng.cancel(rid, reason="handoff")
        eng.release(rid)

    def _admit(cmd, add, timeout_event):
        """``add()`` the request; a deadline already spent emits
        ``timeout_event`` and any other refusal a typed ``err``. Returns
        the engine rid, or None."""
        try:
            return add()
        except RequestTimeoutError:
            _emit(timeout_event)
        except Exception as ex:  # typed errors -> the router surfaces them
            _emit({"e": "err", "gid": cmd["gid"],
                   "kind": type(ex).__name__, "msg": str(ex)})
        return None

    def _qos(cmd):
        return dict(deadline=cmd.get("deadline"), tenant=cmd.get("tenant"),
                    tier=cmd.get("tier"))

    def _timeout_tok(cmd):
        return {"e": "tok", "gid": cmd["gid"], "gen": cmd.get("gen", 0),
                "toks": [], "fin": True, "reason": "timeout"}

    def _handle(cmd):
        nonlocal shutting
        op = cmd.get("op")
        if op == "submit":
            rid = _admit(cmd, lambda: eng.add_request(
                np.asarray(cmd["prompt"], np.int32), _sampling(cmd),
                **_qos(cmd)), _timeout_tok(cmd))
            if rid is not None:
                rid_of[cmd["gid"]] = rid
                meta[cmd["gid"]] = {"gen": cmd.get("gen", 0)}
        elif op == "prefill":
            # disaggregated stage 1: admit normally; the output loop
            # intercepts the first sampled token and streams the pages up
            rid = _admit(cmd, lambda: eng.add_request(
                np.asarray(cmd["prompt"], np.int32), _sampling(cmd),
                **_qos(cmd)),
                {"e": "kvdone", "gid": cmd["gid"],
                 "hid": cmd.get("hid", 0), "first_tok": None, "fin": True,
                 "reason": "timeout", "frames": 0, "crc": 0})
            if rid is not None:
                rid_of[cmd["gid"]] = rid
                handoff[cmd["gid"]] = {"gen": cmd.get("gen", 0),
                                       "hid": cmd.get("hid", 0)}
        elif op == "kvpage":
            # disaggregated stage 2, inbound frame: buffer and verify
            buf = page_buf.setdefault(cmd["gid"], {
                "frames": {}, "bad": None, "t0": time.perf_counter()})
            chunk = decode_frame(cmd)
            if chunk is None:
                buf["bad"] = f"frame {cmd.get('seq')} corrupt"
                return
            buf["frames"][int(cmd["seq"])] = chunk
            # bound the staging dict: frames whose submit_pages never
            # arrives (router died mid-send) must not grow forever
            while len(page_buf) > 32:
                page_buf.pop(next(iter(page_buf)))
        elif op == "submit_pages":
            gid = cmd["gid"]
            buf = page_buf.pop(gid, None) or {"frames": {}, "bad": None}
            if "t0" in buf:
                kv_io["recv_ms"] += (time.perf_counter() - buf["t0"]) * 1e3
            why = buf["bad"]
            pages = None
            if why is None:
                blob, why = join_frames(buf["frames"],
                                        cmd.get("frames", 0),
                                        cmd.get("crc"))
            if why is None:
                kv_io["recv_bytes"] += len(blob)
                try:
                    pages = unpack_kv_pages(blob)
                except ValueError as ex:
                    why = str(ex)
            if why is not None:
                # typed refusal: the router re-drives the prefill under
                # its transfer retry budget, never decodes on bad pages
                _emit({"e": "err", "gid": gid, "kind": "KVTransferError",
                       "msg": f"rejecting handed-off pages: {why}"})
                return
            rid = _admit(cmd, lambda: eng.add_request_with_pages(
                np.asarray(cmd["prompt"], np.int32), pages,
                _sampling(cmd), **_qos(cmd)), _timeout_tok(cmd))
            if rid is not None:
                rid_of[gid] = rid
                meta[gid] = {"gen": cmd.get("gen", 0)}
        elif op == "cancel":
            gid = cmd["gid"]
            page_buf.pop(gid, None)
            handoff.pop(gid, None)
            rid = rid_of.pop(gid, None)
            meta.pop(gid, None)
            if rid is not None:
                # cancelled requests emit no fin event
                eng.cancel(rid, reason=cmd.get("reason", "cancelled"))
                eng.release(rid)
        elif op == "reload":
            step = eng.reload_weights(CheckpointManager(cmd["root"]))
            _emit({"e": "reloaded", "replica": replica_id, "step": step})
        elif op == "stats":
            s = eng.stats()
            m = eng.metrics()
            _emit({"e": "stats", "replica": replica_id, "role": role,
                   "blocks_free": s["blocks_free"],
                   "blocks_high_water": s["blocks_high_water"],
                   "waiting": s["waiting"], "running": s["running"],
                   "steps": s["steps"], "tokens_out": s["tokens_out"],
                   "itl_p50_ms": m["itl_ms"]["p50"],
                   "itl_p99_ms": m["itl_ms"]["p99"],
                   "ttft_p99_ms": m["ttft_ms"]["p99"],
                   "quota_throttled": s["quota_throttled"],
                   "batch_yields": s["batch_yields"],
                   "kv_pages_verified": m["kv_pages_verified"],
                   "kv_pages_rejected": m["kv_pages_rejected"],
                   "weight_audits": m["weight_audits"],
                   "weight_audit_failures": m["weight_audit_failures"],
                   # the port's own: what the launch counts are held to
                   "decode_steps": m["decode_steps"],
                   "prefill_chunks": m["prefill_chunks"],
                   "launches": _kernels.launch_counts(),
                   **{f"kv_{k}": v for k, v in kv_io.items()}})
        elif op == "configure_tenant":
            # idempotent: the router re-sends the full set to every new
            # incarnation; cache shares apply only where the subsystem
            # exists
            eng.configure_tenant(
                cmd["tenant"], weight=cmd.get("weight", 1.0),
                rate_tokens_per_s=cmd.get("rate"),
                window_s=cmd.get("window", 1.0),
                host_blocks=(cmd.get("host_blocks")
                             if eng.kv_tier is not None else None),
                prefix_blocks=(cmd.get("prefix_blocks")
                               if eng.prefix_cache is not None else None))
        elif op == "reset_metrics":
            # a benchmark window's start: warm-phase observations and
            # launches must not count in it
            eng.reset_metrics()
            eng.reset_block_high_water()
            _kernels.reset_launch_counts()
            kv_io.update(dict.fromkeys(kv_io, 0))
        elif op == "shutdown":
            shutting = True

    # heartbeat and load-report throttles: the watchdog judges in seconds
    # and the router's load signal tolerates 100 ms staleness
    last_hb = [0.0]
    last_load = [0.0]

    def _beat():
        now = time.monotonic()
        if now - last_hb[0] >= 0.25:
            last_hb[0] = now
            hb.write(step=steps, dir=hb_dir, rank=hb_rank)

    while True:
        # chaos probes count busy ticks only: the interesting failure is
        # mid-serve, with in-flight requests for the router to recover.
        # The group sites are armed on one member: member_crash is the
        # partial-group kill, member_hang wedges this rank so the next
        # collective stalls the whole group
        if eng.has_work():
            if fi.should_fire("serve.replica_crash") or \
                    fi.should_fire("serve.group_member_crash"):
                os.kill(os.getpid(), signal.SIGKILL)
            if fi.should_fire("serve.replica_hang") or \
                    fi.should_fire("serve.group_member_hang"):
                while True:  # wedged: no heartbeat, no service, no exit
                    time.sleep(3600)
            if fi.should_fire("serve.bit_flip"):
                # silent corruption: this replica keeps serving wrong
                # bytes until the integrity sentinel catches it
                _integrity.flip_bit(
                    eng, os.environ.get("CHAOS_SERVE_BIT_FLIP_TARGET",
                                        "weights"))
        if chan is not None and group_rank > 0:
            # a member: commands arrive only on the channel, in rank 0's
            # order; a fetch timeout is an idle tick
            cmds = chan.fetch()
            if cmds is None:
                steps += 1
                _beat()
                continue
        else:
            try:
                cmd = (cmd_q.get_nowait() if eng.has_work() or shutting
                       else cmd_q.get(timeout=0.05))
            except queue.Empty:
                cmd = None
            cmds = []
            while cmd is not None:
                cmds.append(cmd)
                try:
                    cmd = cmd_q.get_nowait()
                except queue.Empty:
                    cmd = None
            if chan is not None:
                # a deadline expiring between two ranks' checks would
                # split the lockstep: the router enforces deadlines (its
                # cancels ride this ordered channel)
                for c in cmds:
                    c.pop("deadline", None)
                if cmds or eng.has_work():
                    chan.publish(cmds)
        for cmd in cmds:
            _handle(cmd)
        if eng.has_work():
            gid_by_rid = {rid: gid for gid, rid in rid_of.items()}
            per_gid = {}
            for out in eng.step():
                gid = gid_by_rid.get(out.rid)
                if gid is None:
                    continue
                if gid in handoff:
                    # prefill handoff: the first token triggers the page
                    # transfer instead of a tok event
                    _stream_pages(gid, out)
                    continue
                rec = per_gid.setdefault(
                    gid, {"toks": [], "fin": False, "reason": None})
                if out.token >= 0:
                    rec["toks"].append(int(out.token))
                if out.finished:
                    rec["fin"] = True
                    rec["reason"] = out.finish_reason
            for gid, rec in per_gid.items():
                _emit({"e": "tok", "gid": gid, "gen": meta[gid]["gen"],
                       "toks": rec["toks"], "fin": rec["fin"],
                       "reason": rec["reason"]})
                if rec["fin"]:
                    rid = rid_of.pop(gid)
                    meta.pop(gid, None)
                    eng.release(rid)
            now = time.monotonic()
            if now - last_load[0] >= 0.1:
                last_load[0] = now
                m = eng.metrics()
                _emit({"e": "load", "replica": replica_id,
                       "kv": m["kv_block_utilization"] or 0.0,
                       "occ": m["decode_batch_occupancy"] or 0.0,
                       "waiting": len(eng.scheduler.waiting)})
        steps += 1
        if audit_every and steps % audit_every == 0 and not shutting:
            if not eng.audit_weights():
                # in-place weight corruption: tell the router (a suspicion
                # charge) and reload the artifact's weights now
                _emit({"e": "integrity", "kind": "weight_audit",
                       "replica": replica_id})
                try:
                    eng.reload_weights(cfg["artifact"])
                except Exception as ex:
                    _emit({"e": "err", "gid": None,
                           "kind": type(ex).__name__,
                           "msg": f"reload after failed weight audit: "
                                  f"{ex}"})
        _beat()
        if shutting and not eng.has_work():
            eng.close()
            _emit({"e": "bye", "replica": replica_id})
            return 0


if __name__ == "__main__":
    sys.exit(replica_worker_main())
