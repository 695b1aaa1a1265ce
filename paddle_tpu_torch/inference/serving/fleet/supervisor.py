"""Replica process supervision (counterpart of
``paddle_tpu/inference/serving/fleet/supervisor.py``).

``ReplicaSupervisor`` spawns N replica worker processes (``fleet.replica``,
each owning one ``LLMEngine`` over a shared model artifact) and keeps them
alive:

* **Crash**: a replica exiting for any reason (SIGKILL'd by the OOM
  killer, a real crash, a chaos drill) is detected by ``check()`` and
  respawned under a per-replica leaky-bucket
  :class:`~paddle_tpu_torch.distributed.launch.RestartBudget`, with a
  typed :class:`~..errors.ReplicaCrashLoopError` once a slot's budget is
  exhausted (a poisoned replica must not flap forever). A replica that
  dies while booting (say, one that asks for CUDA on a machine without a
  card) restarts under the same budget inside :meth:`wait_ready`.
* **Hang**: replicas heartbeat through ``distributed.launch.heartbeat``
  (atomic ``hb.<replica>`` files, written at every loop tick, stepping or
  idle); a heartbeat older than ``hang_timeout_s`` triggers the
  SIGTERM→SIGKILL escalation and the replica is restarted like a crash.
* **Rejoin**: a restarted replica reloads weights from the fleet's
  checkpoint root inside the worker before reporting ready, so a crash
  during a rolling weight update cannot resurrect stale weights.

The supervisor only manages processes; redispatching the dead replica's
in-flight requests is the Router's job: ``check()`` hands it the death
events with the dying process's final token events (drained to EOF
first), so tokens emitted before the crash are never lost and never
counted twice.

:meth:`ReplicaSupervisor.autoscale` is a pure decision tick driven by the
router's queue depth and occupancy gauges: sustained pressure above the
high watermark grows the fleet by one slot (:meth:`add_replica`), calm
below the low watermark nominates the highest live slot for the caller to
drain and then retire. Hysteresis (distinct watermarks and a cooldown)
and a leaky-bucket scale-event budget keep flapping load from churning
the fleet.

**Model-parallel replica groups** (``group_size > 1``): every slot is a
group of ``group_size`` processes serving one plan-sharded ``LLMEngine``
in SPMD lockstep (``replica.py``), meeting on the incarnation's fresh
coordination port (a respawned group never meets a dead predecessor).
Rank 0 keeps the RPC pipes; the group is atomic: it is alive only while
every member runs, any member's crash or hang (judged by the stalest
``hb.<replica>.<rank>``) fells every member (SIGTERM to all, then
SIGKILL after the shared grace) against one budget slot, the boot grace
scales with the group size, and the gauges ``fleet_group_members_live``
and ``fleet_group_restarts_total`` follow it. Groups cannot take the
prefill role (the handoff exports pages to one host).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

from ....distributed.launch import heartbeat as _hb
from ....distributed.launch.controllers.collective import RestartBudget
from ....observability import metrics as _obs_metrics
from ..errors import ReplicaCrashLoopError

__all__ = ["ReplicaHandle", "ReplicaSupervisor"]

# fleet liveness: how many replicas look alive right now (process running
# and, when the hang watchdog is armed, heartbeat fresh). Transitions are
# appended to <log_dir>/fleet_liveness.log, so a drill can assert that the
# gauge dipped during a kill or hang and recovered.
_G_LIVE = _obs_metrics.gauge(
    "fleet_replicas_live",
    "replicas currently alive (process running + heartbeat fresh when "
    "the hang watchdog is armed)")
_M_RESTARTS = _obs_metrics.counter(
    "fleet_replica_restarts_total",
    "replica respawns performed by the supervisor (crash or hang)")
_M_SCALE_UP = _obs_metrics.counter(
    "fleet_scale_up_total",
    "replicas added by autoscale (queue pressure above the high "
    "watermark past the cooldown)")
_M_SCALE_DOWN = _obs_metrics.counter(
    "fleet_scale_down_total",
    "replicas nominated for drain-then-retire by autoscale (fleet calm "
    "below the low watermark past the cooldown)")
# model-parallel replica groups: per-replica member liveness and
# whole-group restarts. A group is atomic — members_live < group_size is
# a transient state the supervisor resolves by felling the whole group,
# never a serving state.
_G_GROUP_MEMBERS = _obs_metrics.gauge(
    "fleet_group_members_live",
    "processes of this replica group currently running (a value below "
    "the group size means the group is being felled or respawned — a "
    "partial group never serves)")
_M_GROUP_RESTARTS = _obs_metrics.counter(
    "fleet_group_restarts_total",
    "whole-group respawns performed by the supervisor (any member "
    "crash/hang fells and restarts the entire group, charging ONE "
    "restart-budget slot)")

# repo root (five levels up: fleet/serving/inference/paddle_tpu_torch/<repo>)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

ENV_ID = "PADDLE_REPLICA_ID"
ENV_CONFIG = "PADDLE_REPLICA_CONFIG"
ENV_INCARNATION = "PADDLE_REPLICA_INCARNATION"
# model-parallel replica groups
ENV_GROUP_SIZE = "PADDLE_REPLICA_GROUP_SIZE"
ENV_GROUP_RANK = "PADDLE_REPLICA_GROUP_RANK"
ENV_COORD_PORT = "PADDLE_REPLICA_COORD_PORT"


def _free_port():
    """A currently free TCP port for an incarnation's private
    coordination store (racy but fine: the group binds it within
    moments, and a collision fails the boot, which the supervisor turns
    into an ordinary group restart on a new port)."""
    sock = socket.socket()
    try:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]
    finally:
        sock.close()


def _check_group_plan(spec, group_size):
    """Validate a replica group's JSON plan spec (``{"axes": {...},
    "strategies": [...]}``) before anything spawns: its ranks must be the
    group's processes, and only the ``tp`` axis executes (the other axes
    are ROADMAP Queue 1 item 8)."""
    if spec is None:
        return
    axes = dict(spec.get("axes") or {})
    ranks = 1
    for axis, n in axes.items():
        ranks *= int(n)
        if axis != "tp" and int(n) > 1:
            raise NotImplementedError(
                f"plan axis {axis!r} of degree {n}: the port executes "
                "tensor parallelism (tp) only; the other axes are ROADMAP "
                "Queue 1, item 8")
    if ranks != int(group_size):
        raise ValueError(
            f"plan {axes} spans {ranks} ranks but group_size is "
            f"{group_size}: every rank of a replica group is one process")


class ReplicaHandle:
    """One replica worker process and its line-JSON RPC plumbing.

    Commands go down the child's stdin (one JSON object per line); events
    come back on stdout, pumped by a daemon reader thread into a queue
    that :meth:`events` drains. stderr goes to a per-replica log file
    (nothing chatty may reach the RPC stream).

    ``group_size > 1`` makes the handle a multi-process group: rank 0
    keeps the RPC pipes (``proc``/``pid`` stay rank 0's) and ranks 1+
    are spawned headless (stdin ``/dev/null``, stdout and stderr to
    their own log, ``<log>.r<rank>``). The group is atomic:
    :attr:`alive` demands every member running, and :meth:`kill` fells
    them all."""

    def __init__(self, replica_id, config, *, env=None, log_path=None,
                 incarnation=0, group_size=1, coord_port=None):
        self.id = int(replica_id)
        self.incarnation = int(incarnation)
        self.group_size = int(group_size)
        self.coord_port = coord_port
        self.spawn_time = time.time()
        # wall time the reader thread received ``ready`` (boot latency)
        self.ready_time = None
        self.ready = False
        self.ready_info = None
        self.retired = False
        self._lock = threading.Lock()
        self._events: list = []
        self._log_file = open(log_path, "ab") if log_path else None
        self._member_logs = []
        child_env = dict(env if env is not None else os.environ)
        child_env[ENV_ID] = str(self.id)
        child_env[ENV_CONFIG] = json.dumps(config)
        child_env[ENV_INCARNATION] = str(self.incarnation)
        child_env["PYTHONPATH"] = (_REPO + os.pathsep
                                   + child_env.get("PYTHONPATH", ""))
        if self.group_size > 1:
            # a member's idle polls of the group store time out by design;
            # c10d would log a warning for each
            child_env.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
            child_env[ENV_GROUP_SIZE] = str(self.group_size)
            child_env[ENV_COORD_PORT] = str(coord_port)
            child_env[ENV_GROUP_RANK] = "0"
        cmd = [sys.executable, "-u", "-m",
               "paddle_tpu_torch.inference.serving.fleet.replica"]
        self.proc = subprocess.Popen(
            cmd, env=child_env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=(self._log_file or subprocess.DEVNULL), text=True,
            bufsize=1)
        # ranks 1+: the same engine in SPMD lockstep, no RPC stream
        self.members = []
        for rank in range(1, self.group_size):
            member_env = dict(child_env)
            member_env[ENV_GROUP_RANK] = str(rank)
            mlog = (open(f"{log_path}.r{rank}", "ab") if log_path
                    else None)
            self._member_logs.append(mlog)
            self.members.append(subprocess.Popen(
                cmd, env=member_env, stdin=subprocess.DEVNULL,
                stdout=(mlog or subprocess.DEVNULL),
                stderr=(mlog or subprocess.DEVNULL)))
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name=f"replica{self.id}-reader")
        self._reader.start()

    def _read(self):
        try:
            for line in self.proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # stray non-RPC print; never kill the reader
                if ev.get("e") == "ready" and self.ready_time is None:
                    self.ready_time = time.time()
                with self._lock:
                    self._events.append(ev)
        except (OSError, ValueError):
            pass

    @property
    def alive(self):
        """Every member running (a group missing any member must not look
        placeable)."""
        return (not self.retired and self.proc.poll() is None
                and all(m.poll() is None for m in self.members))

    @property
    def pid(self):
        return self.proc.pid

    @property
    def members_live(self):
        """Running member processes (rank 0 included): the
        ``fleet_group_members_live`` gauge."""
        n = 1 if self.proc.poll() is None else 0
        return n + sum(1 for m in self.members if m.poll() is None)

    def dead_member(self):
        """``(rank, rc)`` of the first exited member, or ``None`` while
        all run: the group-crash probe, naming the failing rank."""
        if self.proc.poll() is not None:
            return 0, self.proc.poll()
        for rank, m in enumerate(self.members, start=1):
            if m.poll() is not None:
                return rank, m.poll()
        return None

    def send(self, obj):
        """Write one command line; False when the pipe is gone (the
        caller treats it as a dead replica and redispatches)."""
        try:
            with self._lock:
                self.proc.stdin.write(json.dumps(obj) + "\n")
                self.proc.stdin.flush()
            return True
        except (OSError, ValueError, AttributeError):
            return False

    def events(self):
        """Drain queued events (ready events also flip :attr:`ready`)."""
        with self._lock:
            out, self._events = self._events, []
        for ev in out:
            if ev.get("e") == "ready":
                self.ready = True
                self.ready_info = ev
        return out

    def push_back(self, evs):
        """Requeue events at the front (``wait_ready`` peeks without
        consuming the router's view of the stream)."""
        with self._lock:
            self._events = list(evs) + self._events

    def final_events(self, timeout=2.0):
        """Join the reader (EOF after death) and drain what is left:
        tokens the replica emitted before dying must reach the router."""
        self._reader.join(timeout=timeout)
        return self.events()

    def kill(self, grace_s=5.0):
        """SIGTERM, wait ``grace_s``, then SIGKILL (the launcher's
        escalation), applied to every group member: SIGTERM goes to all
        first, so the grace is shared, and no survivor of a partial
        failure is left to answer."""
        procs = [self.proc] + list(self.members)
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.time() + max(float(grace_s), 0.0)
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(deadline - time.time(), 0.0))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for f in [self._log_file] + self._member_logs:
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        self._log_file = None
        self._member_logs = []

    def close(self):
        """Polite shutdown: ask (rank 0 relays it to a group's members),
        wait briefly for every member, then escalate."""
        self.send({"op": "shutdown"})
        deadline = time.time() + 3.0
        for p in [self.proc] + list(self.members):
            try:
                p.wait(timeout=max(deadline - time.time(), 0.0))
            except subprocess.TimeoutExpired:
                pass
        self.kill(grace_s=1.0)


class ReplicaSupervisor:
    """Spawn and watch ``n_replicas`` replica workers (see module doc)."""

    def __init__(self, n_replicas, config, *, hang_timeout_s=0.0,
                 max_restarts=3, term_grace_s=5.0, boot_grace_s=120.0,
                 log_dir=None, env_extra=None, instance="fleet",
                 roles=None, group_size=1):
        if int(n_replicas) < 1:
            raise ValueError("n_replicas must be >= 1")
        # model-parallel replica groups: every slot is a group of
        # group_size processes serving one plan-sharded engine in SPMD
        # lockstep (group_size=1 is the single-process replica)
        self.group_size = int(group_size)
        if self.group_size < 1:
            raise ValueError("group_size must be >= 1")
        if self.group_size > 1 and roles is not None \
                and any(r == "prefill" for r in roles):
            raise ValueError(
                "prefill-role slots cannot be multi-process groups: the "
                "disaggregated handoff exports KV pages to one host, "
                "which a process-spanning plan does not support yet")
        _check_group_plan(config.get("plan"), self.group_size)
        # role-disaggregated serving: each slot is "prefill", "decode" or
        # "both" (colocated). The role belongs to the slot, not the
        # incarnation: a restarted replica respawns with the same role.
        if roles is not None:
            roles = [str(r) for r in roles]
            if len(roles) != int(n_replicas):
                raise ValueError(
                    f"roles has {len(roles)} entries for {n_replicas} "
                    "replicas")
            bad = [r for r in roles if r not in ("prefill", "decode",
                                                 "both")]
            if bad:
                raise ValueError(f"unknown replica roles {bad}; expected "
                                 "'prefill', 'decode' or 'both'")
        self._roles = roles
        self.instance = instance
        self.hang_timeout_s = float(hang_timeout_s or 0.0)
        self.term_grace_s = float(term_grace_s)
        # a replica writes its first heartbeat only after the imports and
        # the engine build (and its warm-up), so a booting replica is
        # judged against this longer grace: otherwise a tight watchdog
        # condemns every restart before it can beat. Groups boot slower
        # (the rendezvous, the sharded weights, the all-ranks warm-up
        # barrier): the grace scales with the group size
        self.boot_grace_s = (max(float(boot_grace_s), self.hang_timeout_s)
                             * max(1, self.group_size))
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._hb_dir = os.path.join(log_dir, "heartbeats")
        else:
            self._hb_dir = tempfile.mkdtemp(prefix="paddle_fleet_hb.")
        os.makedirs(self._hb_dir, exist_ok=True)
        self._config = dict(config)
        self._config["hb_dir"] = self._hb_dir
        self._env = dict(os.environ)
        # replicas share the host's cores: unless the caller set it, each
        # gets its share of intra-op threads (a CPU fleet of N processes
        # with every core each spins itself to a crawl)
        self._env.setdefault("OMP_NUM_THREADS", str(
            max(1, (os.cpu_count() or 1)
                // (int(n_replicas) * self.group_size))))
        self._env.update(env_extra or {})
        # sleep=no-op: backoff() only computes the delay; the supervisor
        # schedules the respawn at now + delay instead of sleeping inside
        # the router's single-threaded pump
        self._max_restarts = int(max_restarts)
        self._budgets = [RestartBudget(max_restarts, sleep=lambda s: None)
                         for _ in range(int(n_replicas))]
        self._pending_respawn: dict[int, float] = {}
        # every death reported (check's and quarantine's dicts without
        # their final events), with the wall times it was found
        # (``detected``) and handled (``handled``: killed, final events
        # drained), the replica's last heartbeat before (``last_beat``;
        # a group's stalest member's) and a group's failing rank
        self.deaths: list = []
        self.handles = [self._spawn(i, 0) for i in range(int(n_replicas))]
        self._last_live = None
        # autoscale state: the budget is made at the first autoscale()
        # tick (its shape is the caller's)
        self._scale_budget = None
        self._last_scale_t = None
        self._scale_warned = False
        self._note_liveness()

    # -- lifecycle -------------------------------------------------------
    def role(self, i):
        """The slot's serving role ("both" when undeclared)."""
        return self._roles[i] if self._roles else "both"

    def _spawn(self, i, incarnation):
        log_path = (os.path.join(self.log_dir, f"replica.{i}.log")
                    if self.log_dir else None)
        config = self._config
        if self._roles is not None:
            config = dict(config, role=self._roles[i])
        # a fresh coordination port per incarnation: a respawned group
        # never meets a predecessor's half-dead store
        port = _free_port() if self.group_size > 1 else None
        h = ReplicaHandle(i, config, env=self._env, log_path=log_path,
                          incarnation=incarnation,
                          group_size=self.group_size, coord_port=port)
        h.role = self.role(i)
        return h

    def wait_ready(self, timeout=180.0):
        """Block until every replica that is not retired is running and
        reported ``ready`` (engine built, weights loaded or reloaded,
        warmed). Peeked events are pushed back for the router's pump. A
        replica that is dead (pending respawn) or dies while booting
        restarts under its budget through :meth:`check`, which raises
        :class:`ReplicaCrashLoopError` once the budget is spent."""
        deadline = time.time() + float(timeout)
        while True:
            booting = [h for h in self.handles
                       if not h.retired and not (h.ready and h.alive)]
            for h in booting:
                evs = h.events()
                if evs:
                    h.push_back(evs)
            if all(h.ready and h.alive for h in booting):
                return
            self.check()
            if time.time() > deadline:
                slow = [h.id for h in self.handles
                        if not h.retired and not (h.ready and h.alive)]
                raise TimeoutError(
                    f"replicas {slow} not ready within {timeout}s"
                    + (f"; see their logs in {self.log_dir}"
                       if self.log_dir else ""))
            time.sleep(0.05)

    def retire(self, i):
        """Permanently stop replica ``i`` (the drain-then-retire path):
        no restart, excluded from liveness."""
        h = self.handles[i]
        h.retired = True
        h.close()
        self._note_liveness()  # zeroes a group's member gauge

    def shutdown(self):
        for h in self.handles:
            if not h.retired:
                h.close()
        _G_LIVE.remove(instance=self.instance)
        _M_RESTARTS.remove(instance=self.instance)
        _M_SCALE_UP.remove(instance=self.instance)
        _M_SCALE_DOWN.remove(instance=self.instance)
        if self.group_size > 1:
            _M_GROUP_RESTARTS.remove(instance=self.instance)
            for h in self.handles:
                _G_GROUP_MEMBERS.remove(instance=self.instance,
                                        replica=h.id)

    # -- fleet autoscaling ----------------------------------------------
    @property
    def n_active(self):
        """Slots not retired (live, booting, or pending respawn): the
        fleet size autoscale reasons about."""
        return sum(1 for h in self.handles if not h.retired)

    def add_replica(self, role="both"):
        """Grow the fleet by one slot (the autoscale-up action). The new
        slot appends at the end, so slot id == handles index stays true,
        with a fresh restart budget and incarnation 0. Returns its id."""
        i = len(self.handles)
        if self._roles is not None:
            role = str(role)
            if role not in ("prefill", "decode", "both"):
                raise ValueError(f"unknown replica role {role!r}")
            self._roles.append(role)
        self._budgets.append(
            RestartBudget(self._max_restarts, sleep=lambda s: None))
        self.handles.append(self._spawn(i, 0))
        _M_SCALE_UP.inc(instance=self.instance)
        self._note_liveness()
        return i

    def autoscale(self, min_replicas, max_replicas, *, queue_depth,
                  occupancy, high_water=0.75, low_water=0.25,
                  cooldown_s=5.0, max_events=8, window_s=60.0, now=None):
        """One autoscale decision tick, driven by the router's gauges:
        ``queue_depth`` (requests waiting at the router) and ``occupancy``
        (mean decode-slot occupancy across live replicas, 0..1).

        * **Up**: work is queued and the fleet is busy (``occupancy >=
          high_water``) with room to grow: spawn one replica and return
          ``("up", new_id)``.
        * **Down**: nothing queued and the fleet idle (``occupancy <=
          low_water``) above the floor: return ``("down", victim_id)``,
          the highest live slot; the caller drains it (zero-drop) and
          calls :meth:`retire`. The supervisor never kills a slot that
          may hold in-flight work.
        * Otherwise (inside the hysteresis band, the cooldown, or past the
          scale-event budget) return ``None``.

        The scale-event budget (``max_events`` per rolling ``window_s``,
        fixed at the first tick) stops flapping load from churning
        replicas forever: past it autoscale goes quiet (one warning)."""
        min_replicas, max_replicas = int(min_replicas), int(max_replicas)
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min ({min_replicas}) <= max ({max_replicas})")
        if not low_water < high_water:
            raise ValueError(
                f"need low_water ({low_water}) < high_water "
                f"({high_water}) — the gap IS the hysteresis band")
        now = time.time() if now is None else now
        n = self.n_active
        want_up = (queue_depth > 0 and occupancy >= high_water
                   and n < max_replicas)
        want_down = (queue_depth == 0 and occupancy <= low_water
                     and n > min_replicas)
        if not (want_up or want_down):
            return None
        if (self._last_scale_t is not None
                and now - self._last_scale_t < cooldown_s):
            return None
        if self._scale_budget is None:
            self._scale_budget = RestartBudget(
                int(max_events), window_s=float(window_s),
                sleep=lambda s: None)
        if not self._scale_budget.try_acquire():
            if not self._scale_warned:
                self._scale_warned = True
                warnings.warn(
                    f"{self.instance}: scale-event budget exhausted "
                    f"({self._scale_budget.max_restarts} per "
                    f"{self._scale_budget.window_s:.0f}s); autoscale "
                    "pausing — flapping load, widen the watermarks",
                    RuntimeWarning)
            return None
        self._last_scale_t = now
        if want_up:
            return ("up", self.add_replica())
        victim = max(h.id for h in self.handles if not h.retired)
        _M_SCALE_DOWN.inc(instance=self.instance)
        return ("down", victim)

    # -- the watchdog tick ----------------------------------------------
    def _hung(self, h, beats, now):
        if self.hang_timeout_s <= 0 or not h.alive:
            return False
        if not h.ready:
            # still booting: only the boot grace can condemn it
            return (now - h.spawn_time) > self.boot_grace_s
        return (now - self._last_beat(h, beats)) > self.hang_timeout_s

    @staticmethod
    def _last_beat(h, beats):
        """The replica's last heartbeat time (its spawn time before the
        first). A group runs in lockstep, so one wedged rank stalls every
        member's next collective: it is judged by its stalest member's
        ``hb.<replica>.<rank>``."""
        keys = ([f"{h.id}.{r}" for r in range(h.group_size)]
                if getattr(h, "group_size", 1) > 1 else [str(h.id)])
        ts = [beats.get(k, {}).get("time") for k in keys]
        return min(h.spawn_time if t is None else float(t) for t in ts)

    def check(self, now=None):
        """One supervision tick. Detects dead and hung replicas, kills the
        hung ones, respawns both under the per-replica restart budget,
        and returns the death events for the router::

            [{"replica": i, "reason": "crash"|"hang", "rc": rc,
              "rank": None, "events": [<final events drained after EOF>]}]

        Raises :class:`ReplicaCrashLoopError` when a slot's budget is
        exhausted. Also refreshes the ``fleet_replicas_live`` gauge
        (transition log: ``<log_dir>/fleet_liveness.log``)."""
        now = time.time() if now is None else now
        beats = _hb.read_all(self._hb_dir)
        deaths = []
        for i, h in enumerate(self.handles):
            if h.retired:
                continue
            if i in self._pending_respawn:
                # death already reported; respawn when the backoff lapses
                if now >= self._pending_respawn[i]:
                    del self._pending_respawn[i]
                    # stale heartbeats must not condemn the new life
                    self._clear_heartbeats(i)
                    self.handles[i] = self._spawn(i, h.incarnation + 1)
                    _M_RESTARTS.inc(instance=self.instance)
                    if self.group_size > 1:
                        _M_GROUP_RESTARTS.inc(instance=self.instance)
                continue
            dead = (h.dead_member() if hasattr(h, "dead_member")
                    else ((0, h.proc.poll())
                          if h.proc.poll() is not None else None))
            detected = time.time()
            if dead is not None:
                # any member exiting fells the whole group: survivors are
                # killed before the death is even reported
                reason = "crash"
                h.kill(grace_s=self.term_grace_s)
                rank, rc = dead
            elif self._hung(h, beats, now):
                reason = "hang"
                h.kill(grace_s=self.term_grace_s)
                rank, rc = None, h.proc.poll()
            else:
                continue
            if self.group_size == 1:
                rank = None
            leftovers = h.final_events()
            self._log_death(i, reason, rc, detected, beats, rank)
            # the dip must be visible before the respawn restores it
            self._note_liveness()
            budget = self._budgets[i]
            if not budget.try_acquire():
                self.shutdown()
                at_rank = f" at group rank {rank}" if rank else ""
                raise ReplicaCrashLoopError(
                    f"replica {i} crash loop ({reason}{at_rank}, rc={rc}): "
                    f"restart budget exhausted ({budget.max_restarts} per "
                    f"{budget.window_s:.0f}s window, "
                    f"{budget.total_restarts} performed)"
                    + (f"; see its log in {self.log_dir}"
                       if self.log_dir else ""),
                    replica=i, exit_code=rc if rc is not None else 1,
                    restarts=budget.total_restarts)
            # schedule, never sleep in the pump: the death event returns
            # now so the router redispatches at once; the slot stays
            # unplaceable (dead handle) until the delayed respawn
            self._pending_respawn[i] = now + budget.backoff()
            deaths.append({"replica": i, "reason": reason, "rc": rc,
                           "rank": rank, "events": leftovers})
        self._note_liveness(beats=beats, now=now)
        return deaths

    def quarantine(self, i, now=None):
        """Integrity quarantine: kill replica ``i`` now, like a watchdog
        kill but without grace, charge one restart-budget slot and
        schedule the respawn through the normal pending-respawn path (so
        a supervision tick racing this call never double-restarts the
        slot). Returns the death dict (``reason: "quarantine"``) for the
        router to redispatch from, or ``None`` when the slot is retired or
        already dying. Raises :class:`ReplicaCrashLoopError` when the
        budget is exhausted: a replica that keeps corrupting after
        restarts is bad hardware, not bad luck."""
        now = time.time() if now is None else now
        h = self.handles[i]
        if h.retired or i in self._pending_respawn:
            return None
        # no SIGTERM grace: a corrupt replica must stop emitting at once
        detected = time.time()
        h.kill(grace_s=0.0)
        rc = h.proc.poll()
        leftovers = h.final_events()
        self._log_death(i, "quarantine", rc, detected)
        self._note_liveness()  # the dip precedes the respawn
        budget = self._budgets[i]
        if not budget.try_acquire():
            self.shutdown()
            raise ReplicaCrashLoopError(
                f"replica {i} quarantine loop: restart budget exhausted "
                f"({budget.max_restarts} per {budget.window_s:.0f}s "
                f"window, {budget.total_restarts} performed) — the slot "
                "keeps serving corrupt output; suspect the hardware",
                replica=i, exit_code=rc if rc is not None else 1,
                restarts=budget.total_restarts)
        self._pending_respawn[i] = now + budget.backoff()
        return {"replica": i, "reason": "quarantine", "rc": rc,
                "rank": None, "events": leftovers}

    def _log_death(self, i, reason, rc, detected, beats=None, rank=None):
        if beats is None:
            beats = _hb.read_all(self._hb_dir)
        keys = ([f"{i}.{r}" for r in range(self.group_size)]
                if self.group_size > 1 else [str(i)])
        ts = [beats.get(k, {}).get("time") for k in keys]
        self.deaths.append({"replica": i, "reason": reason, "rc": rc,
                            "rank": rank, "detected": detected,
                            "handled": time.time(),
                            "last_beat": (None if None in ts
                                          else min(float(t) for t in ts))})

    def _clear_heartbeats(self, i):
        """Remove slot ``i``'s heartbeat files: the bare ``hb.<i>`` and
        every group member's ``hb.<i>.<rank>``."""
        for r in [None] + list(range(self.group_size)):
            fn = f"hb.{i}" if r is None else f"hb.{i}.{r}"
            try:
                os.remove(os.path.join(self._hb_dir, fn))
            except OSError:
                pass

    def _note_liveness(self, beats=None, now=None):
        now = time.time() if now is None else now
        if beats is None:
            beats = _hb.read_all(self._hb_dir)
        n = sum(1 for h in self.handles
                if h.alive and not self._hung(h, beats, now))
        _G_LIVE.set(n, instance=self.instance)
        if self.group_size > 1:
            for h in self.handles:
                _G_GROUP_MEMBERS.set(
                    0 if h.retired else h.members_live,
                    instance=self.instance, replica=h.id)
        if n != self._last_live:
            self._last_live = n
            if self.log_dir:
                try:
                    with open(os.path.join(self.log_dir,
                                           "fleet_liveness.log"), "a") as f:
                        f.write(f"{now:.3f} {n}\n")
                except OSError:
                    pass
        return n
