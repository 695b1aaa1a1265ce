"""Collective job controller (counterpart of
``paddle_tpu/distributed/launch/controllers/collective.py``).

Starts ``nproc_per_node`` local workers with the ``PADDLE_*``/``MASTER_*``
env contract that :func:`..parallel.init_parallel_env` reads, and
supervises the group:

- **Crash**: any worker exiting with a real nonzero code kills the whole
  local group and relaunches it (checkpoint auto-resume does the rest).
- **Hang**: workers heartbeat into ``PADDLE_HEARTBEAT_DIR`` (see
  :mod:`..heartbeat`); when a still-running rank's heartbeat is older
  than ``FLAGS_worker_hang_timeout_s`` the group is SIGTERM→SIGKILL'd and
  restarted like a crash, so a rank wedged in a collective cannot hold
  the job forever.
- **Clean preemption**: a worker exiting with ``PREEMPT_EXIT_CODE`` (123,
  from ``FusedTrainStep.drive``'s SIGTERM handler after it committed a
  checkpoint) relaunches without consuming restart budget.
- **Crash-loop breaker**: :class:`RestartBudget`, a leaky bucket of
  ``--max_restart`` crash restarts per ``FLAGS_restart_window_s`` with
  exponential backoff; once it is full the controller raises
  :class:`CrashLoopError` with the last exit code. The serving fleet's
  ``ReplicaSupervisor`` keeps one budget a replica slot.

Each restart round of a single-node auto-selected master picks a fresh
port: the dead round's rendezvous socket can sit in TIME_WAIT. The
rendezvous is ``torch.distributed``'s TCP store at
``MASTER_ADDR:MASTER_PORT``, which the workers' own
``init_parallel_env`` opens; the controller itself never imports torch.

The budget reads ``FLAGS_restart_window_s`` and ``FLAGS_restart_backoff_s``
when its window or backoff base is not given; the controller reads
``FLAGS_worker_hang_timeout_s`` and ``FLAGS_worker_term_grace_s``.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

from ....core.flags import flag_value
from ....observability import metrics as _obs_metrics
from ..heartbeat import PREEMPT_EXIT_CODE, live_ranks as _hb_live

# how many of this node's workers look alive right now: process running
# and, with the hang watchdog armed, heartbeat fresh. Updated every
# supervision tick; transitions are appended to <log_dir>/liveness.log so
# a drill can assert the gauge dipped during a kill and recovered.
_G_LIVE_RANKS = _obs_metrics.gauge(
    "launch_live_ranks",
    "workers of this node currently alive (process running + heartbeat "
    "fresh when the hang watchdog is armed)")

__all__ = ["CollectiveController", "RestartBudget", "CrashLoopError",
           "HANG_EXIT_CODE", "PREEMPT_EXIT_CODE"]

# the controller's own code for "group killed for stale heartbeats": no
# worker produced an exit code, so one is synthesized (124 = timeout(1))
HANG_EXIT_CODE = 124


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CrashLoopError(RuntimeError):
    """The job kept crashing after its restart budget was exhausted
    (``max_restarts`` restarts within ``FLAGS_restart_window_s``).
    Carries the final exit code and the restarts performed, so a caller
    can propagate the real failure instead of looping forever."""

    def __init__(self, msg, exit_code=1, restarts=0):
        super().__init__(msg)
        self.exit_code = exit_code
        self.restarts = restarts


class RestartBudget:
    """Leaky-bucket crash-loop breaker: at most ``max_restarts`` crash
    restarts within a rolling ``window_s`` window (old crashes age out),
    with exponential backoff between relaunches: the delay doubles with
    each crash currently in the bucket, capped, so a tight crash loop
    slows down instead of hammering the scheduler. Clean preemptions go
    through :meth:`note_preemption` and never touch the bucket.
    ``clock``/``sleep`` are injectable for tests."""

    def __init__(self, max_restarts, window_s=None, backoff_base_s=None,
                 backoff_cap_s=30.0, clock=time.monotonic, sleep=time.sleep):
        self.max_restarts = int(max_restarts)
        self.window_s = float(
            flag_value("restart_window_s", 3600.0)
            if window_s is None else window_s)
        self.backoff_base_s = float(
            flag_value("restart_backoff_s", 1.0)
            if backoff_base_s is None else backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._clock = clock
        self._sleep = sleep
        self._events: list[float] = []
        self._preempt_events: list[float] = []
        self.total_restarts = 0
        self.preemptions = 0

    def _prune(self, now):
        if self.window_s > 0:
            self._events = [t for t in self._events
                            if now - t <= self.window_s]

    @property
    def used(self):
        """Crash restarts currently counted against the budget."""
        self._prune(self._clock())
        return len(self._events)

    # clean preemptions are budget-free but not unbounded: a worker that
    # exits 123 over and over without ever running is a crash loop, so
    # past this many a rolling window further preemptions are charged as
    # crashes
    PREEMPT_CAP_PER_WINDOW = 16

    def try_acquire(self):
        """Record one crash restart; False when the bucket is full (the
        caller must stop relaunching)."""
        now = self._clock()
        self._prune(now)
        if len(self._events) >= self.max_restarts:
            return False
        self._events.append(now)
        self.total_restarts += 1
        return True

    def note_preemption(self):
        """Record one clean-preemption relaunch in its own leaky window,
        never the crash bucket and with no backoff. False once the
        per-window cap is exceeded: the caller should then charge further
        preemptions as crashes."""
        now = self._clock()
        if self.window_s > 0:
            self._preempt_events = [t for t in self._preempt_events
                                    if now - t <= self.window_s]
        if len(self._preempt_events) >= self.PREEMPT_CAP_PER_WINDOW:
            return False
        self._preempt_events.append(now)
        self.preemptions += 1
        return True

    def backoff(self):
        """Sleep the current backoff (exponential in the in-window crash
        count, capped) and return the delay applied."""
        n = max(1, len(self._events))
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * (2 ** (n - 1)))
        if delay > 0:
            self._sleep(delay)
        return delay


class CollectiveController:
    def __init__(self, args):
        self.args = args
        self.nproc = args.nproc_per_node or 1
        self.world_size = args.nnodes * self.nproc
        self.procs: list[subprocess.Popen] = []
        self._log_files = []
        self._spawn_time = None
        # heartbeat rendezvous: under log_dir when given (inspectable after
        # the run), else a tmpdir; workers find it via PADDLE_HEARTBEAT_DIR
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            self._hb_dir = os.path.join(args.log_dir, "heartbeats")
        else:
            self._hb_dir = tempfile.mkdtemp(prefix="paddle_hb.")
        os.makedirs(self._hb_dir, exist_ok=True)
        self._last_live = None  # last launch_live_ranks value published

    # -- env contract ----------------------------------------------------
    def _worker_env(self, local_rank):
        env = dict(os.environ)
        addr, port = self.args.master.rsplit(":", 1)
        global_rank = self.args.rank * self.nproc + local_rank
        env.update({
            "PADDLE_MASTER": addr,
            "MASTER_ADDR": addr,
            "MASTER_PORT": port,
            "PADDLE_TRAINER_ID": str(global_rank),
            "PADDLE_TRAINERS_NUM": str(self.world_size),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_LOCAL_SIZE": str(self.nproc),
            "PADDLE_NNODES": str(self.args.nnodes),
            "PADDLE_NODE_RANK": str(self.args.rank),
            "PADDLE_HEARTBEAT_DIR": self._hb_dir,
        })
        if self.args.devices:
            devs = self.args.devices.split(",")
            env["CUDA_VISIBLE_DEVICES"] = devs[local_rank % len(devs)]
        return env

    def _cmd(self):
        script = self.args.training_script
        rest = list(self.args.training_script_args)
        if script.endswith(".py"):
            # the bootstrap writes the first heartbeat before the script
            # imports anything heavy
            return [sys.executable, "-u", "-m",
                    "paddle_tpu_torch.distributed.launch.bootstrap",
                    script] + rest
        return [script] + rest

    # -- lifecycle -------------------------------------------------------
    def _spawn_all(self):
        self._close_logs()  # previous restart round's handles
        # stale heartbeats from the previous round must not mask (or fake)
        # this round's liveness: every round starts from a clean slate
        for fn in os.listdir(self._hb_dir):
            try:
                os.remove(os.path.join(self._hb_dir, fn))
            except OSError:
                pass
        self.procs = []
        self._spawn_time = time.time()
        for lr in range(self.nproc):
            out = None
            if self.args.log_dir:
                os.makedirs(self.args.log_dir, exist_ok=True)
                out = open(os.path.join(self.args.log_dir,
                                        f"workerlog.{lr}"), "ab")
                self._log_files.append(out)
            self.procs.append(subprocess.Popen(
                self._cmd(), env=self._worker_env(lr),
                stdout=out, stderr=(subprocess.STDOUT if out else None)))

    def _kill_all(self):
        grace = float(flag_value("worker_term_grace_s", 10.0) or 10.0)
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + grace
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def _watch(self):
        """Block until the group's round resolves. Returns 0 (all
        succeeded), PREEMPT_EXIT_CODE (at least one worker preempted
        cleanly, none crashed), HANG_EXIT_CODE (heartbeats went stale, the
        group killed), or the first real nonzero exit code (the group
        killed)."""
        hang_timeout = float(flag_value("worker_hang_timeout_s", 0) or 0)
        grace = float(flag_value("worker_term_grace_s", 10.0) or 10.0)
        preempt_seen = None
        while True:
            codes = [p.poll() for p in self.procs]
            # publish liveness before the crash/hang judgments below, so
            # the tick that detects a dead rank records the dip first; the
            # hang check reuses this tick's one heartbeat-dir read
            running, live = self._note_liveness(codes, hang_timeout)
            crash = next((rc for rc in codes if rc is not None
                          and rc not in (0, PREEMPT_EXIT_CODE)), None)
            if crash is not None:
                self._kill_all()
                return crash
            if all(rc is not None for rc in codes):
                return (PREEMPT_EXIT_CODE
                        if any(rc == PREEMPT_EXIT_CODE for rc in codes)
                        else 0)
            if any(rc == PREEMPT_EXIT_CODE for rc in codes):
                # part of the group preempted cleanly; give the remaining
                # ranks one grace window to land their own preemption
                # checkpoint before reaping the round
                if preempt_seen is None:
                    preempt_seen = time.time()
                elif time.time() - preempt_seen > grace:
                    self._kill_all()
                    return PREEMPT_EXIT_CODE
            # judge only the still-running ranks: a finished or preempted
            # worker's aging heartbeat must not condemn the live ones
            if hang_timeout > 0 and running and live != running:
                print("[launch] worker heartbeats stale (no progress for "
                      f"{hang_timeout:g}s) — killing the hung group",
                      file=sys.stderr)
                self._kill_all()
                return HANG_EXIT_CODE
            time.sleep(0.2)

    def _note_liveness(self, codes, hang_timeout):
        """Set the ``launch_live_ranks`` gauge from this tick's evidence:
        a rank is live when its process is running and, with the hang
        watchdog armed, its heartbeat is fresh (spawn time as the
        not-yet-written grace anchor). Value changes are appended to
        ``<log_dir>/liveness.log`` (``<epoch-seconds> <n>``). Returns
        ``(running_ranks, live_ranks)``."""
        running = {str(self.args.rank * self.nproc + lr)
                   for lr, rc in enumerate(codes) if rc is None}
        live = set(running)
        if hang_timeout > 0 and live:
            live &= _hb_live(self._hb_dir, hang_timeout,
                             since=self._spawn_time, ranks=live)
        n = len(live)
        _G_LIVE_RANKS.set(n)
        if n != self._last_live:
            self._last_live = n
            if self.args.log_dir:
                try:
                    with open(os.path.join(self.args.log_dir,
                                           "liveness.log"), "a") as f:
                        f.write(f"{time.time():.3f} {n}\n")
                except OSError:
                    pass
        return running, live

    def _refresh_master(self):
        """A fresh rendezvous port per restart round for an auto-selected
        single-node master: the dead round's port can linger in
        TIME_WAIT."""
        if getattr(self.args, "master_auto", False) and self.args.nnodes == 1:
            addr = self.args.master.rsplit(":", 1)[0]
            self.args.master = f"{addr}:{_free_port()}"

    def run(self):
        budget = RestartBudget(self.args.max_restart)
        try:
            while True:
                self._spawn_all()
                rc = self._watch()
                if rc == 0:
                    return 0
                if rc == PREEMPT_EXIT_CODE and budget.note_preemption():
                    print(f"[launch] clean preemption (exit "
                          f"{PREEMPT_EXIT_CODE}); relaunching — restart "
                          f"budget untouched ({budget.used}/"
                          f"{budget.max_restarts} used)", file=sys.stderr)
                    self._refresh_master()
                    continue
                if rc == PREEMPT_EXIT_CODE:
                    reason = (f"preempt-looping (> "
                              f"{budget.PREEMPT_CAP_PER_WINDOW} clean "
                              f"preemptions per {budget.window_s:.0f}s "
                              "window) — charging further preemptions "
                              "as crashes")
                else:
                    reason = ("hang (stale heartbeats past "
                              "FLAGS_worker_hang_timeout_s)"
                              if rc == HANG_EXIT_CODE else f"rc={rc}")
                if budget.try_acquire():
                    self._refresh_master()
                    delay = budget.backoff()
                    print(f"[launch] worker failed ({reason}); restart "
                          f"{budget.used}/{budget.max_restarts} "
                          f"(backoff {delay:.1f}s)", file=sys.stderr)
                    continue
                raise CrashLoopError(
                    f"crash loop: worker failed ({reason}) with the "
                    f"restart budget exhausted ({budget.max_restarts} "
                    f"restarts per {budget.window_s:.0f}s window, "
                    f"{budget.total_restarts} performed); giving up",
                    exit_code=rc, restarts=budget.total_restarts)
        finally:
            self._close_logs()
            if not self.args.log_dir:  # tmpdir heartbeat rendezvous
                import shutil

                shutil.rmtree(self._hb_dir, ignore_errors=True)

    def _close_logs(self):
        for f in self._log_files:
            try:
                f.close()
            except Exception:
                pass
        self._log_files = []
