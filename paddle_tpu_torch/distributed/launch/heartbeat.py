"""Worker-side supervision contract: heartbeat files + graceful preemption
(counterpart of ``paddle_tpu/distributed/launch/heartbeat.py``).

The supervisor (``CollectiveController``) can see a worker *die* (exit
code) but not *wedge* — a rank parked in a collective whose peer is gone
looks exactly like one making slow progress. This module is the shared
contract that closes that gap:

- **Heartbeats.** The launcher exports ``PADDLE_HEARTBEAT_DIR`` to every
  worker; :func:`write` drops an atomic ``hb.<rank>`` JSON file (step +
  wall time) there. ``FusedTrainStep.drive`` calls it at every metric-fetch
  window boundary (and the launch bootstrap writes one at process start,
  so a long start-up never reads as a hang). The supervisor's
  :func:`stale` compares the *stalest* rank — training is lockstep, so one
  silent rank means the group is wedged even while the others still beat.
  Heartbeats are best-effort: a failed write (fault site ``hb.write``)
  returns ``False`` and training continues; losing supervision must never
  cause the failure it exists to detect.

- **Preemption.** A scheduler evicting a job sends SIGTERM.
  :func:`trap_preemption` installs a recording (not raising) handler so
  the training loop can finish its in-flight fetch window, write a
  committed checkpoint, and exit with :data:`PREEMPT_EXIT_CODE` — which
  the supervisor treats as *clean*: relaunch without consuming restart
  budget. Exit-code contract: ``0`` done, ``123`` preempted-with-
  checkpoint, anything else a crash.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time

__all__ = ["HEARTBEAT_DIR_ENV", "PREEMPT_EXIT_CODE", "heartbeat_dir",
           "write", "read_all", "stale", "live_ranks", "PreemptionState",
           "trap_preemption"]

HEARTBEAT_DIR_ENV = "PADDLE_HEARTBEAT_DIR"
# 123 is outside the shell/signal ranges workers produce by accident
# (128+N = killed by signal N; small codes = script errors)
PREEMPT_EXIT_CODE = 123


def heartbeat_dir():
    """The directory this process should heartbeat into, or ``None`` when
    running unsupervised (env unset — every write becomes a no-op)."""
    return os.environ.get(HEARTBEAT_DIR_ENV) or None


def write(step=None, dir=None, rank=None):
    """Atomically publish this worker's heartbeat (``hb.<rank>``: step,
    wall time, pid). Returns ``True`` on success, ``False`` when
    unsupervised (no dir) or the write failed — heartbeat failure is
    never allowed to crash training."""
    d = dir or heartbeat_dir()
    if not d:
        return False
    if rank is None:
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
    path = os.path.join(d, f"hb.{rank}")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        from ...utils import fault_injection

        fault_injection.fire("hb.write")
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "pid": os.getpid()}, f)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def read_all(dir):
    """``{rank: payload}`` for every parseable ``hb.*`` file under ``dir``
    (heartbeats are written atomically, so a partial file can only be a
    leftover tmp — those are skipped by name)."""
    out = {}
    try:
        entries = os.listdir(dir)
    except OSError:
        return out
    for fn in entries:
        if not fn.startswith("hb.") or ".tmp." in fn:
            continue
        try:
            with open(os.path.join(dir, fn)) as f:
                out[fn[3:]] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def stale(dir, timeout_s, since=None, now=None, expected=None, ranks=None):
    """True when the group looks hung: the *stalest* rank's newest
    heartbeat is older than ``timeout_s``. Ranks that have not written yet
    are scored at ``since`` (the group's spawn time), so a worker that
    never starts beating is caught too — but a freshly spawned group is
    not declared hung before ``since + timeout_s``. ``expected`` is the
    number of workers the supervisor launched; without it only ranks that
    actually wrote are considered. ``ranks`` restricts the judgment to
    those rank ids — the supervisor passes its *still-running* workers, so
    the aging heartbeat file of a rank that already exited (done, or
    preempted cleanly) can never condemn the live ones as hung. Returns
    ``False`` when there is nothing to judge (no heartbeats and no
    baseline)."""
    if not timeout_s or float(timeout_s) <= 0:
        return False
    if now is None:
        now = time.time()
    beats = read_all(dir)
    if ranks is not None:
        allowed = {str(r) for r in ranks}
        beats = {r: v for r, v in beats.items() if r in allowed}
        expected = len(allowed)
    times = [float(v.get("time", 0.0)) for v in beats.values()]
    missing = 0 if expected is None else max(0, int(expected) - len(times))
    if missing and since is not None:
        times += [float(since)] * missing
    if not times:
        if since is None:
            return False
        times = [float(since)]
    return (now - min(times)) > float(timeout_s)


def live_ranks(dir, timeout_s, since=None, now=None, ranks=None):
    """Rank ids (strings) whose heartbeat looks alive: newest ``hb.<rank>``
    mtime within ``timeout_s`` of ``now``. A rank that has not written yet
    is scored at ``since`` (its spawn time) when given, so a freshly
    spawned worker counts as live until ``since + timeout_s`` — the same
    grace :func:`stale` applies. ``ranks`` names the candidate set (the
    supervisor passes its workers); without it only ranks that wrote are
    considered. Feeds the supervisor's ``launch_live_ranks`` gauge
    (``paddle.observability.metrics``)."""
    if now is None:
        now = time.time()
    beats = read_all(dir)
    candidates = ({str(r) for r in ranks} if ranks is not None
                  else set(beats))
    out = set()
    for r in candidates:
        t = beats.get(r, {}).get("time")
        if t is None:
            t = since
        if t is None:
            continue
        if not timeout_s or float(timeout_s) <= 0 \
                or (now - float(t)) <= float(timeout_s):
            out.add(r)
    return out


class PreemptionState:
    """Cross-references the signal a :func:`trap_preemption` scope
    absorbed. ``triggered`` flips once and stays set; ``signum`` records
    which signal arrived."""

    __slots__ = ("triggered", "signum")

    def __init__(self):
        self.triggered = False
        self.signum = None


@contextlib.contextmanager
def trap_preemption(signals=(signal.SIGTERM,), enable=True):
    """Record (instead of dying on) preemption signals for the duration of
    the block; previous handlers are restored on exit. Yields a
    :class:`PreemptionState` the loop polls at its window boundaries.
    Off the main thread (or with ``enable=False``) the state is yielded
    inert — signal handlers can only be installed from the main thread."""
    state = PreemptionState()
    installed = {}
    if enable and threading.current_thread() is threading.main_thread():
        def _handler(signum, frame):
            state.triggered = True
            state.signum = signum

        try:
            for s in signals:
                installed[s] = signal.signal(s, _handler)
        except (ValueError, OSError):
            for s, h in installed.items():
                signal.signal(s, h)
            installed = {}
    try:
        yield state
    finally:
        for s, h in installed.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
