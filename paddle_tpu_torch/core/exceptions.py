"""Typed supervision exceptions + the in-process stall guard (counterpart
of ``paddle_tpu/core/exceptions.py``).

A wedged collective (one peer dead, the rest parked in an allgather) or a
hung input pipeline blocks the training loop forever without raising — the
process looks alive to everything except its own wall clock. The reference
framework's elastic stack surfaces this at two levels: in-process (trainer
watchdog timers) and out-of-process (the elastic controller's heartbeat
scanner). This module is the in-process half: :func:`stall_guard` arms a
wall-clock timer around a blocking region and turns "no progress within
``FLAGS_step_timeout_s``" into a typed :class:`TrainStallError` the caller
— and the supervising launcher, via the nonzero exit it causes — can treat
exactly like a crash. The out-of-process half is the launcher's heartbeat
watchdog (a stall the guard cannot interrupt, e.g. code blocked in C
holding the GIL, is caught there instead): workers write the heartbeats
(:mod:`..distributed.launch.heartbeat`) and the launcher's
``CollectiveController`` judges them
(:mod:`..distributed.launch.controllers.collective`).
"""

from __future__ import annotations

import contextlib
import signal
import threading

__all__ = ["TrainDivergenceError", "TrainStallError", "stall_guard"]


class TrainDivergenceError(RuntimeError):
    """Training is finite-but-wrong and the divergence sentinel ran out of
    graceful responses: the loss-spike / grad-explosion detector
    (``FLAGS_sentinel_action``) either exhausted its rollback budget
    (``FLAGS_sentinel_rollback_budget`` rollbacks per rolling
    ``FLAGS_sentinel_budget_window_s`` window), was configured to raise on
    the first verdict, or had no healthy checkpoint to roll back to.

    ``history`` carries the sentinel's spike records (one dict per spike
    verdict: step, window mean loss, z-score, grad-norm peak, reasons) and
    ``rollbacks`` the number of rollbacks already performed — enough for a
    supervisor or a human to reconstruct the divergence post-mortem without
    the (possibly dead) process's logs."""

    def __init__(self, msg, history=None, rollbacks=0):
        super().__init__(msg)
        self.history = list(history or [])
        self.rollbacks = int(rollbacks)


class TrainStallError(RuntimeError):
    """A training step made no progress within the armed timeout
    (``FLAGS_step_timeout_s``): the fetch/dispatch the guard wrapped is
    wedged — typically a collective waiting on a dead peer or a stuck
    input pipeline. Semantically a crash: checkpoint state on disk is
    intact, so the supervisor's restart + ``auto_resume`` is the fix."""


@contextlib.contextmanager
def stall_guard(timeout_s, what="training step"):
    """Arm a wall-clock watchdog over the enclosed block: if it does not
    finish within ``timeout_s`` seconds, raise :class:`TrainStallError`
    *inside* the block (SIGALRM-based, so a Python-level block — e.g. a
    queue wait or ``time.sleep`` — is interrupted).

    No-op when ``timeout_s`` is falsy/<= 0, off the main thread, or on
    platforms without ``SIGALRM`` — the guard degrades to unsupervised
    rather than refusing to run. Best-effort by design: code blocked in C
    without releasing the GIL only unblocks at the next bytecode boundary;
    the launcher's heartbeat watchdog is the backstop for those."""
    if (not timeout_s or float(timeout_s) <= 0
            or not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def _on_alarm(signum, frame):
        raise TrainStallError(
            f"no progress within {float(timeout_s):g}s at {what} "
            "(FLAGS_step_timeout_s) — surfacing the wedged step as a crash")

    prev_handler = signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, float(timeout_s))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev_handler)
