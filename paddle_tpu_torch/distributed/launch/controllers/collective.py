"""The launcher's crash-loop breaker (counterpart of
``paddle_tpu/distributed/launch/controllers/collective.py:72-166``):
:class:`RestartBudget`, a leaky bucket of crash restarts with exponential
backoff and a cap on clean preemptions, and :class:`CrashLoopError`, what
a supervisor raises once the bucket is full. The serving fleet's
``ReplicaSupervisor`` keeps one budget a replica slot (and one for scale
events). ``CollectiveController`` and ``HANG_EXIT_CODE`` come with the
launcher (ROADMAP Queue 1 item 3).

The budget reads ``FLAGS_restart_window_s`` and ``FLAGS_restart_backoff_s``
when its window or backoff base is not given.
"""

from __future__ import annotations

import time

from ....core.flags import flag_value

__all__ = ["RestartBudget", "CrashLoopError"]


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
