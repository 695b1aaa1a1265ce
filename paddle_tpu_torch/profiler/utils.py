"""Host-side event recording (counterpart of
``paddle_tpu/profiler/utils.py``; reference: python/paddle/profiler/
utils.py, backed by the C++ HostTracer/HostEventRecorder).

A process-local recorder keeps the spans of a :class:`Profiler`'s RECORD
window; every :class:`RecordEvent` is also a
``torch.profiler.record_function`` range, so it lands in the device
trace (``torch.profiler``) too, inside or outside a window.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

__all__ = ["RecordEvent", "in_profiler_mode", "wrap_optimizers"]


class _Recorder:
    def __init__(self):
        self.events = []  # (name, start_ns, end_ns, tid)
        self.enabled = False
        self._lock = threading.Lock()

    def clear(self):
        with self._lock:
            self.events = []

    def add(self, name, start_ns, end_ns):
        if not self.enabled:
            return
        with self._lock:
            self.events.append(
                (name, start_ns, end_ns, threading.get_ident()))


RECORDER = _Recorder()


def in_profiler_mode():
    return RECORDER.enabled


class RecordEvent:
    """User-facing span marker (reference utils.py RecordEvent).

    Usage::

        with profiler.RecordEvent("data_loading"):
            batch = next(loader)
    """

    def __init__(self, name, event_type=None):
        self.name = name
        self.event_type = event_type
        self._start = None
        self._range = None

    def begin(self):
        self._start = time.perf_counter_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def end(self):
        if self._start is None:
            return
        self._range.__exit__(None, None, None)
        self._range = None
        RECORDER.add(self.name, self._start, time.perf_counter_ns())
        self._start = None

    __enter__ = begin

    def __exit__(self, *exc):
        self.end()
        return False


def wrap_optimizers():
    """Run every optimizer's ``step`` inside a ``RecordEvent("Optimization
    Step")`` while a profiler records (reference utils.py; idempotent).
    The fused training step does not call ``step``: its update is part of
    its program."""
    from ..optimizer import optimizer as opt_mod
    from ..optimizer import optimizers

    classes = [opt_mod.Optimizer] + [
        c for c in vars(optimizers).values()
        if isinstance(c, type) and issubclass(c, opt_mod.Optimizer)]
    for cls in classes:
        step = cls.__dict__.get("step")
        if step is None or getattr(step, "_recorded", False):
            continue

        @functools.wraps(step)
        def recorded(self, *args, _step=step, **kwargs):
            if not RECORDER.enabled:
                return _step(self, *args, **kwargs)
            with RecordEvent("Optimization Step"):
                return _step(self, *args, **kwargs)

        recorded._recorded = True
        cls.step = recorded
