"""Profiler core (counterpart of ``paddle_tpu/profiler/profiler.py``;
reference: python/paddle/profiler/profiler.py — Profiler (:346),
make_scheduler (:117), export_chrome_tracing (:215), the ProfilerState
and ProfilerTarget enums).

Host spans come from :class:`~.utils.RecordEvent` and, for the RECORD
window, from ``observability.trace`` (drive windows, serving request
lifecycles, checkpoint IO). With the GPU target the device trace is a
``torch.profiler.profile(activities=[CPU, CUDA])`` session, opened and
closed around each RECORD window; its chrome trace lands in a fresh
directory that ``export()`` names as ``metadata.device_trace_dir``. The
window's device kernels are read from the profiler's own event records
(its filter, start and end), never through ``prof.events()``, which
builds an object for every CPU op and came up short on long runs.

A GPU target where there is no card raises, as do the targets the port
has no device for (XPU, CUSTOM_DEVICE, TPU); the reference swallows every
error of its device trace.
"""

from __future__ import annotations

import enum
import json
import os
import socket
import tempfile
import time

import torch

from .utils import RECORDER

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "load_profiler_result"]


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # last RECORD step of a window


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """reference profiler.py:117 — step number -> ProfilerState.

    The cycle is [closed]*closed + [ready]*ready + [record]*record,
    repeated ``repeat`` times (0 = forever), after ``skip_first`` initial
    CLOSED steps. The last record step of each cycle returns
    RECORD_AND_RETURN (the trace is handed to on_trace_ready).
    """
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("closed/ready must be >=0 and record >= 1")
    span = closed + ready + record

    def fn(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * span:
            return ProfilerState.CLOSED
        pos = s % span
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == span - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return fn


def _default_state_scheduler(step):
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name, worker_name=None):
    """reference profiler.py:215 — an on_trace_ready callback writing
    ``<dir>/<worker>_time_<ms>.paddle_trace.json`` in chrome trace
    format."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof):
        worker = worker_name or f"host_{socket.gethostname()}_{os.getpid()}"
        path = os.path.join(dir_name, f"{worker}_time_{int(time.time()*1e3)}"
                            ".paddle_trace.json")
        prof.export(path, format="json")
        return path

    return handler


def load_profiler_result(filename):
    with open(filename) as f:
        return json.load(f)


def _device_events(prof):
    """The device intervals of a finished ``torch.profiler`` session as
    ``(name, start_ns, end_ns, 0)``, read from its event records with
    ``prof.events()``'s filter and names."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import _filter_name
    from torch.autograd.profiler_util import _rewrite_name

    return sorted(
        (_rewrite_name(e.name(), with_wildcard=True), e.start_ns(),
         e.end_ns(), 0)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and not _filter_name(e.name())
        and not getattr(e, "is_hidden_event", lambda: False)())


class Profiler:
    """reference profiler.py:346.

    Usage::

        with profiler.Profiler(
                scheduler=profiler.make_scheduler(closed=1, ready=1,
                                                  record=2),
                on_trace_ready=profiler.export_chrome_tracing("./log"),
        ) as p:
            for batch in loader:
                train_step(batch)
                p.step()
        print(p.summary())
    """

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False):
        self.targets = list(targets or [ProfilerTarget.CPU,
                                        ProfilerTarget.GPU])
        other = [t for t in self.targets
                 if t not in (ProfilerTarget.CPU, ProfilerTarget.GPU)]
        if other:
            raise ValueError(f"profiler targets {other}: the port traces "
                             "ProfilerTarget.CPU and ProfilerTarget.GPU")
        self.timer_only = timer_only
        if self._want_device_trace() and not torch.cuda.is_available():
            raise RuntimeError(
                "ProfilerTarget.GPU requested but torch.cuda.is_available() "
                "is False; pass targets=[ProfilerTarget.CPU]")
        if scheduler is None:
            self._scheduler = _default_state_scheduler
        elif isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = make_scheduler(
                closed=max(lo - 1, 0), ready=1 if lo > 0 else 0,
                record=hi - lo, repeat=1)
        else:
            self._scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self._torch_kw = dict(record_shapes=record_shapes,
                              profile_memory=profile_memory,
                              with_flops=with_flops)
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._device_prof = None
        self._trace_dir = None
        self._events_snapshot = []
        self._device_snapshot = []
        # observability-tracer spans captured during the RECORD window
        self._obs_spans = []
        self._owns_tracer = False
        self._obs_window_start_ts = 0.0  # chrome-trace us clock
        from .timer import benchmark

        self._benchmark = benchmark()

    # -- device trace (torch.profiler) -----------------------------------
    def _want_device_trace(self):
        return not self.timer_only and ProfilerTarget.GPU in self.targets

    def _start_device_trace(self):
        if not self._want_device_trace() or self._device_prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self._trace_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_trace_")
        self._device_prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            **self._torch_kw)
        self._device_prof.start()

    def _stop_device_trace(self):
        prof, self._device_prof = self._device_prof, None
        if prof is None:
            return
        torch.cuda.synchronize()
        prof.stop()
        self._device_snapshot = _device_events(prof)
        prof.export_chrome_trace(os.path.join(self._trace_dir,
                                              "device_trace.json"))

    # -- state machine ---------------------------------------------------
    def _transit(self, new_state):
        old = self.current_state
        if old == new_state:
            return
        recording_old = old in (ProfilerState.RECORD,
                                ProfilerState.RECORD_AND_RETURN)
        recording_new = new_state in (ProfilerState.RECORD,
                                      ProfilerState.RECORD_AND_RETURN)
        if not recording_old and recording_new:
            RECORDER.enabled = True
            from ..observability import trace as obs_trace

            # arm the span tracer for the window; if the user already has
            # it on (collecting their own trace), leave it theirs and
            # remember where this window starts so export() takes only
            # in-window spans, not the user's whole history
            self._owns_tracer = not obs_trace.TRACER.enabled
            self._obs_window_start_ts = time.perf_counter_ns() / 1e3
            if self._owns_tracer:
                obs_trace.TRACER.enable()
            self._start_device_trace()
        elif recording_old and not recording_new:
            # a custom scheduler may go RECORD -> CLOSED/READY without ever
            # returning RECORD_AND_RETURN; tear the window down here so the
            # recorder and device trace never leak (reference state machine)
            self._finish_window()
        self.current_state = new_state

    def _finish_window(self):
        from ..observability import trace as obs_trace

        self._events_snapshot = list(RECORDER.events)
        RECORDER.enabled = False
        RECORDER.clear()
        # only the observability spans recorded during this window: if we
        # armed the tracer, drain our window's events and disarm, leaving
        # earlier buffered events for the user's own trace.export(); a
        # user-enabled tracer keeps its whole buffer — we only copy
        if self._owns_tracer:
            self._obs_spans = obs_trace.TRACER.drain_since(
                self._obs_window_start_ts)
            obs_trace.TRACER.disable()
            self._owns_tracer = False
        else:
            self._obs_spans = [
                e for e in obs_trace.TRACER.events()
                if e.get("ts", 0.0) >= self._obs_window_start_ts]
        self._stop_device_trace()
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def start(self):
        self._benchmark.begin()
        self.step_num = 0
        self._transit(self._scheduler(0))
        return self

    def stop(self):
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._finish_window()
        self.current_state = ProfilerState.CLOSED
        self._benchmark.end()

    def step(self, num_samples=1):
        self._benchmark.step(num_samples)
        if self.current_state == ProfilerState.RECORD_AND_RETURN:
            self._finish_window()
            self.current_state = ProfilerState.CLOSED
        self.step_num += 1
        self._transit(self._scheduler(self.step_num))

    def step_info(self, unit=None):
        return self._benchmark.step_info(unit)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- output ----------------------------------------------------------
    def export(self, path, format="json"):
        """Write the window's host spans as a chrome trace: RecordEvent
        spans plus every ``observability.trace`` span recorded in the
        window. The device trace (GPU target) is the chrome trace in
        ``metadata.device_trace_dir``."""
        events = [{"name": name, "ph": "X", "cat": "host",
                   "ts": start / 1e3, "dur": (end - start) / 1e3,
                   "pid": os.getpid(), "tid": tid}
                  for name, start, end, tid in self._events_snapshot]
        events.extend(self._obs_spans)
        doc = {"traceEvents": events,
               "metadata": {"device_trace_dir": self._trace_dir}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """The window's host spans by name and, with a device trace, its
        device kernels by name."""
        from .profiler_statistic import SortedKeys, build_summary

        key = sorted_by or SortedKeys.CPUTotal
        text = build_summary(self._events_snapshot, time_unit=time_unit,
                             sorted_by=key)
        if self._device_snapshot:
            text += "\n\nDevice kernels\n" + build_summary(
                self._device_snapshot, time_unit=time_unit, sorted_by=key)
        return text
