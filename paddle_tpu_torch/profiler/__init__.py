"""``profiler`` — tracing and throughput monitoring (counterpart of
``paddle_tpu/profiler/``; reference: python/paddle/profiler/ — Profiler
profiler.py:346, make_scheduler :117, export_chrome_tracing :215,
RecordEvent utils.py, Benchmark timer.py:349).

Host spans are :class:`RecordEvent` and ``observability.trace`` spans;
device traces are ``torch.profiler`` sessions (CUPTI) around RECORD
windows (see :mod:`.profiler`).
"""

from .profiler import (  # noqa: F401
    Profiler,
    ProfilerState,
    ProfilerTarget,
    export_chrome_tracing,
    load_profiler_result,
    make_scheduler,
)
from .profiler_statistic import SortedKeys  # noqa: F401
from .timer import Benchmark, benchmark  # noqa: F401
from .utils import RecordEvent, in_profiler_mode  # noqa: F401

__all__ = [
    "Profiler", "ProfilerState", "ProfilerTarget", "make_scheduler",
    "export_chrome_tracing", "load_profiler_result", "SortedKeys",
    "RecordEvent", "in_profiler_mode", "Benchmark", "benchmark",
    "SummaryView", "export_protobuf",
]


class SummaryView:
    """reference profiler SummaryView enum (table selection)."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    OperatorDetailView = 6
    MemoryView = 7
    MemoryManipulationView = 8
    UDFView = 9


def export_protobuf(dir_name=None, worker_name=None):
    """reference profiler.export_protobuf: an on_trace_ready handler
    saving the window's host events, pickled (``(name, start_ns, end_ns,
    tid)`` each) with a ``.pb`` extension; the chrome-trace JSON is the
    canonical artifact."""
    import os
    import pickle
    import time

    def handler(prof):
        d = dir_name or "./profiler_log"
        os.makedirs(d, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(d, f"{name}_{int(time.time())}.pb")
        with open(path, "wb") as f:
            pickle.dump(list(prof._events_snapshot), f)
        return path

    return handler
