"""Span tracer: Chrome-trace/Perfetto-compatible JSON, zero added syncs.

The port's own copy of ``paddle_tpu/observability/trace.py`` (stdlib
only). Host-side spans — per-request serving lifecycles (queued, prefill,
decode) — export as one ``{"traceEvents": [...]}`` JSON that
chrome://tracing and Perfetto open directly.

Spans open and close ONLY at points where the host already blocks or
already holds the value (admission bookkeeping, post-fetch sampling). A
span never forces a device sync and costs one ``perf_counter_ns`` pair
plus a dict append when enabled. Disabled (the default), ``span()``
returns a shared no-op context manager and ``add_complete`` returns
before taking the lock.

Timestamps are ``time.perf_counter_ns`` (monotonic), emitted in the
chrome-trace microsecond unit. Complete events use ``ph="X"``; per-request
serving spans ride on ``tid=<request id>`` so each request renders as its
own row.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Tracer", "TRACER", "span", "instant", "add_complete", "enable",
           "disable", "enabled", "clear", "events", "drain", "export"]


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self):
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "tid", "args", "_start")

    def __init__(self, tracer, name, cat, tid, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self._start = time.perf_counter_ns()

    def end(self):
        if self._start is None:
            return
        self._tracer.add_complete(self.name, self._start,
                                  time.perf_counter_ns(), cat=self.cat,
                                  tid=self.tid, args=self.args)
        self._start = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    """Thread-safe buffer of chrome-trace events with an on/off switch.

    The buffer is BOUNDED (``max_events``, default 1M): a tracer left
    armed on a long-lived server must not grow host memory without
    limit. On overflow the oldest quarter is dropped, counted in
    ``dropped`` (surfaced in ``export``'s metadata) and warned about
    once — a silently truncated trace reading as complete is the
    no-silent-caps rule's trace-side case."""

    DEFAULT_MAX_EVENTS = 1_000_000

    def __init__(self, max_events=None):
        self.enabled = False
        self.max_events = int(max_events or self.DEFAULT_MAX_EVENTS)
        self.dropped = 0
        self._warned_drop = False
        self._lock = threading.Lock()
        self._events = []

    # -- switches --------------------------------------------------------
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._events = []
            self.dropped = 0
            self._warned_drop = False

    def _append(self, ev):
        with self._lock:
            self._events.append(ev)
            if len(self._events) <= self.max_events:
                return
            cut = max(1, len(self._events) // 4)
            del self._events[:cut]
            self.dropped += cut
            warn = not self._warned_drop
            self._warned_drop = True
        if warn:
            import warnings

            warnings.warn(
                f"observability tracer buffer exceeded max_events="
                f"{self.max_events}; dropping the oldest quarter "
                "(counted in Tracer.dropped / export metadata). Export "
                "or clear() periodically, or raise TRACER.max_events",
                RuntimeWarning, stacklevel=3)

    # -- recording -------------------------------------------------------
    def span(self, name, cat="host", tid=None, args=None):
        """Context manager measuring a host-side region. When the tracer
        is disabled this returns a shared no-op — callers never pay more
        than one attribute read."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, tid, args)

    def add_complete(self, name, start_ns, end_ns, cat="host", tid=None,
                     args=None):
        """Record one complete (``ph="X"``) event from timestamps the
        caller already holds — how the serving engine emits request
        lifecycle spans retroactively at state transitions."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "cat": cat,
              "ts": start_ns / 1e3,
              "dur": max(end_ns - start_ns, 1) / 1e3,
              "pid": os.getpid(),
              "tid": tid if tid is not None else threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def instant(self, name, cat="host", tid=None, args=None):
        """One ``ph="i"`` marker (e.g. a sentinel verdict)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
              "ts": time.perf_counter_ns() / 1e3,
              "pid": os.getpid(),
              "tid": tid if tid is not None else threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    # -- readout ---------------------------------------------------------
    def events(self):
        with self._lock:
            return list(self._events)

    def drain(self):
        with self._lock:
            out, self._events = self._events, []
            return out

    def drain_since(self, cutoff_ts_us):
        """Remove and return events with ``ts >= cutoff``, keeping older
        ones — a Profiler RECORD window takes only its own spans and
        leaves a user's earlier buffered history (kept for their own
        ``export``) intact."""
        with self._lock:
            take = [e for e in self._events
                    if e.get("ts", 0.0) >= cutoff_ts_us]
            self._events = [e for e in self._events
                            if e.get("ts", 0.0) < cutoff_ts_us]
            return take

    def export(self, path):
        """Write the buffered events as chrome-trace JSON. The file opens
        directly in chrome://tracing / Perfetto and feeds
        ``scripts/trace_report.py``."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        if self.dropped:
            doc["metadata"] = {"droppedEvents": self.dropped}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


TRACER = Tracer()


# -- module-level facade over the process-wide tracer ----------------------

def span(name, cat="host", tid=None, args=None):
    return TRACER.span(name, cat=cat, tid=tid, args=args)


def instant(name, cat="host", tid=None, args=None):
    return TRACER.instant(name, cat=cat, tid=tid, args=args)


def add_complete(name, start_ns, end_ns, cat="host", tid=None, args=None):
    return TRACER.add_complete(name, start_ns, end_ns, cat=cat, tid=tid,
                               args=args)


def enable():
    TRACER.enable()


def disable():
    TRACER.disable()


def enabled():
    return TRACER.enabled


def clear():
    TRACER.clear()


def events():
    return TRACER.events()


def drain():
    return TRACER.drain()


def export(path):
    return TRACER.export(path)
