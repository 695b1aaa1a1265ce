"""Process-wide metrics registry: labeled counters, gauges, histograms.

The port's own copy of ``paddle_tpu/observability/metrics.py`` (stdlib
only). The serving scheduler and engine register their ``serving_*``
counters, gauges and histograms here, labeled by engine instance:

- ``snapshot()`` — the nested-dict API every in-process consumer reads;
- ``to_prometheus_text()`` — Prometheus text exposition;
- ``export_json()`` / ``compact_snapshot()`` — artifact forms.

Naming convention: ``<subsystem>_<what>[_total]``; counters end in
``_total``. Labels identify a bounded set of instances
(``instance=llm_engine#1``) — never unbounded values (shapes, request
ids, file paths).

Recording is host-side arithmetic only — no device values are fetched
here, ever, so instrumentation adds no device synchronisation.
"""

from __future__ import annotations

import bisect
import json
import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "compact_snapshot",
    "to_prometheus_text", "export_json", "reset", "set_enabled", "enabled",
    "exponential_buckets", "DEFAULT_MS_BUCKETS", "DEFAULT_SECONDS_BUCKETS",
]

# latency-ish defaults: wide enough for CPU-smoke and TPU-pod scales
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
                      30000.0)
DEFAULT_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                           0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                           300.0)


def exponential_buckets(start, factor, count):
    """``count`` upper bounds growing by ``factor`` from ``start``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out, b = [], float(start)
    for _ in range(int(count)):
        out.append(b)
        b *= float(factor)
    return tuple(out)


def _label_key(labels):
    """Canonical hashable form of a label set (sorted (k, str(v)) pairs)."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key):
    """``a=x,b=y`` rendering used as the JSON/snapshot series key."""
    return ",".join(f"{k}={v}" for k, v in key)


class _Metric:
    """Base: one named metric holding labeled series."""

    kind = "untyped"

    def __init__(self, registry, name, help=""):
        self._registry = registry
        self.name = name
        self.help = help
        self._series = {}          # label_key -> value
        self._label_names = None   # fixed by the first series

    def _check_labels(self, labels):
        names = tuple(sorted(str(k) for k in labels))
        if self._label_names is None:
            self._label_names = names
        elif names != self._label_names:
            raise ValueError(
                f"metric {self.name!r} was first used with labels "
                f"{self._label_names}; got {names} — every series of one "
                "metric must share the same label names (Prometheus "
                "exposition and the cardinality rules both require it)")
        return _label_key(labels)

    def labels(self):
        """All live label keys, sorted — snapshot/exposition order."""
        with self._registry._lock:
            return sorted(self._series)

    def remove(self, **labels):
        """Drop one series (e.g. an engine instance resetting its own
        window-local numbers). Missing series is a no-op."""
        with self._registry._lock:
            self._series.pop(_label_key(labels), None)

    def clear(self):
        """Drop every series of this metric."""
        with self._registry._lock:
            self._series.clear()
            self._label_names = None


class Counter(_Metric):
    """Monotonically increasing count (events, bytes, tokens)."""

    kind = "counter"

    def inc(self, n=1, **labels):
        if not self._registry.enabled:
            return
        n = float(n)
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._registry._lock:
            key = self._check_labels(labels)
            self._series[key] = self._series.get(key, 0.0) + n

    def value(self, **labels):
        with self._registry._lock:
            return self._series.get(_label_key(labels), 0.0)


class Gauge(_Metric):
    """Point-in-time value (queue depth, utilization, liveness)."""

    kind = "gauge"

    def set(self, v, **labels):
        if not self._registry.enabled:
            return
        with self._registry._lock:
            key = self._check_labels(labels)
            self._series[key] = float(v)

    def inc(self, n=1, **labels):
        if not self._registry.enabled:
            return
        with self._registry._lock:
            key = self._check_labels(labels)
            self._series[key] = self._series.get(key, 0.0) + float(n)

    def dec(self, n=1, **labels):
        self.inc(-float(n), **labels)

    def value(self, **labels):
        with self._registry._lock:
            return self._series.get(_label_key(labels), 0.0)


class _HistSeries:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None


class Histogram(_Metric):
    """Fixed-bucket distribution (latencies, window wall times).

    Buckets are UPPER bounds (``le`` semantics); an implicit ``+Inf``
    bucket catches overflow. ``percentile`` interpolates linearly inside
    the winning bucket, clamped to the observed min/max — an estimate,
    which is the honest best a fixed-bucket histogram can do (documented
    in DESIGN_DECISIONS.md "Observability").
    """

    kind = "histogram"

    def __init__(self, registry, name, help="", buckets=None):
        super().__init__(registry, name, help)
        b = tuple(float(x) for x in (buckets or DEFAULT_SECONDS_BUCKETS))
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing, got {b}")
        self.buckets = b

    def observe(self, v, **labels):
        if not self._registry.enabled:
            return
        v = float(v)
        with self._registry._lock:
            key = self._check_labels(labels)
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.counts[bisect.bisect_left(self.buckets, v)] += 1
            s.count += 1
            s.sum += v
            s.min = v if s.min is None else min(s.min, v)
            s.max = v if s.max is None else max(s.max, v)

    def _get(self, labels):
        return self._series.get(_label_key(labels))

    def count(self, **labels):
        with self._registry._lock:
            s = self._get(labels)
            return s.count if s else 0

    def sum(self, **labels):
        with self._registry._lock:
            s = self._get(labels)
            return s.sum if s else 0.0

    def percentile(self, p, **labels):
        """Estimated p-th percentile (0..100) from the bucket counts, or
        ``None`` for an empty series."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile wants 0..100, got {p}")
        with self._registry._lock:
            s = self._get(labels)
            if s is None or s.count == 0:
                return None
            target = (p / 100.0) * s.count
            cum = 0
            for i, n in enumerate(s.counts):
                if n == 0:
                    continue
                if cum + n >= target:
                    lo = self.buckets[i - 1] if i > 0 else s.min
                    hi = (self.buckets[i] if i < len(self.buckets)
                          else s.max)
                    frac = (target - cum) / n
                    est = lo + frac * (hi - lo)
                    return float(min(max(est, s.min), s.max))
                cum += n
            return float(s.max)

    def summary(self, **labels):
        """``{count, sum, min, max, mean, p50, p99}`` for one series —
        the compact form bench lines and ``LLMEngine.metrics()`` report."""
        with self._registry._lock:
            s = self._get(labels)
            if s is None or s.count == 0:
                return {"count": 0, "sum": 0.0, "min": None, "max": None,
                        "mean": None, "p50": None, "p99": None}
        return {"count": s.count, "sum": s.sum, "min": s.min, "max": s.max,
                "mean": s.sum / s.count,
                "p50": self.percentile(50, **labels),
                "p99": self.percentile(99, **labels)}

    def _series_snapshot(self, s):
        d = {"count": s.count, "sum": s.sum, "min": s.min, "max": s.max,
             "buckets": {}}
        cum = 0
        for bound, n in zip(self.buckets, s.counts):
            cum += n
            d["buckets"][repr(bound)] = cum
        d["buckets"]["+Inf"] = s.count
        return d


class MetricsRegistry:
    """Name -> metric map with one lock. ``enabled=False`` turns every
    recording call into a no-op (the observability-off A/B arm); values
    recorded before the switch are retained, not cleared."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}
        self.enabled = True

    def _get_or_create(self, cls, name, help, **kw):
        if not name or not all(c.isalnum() or c == "_" for c in name):
            raise ValueError(
                f"metric name {name!r} must be non-empty "
                "[a-zA-Z0-9_] (the exposition grammar)")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help, **kw)
                return m
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is already registered as a "
                    f"{m.kind}; cannot re-register as a {cls.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=None):
        m = self._get_or_create(Histogram, name, help, buckets=buckets)
        if buckets is not None and tuple(float(b) for b in buckets) \
                != m.buckets:
            raise ValueError(
                f"histogram {name!r} is already registered with buckets "
                f"{m.buckets}; got {tuple(buckets)}")
        return m

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    # -- export ----------------------------------------------------------
    def snapshot(self):
        """``{name: {"type", "help", "series": {label_str: value}}}``.
        Histogram series values are the full bucket dicts plus
        count/sum/min/max."""
        out = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                series = {}
                for key in sorted(m._series):
                    v = m._series[key]
                    if isinstance(m, Histogram):
                        series[_label_str(key)] = m._series_snapshot(v)
                    else:
                        series[_label_str(key)] = v
                out[name] = {"type": m.kind, "help": m.help,
                             "series": series}
        return out

    def compact_snapshot(self):
        """``{name: {label_str: scalar-or-summary}}`` — the small form
        appended to BENCH lines (histograms collapse to their
        count/sum/p50/p99 summary)."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in sorted(metrics):
            series = {}
            for key in m.labels():
                if isinstance(m, Histogram):
                    s = m.summary(**dict(key))
                    series[_label_str(key)] = {
                        "count": s["count"],
                        "sum": round(s["sum"], 4),
                        "p50": (round(s["p50"], 4)
                                if s["p50"] is not None else None),
                        "p99": (round(s["p99"], 4)
                                if s["p99"] is not None else None)}
                else:
                    with self._lock:
                        v = m._series.get(key)
                    if v is not None:
                        series[_label_str(key)] = round(v, 4)
            if series:
                out[name] = series
        return out

    def to_prometheus_text(self):
        """Prometheus text exposition (v0.0.4): HELP/TYPE headers, one
        sample line per series, histograms as cumulative ``_bucket``
        series plus ``_sum``/``_count``."""
        lines = []

        def esc(v):
            # exposition v0.0.4 label-value escaping: a user-chosen
            # instance name containing " \ or a newline must not produce
            # an unparseable sample line that rejects the whole scrape
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def fmt_labels(key, extra=()):
            items = list(key) + list(extra)
            if not items:
                return ""
            return ("{" + ",".join(f'{k}="{esc(v)}"' for k, v in items)
                    + "}")

        def fmt_val(v):
            v = float(v)
            # Prometheus renders non-finite samples as +Inf/-Inf/NaN; a
            # single poisoned series must not crash the whole scrape
            if math.isinf(v):
                return "+Inf" if v > 0 else "-Inf"
            if math.isnan(v):
                return "NaN"
            if v == int(v) and abs(v) < 1e15:
                return str(int(v))
            return repr(v)

        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if not m._series:
                    continue
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                for key in sorted(m._series):
                    v = m._series[key]
                    if isinstance(m, Histogram):
                        cum = 0
                        for bound, n in zip(m.buckets, v.counts):
                            cum += n
                            lab = fmt_labels(key, [("le", repr(bound))])
                            lines.append(f"{name}_bucket{lab} {cum}")
                        lab = fmt_labels(key, [("le", "+Inf")])
                        lines.append(f"{name}_bucket{lab} {v.count}")
                        lines.append(
                            f"{name}_sum{fmt_labels(key)} {fmt_val(v.sum)}")
                        lines.append(
                            f"{name}_count{fmt_labels(key)} {v.count}")
                    else:
                        lines.append(
                            f"{name}{fmt_labels(key)} {fmt_val(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_json(self, path):
        """Write ``snapshot()`` to ``path`` — the metrics half of the
        artifact pair ``scripts/trace_report.py`` renders."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def reset(self):
        """Clear every series of every metric. Registrations survive —
        subsystems hold module-level handles to their metric objects, and
        dropping those would silently fork the registry from its writers.
        Tests and benchmarks only; never steady state."""
        with self._lock:
            for m in self._metrics.values():
                m.clear()


REGISTRY = MetricsRegistry()


# -- module-level facade over the process-wide registry --------------------

def counter(name, help=""):
    return REGISTRY.counter(name, help)


def gauge(name, help=""):
    return REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=None):
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot():
    return REGISTRY.snapshot()


def compact_snapshot():
    return REGISTRY.compact_snapshot()


def to_prometheus_text():
    return REGISTRY.to_prometheus_text()


def export_json(path):
    return REGISTRY.export_json(path)


def reset():
    REGISTRY.reset()


def set_enabled(flag):
    """Master recording switch. Disabling freezes every counter/gauge/
    histogram at its current value (registered telemetry like
    ``jit.cache_stats()`` reads frozen numbers) — meant for the
    observability-off arm of an A/B, not steady-state operation.
    Returns the previous state."""
    prev = REGISTRY.enabled
    REGISTRY.enabled = bool(flag)
    return prev


def enabled():
    return REGISTRY.enabled
