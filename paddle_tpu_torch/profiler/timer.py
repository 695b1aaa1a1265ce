"""Throughput monitor (counterpart of ``paddle_tpu/profiler/timer.py``).

Reference: python/paddle/profiler/timer.py — Benchmark (:349) with
begin/step/end and the ips (items/sec) summary the hapi loop auto-
reports.
"""

from __future__ import annotations

import time

__all__ = ["Benchmark", "benchmark"]


class _Stat:
    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def update(self, v):
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def avg(self):
        return self.total / self.count if self.count else 0.0


class Benchmark:
    """reference timer.py:349 — measures per-step wall time and ips.

    Usage::

        bm = profiler.Benchmark()
        bm.begin()
        for batch in loader:
            ...train...
            bm.step(batch_size)
        info = bm.step_info()   # 'ips: 1234.5 items/s ...'
        bm.end()
    """

    def __init__(self):
        self.reader = _Stat()      # data-wait time (begin->step gap reuse)
        self.batch = _Stat()       # full step time
        self._last = None
        self._running = False
        self.units = "items/s"
        self._items = 0
        self.skip_first = 1        # warmup steps excluded from stats
        self._seen = 0

    def begin(self):
        self._running = True
        self._last = time.perf_counter()
        self.reader.reset()
        self.batch.reset()
        self._items = 0
        self._seen = 0

    def step(self, num_samples=1):
        if not self._running:
            self.begin()
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._seen += 1
        if self._seen > self.skip_first:
            self.batch.update(dt)
            self._items += num_samples

    def end(self):
        self._running = False

    @property
    def ips(self):
        if self.batch.total <= 0:
            return 0.0
        return self._items / self.batch.total

    def step_info(self, unit=None):
        u = unit or self.units
        return (f"avg_samples_per_sec: {self.ips:.1f} {u}, "
                f"batch_cost: {self.batch.avg * 1000:.2f} ms "
                f"(min {self.batch.min * 1000:.2f}, "
                f"max {self.batch.max * 1000:.2f})")


_GLOBAL = Benchmark()


def benchmark():
    """Global Benchmark instance (reference timer.py benchmark())."""
    return _GLOBAL
