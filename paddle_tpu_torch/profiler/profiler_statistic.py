"""Summary tables (counterpart of ``paddle_tpu/profiler/
profiler_statistic.py``; reference: python/paddle/profiler/
profiler_statistic.py).

Aggregates spans by name into a fixed-width table: calls, total, avg,
min and max duration.
"""

from __future__ import annotations

__all__ = ["SortedKeys", "build_summary"]


class SortedKeys:
    CPUTotal = "total"
    CPUAvg = "avg"
    CPUMax = "max"
    CPUMin = "min"
    Calls = "calls"


_UNIT = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}


def build_summary(events, time_unit="ms", sorted_by=SortedKeys.CPUTotal):
    """The table of ``events``, ``(name, start_ns, end_ns, tid)`` each,
    sorted by ``sorted_by``, descending."""
    div = _UNIT.get(time_unit, 1e6)
    agg = {}
    for name, start, end, _tid in events:
        d = agg.setdefault(name, {"calls": 0, "total": 0.0,
                                  "min": float("inf"), "max": 0.0})
        dur = (end - start) / div
        d["calls"] += 1
        d["total"] += dur
        d["min"] = min(d["min"], dur)
        d["max"] = max(d["max"], dur)
    rows = [(name, d["calls"], d["total"], d["total"] / d["calls"],
             d["min"], d["max"]) for name, d in agg.items()]
    key_idx = {"calls": 1, "total": 2, "avg": 3, "min": 4, "max": 5}
    rows.sort(key=lambda r: -r[key_idx.get(sorted_by, 2)])
    width = max([len(r[0]) for r in rows], default=4) + 2
    lines = [
        f"{'Name':<{width}}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
        f"{'Avg':>12}{'Min':>12}{'Max':>12}",
        "-" * (width + 58),
    ]
    for name, calls, total, avg, mn, mx in rows:
        lines.append(f"{name:<{width}}{calls:>8}{total:>14.3f}{avg:>12.3f}"
                     f"{mn:>12.3f}{mx:>12.3f}")
    return "\n".join(lines)
