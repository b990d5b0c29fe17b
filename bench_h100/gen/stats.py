"""The reductions from timings and traced intervals to metrics."""
from __future__ import annotations

import statistics


def p95(values) -> float:
    """The 95th percentile of every value, as
    ``statistics.quantiles(values, n=20)`` puts its last cut point (a
    single value is its own percentile)."""
    values = list(values)
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]


def union(intervals, lo: float | None = None, hi: float | None = None):
    """The union of ``(start, end)`` intervals, clipped to ``[lo, hi]``,
    as sorted disjoint intervals: overlaps count once."""
    out = []
    for s, e in sorted((s, e) for s, e, *_ in intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def covered(intervals, lo: float | None = None,
            hi: float | None = None) -> float:
    """The length of the union of the intervals inside ``[lo, hi]``."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
