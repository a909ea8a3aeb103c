"""The benchmark's arithmetic: percentiles, spreads and device-interval unions."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float):
    """The nearest-rank ``q``-th percentile of ``values`` and the number of
    samples above it: (value, n_beyond)."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no samples")
    k = max(math.ceil(q / 100.0 * len(s)) - 1, 0)
    v = s[k]
    return v, sum(1 for x in s if x > v)


def spread(values) -> float:
    """Interquartile distance over the median (Python's default quartiles)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps counted once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The (start, end) spans inside [start, end] that no interval covers."""
    out = []
    pos = start
    for s, e in sorted(intervals):
        if s > pos:
            out.append((pos, min(s, end)))
        pos = max(pos, e)
        if pos >= end:
            break
    if pos < end:
        out.append((pos, end))
    return [(s, e) for s, e in out if e > s]
