"""The benchmark's own arithmetic over a window's records."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0–100) of every value, by linear interpolation
    between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """count per second over the whole window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def intervals_union(intervals) -> float:
    """Total length covered by (start, end) intervals: overlapping
    intervals (kernels on several streams) are counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
