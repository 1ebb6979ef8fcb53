"""The arithmetic of the end-to-end metrics, kept with the benchmark."""

from __future__ import annotations

import math

__all__ = ["percentile", "union_length", "gaps"]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at
    least q % of the values at or below it.  Missing values count as
    +inf, so a tail that holds a miss is +inf."""
    xs = sorted(values)
    if not xs:
        return math.nan
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def union_length(intervals) -> float:
    """The length covered by the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if b <= cur:
            continue
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
