"""The arithmetic of the metrics: rates, tails, means and device time."""

from __future__ import annotations

import math
import statistics


def rate(done: int, seconds: float) -> float:
    """Work completed over all the seconds of the window."""
    return done / seconds


def p95_with_failures(times: list[float | None]) -> float:
    """The 95th percentile (nearest rank) of every job's time, a failed
    job (None) counted as missing any limit: +inf."""
    xs = sorted(math.inf if t is None else t for t in times)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def geomean(values: list[float], floor: float) -> float:
    """Geometric mean, each value taken as at least ``floor`` (> 0)."""
    return math.exp(sum(math.log(max(v, floor)) for v in values) / len(values))


def spread(values: list[float]) -> float:
    """Distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals: list[tuple[float, float]], t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers."""
    out, at = [], t0
    for s, e in merged(intervals):
        s, e = max(s, t0), min(e, t1)
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out
