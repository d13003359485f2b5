"""The arithmetic the metrics rest on: percentiles, the rate between
sightings, and intervals of device activity."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The exact q-th percentile by nearest rank: the smallest value
    with at least q% of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(1, math.ceil(q / 100.0 * len(s))) - 1]


def sighting_rate(first, last) -> float:
    """Turns per second between two sightings (time, turn, ...): all the
    turns between two exact published pairs over the wall time between
    them."""
    if last[0] <= first[0]:
        raise ValueError("the sightings are not in time order")
    return (last[1] - first[1]) / (last[0] - first[0])


def union(intervals) -> list:
    """Merged, sorted (start, end) of possibly overlapping intervals."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def covered(merged, lo: float, hi: float) -> float:
    """Length of [lo, hi] that merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def idle_share(merged, lo: float, hi: float) -> float:
    """Share of [lo, hi] that no interval covers, in percent."""
    if hi <= lo:
        raise ValueError("empty window")
    return 100.0 * (1.0 - covered(merged, lo, hi) / (hi - lo))


def gaps(merged, lo: float, hi: float) -> list:
    """(start, end) of the stretches of [lo, hi] no interval covers."""
    out, at = [], lo
    for s, e in merged:
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out
