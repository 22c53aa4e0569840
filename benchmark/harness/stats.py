"""The arithmetic of the end-to-end metrics and of the device trace:
percentiles over all frames, a rate over the window, the union of device
intervals and the idle gaps between them."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        raise ValueError("no values")
    return float(np.percentile(v, q))


def rate(count: int, seconds: float) -> float:
    """Events completed in the window over the window's seconds."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return count / seconds


def union(intervals: Iterable[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals clipped to [lo, hi), as sorted
    disjoint intervals."""
    clipped = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                     if e > lo and s < hi)
    out: List[Tuple[float, float]] = []
    for s, e in clipped:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(merged: Sequence[Tuple[float, float]]) -> float:
    return float(sum(e - s for s, e in merged))


def gaps(merged: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi) that the disjoint sorted intervals leave
    uncovered."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
