"""The metric arithmetic, kept apart from the program under test.

* `rate`: work done over the whole window, divided by its seconds.
* `percentile`: a percentile over every sample of the window (linear
  interpolation between the closest ranks, numpy's default), never a
  median of medians or a histogram's bucket.
* `union_seconds`: the length of the union of (start, end) intervals, the
  time in which at least one operation ran on the device.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np


def rate(done: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("an empty window has no rate")
    return done / seconds


def percentile(samples: Sequence[float], pct: float) -> float:
    if not len(samples):
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(samples, np.float64), pct))


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
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


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float
         ):
    """(start, end) of each stretch of [start, end] no interval covers."""
    cur = start
    for s, e in sorted(intervals):
        if s > cur:
            yield cur, min(s, end)
        cur = max(cur, e)
        if cur >= end:
            return
    if cur < end:
        yield cur, end
