"""The arithmetic of the end-to-end metrics, over all blocks of the window."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values: the
    smallest value with at least q % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def rate(samples: int, seconds: float) -> float:
    """Samples completed over the window's seconds."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return samples / seconds


def quartiles(values):
    """(Q1, median, Q3) as statistics.quantiles gives them (n=4)."""
    if len(values) < 2:
        v = values[0]
        return v, v, v
    return tuple(statistics.quantiles(values, n=4))


def spread(values) -> float:
    """(Q3 - Q1) / median, the quartiles as statistics.quantiles gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
