"""Percentile and rate arithmetic over all queries of a window.

Frozen here so that no change to the program can move the yardstick.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def query_latencies(batches) -> list[float]:
    """Seconds from each query's batch formation to its answer, one entry
    a query: ``batches`` holds (formed, answered, n_queries)."""
    out: list[float] = []
    for formed, answered, n in batches:
        out.extend([answered - formed] * n)
    return out


def rate(n: int, seconds: float) -> float:
    """Work per second over the whole window."""
    return n / seconds
