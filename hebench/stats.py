"""The statistics a run and a set of runs are summarised by."""

from __future__ import annotations

import statistics


def percentile(values: list, p: int) -> float:
    """The p-th percentile (1 <= p <= 99) of every value, linearly
    interpolated between the order statistics (statistics.quantiles,
    'inclusive')."""
    if not values:
        raise ValueError("a percentile of no values")
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def rate(count: int, seconds: float) -> float:
    """Work done over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds


def spread(values: list) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    statistics.quantiles(values, n=4) gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
