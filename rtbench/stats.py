"""The end-to-end arithmetic, and the spread the bounds are set from."""

from __future__ import annotations

import math
import statistics


def rate(count: float, seconds: float) -> float:
    """Work completed over all of a window's wall seconds."""
    return count / seconds


def p95(values) -> float:
    """The 95th percentile of all ``values`` by nearest rank: the
    smallest value that at least 95 % of them do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def spread(values) -> float:
    """The distance between the first and third quartile
    (``statistics.quantiles(values, n=4)``) over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
