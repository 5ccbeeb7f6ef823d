"""Statistics of a run's timings and of a set of runs."""

from __future__ import annotations

import statistics
from typing import Sequence


def p90(values: Sequence[float]) -> float:
    """The 90th percentile of every value (linear between order
    statistics, as numpy's default)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def rate(work: float, seconds: float) -> float:
    """All the work over all the time."""
    return work / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median
    (Python's default quantiles), the measure bounds are set from."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)
