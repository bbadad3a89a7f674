"""Spreads, as the benchmark's bounds are read."""

from __future__ import annotations

import statistics
from typing import Sequence


def spread(values: Sequence[float]) -> float:
    """Distance between the first and the third quartile over the median,
    by `statistics.quantiles(values, n=4)`."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
