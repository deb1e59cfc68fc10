"""The statistics the metrics share: rates, tails and spreads."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence


def rate_per_s(total: float, seconds: float) -> Optional[float]:
    """``total`` over ``seconds``; None for an empty window."""
    if seconds <= 0:
        return None
    return total / seconds


def percentile(values: Sequence[float], pct: int) -> Optional[float]:
    """The ``pct``-th percentile of ``values`` (Python's inclusive
    quantiles, so it never lies beyond the largest value); None for no
    values."""
    vals = [float(v) for v in values]
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=100, method="inclusive")[pct - 1]


def quartile_spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, by ``statistics.quantiles(values, n=4)``: the spread the
    bounds are set from."""
    q1, q2, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / q2
