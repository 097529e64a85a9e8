"""Percentiles and spreads, as the benchmark reports them."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile (``q`` in 0..100) over every sample."""
    v = sorted(values)
    if not v:
        return None
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def spread(values) -> float:
    """The distance between the first and third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
