"""Order statistics the metric readers share."""
from __future__ import annotations

import math


def percentile(values, p: float) -> float | None:
    """The nearest-rank p-th percentile (the smallest value with at least p %
    of the values at or below it); None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    return float(vals[max(0, math.ceil(p / 100.0 * len(vals)) - 1)])
