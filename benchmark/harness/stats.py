"""Percentiles, in plain Python."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 - 100) by linear interpolation between the
    closest ranks (numpy's default). ``inf`` entries sort last."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or xs[hi] == xs[lo]:
        return float(xs[lo])
    if math.isinf(xs[hi]):
        return math.inf
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))
