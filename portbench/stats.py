"""The statistics the benchmark reports, over every sample of a window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linearly
    interpolated between the order statistics around rank q/100 (n - 1)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    r = q / 100 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def rate(work: float, seconds: float) -> float:
    """Work a second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds
