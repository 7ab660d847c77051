"""The arithmetic of the metrics: percentiles over every sample and rates
over the whole window. No sample is dropped as an outlier: a stall is what
a tail is made of."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear rule) of all samples; None
    when there are none."""
    x = np.asarray(list(samples), dtype=np.float64)
    if x.size == 0:
        return None
    return float(np.percentile(x, q))


def rate(count: int, seconds: float) -> Optional[float]:
    """Work done in a window over the window's length."""
    if seconds <= 0:
        return None
    return count / seconds


def per_item(total: float, count: int) -> Optional[float]:
    return total / count if count > 0 else None
