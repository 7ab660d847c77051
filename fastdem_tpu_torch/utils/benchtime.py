"""Two-length difference timing and robust sample statistics (the port's
own copy of ``fastdem_tpu/utils/benchtime.py``; it imports nothing of the
JAX package).

One call over a K-iteration chain costs ``T(K) = D + K*s``: D the fixed
per-call cost (host dispatch, synchronisation), s the true per-iteration
time. Timing the SAME chain at K and 2K and differencing cancels D; taking
MEDIANS of each leg over interleaved repetitions first removes the stall
tails a single difference would leak. If the 2K chain slows itself (memory
pressure from 2K scans staged at once) the estimate inflates, so keep the
2K leg's buffers comfortable.

Callers pass thunks that run their chain and block until it is done (on a
card: ``torch.cuda.synchronize()`` inside the thunk).
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np


def median(xs) -> float:
    """The one median definition every committed number uses (np.median:
    even counts average the two middle values — tools previously used the
    upper-middle sample, a subtly different estimator)."""
    return float(np.median(np.asarray(xs, dtype=np.float64)))


def two_length_diff_ms(
    run_k: Callable[[], None],
    run_2k: Callable[[], None],
    K: int,
    pairs: int = 10,
) -> Tuple[float, List[float], float]:
    """Median-of-pairs two-length difference estimate of ms per iteration.

    ``run_k`` / ``run_2k`` execute the K- and 2K-iteration chains and BLOCK
    until the device result is ready (callers synchronise the card); both
    must already be warmed up -- this function only times.

    Returns ``(ms_per_iter, per_pair, med_k_s)`` where per_pair lists each
    interleaved difference ``(t2 - t1)/K`` in ms (spread diagnostic) and
    med_k_s is the K-leg's median wall seconds (for the raw dispatch-
    inflated quotient ``med_k_s / K * 1e3`` some reports also show). The
    estimate is clamped to a 0.1 us floor: timing noise can drive the
    difference non-positive on sub-millisecond chains.
    """
    t1s, t2s = [], []
    for _ in range(pairs):
        t0 = time.perf_counter()
        run_k()
        t1s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        run_2k()
        t2s.append(time.perf_counter() - t0)
    ms = max((median(t2s) - median(t1s)) / K * 1e3, 1e-4)
    per_pair = [(b - a) / K * 1e3 for a, b in zip(t1s, t2s)]
    return ms, per_pair, median(t1s)


def summarize(samples, iqr_factor: float = 1.5) -> dict:
    """Robust sample statistics in the reference benchmark harness's shape
    (nanoPCL lib/nanoPCL/benchmarks/common/benchmark_common.hpp: Stats with
    mean/stddev/median/CI95 after IQR outlier removal).

    Removes samples outside [q1 - f*IQR, q3 + f*IQR], then reports
    mean/stddev (ddof=1)/median/min/max and the 95% confidence interval of
    the mean (1.96 * stddev / sqrt(n)). Use for wall-time rep pools where
    a stall tail would otherwise skew the mean (the two-length chain
    estimator above is the right tool for chained device throughput; this
    is for per-call latencies and host-loop timings).
    """
    xs = np.asarray(samples, dtype=np.float64)
    if xs.size == 0:
        raise ValueError("summarize() needs at least one sample")
    q1, q3 = np.percentile(xs, [25, 75])
    iqr = q3 - q1
    keep = (xs >= q1 - iqr_factor * iqr) & (xs <= q3 + iqr_factor * iqr)
    kept = xs[keep]
    n = int(kept.size)
    mean = float(kept.mean())
    std = float(kept.std(ddof=1)) if n > 1 else 0.0
    return {
        "n": n,
        "outliers_removed": int(xs.size - n),
        "mean": mean,
        "stddev": std,
        "median": float(np.median(kept)),
        "min": float(kept.min()),
        "max": float(kept.max()),
        "ci95": 1.96 * std / np.sqrt(n) if n > 0 else 0.0,
    }
