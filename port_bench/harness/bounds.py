"""The H100's peaks and the least time a kernel could take (copied from the
port's card smoke test, ``bound_of``, ``k1_bound`` and ``k4_lookup_bound``).

Peaks: NVIDIA H100 SXM data sheet, at the 700 W limit: 3.35 TB/s of HBM,
67 TFLOP/s float32 outside the tensor cores.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per cell of K4's index math (two atan2f and one log2f
# counted at ~20 each) and its lookup.
K4_LOOKUP_OPS = 100


def bound_of(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for ``nbytes`` of traffic and ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bytes(R: int, A: int) -> int:
    """K1 reads the slope table and the window tables once and writes the
    field once."""
    return 2 * R * A * 4 + 2 * R * 4 + 4


def k1_bound(R: int, A: int, nfold: int, lvl, shift, exact: bool):
    """Per element a suffix min, the affine height (three operations),
    nfold - 1 fold mins and one min per azimuth pass (lvl doublings, then
    one pass for a nonzero exact-window shift)."""
    lvl, shift = np.asarray(lvl), np.asarray(shift)
    passes = int(lvl.sum()) + (int((shift > 0).sum()) if exact else 0)
    return bound_of(k1_bytes(R, A), R * A * (3 + nfold) + A * passes)


def k4_bytes(cells: int, reads: int) -> int:
    """K4 reads the field once or twice per cell (4 bytes each) and writes
    5 bytes per cell; the position, origin and offsets are a few bytes."""
    return cells * (4 * reads + 5) + 28


def k4_lookup_bound(cells: int, reads: int):
    return bound_of(k4_bytes(cells, reads), cells * K4_LOOKUP_OPS)
