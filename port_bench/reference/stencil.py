"""Window-stencil helpers: neighbourhood offset sets, the shifted-stack
gather and sums over it (port of ``fastdem_tpu/postprocess/stencil.py``).

A window of K offsets over an [H, W] layer becomes a [K, H, W] stack of
shifted copies, NaN outside the map, so border cells simply see fewer
valid neighbours. Offsets are row-major over (dr, dc), as in the
reference; the sums below run over the stack in that order.

The offset sets are pure numpy, copied here (importing the reference's
module would import JAX).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def disk_offsets(radius_m: float, resolution: float) -> Tuple[Tuple[int, int], ...]:
    """Offsets (dr, dc) whose centre distance is within ``radius_m``,
    the centre cell included."""
    r_cells = int(np.floor(radius_m / resolution + 1e-6))
    out: List[Tuple[int, int]] = []
    for dr in range(-r_cells, r_cells + 1):
        for dc in range(-r_cells, r_cells + 1):
            d = np.hypot(dr, dc) * resolution
            if d <= radius_m + 1e-6:
                out.append((dr, dc))
    return tuple(out)


@lru_cache(maxsize=16)
def square_offsets(k: int, include_center: bool = True) -> Tuple[Tuple[int, int], ...]:
    """k x k window offsets."""
    h = k // 2
    return tuple(
        (dr, dc)
        for dr in range(-h, h + 1)
        for dc in range(-h, h + 1)
        if include_center or (dr, dc) != (0, 0)
    )


def offset_distances_sq(
    offsets: Sequence[Tuple[int, int]], resolution: float
) -> np.ndarray:
    """Squared metric distance per offset."""
    o = np.asarray(offsets, dtype=np.float32)
    return (o[:, 0] ** 2 + o[:, 1] ** 2) * resolution * resolution


def window_stack(
    a: torch.Tensor, offsets: Sequence[Tuple[int, int]], fill: float = float("nan")
) -> torch.Tensor:
    """[K, H, W] where out[k, i, j] = a[i + dr_k, j + dc_k] (``fill``
    outside)."""
    H, W = a.shape
    R = max(max(abs(dr), abs(dc)) for dr, dc in offsets)
    padded = F.pad(a, (R, R, R, R), value=fill)
    return torch.stack(
        [padded[R + dr : R + dr + H, R + dc : R + dc + W] for dr, dc in offsets]
    )


def sum_in_order(stack: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 from +0, one term at a time in offset order: the
    reference's window sums, bit for bit. ``torch.sum`` associates
    differently at some window sizes."""
    acc = torch.zeros_like(stack[0])
    for k in range(stack.shape[0]):
        acc = acc + stack[k]
    return acc


def count_true(mask: torch.Tensor) -> torch.Tensor:
    """int32 count of True over axis 0 (exact in any order)."""
    return torch.sum(mask, dim=0, dtype=torch.int32)
