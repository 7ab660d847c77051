"""Iterative NaN-hole inpainting by neighbour averaging (port of
``fastdem_tpu/postprocess/inpainting.py``).

Per pass, NaN cells with >= min_valid finite 8-neighbours receive the mean
of those neighbours (double-buffered: every read sees the previous pass).

The reference stops early once a pass fills nothing; testing that here
would read a flag back to the host every pass. A pass that fills nothing
returns its input unchanged, and so does every pass after it, so running
exactly ``max_iterations`` passes gives the same result bit for bit, with
no host sync.
"""

from __future__ import annotations

import torch

from .stencil import (
    count_true,
    square_offsets,
    sum_in_order,
    window_stack,
)


def inpaint(
    elevation: torch.Tensor,
    max_iterations: int = 3,
    min_valid_neighbors: int = 2,
) -> torch.Tensor:
    """Fill NaN holes; returns the inpainted layer."""
    offsets = square_offsets(3, include_center=False)
    a = elevation
    for _ in range(max_iterations):
        win = window_stack(a, offsets)
        finite = torch.isfinite(win)
        cnt = count_true(finite)
        s = sum_in_order(torch.where(finite, win, 0.0))
        fill = torch.isnan(a) & (cnt >= min_valid_neighbors)
        mean = s / torch.clamp_min(cnt, 1)
        a = torch.where(fill, mean, a)
    return a


