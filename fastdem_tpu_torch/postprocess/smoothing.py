"""Median spatial smoothing of a map layer (port of
``fastdem_tpu/postprocess/smoothing.py``).

Each finite cell with >= min_valid finite neighbours in its k x k window
becomes the window's upper median: element count // 2 of the window
sorted with NaN set to +inf.
"""

from __future__ import annotations

import torch

from fastdem_tpu_torch.postprocess.stencil import (
    count_true,
    square_offsets,
    window_stack,
)


def smooth_median(
    layer: torch.Tensor, kernel_size: int = 3, min_valid_neighbors: int = 5
) -> torch.Tensor:
    offsets = square_offsets(kernel_size, include_center=True)
    win = window_stack(layer, offsets)  # [K, H, W]
    finite = torch.isfinite(win)
    cnt = count_true(finite)
    sorted_vals = torch.sort(
        torch.where(finite, win, float("inf")), dim=0, stable=True
    ).values
    median = torch.gather(sorted_vals, 0, (cnt // 2).long()[None])[0]
    ok = torch.isfinite(layer) & (cnt >= min_valid_neighbors)
    return torch.where(ok, median, layer)


def apply_spatial_smoothing(
    state, layer_name: str, kernel_size: int = 3, min_valid_neighbors: int = 5
):
    if layer_name not in state.layers:
        return state
    return state.replace_layer(
        layer_name,
        smooth_median(state.layers[layer_name], kernel_size, min_valid_neighbors),
    )
