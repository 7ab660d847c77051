"""K1's plain twin, the polar ray field's dense tail (frozen copy of the
port's ``ops/polar_field.py::polar_field_plain``, the reference's XLA
formulation). From the scattered min-slope table [R, A] it computes, in
order:

  1. a suffix min along the range rows;
  2. h = z0 + slope * (r * dr) where the slope is finite, else +inf;
  3. the in-cell fold: the min over rows r-nfold+1 .. r (row 0 stands in
     above the top edge);
  4. per-row circular azimuth roll-min doublings for k < lvl[r];
  5. with ``exact_window``, one more roll-min at each set bit of shift[r].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .numerics import fma_f32

@dataclasses.dataclass(frozen=True)
class ColumnWindows:
    """Per-range-row azimuth windows of one polar geometry, on the device:
    w(r) = 2^lvl[r] + shift[r] bins (see raycasting._column_windows)."""

    lvl: torch.Tensor  # int32[R]
    shift: torch.Tensor  # int32[R]
    max_lvl: int
    max_shift: int

    @staticmethod
    def from_numpy(lvl: np.ndarray, shift: np.ndarray, device) -> "ColumnWindows":
        return ColumnWindows(
            lvl=torch.as_tensor(lvl.astype(np.int32), device=device),
            shift=torch.as_tensor(shift.astype(np.int32), device=device),
            max_lvl=int(np.max(lvl)),
            max_shift=int(np.max(shift)),
        )


def polar_field_plain(
    scat: torch.Tensor,
    windows: ColumnWindows,
    sensor_origin: torch.Tensor,
    dr: float,
    nfold: int,
    exact_window: bool,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (the reference's XLA formulation); a
    batch [K, R, A] field by field."""
    if scat.dim() == 3:
        return torch.stack([
            polar_field_plain(s, windows, o, dr, nfold, exact_window)
            for s, o in zip(scat, sensor_origin)
        ])
    R, A = scat.shape
    ms = torch.flip(torch.cummin(torch.flip(scat, [0]), dim=0).values, [0])
    d_r = torch.arange(R, dtype=torch.float32, device=scat.device)[:, None] * dr
    # The reference's compiler contracts z0 + ms * d_r into one FMA.
    h = torch.where(
        torch.isfinite(ms), fma_f32(ms, d_r, sensor_origin[2]), float("inf")
    )

    def shift_down(a, k):
        return torch.cat([a[:1].expand(k, -1), a[:-k]], dim=0) if k > 0 else a

    p = 1
    acc = h
    while 2 * p <= nfold:
        acc = torch.minimum(acc, shift_down(acc, p))
        p *= 2
    if nfold - p > 0:
        acc = torch.minimum(acc, shift_down(acc, nfold - p))
    h = acc

    for k in range(windows.max_lvl):
        rowmask = (windows.lvl > k)[:, None]
        h = torch.where(rowmask, torch.minimum(h, torch.roll(h, -(1 << k), 1)), h)
    if exact_window:
        for b in range(max(0, windows.max_shift).bit_length()):
            rowmask = (((windows.shift >> b) & 1) == 1)[:, None]
            h = torch.where(
                rowmask, torch.minimum(h, torch.roll(h, -(1 << b), 1)), h
            )
    return h


def polar_field(
    scat: torch.Tensor,
    windows: ColumnWindows,
    sensor_origin: torch.Tensor,
    dr: float,
    nfold: int,
    exact_window: bool,
) -> torch.Tensor:
    """The plain twin on any device."""
    return polar_field_plain(scat, windows, sensor_origin, dr, nfold, exact_window)
