"""K4's plain twin, the per-cell lookup of the polar ray field (frozen copy
of the port's ``ops/resample.py``: ``lookup_indices`` followed by
``resample_plain``). The field is f32[R, A]; per cell (all [h, w], the
whole map or a window) it returns

  ray_min f32[h, w]: the field's min over the cell's one or two reads,
                     NaN where the cell is not touched;
  touched bool[h, w] = isfinite(min) & in_range.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .geometry import GridGeometry, floor_i32, to_i32
from .numerics import fma_f32, recip_f32, sqrt_f32

# Azimuth half-width factor of a cell's angular footprint; the lookup and
# raycasting._column_windows must use the same value (the exact-window fold
# relies on it).
AZ_HALF_WIDTH = 0.5
_PI = math.pi
_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class PolarLookup:
    """The static part of one polar geometry's per-cell lookup: the map's
    geometry and a field [R, A] of range bin ``dr``
    (raycasting.polar_lookup builds it)."""

    geom: GridGeometry
    A: int
    R: int
    dr: float

    @functools.cached_property
    def consts(self) -> dict:
        """The lookup's constants, computed once: each the f32 value that the
        twin's ops compute with (a Python float operand of an f32 op is
        rounded to f32 first). The kernel and ``lookup_indices`` both read
        them."""
        f32 = np.float32
        rows, cols, res = self.geom.rows, self.geom.cols, self.geom.resolution
        return {
            k: float(v)
            for k, v in (
                ("half_x", f32(0.5 * rows * res)),
                ("half_y", f32(0.5 * cols * res)),
                ("res", f32(res)),
                ("half_res", f32(res * 0.5)),
                ("inv_dr", recip_f32(self.dr)),
                ("dr", f32(self.dr)),
                ("az_half", f32(res * AZ_HALF_WIDTH)),
                ("d_min", f32(1e-6)),
                ("inv_bin", recip_f32(2 * _PI / self.A)),
                ("pi", f32(_PI)),
                ("inv_2pi", recip_f32(2 * _PI)),
                ("a_f", f32(self.A)),
                ("r_max", f32((self.R - 1) * self.dr)),
            )
        }


def resample_plain(
    field: torch.Tensor,
    a0: torch.Tensor,
    a1: Optional[torch.Tensor],
    r_idx: torch.Tensor,
    in_range: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lookup of given indices in plain PyTorch: the twin's second
    half (``resample_lookup_plain``)."""
    A = field.shape[1]
    flat = field.reshape(-1)
    base = r_idx.long() * A
    h = flat[base + a0.long()]
    if a1 is not None:
        h = torch.minimum(h, flat[base + a1.long()])
    touched = torch.isfinite(h) & in_range
    return torch.where(touched, h, float("nan")), touched


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hypot as the reference computes it: max * sqrt(fma(q, q, 1)) with
    q = min / max."""
    x, y = torch.abs(x), torch.abs(y)
    idx_inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    q = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    out = torch.where(hi == 0, hi, hi * sqrt_f32(fma_f32(q, q, 1.0)))
    return torch.where(idx_inf, _INF, out)


def lookup_indices(
    lk: PolarLookup,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    window: Optional[Tuple] = None,
):
    """Per-cell (a0, a1, r_idx, in_range) lookups into the smeared field, as
    the reference's ``resample_indices`` computes them. Cells beyond the
    field's range bound report in_range=False.

    ``window``: optional (r0, c0, wr, wc) -- only the wr x wc cells whose
    top-left cell is (r0, c0); r0 / c0 are int32 device scalars, so the
    window never costs a host sync.
    """
    geom, A, R, c = lk.geom, lk.A, lk.R, lk.consts
    dev = position.device
    if window is not None:
        r0, c0, wr, wc = window
        rr = r0 + torch.arange(wr, dtype=torch.int32, device=dev)
        cc = c0 + torch.arange(wc, dtype=torch.int32, device=dev)
    else:
        wr, wc = geom.shape
        rr = torch.arange(wr, dtype=torch.int32, device=dev)
        cc = torch.arange(wc, dtype=torch.int32, device=dev)
    # Cell centres o - (i + 0.5) * res, which the reference's compiler
    # contracts into one fused multiply-add inside its compiled step.
    ox, oy = geom.origin(position)
    res = torch.full((), c["res"], dtype=torch.float32, device=dev)
    cx = fma_f32(-(rr.to(torch.float32) + 0.5), res, ox)[:, None].expand(wr, wc)
    cy = fma_f32(-(cc.to(torch.float32) + 0.5), res, oy)[None, :].expand(wr, wc)
    ddx = cx - sensor_origin[0]
    ddy = cy - sensor_origin[1]
    dist = _hypot(ddx, ddy)
    cell_az = torch.atan2(ddy, ddx)
    # Far-edge range: for downward rays the in-cell minimum sits there.
    r_idx = torch.clamp(to_i32((dist + c["half_res"]) * c["inv_dr"]), 0, R - 1)
    d_cell = r_idx.to(torch.float32) * c["dr"]
    half_w = torch.atan2(
        torch.full_like(d_cell, c["az_half"]), torch.clamp_min(d_cell, c["d_min"])
    )
    w_bins = torch.clamp(to_i32(torch.ceil(half_w * c["inv_bin"] * 2.0)) + 1, 1, A // 2)
    lvl_cell = floor_i32(torch.log2(torch.clamp_min(w_bins, 1).to(torch.float32)))
    w_pow = torch.bitwise_left_shift(torch.ones_like(lvl_cell), lvl_cell)
    a_center = torch.clamp(
        floor_i32((cell_az + c["pi"]) * c["inv_2pi"] * c["a_f"]), 0, A - 1
    )
    a0 = torch.remainder(a_center - w_bins // 2, A)
    a1 = torch.remainder(a0 + w_bins - w_pow, A)
    in_range = (dist + c["half_res"]) <= c["r_max"]
    return a0, a1, r_idx, in_range


def resample_lookup_plain(
    field: torch.Tensor,
    lk: PolarLookup,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    window: Optional[Tuple] = None,
    two_reads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the main path's K4: ``lookup_indices``
    followed by ``resample_plain``; a batch frame by frame."""
    if field.dim() == 3:
        outs = [
            resample_lookup_plain(
                field[k], lk, position[k], sensor_origin[k],
                None if window is None else (window[0][k], window[1][k], *window[2:]),
                two_reads,
            )
            for k in range(field.shape[0])
        ]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    a0, a1, r_idx, in_range = lookup_indices(lk, position, sensor_origin, window)
    return resample_plain(field, a0, a1 if two_reads else None, r_idx, in_range)


def resample_lookup(
    field: torch.Tensor,
    lk: PolarLookup,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    window: Optional[Tuple] = None,
    two_reads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin on any device."""
    return resample_lookup_plain(field, lk, position, sensor_origin, window, two_reads)
