"""Grid geometry: world position <-> cell index math (port of
``fastdem_tpu/grid/geometry.py``).

Same conventions as the reference: a dense ``rows x cols`` grid of square
cells of side ``resolution``, centered on ``position``; row index grows
toward -x, column index toward -y:

    row = floor((position.x + length.x/2 - p.x) / resolution)
    col = floor((position.y + length.y/2 - p.y) / resolution)

Layers are stored world-aligned (no circular buffer); ``gridmap.move``
rolls the data.

Float -> int32 casts follow the reference's conversion semantics on every
device: out-of-range values saturate and NaN becomes 0. Padded points
carry a 1e9 sentinel, so ``(ox - 1e9) / res`` is far below the int32
range; a plain torch cast gives INT_MIN on the CPU and saturates on CUDA,
so the cast here is explicit and the ``inside`` mask and the dump-slot id
agree on both devices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fastdem_tpu_torch.numerics import div_f32, recip_f32

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Truncating f32 -> int32 cast that saturates out-of-range values and
    maps NaN to 0 (the reference's conversion semantics)."""
    hi = x >= 2147483648.0
    lo = x < -2147483648.0
    bad = hi | lo | torch.isnan(x)
    out = torch.where(bad, torch.zeros_like(x), x).to(torch.int32)
    out = torch.where(hi, _I32_MAX, out)
    return torch.where(lo, _I32_MIN, out)


def floor_i32(x: torch.Tensor) -> torch.Tensor:
    return to_i32(torch.floor(x))


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static grid shape and resolution (hashable)."""

    rows: int
    cols: int
    resolution: float

    @staticmethod
    def from_length(width: float, height: float, resolution: float) -> "GridGeometry":
        """A geometry covering at least ``width x height`` meters."""
        rows = max(1, int(np.ceil(round(width / resolution, 6))))
        cols = max(1, int(np.ceil(round(height / resolution, 6))))
        return GridGeometry(rows=rows, cols=cols, resolution=float(resolution))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @property
    def num_cells(self) -> int:
        return self.rows * self.cols

    @property
    def length(self) -> Tuple[float, float]:
        return (self.rows * self.resolution, self.cols * self.resolution)

    def origin(self, position: torch.Tensor):
        """Top-left map corner (max-x, max-y edge) in world coordinates."""
        ox = position[0] + 0.5 * self.rows * self.resolution
        oy = position[1] + 0.5 * self.cols * self.resolution
        return ox, oy

    def index_of(self, position: torch.Tensor, xy: torch.Tensor, true_div: bool = False):
        """World points f32[..., 2] -> (row i32, col i32, inside bool).

        The division by the resolution is the compiled step's multiply by
        its float32 reciprocal, or with ``true_div`` the reference's eager
        true division (its batch DEM path)."""
        ox, oy = self.origin(position)
        if true_div:
            r = floor_i32(div_f32(ox - xy[..., 0], self.resolution))
            c = floor_i32(div_f32(oy - xy[..., 1], self.resolution))
        else:
            inv = recip_f32(self.resolution)
            r = floor_i32((ox - xy[..., 0]) * inv)
            c = floor_i32((oy - xy[..., 1]) * inv)
        inside = (r >= 0) & (r < self.rows) & (c >= 0) & (c < self.cols)
        return r, c, inside

    def cell_id_of(self, position: torch.Tensor, xy: torch.Tensor, true_div: bool = False):
        """Flattened cell ids (r * cols + c); points outside the map get the
        dump-slot id ``num_cells``."""
        r, c, inside = self.index_of(position, xy, true_div)
        flat = r * self.cols + c
        return torch.where(inside, flat, self.num_cells), inside

    def position_of(self, position: torch.Tensor, row: torch.Tensor, col: torch.Tensor):
        """World coordinates of cell centers (inverse of ``index_of``)."""
        ox, oy = self.origin(position)
        x = ox - (row.to(torch.float32) + 0.5) * self.resolution
        y = oy - (col.to(torch.float32) + 0.5) * self.resolution
        return x, y

    def cell_centers(self, position: torch.Tensor):
        """World x / y of all cell centers, each f32[rows, cols]."""
        dev = position.device
        rr = torch.arange(self.rows, dtype=torch.float32, device=dev)[:, None]
        cc = torch.arange(self.cols, dtype=torch.float32, device=dev)[None, :]
        ox, oy = self.origin(position)
        x = ox - (rr + 0.5) * self.resolution
        y = oy - (cc + 0.5) * self.resolution
        return x.expand(self.shape), y.expand(self.shape)

    def is_inside(self, position: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
        _, _, inside = self.index_of(position, xy)
        return inside
