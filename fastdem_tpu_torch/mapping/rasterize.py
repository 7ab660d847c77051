"""Point-to-cell rasterization (port of ``rasterize_scatter_rows`` and
``rasterize_stats`` in ``fastdem_tpu/mapping/rasterize.py``).

Every per-cell reduction is one lane of a single int32 row scatter-min
into a [ncell+1, L] table (row ``ncell`` is the dump slot of invalid
points):

  lane 0: packed ``(quantized z << idx_bits) | point_index`` -- the argmin
          carry for variance / color; among z within one quantum the
          smallest point index wins (the reference's first-strict-min rule
          up to the quantum).
  lane 1: ordered(z)  -- exact min z.
  lane 2: ordered(-z) -- exact max z.
  lane 3 (optional): ordered(-intensity).
  32 lanes (voxel_count_mode="exact"): distinct-z-voxel presence -- lane k
          gets 0 iff a point's (zbin mod 32) == k. Above 2^23 table
          entries the lanes are dropped and the count comes from one
          representative point per voxel (``filters.unique_mask_of``).

``ordered`` is the monotone f32 <-> int32 bit map, so the int32 min is the
float min, bit for bit. The argmin-carried channels come from one index
gather ``z_var[amin]``; the reference splits that gather by a TPU cost
model (cell path / per-point path), and both give these values for every
touched cell.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fastdem_tpu_torch.numerics import recip_f32
from fastdem_tpu_torch.grid.geometry import GridGeometry, floor_i32

_IMAX = 0x7FFFFFFF
_INF = float("inf")
_ZB = 32  # z-presence lanes per cell
_ORD_INF = 0x7F800000  # ordered(+inf)
_ORD_NINF = -0x7F800001  # ordered(-inf)


@dataclasses.dataclass
class CellObservations:
    """Dense per-cell observations from one scan. Untouched cells hold NaN
    (min_z / max_z / ...) and False (touched)."""

    min_z: torch.Tensor
    min_z_var: torch.Tensor
    max_z: torch.Tensor
    touched: torch.Tensor
    max_intensity: Optional[torch.Tensor]
    color: Optional[torch.Tensor]
    # Distinct z-voxels (side = grid resolution) among the cell's points:
    # the raycaster's observed-evidence multiplicity.
    voxel_count: Optional[torch.Tensor] = None
    # The extra min-scatter's table (see rasterize_scatter_rows).
    extra: Optional[torch.Tensor] = None


def _f32_ordered_i32(x: torch.Tensor) -> torch.Tensor:
    """Monotone, involutive f32 -> int32 map: a < b (floats, no NaN) iff
    map(a) < map(b). Negative floats flip their non-sign bits. Bitwise:
    -0.0, infinities and NaN payloads survive the round trip."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & _IMAX)


def _i32_ordered_f32(m: torch.Tensor) -> torch.Tensor:
    return (m ^ ((m >> 31) & _IMAX)).contiguous().view(torch.float32)


def _window_ids(geom: GridGeometry, position, xyz, mask, window):
    """Cell ids for the scatter table: (ids, valid, ncell, shape).

    ``window`` = (r0, c0, wr, wc), top-left cell as int32 device scalars:
    ids become window-local ``(r - r0) * wc + (c - c0)`` over a ``wr * wc``
    table, and points outside the window are masked like out-of-map points.
    """
    if window is None:
        ids, inside = geom.cell_id_of(position, xyz[:, :2])
        valid = mask & inside
        ncell = geom.num_cells
        return torch.where(valid, ids, ncell), valid, ncell, geom.shape
    r0, c0, wr, wc = window
    r, c, inside = geom.index_of(position, xyz[:, :2])
    rl = r - r0
    cl = c - c0
    inside = inside & (rl >= 0) & (rl < wr) & (cl >= 0) & (cl < wc)
    valid = mask & inside
    ncell = wr * wc
    return torch.where(valid, rl * wc + cl, ncell), valid, ncell, (wr, wc)


def _scatter_min_rows(ids: torch.Tensor, upd: torch.Tensor, nrows: int) -> torch.Tensor:
    """int32 [nrows, L] table of row-wise minima of ``upd`` rows at ``ids``,
    _IMAX where no row lands."""
    table = torch.full(
        (nrows, upd.shape[1]), _IMAX, dtype=torch.int32, device=upd.device
    )
    index = ids.long()[:, None].expand(-1, upd.shape[1])
    return table.scatter_reduce_(0, index, upd, "amin", include_self=True)


def rasterize_scatter_rows(
    geom: GridGeometry,
    position: torch.Tensor,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    z_var: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    color_packed: Optional[torch.Tensor] = None,
    with_voxel_count: bool = False,
    extra_min_scatter=None,
    voxel_count_mode: str = "exact",
    window=None,
) -> CellObservations:
    """Row-widened single-index scatter rasterization of one scan.

    ``extra_min_scatter``: optional (ids, values, table_size) of an
    unrelated min-reduction (the raycaster's polar slopes); its table
    without the dump slot, +inf where empty, lands in
    ``CellObservations.extra``.
    ``window``: optional (r0, c0, wr, wc); the observations are then
    window-shaped (see ``_window_ids``).
    """
    if voxel_count_mode not in ("exact", "span"):
        raise ValueError(f"unknown voxel_count_mode: {voxel_count_mode!r}")
    n = xyz.shape[0]
    dev = xyz.device
    idx_bits = max(1, (n - 1).bit_length())
    # One level fewer than the field allows: a valid point at index n-1
    # holding the scan's max z must not pack to exactly _IMAX.
    qmax = (1 << (31 - idx_bits)) - 2
    ids, valid, ncell, shape = _window_ids(geom, position, xyz, mask, window)
    z = xyz[:, 2]

    zlo = torch.min(torch.where(valid, z, _INF))
    zhi = torch.max(torch.where(valid, z, -_INF))
    zrange = torch.clamp_min(zhi - zlo, 1e-6)
    zq = torch.clamp(floor_i32((z - zlo) / zrange * qmax), 0, qmax)
    iota = torch.arange(n, dtype=torch.int32, device=dev)

    lanes = [
        torch.where(valid, (zq << idx_bits) | iota, _IMAX),
        torch.where(valid, _f32_ordered_i32(z), _IMAX),
        torch.where(valid, _f32_ordered_i32(-z), _IMAX),
    ]
    if intensity is not None:
        lanes.append(torch.where(valid, _f32_ordered_i32(-intensity), _IMAX))
    int_lane = len(lanes) - 1 if intensity is not None else None

    vox_in_rows = (
        with_voxel_count
        and voxel_count_mode == "exact"
        and (ncell + 1) * (len(lanes) + _ZB) <= (1 << 23)
    )
    vox_lane0 = None
    if vox_in_rows:
        vox_lane0 = len(lanes)
        zbin = torch.remainder(floor_i32(z * recip_f32(geom.resolution)), _ZB)
        lane_k = torch.arange(_ZB, dtype=torch.int32, device=dev)
        onehot = torch.where(
            valid[:, None] & (zbin[:, None] == lane_k[None, :]),
            torch.zeros((), dtype=torch.int32, device=dev),
            _IMAX,
        )
        upd = torch.cat([torch.stack(lanes, dim=1), onehot], dim=1)
    else:
        upd = torch.stack(lanes, dim=1)

    t = _scatter_min_rows(ids, upd, ncell + 1)[:ncell]

    packed_t = t[:, 0]
    touched = packed_t != _IMAX
    # Untouched cells decode the _IMAX sentinel's low bits; clamp, and the
    # gathered value is masked by ``touched`` below.
    amin = torch.clamp_max(packed_t & ((1 << idx_bits) - 1), n - 1).long()
    min_z = _i32_ordered_f32(t[:, 1])
    max_z = -_i32_ordered_f32(t[:, 2])
    max_intensity = None
    if intensity is not None:
        mi = -_i32_ordered_f32(t[:, int_lane])
        max_intensity = torch.where(torch.isfinite(mi), mi, float("nan")).reshape(shape)

    extra = None
    if extra_min_scatter is not None:
        e_ids, e_vals, e_size = extra_min_scatter
        et = torch.full((e_size,), _IMAX, dtype=torch.int32, device=dev)
        et.scatter_reduce_(
            0, e_ids.long(), _f32_ordered_i32(e_vals), "amin", include_self=True
        )
        et = et[: e_size - 1]
        extra = torch.where(et == _IMAX, _INF, _i32_ordered_f32(et))

    min_z_var = z_var[amin]
    color = None
    if color_packed is not None:
        color = torch.where(touched, color_packed[amin], float("nan")).reshape(shape)

    voxel_count = None
    if vox_in_rows:
        voxel_count = (
            (t[:, vox_lane0 : vox_lane0 + _ZB] == 0)
            .sum(dim=1)
            .to(torch.float32)
            .reshape(shape)
        )
    elif with_voxel_count and voxel_count_mode == "exact":
        # Above 2^23 table entries: one representative point per z-voxel
        # (side = resolution), counted into its cell.
        from fastdem_tpu_torch.cloud.filters import unique_mask_of

        vm = unique_mask_of(floor_i32(xyz * recip_f32(geom.resolution)), valid)
        voxel_count = (
            torch.zeros(ncell + 1, dtype=torch.float32, device=dev)
            .index_add_(0, ids.long(), vm.to(torch.float32))[:ncell]
            .reshape(shape)
        )
    elif with_voxel_count:  # "span"
        inv = recip_f32(geom.resolution)
        lo = torch.floor(min_z * inv)
        hi = torch.floor(max_z * inv)
        voxel_count = torch.where(
            touched, torch.clamp(hi - lo + 1.0, 1.0, float(_ZB)), 0.0
        ).reshape(shape)

    nan = float("nan")
    return CellObservations(
        min_z=torch.where(touched, min_z, nan).reshape(shape),
        min_z_var=torch.where(touched, min_z_var, nan).reshape(shape),
        max_z=torch.where(touched, max_z, nan).reshape(shape),
        touched=touched.reshape(shape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=voxel_count,
        extra=extra,
    )


@dataclasses.dataclass
class CellStats:
    """Batch per-cell statistics (the offline DEM path)."""

    mean: torch.Tensor
    variance: torch.Tensor
    min_z: torch.Tensor
    max_z: torch.Tensor
    count: torch.Tensor
    touched: torch.Tensor
    max_intensity: Optional[torch.Tensor]
    color: Optional[torch.Tensor]


def rasterize_stats(
    geom: GridGeometry,
    position: torch.Tensor,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    color_packed: Optional[torch.Tensor] = None,
) -> CellStats:
    """Per-cell count / mean / sample variance / min / max of a whole cloud.

    Sums are taken around a per-cell pivot (the cell's min z) for
    stability: var = (sum_sq - sum^2 / n) / (n - 1). Min, max and count
    come from scatter min / max / add, the sums from ``index_add_`` (on
    the CPU in point order; on CUDA its atomics add in any order, so the
    mean and variance may differ in the last bits). The colour is the
    min-z point's, the smallest packed colour on ties. Cell ids use the
    reference's eager true division.
    """
    ncell = geom.num_cells
    shape = geom.shape
    dev = xyz.device
    ids, inside = geom.cell_id_of(position, xyz[:, :2], true_div=True)
    valid = mask & inside
    ids = torch.where(valid, ids, ncell).long()
    safe = ids.clamp_max(ncell - 1)

    def reduce(vals, how, fill):
        t = torch.full((ncell + 1,), fill, dtype=vals.dtype, device=dev)
        return t.scatter_reduce_(0, ids, vals, how, include_self=True)[:ncell]

    def add(vals):
        t = torch.zeros(ncell + 1, dtype=torch.float32, device=dev)
        return t.index_add_(0, ids, vals)[:ncell]

    # Min / max through the ordered int32 map: -0.0 orders below +0.0, on
    # every device.
    z = xyz[:, 2]
    oz = _f32_ordered_i32(z)
    zmin = _i32_ordered_f32(reduce(torch.where(valid, oz, _ORD_INF), "amin", _ORD_INF))
    zmax = _i32_ordered_f32(reduce(torch.where(valid, oz, _ORD_NINF), "amax", _ORD_NINF))
    cnt = add(valid.to(torch.float32))
    touched = cnt > 0
    pivot = torch.where(touched, zmin, 0.0)
    dz = torch.where(valid, z - pivot[safe], 0.0)
    s1 = add(dz)
    s2 = add(dz * dz)
    den = torch.clamp_min(cnt, 1.0)
    mean = pivot + s1 / den
    var = torch.where(
        cnt >= 2.0,
        torch.clamp_min(s2 - s1 * s1 / den, 0.0) / torch.clamp_min(cnt - 1.0, 1.0),
        0.0,
    )

    nan = float("nan")
    max_intensity = None
    if intensity is not None:
        oi = torch.where(valid, _f32_ordered_i32(intensity), _ORD_NINF)
        mi = _i32_ordered_f32(reduce(oi, "amax", _ORD_NINF))
        max_intensity = torch.where(torch.isfinite(mi), mi, nan).reshape(shape)

    color = None
    if color_packed is not None:
        # Packed colours are non-negative float bit patterns: their int32
        # views order as the floats do, subnormals included.
        at_min = valid & (z == zmin[safe])
        bits = color_packed.contiguous().view(torch.int32)
        c = reduce(torch.where(at_min, bits, _IMAX), "amin", _IMAX)
        color = torch.where(c != _IMAX, c.view(torch.float32), nan).reshape(shape)

    return CellStats(
        mean=torch.where(touched, mean, nan).reshape(shape),
        variance=torch.where(touched, var, nan).reshape(shape),
        min_z=torch.where(touched, zmin, nan).reshape(shape),
        max_z=torch.where(touched, zmax, nan).reshape(shape),
        count=cnt.reshape(shape),
        touched=touched.reshape(shape),
        max_intensity=max_intensity,
        color=color,
    )
