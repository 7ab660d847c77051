"""Point-to-cell rasterization (port of ``fastdem_tpu/mapping/rasterize.py``):
the four formulations of the reference's integrate step and
``rasterize_stats`` of its batch path.

Rows mode (``rasterize_scatter_rows``, the default): every per-cell
reduction is one lane of a single int32 row scatter-min into a
[ncell+1, L] table (row ``ncell`` is the dump slot of invalid points):

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

Packed mode (``rasterize_scatter_packed``) drops lane 1: min z is the
argmin point's. The reference's pipeline switches rows to packed above
2^19 update cells. Twophase (``rasterize_scatter``) takes the exact min z
first, then the variance and colour over the points at it; sort mode
(``rasterize``) sorts the scan by (cell, z, variance).
``rasterize_scatter_rows_batched`` is rows mode over K scans in one
scatter.

``ordered`` is the monotone f32 <-> int32 bit map, so the int32 min is the
float min, bit for bit, on every device. The argmin-carried channels come
from one index gather ``z_var[amin]``; the reference splits that gather by
a TPU cost model (cell path / per-point path), and both give these values
for every touched cell.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .geometry import GridGeometry, floor_i32
from .numerics import recip_f32
from . import segments as seg

_IMAX = 0x7FFFFFFF
_INF = float("inf")
_ZB = 32  # z-presence lanes per cell
_ORD_INF = 0x7F800000  # ordered(+inf)
_ORD_NINF = -0x7F800001  # ordered(-inf)
# Presence lanes ride the scatter table up to this many entries: the whole
# row table in rows mode, the presence part (ncell * 32) in the others.
_ROWS_TABLE_MAX = 1 << 23
_FLAT_TABLE_MAX = 1 << 21


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


@dataclasses.dataclass
class UnshardedScan:
    """The unsharded rasterizer's view of one scan, for a call that
    rasterizes a block of the map (``parallel.sharding``), so that the
    block's cells come out as the unsharded call's:

      z_bounds: (zlo, zhi), the z range the argmin key quantizes over;
      valid:    the points the unsharded call keeps; a voxel's
                representative point is chosen among them;
      ncell:    the unsharded call's cell count, which picks the voxel
                count's path (presence lanes or representatives).
    """

    z_bounds: tuple
    valid: torch.Tensor
    ncell: int


def z_range_of(z: torch.Tensor, valid: torch.Tensor):
    """(min, max) of ``z`` over the ``valid`` points along the last axis,
    kept as a size-1 axis (+inf, -inf if none): the range the argmin key
    quantizes z over."""
    return (
        torch.amin(torch.where(valid, z, _INF), dim=-1, keepdim=True),
        torch.amax(torch.where(valid, z, -_INF), dim=-1, keepdim=True),
    )


def scatter_min_table(ids: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """f32 min of ``values`` at ``ids`` over a table of ``size`` entries
    whose last is the dump slot; returns the table without it, +inf where
    nothing landed. Exact (an int32 min of the ordered bit map). ``ids`` /
    ``values`` [N], or [K, N] for K tables in one flat scatter
    (-> [K, size - 1])."""
    lead = ids.shape[:-1]
    k = ids[..., :1].numel()
    offs = torch.arange(k, dtype=ids.dtype, device=ids.device)[:, None] * size
    et = torch.full((k * size,), _IMAX, dtype=torch.int32, device=values.device)
    et.scatter_reduce_(
        0, (ids.reshape(k, -1) + offs).reshape(-1).long(),
        _f32_ordered_i32(values).reshape(-1), "amin", include_self=True,
    )
    et = et.reshape(*lead, size)[..., : size - 1]
    return torch.where(et == _IMAX, _INF, _i32_ordered_f32(et))


def _argmin_key(z: torch.Tensor, valid: torch.Tensor, z_bounds=None):
    """The argmin lane over the last axis: ``(quantized z << idx_bits) |
    point_index`` where valid, _IMAX elsewhere; and idx_bits. Among z
    within one quantum (scan z-range / 2^(31 - idx_bits)) the smallest
    point index wins: the reference's first-strict-min rule up to the
    quantum."""
    n = z.shape[-1]
    idx_bits = max(1, (n - 1).bit_length())
    # One level fewer than the field allows: a valid point at index n-1
    # holding the scan's max z must not pack to exactly _IMAX.
    qmax = (1 << (31 - idx_bits)) - 2
    zlo, zhi = z_bounds if z_bounds is not None else z_range_of(z, valid)
    zrange = torch.clamp_min(zhi - zlo, 1e-6)
    zq = torch.clamp(floor_i32((z - zlo) / zrange * qmax), 0, qmax)
    iota = torch.arange(n, dtype=torch.int32, device=z.device)
    return torch.where(valid, (zq << idx_bits) | iota, _IMAX), idx_bits


def _presence_lanes(geom: GridGeometry, z: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The 32 distinct-z-voxel presence lanes: lane k is 0 iff the point's
    (zbin mod 32) == k (voxels 32 bins apart alias)."""
    zbin = torch.remainder(floor_i32(z * recip_f32(geom.resolution)), _ZB)
    lane_k = torch.arange(_ZB, dtype=torch.int32, device=z.device)
    return torch.where(
        valid[..., None] & (zbin[..., None] == lane_k),
        torch.zeros((), dtype=torch.int32, device=z.device),
        _IMAX,
    )


def _representative_count(geom, xyz, valid, ids, ncell, scope) -> torch.Tensor:
    """The presence lanes' fallback above 2^23 table entries: no cell of the
    benchmark's configurations reaches it."""
    raise NotImplementedError("the voxel count's representative fallback is not copied")


def _span_count(geom, min_z, max_z, touched) -> torch.Tensor:
    """The voxel count as the cell's z extent in voxels, capped at 32."""
    inv = recip_f32(geom.resolution)
    lo = torch.floor(min_z * inv)
    hi = torch.floor(max_z * inv)
    return torch.where(touched, torch.clamp(hi - lo + 1.0, 1.0, float(_ZB)), 0.0)


def _rows_scatter(
    geom, ids, valid, xyz, z_var, intensity, color_packed, with_voxel_count,
    voxel_count_mode, exact_min, ncell, shape, scope=None,
) -> CellObservations:
    """The row scatter of K scans (every input with a leading K axis, ids
    ``ncell`` where not valid) into one [K * (ncell+1), L] table, each
    scan's rows offset by k * (ncell+1); results [K, *shape].
    ``exact_min``: the exact-min-z lane of rows mode; without it (packed
    mode) min_z is the argmin point's z."""
    if voxel_count_mode not in ("exact", "span"):
        raise ValueError(f"unknown voxel_count_mode: {voxel_count_mode!r}")
    K, n = valid.shape
    dev = xyz.device
    z = xyz[..., 2]
    key, idx_bits = _argmin_key(z, valid, None if scope is None else scope.z_bounds)
    lanes = [key]
    if exact_min:
        lanes.append(torch.where(valid, _f32_ordered_i32(z), _IMAX))
    lanes.append(torch.where(valid, _f32_ordered_i32(-z), _IMAX))
    if intensity is not None:
        lanes.append(torch.where(valid, _f32_ordered_i32(-intensity), _IMAX))
    # The presence lanes ride the table while it stays small: rows mode
    # bounds the whole row table, packed mode the presence sub-table.
    vox_cells = ncell if scope is None else scope.ncell
    if exact_min:
        fits = (vox_cells + 1) * (len(lanes) + _ZB) <= _ROWS_TABLE_MAX
    else:
        fits = vox_cells * _ZB <= _FLAT_TABLE_MAX
    vox_lanes = with_voxel_count and voxel_count_mode == "exact" and fits
    upd = torch.stack(lanes, dim=-1)
    if vox_lanes:
        upd = torch.cat([upd, _presence_lanes(geom, z, valid)], dim=-1)
    L = upd.shape[-1]

    stride = ncell + 1
    flat_ids = ids + torch.arange(K, dtype=ids.dtype, device=dev)[:, None] * stride
    t = _scatter_min_rows(flat_ids.reshape(-1), upd.reshape(K * n, L), K * stride)
    t = t.reshape(K, stride, L)[:, :ncell]

    packed_t = t[..., 0]
    touched = packed_t != _IMAX
    # Untouched cells decode the _IMAX sentinel's low bits; clamp, and the
    # gathered value is masked by ``touched`` below. Flat point indices.
    amin = torch.clamp_max(packed_t & ((1 << idx_bits) - 1), n - 1).long()
    amin = amin + torch.arange(K, device=dev)[:, None] * n
    lane = 1
    if exact_min:
        min_z = _i32_ordered_f32(t[..., 1])
        lane = 2
    else:
        min_z = z.reshape(-1)[amin]
    max_z = -_i32_ordered_f32(t[..., lane])
    lane += 1
    kshape = (K,) + tuple(shape)
    nan = float("nan")
    max_intensity = None
    if intensity is not None:
        mi = -_i32_ordered_f32(t[..., lane])
        max_intensity = torch.where(torch.isfinite(mi), mi, nan).reshape(kshape)
        lane += 1

    min_z_var = z_var.reshape(-1)[amin]
    color = None
    if color_packed is not None:
        color = torch.where(touched, color_packed.reshape(-1)[amin], nan).reshape(kshape)

    voxel_count = None
    if vox_lanes:
        voxel_count = (t[..., lane : lane + _ZB] == 0).sum(dim=-1).to(torch.float32)
    elif with_voxel_count and voxel_count_mode == "exact":
        voxel_count = torch.stack([
            _representative_count(geom, xyz[k], valid[k], ids[k], ncell, scope)
            for k in range(K)
        ])
    elif with_voxel_count:
        voxel_count = _span_count(geom, min_z, max_z, touched)

    return CellObservations(
        min_z=torch.where(touched, min_z, nan).reshape(kshape),
        min_z_var=torch.where(touched, min_z_var, nan).reshape(kshape),
        max_z=torch.where(touched, max_z, nan).reshape(kshape),
        touched=touched.reshape(kshape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=None if voxel_count is None else voxel_count.reshape(kshape),
    )


def _one(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t[None]


def frame_of(obs: CellObservations, k: int) -> CellObservations:
    """Scan k's observations of a K-scan call."""
    return CellObservations(**{
        f.name: None if getattr(obs, f.name) is None else getattr(obs, f.name)[k]
        for f in dataclasses.fields(obs)
    })


def rasterize_scatter_rows(
    geom: GridGeometry,
    position: torch.Tensor,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    z_var: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    color_packed: Optional[torch.Tensor] = None,
    with_voxel_count: bool = False,
    voxel_count_mode: str = "exact",
    window=None,
    scope: Optional[UnshardedScan] = None,
) -> CellObservations:
    """Row-widened single-index scatter rasterization of one scan (rows
    mode): exact min z from its own lane.

    ``window``: optional (r0, c0, wr, wc); the observations are then
    window-shaped (see ``_window_ids``).
    ``scope``: a block of a sharded map passes the unsharded rasterizer's
    view of the scan (``UnshardedScan``), so its argmin carries and voxel
    counts are the unsharded step's.
    """
    ids, valid, ncell, shape = _window_ids(geom, position, xyz, mask, window)
    return frame_of(_rows_scatter(
        geom, ids[None], valid[None], xyz[None], z_var[None], _one(intensity),
        _one(color_packed), with_voxel_count, voxel_count_mode, True, ncell, shape, scope,
    ), 0)


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order floats as the reference's sort does: -0.0
    equal to +0.0, every NaN equal and last."""
    x = torch.where(x == 0, 0.0, torch.where(torch.isnan(x), float("nan"), x))
    return _f32_ordered_i32(x)


def rasterize(
    geom: GridGeometry,
    position: torch.Tensor,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    z_var: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    color_packed: Optional[torch.Tensor] = None,
    with_voxel_count: bool = False,
    window=None,
) -> CellObservations:
    """Sort mode (``rasterize``): one sort of the scan by (invalid, cell,
    z, variance), so each cell's run starts at its min-z point with the
    smallest variance among exact z ties and ends at its max-z point; the
    dense results come from a searchsorted per cell (``ops/segments.py``).
    The colour is the run head's. The sort is stable and the reference's
    is not: at ties in all four keys the port takes the lowest point
    index, the reference any of them. The voxel count is the number of
    z-bin changes in the run (exact, no aliasing). ``window`` as in
    ``rasterize_scatter_rows``.
    """
    ids, valid, ncell, shape = _window_ids(geom, position, xyz, mask, window)
    z = xyz[:, 2]
    # Invalid points carry id ncell, so the cell id alone orders them last.
    # A stable sort by variance, then one by (cell, z) as one int64 key.
    order = torch.sort(_sort_key(z_var), stable=True).indices
    oz = _sort_key(z[order]).to(torch.int64) + (1 << 31)
    order = order[torch.sort((ids[order].to(torch.int64) << 32) | oz, stable=True).indices]
    ids_s, z_s, var_s, valid_s = ids[order], z[order], z_var[order], valid[order]

    left, right, hit = seg.dense_lookup(ids_s, ncell)
    min_z = seg.gather_at(z_s, left, hit).reshape(shape)
    min_z_var = seg.gather_at(var_s, left, hit).reshape(shape)
    max_z = seg.gather_at(z_s, right - 1, hit).reshape(shape)

    max_intensity = None
    if intensity is not None:
        heads = seg.segment_heads(ids_s, valid_s)
        # Identity-fill the invalid tail (see segments.segmented_scan).
        int_s = torch.where(valid_s, intensity[order], -_INF)
        run_max = seg.segmented_scan(torch.maximum, int_s, heads, reverse=True)
        max_intensity = seg.gather_at(run_max, left, hit).reshape(shape)
    color = None
    if color_packed is not None:
        color = seg.gather_at(color_packed[order], left, hit).reshape(shape)

    voxel_count = None
    if with_voxel_count:
        zbin = floor_i32(z_s * recip_f32(geom.resolution))
        first = torch.ones_like(valid_s)
        first[1:] = ids_s[1:] != ids_s[:-1]
        changed = torch.ones_like(valid_s)
        changed[1:] = zbin[1:] != zbin[:-1]
        new_voxel = valid_s & (first | changed)
        csum = torch.cumsum(new_voxel.to(torch.int32), 0).to(torch.float32)
        at_tail = seg.gather_at(csum, right - 1, hit, 0.0)
        before = torch.where(left > 0, seg.gather_at(csum, left - 1, hit, 0.0), 0.0)
        voxel_count = (at_tail - before).reshape(shape)

    return CellObservations(
        min_z=min_z,
        min_z_var=min_z_var,
        max_z=max_z,
        touched=hit.reshape(shape),
        max_intensity=max_intensity,
        color=color,
        voxel_count=voxel_count,
    )


