"""Offline batch DEM building (port of ``fastdem_tpu/mapping/batch.py``, the
reference's ``pcd_convert``).

  * ``from_pointcloud``: per-cell count / mean / variance / min / max and
    the elevation by ``RasterMethod`` (Max / Min / Mean / MinMax), the
    maximum intensity and the min-z point's colour;
  * ``from_pointcloud_auto``: the same on the cloud's bounding box plus a
    one-cell margin;
  * ``remove_floating_points``: per-cell z-histogram ground peak + cutoff,
    sort-based: points sorted by (cell, z-bin), group counts by segment
    sums, each cell's modal bin by a scatter-max of ``count * max_bins -
    bin`` (the first maximum, i.e. the lowest bin, on ties);
  * ``build_dem``: outlier removal -> bounding box -> floating-point
    removal -> rasterization -> inpainting;
  * ``to_pointcloud``: the map as a cloud of cell centres.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.cloud import filters as pcf
from fastdem_tpu_torch.cloud.pointcloud import PointCloud, from_numpy
from fastdem_tpu_torch.config import RasterMethod
from fastdem_tpu_torch.grid.geometry import GridGeometry, floor_i32
from fastdem_tpu_torch.grid.gridmap import GridMapState, layers
from fastdem_tpu_torch.interop import to_host
from fastdem_tpu_torch.mapping.rasterize import rasterize_stats
from fastdem_tpu_torch.numerics import div_f32
from fastdem_tpu_torch.postprocess.inpainting import inpaint
from fastdem_tpu_torch.utils.colors import pack_rgb, unpack_rgb

_INF = float("inf")


@dataclasses.dataclass
class DEMConfig:
    """The reference's ``DEMConfig``."""

    resolution: float = 0.1
    method: RasterMethod = RasterMethod.MAX
    sor_k: int = 20
    sor_std_mul: float = 1.0
    height_threshold: float = 2.0
    bin_size: float = 0.0  # 0 -> the resolution
    inpaint_iterations: int = 3


def bbox_geometry(xyz, mask, resolution: float) -> Tuple[GridGeometry, np.ndarray]:
    """Geometry of the valid points' xy bounding box plus one cell, and its
    centre (host f32[2]). A tensor cloud is reduced on its device; only
    the four bounds leave it."""
    if isinstance(xyz, torch.Tensor):
        ok = mask & torch.isfinite(xyz[:, :2]).all(dim=1)
        xy = xyz[:, :2]
        lo = torch.where(ok[:, None], xy, _INF).amin(dim=0)
        hi = torch.where(ok[:, None], xy, -_INF).amax(dim=0)
        (min_x, min_y), (max_x, max_y) = np.float32(torch.stack([lo, hi]).cpu().numpy())
    else:
        pts = np.asarray(xyz)[np.asarray(mask)]
        pts = pts[np.isfinite(pts[:, :2]).all(axis=1)]
        min_x, min_y = pts[:, 0].min(), pts[:, 1].min()
        max_x, max_y = pts[:, 0].max(), pts[:, 1].max()
    width = max_x - min_x + resolution
    height = max_y - min_y + resolution
    geom = GridGeometry.from_length(width, height, resolution)
    position = np.array([(min_x + max_x) / 2.0, (min_y + max_y) / 2.0], dtype=np.float32)
    return geom, position


def _position(position, dev) -> torch.Tensor:
    if isinstance(position, torch.Tensor):
        return position.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(position, np.float32), device=dev)


def from_pointcloud(
    cloud: PointCloud,
    geom: GridGeometry,
    position,
    method: RasterMethod = RasterMethod.MAX,
) -> GridMapState:
    """Rasterize a whole cloud into a fresh map state on its device."""
    pos = _position(position, cloud.device)
    has_c = cloud.has("color")
    stats = rasterize_stats(
        geom, pos, cloud.xyz, cloud.mask,
        intensity=cloud.channels.get("intensity"),
        color_packed=pack_rgb(cloud.channels["color"]) if has_c else None,
    )
    if method in (RasterMethod.MAX, RasterMethod.MINMAX):
        elev = stats.max_z
    elif method == RasterMethod.MIN:
        elev = stats.min_z
    else:
        elev = stats.mean
    lyr = {
        layers.elevation: elev,
        layers.elevation_min: stats.min_z,
        layers.elevation_max: stats.max_z,
        layers.variance: stats.variance,
        layers.n_points: stats.count,
    }
    if cloud.has("intensity"):
        lyr[layers.intensity] = stats.max_intensity
    if has_c:
        lyr[layers.color] = stats.color
    return GridMapState(layers=lyr, position=pos)


def from_pointcloud_auto(
    cloud: PointCloud, resolution: float, method: RasterMethod = RasterMethod.MAX
) -> Tuple[GridGeometry, GridMapState]:
    geom, position = bbox_geometry(cloud.xyz, cloud.mask, resolution)
    return geom, from_pointcloud(cloud, geom, position, method)


def remove_floating_points(
    cloud: PointCloud,
    geom: GridGeometry,
    position,
    height_threshold: float,
    bin_size: float,
    max_bins: int = 512,
) -> PointCloud:
    """Drop points above (the cell's ground peak + height_threshold).

    The ground peak is the cell's modal z-histogram bin (the lowest one on
    ties), bins starting at the cell's min z; points past max_bins *
    bin_size above it clamp into the top bin."""
    n = cloud.capacity
    dev = cloud.device
    pos = _position(position, dev)
    ids, inside = geom.cell_id_of(pos, cloud.xyz[:, :2], true_div=True)
    valid = cloud.mask & inside
    ncell = geom.num_cells
    ids_eff = torch.where(valid, ids, ncell).long()

    z = cloud.xyz[:, 2]
    zmin_cell = torch.full((ncell + 1,), _INF, device=dev).scatter_reduce_(
        0, ids_eff, torch.where(valid, z, _INF), "amin", include_self=True
    )
    z0 = zmin_cell[ids_eff]
    zbin = torch.clamp(floor_i32(div_f32(z - z0, bin_size)), 0, max_bins - 1)
    zbin = torch.where(valid, zbin, max_bins).long()

    # One stable sort on (validity, cell, bin) packed into an int64 key.
    invalid = (~valid).long()
    order = torch.sort((invalid << 53) | (ids_eff << 20) | zbin, stable=True).indices
    valid_s = valid[order]
    ids_s = ids_eff[order]
    bin_s = zbin[order]
    new_group = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        new_group[1:] = (ids_s[1:] != ids_s[:-1]) | (bin_s[1:] != bin_s[:-1])
    new_group &= valid_s
    gid = torch.cumsum(new_group.long(), 0) - 1
    gid = torch.where(valid_s, gid, n)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, gid, valid_s.long()
    )
    pref = torch.where(valid_s, counts[gid] * max_bins - bin_s, -1)
    best_pref = torch.full((ncell + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, ids_s, pref, "amax", include_self=True
    )
    best_bin = torch.remainder(-best_pref[ids_eff], max_bins)
    ground_z = z0 + (best_bin.to(torch.float32) + 0.5) * bin_size
    cutoff = ground_z + height_threshold
    return cloud.with_mask(valid & (z <= cutoff))


def build_dem(
    cloud: PointCloud, config: Optional[DEMConfig] = None, *, device="cuda"
) -> Tuple[GridGeometry, GridMapState]:
    """The whole offline pipeline on ``device`` (the card unless the caller
    names the CPU; the cloud moves there if it lies elsewhere)."""
    from fastdem_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if cloud.device != dev:
        cloud = cloud.to(dev)
    cfg = config or DEMConfig()
    filtered = pcf.statistical_outlier_removal(cloud, cfg.sor_k, cfg.sor_std_mul)
    geom, position = bbox_geometry(filtered.xyz, filtered.mask, cfg.resolution)
    bin_size = cfg.bin_size if cfg.bin_size > 0 else cfg.resolution
    filtered = remove_floating_points(filtered, geom, position, cfg.height_threshold, bin_size)
    state = from_pointcloud(filtered, geom, position, cfg.method)
    if cfg.inpaint_iterations > 0:
        state = state.replace_layer(
            layers.elevation,
            inpaint(state.layers[layers.elevation], cfg.inpaint_iterations,
                    min_valid_neighbors=2),
        )
    return geom, state


def to_pointcloud(geom: GridGeometry, state: GridMapState) -> PointCloud:
    """The map as a cloud of cell centres at the elevation, with intensity
    and colour carried over, on the map's device."""
    x, y = geom.cell_centers(state.position)
    names = [n for n in (layers.intensity, layers.color) if n in state.layers]
    host = to_host({"x": x, "y": y, **{n: state.layers[n] for n in
                                       [layers.elevation] + names}})
    elev = host[layers.elevation]
    finite = np.isfinite(elev)
    xyz = np.column_stack([host["x"][finite], host["y"][finite], elev[finite]]).astype(np.float32)
    channels = {}
    if layers.intensity in host:
        inten = host[layers.intensity][finite]
        channels["intensity"] = np.where(np.isfinite(inten), inten, 0.0).astype(np.float32)
    if layers.color in host:
        channels["color"] = unpack_rgb(np.nan_to_num(host[layers.color][finite]))
    return from_numpy(xyz, frame_id="map", device=state.position.device, **channels)
