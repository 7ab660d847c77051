"""Ghost-obstacle removal via log-odds visibility: the polar raycast (port of
``fastdem_tpu/postprocess/raycasting.py``, the path the pipeline runs).

All rays share one origin, so the minimum ray height at 2D distance d is
origin_z + d * min(slope of rays alive at d):

  1. one scatter-min of ray slopes into an (exit range bin, azimuth bin)
     polar table (``polar_scatter_spec``; the rasterizer runs it);
  2. the dense tail -- reverse cummin along range, in-cell fold, per-row
     azimuth smears -- is K1 (``ops/polar_field.py``);
  3. one or two lookups per cell at its (range, azimuth), the indices
     computed in the same kernel, then the touched mask: K4
     (``ops/resample.py``), over the whole map or a sensor-centred window.

``apply_raycasting`` then adds observed evidence, resolves ghost cells and
clears them, as the reference does; ``polar_resample`` and
``ray_min_height_polar`` are the standalone forms of steps 1-3.
``ray_min_height_sampled`` is the exactness-first alternative
(``raycasting.method = "sampled"``): every ray sampled S times and the
sample heights scatter-minned per cell, the polar path's oracle.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .numerics import fma_f32, recip_f32, sqrt_f32
from .geometry import GridGeometry, floor_i32, to_i32
from .gridmap import GridMapState, layers
from . import polar_field as k1
from . import resample as k4

_INF = float("inf")
_PI = math.pi

# Azimuth half-width factor of a cell's angular footprint; the per-cell
# lookup and _column_windows must use the same value (the exact-window fold
# relies on it).
AZ_HALF_WIDTH = k4.AZ_HALF_WIDTH


def layer_fills() -> Dict[str, float]:
    """Raycasting layers, created with the map."""
    return {
        layers.ghost_removal: np.nan,
        layers.raycasting: np.nan,
        layers.visibility_logodds: np.nan,
    }


def _clip_exit(
    geom: GridGeometry,
    position: torch.Tensor,
    origin: torch.Tensor,
    ends: torch.Tensor,
) -> torch.Tensor:
    """Liang-Barsky: t of the map-rect exit along origin->end, in [0, 1]."""
    half_x = 0.5 * geom.rows * geom.resolution
    half_y = 0.5 * geom.cols * geom.resolution
    lo = torch.stack([position[0] - half_x, position[1] - half_y])
    hi = torch.stack([position[0] + half_x, position[1] + half_y])
    d = ends[:, :2] - origin[:2]
    safe_d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t_lo = (lo - origin[:2]) / safe_d
    t_hi = (hi - origin[:2]) / safe_d
    t_exit = torch.min(torch.maximum(t_lo, t_hi), dim=1).values
    return torch.clamp(t_exit, 0.0, 1.0)


def polar_dims(
    geom: GridGeometry,
    num_azimuth: int,
    range_bin_factor: float,
    max_range: Optional[float] = None,
):
    """Polar grid dims (A, R, dr); ``max_range`` bounds the range axis,
    which otherwise spans the map diagonal."""
    A = num_azimuth
    dr = geom.resolution * range_bin_factor
    diag = math.hypot(geom.rows, geom.cols) * geom.resolution
    extent = diag if max_range is None else min(diag, max_range)
    R = int(math.ceil(extent / dr)) + 2
    return A, R, dr


def polar_scatter_spec(
    geom: GridGeometry,
    position: torch.Tensor,
    xyz: torch.Tensor,
    ray_mask: torch.Tensor,
    sensor_origin: torch.Tensor,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
):
    """The polar slope-scatter inputs: (keys in [0, A*R] with A*R the dump
    slot, slopes, table size A*R + 1). Table layout is [R, A]."""
    A, R, dr = polar_dims(geom, num_azimuth, range_bin_factor, max_range)
    dxy = xyz[:, :2] - sensor_origin[:2]
    dz = xyz[:, 2] - sensor_origin[2]
    len2d = sqrt_f32(fma_f32(dxy[:, 1], dxy[:, 1], dxy[:, 0] * dxy[:, 0]))
    # Skip upward rays and degenerate 2D rays.
    valid = ray_mask & (dz < 0.0) & (len2d >= 1e-4)

    azim = torch.atan2(dxy[:, 1], dxy[:, 0])
    abin = torch.clamp(
        floor_i32((azim + _PI) * recip_f32(2 * _PI) * A), 0, A - 1
    )
    slope = dz / torch.clamp_min(len2d, 1e-12)
    t_exit = _clip_exit(geom, position, sensor_origin, xyz)
    d_exit = t_exit * len2d
    # Round half to even, as the reference does.
    rbin_exit = torch.clamp(
        to_i32(torch.round(d_exit * recip_f32(dr))), 0, R - 1
    )
    key = torch.where(valid, rbin_exit * A + abin, A * R)
    return key, torch.where(valid, slope, _INF), A * R + 1


def _column_windows(
    geom: GridGeometry, A: int, R: int, dr: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-range-row azimuth windows: (level, shift) with level =
    floor(log2(w)) and shift = w - 2^level. Host-side numpy, as in the
    reference; ``column_windows`` puts them on the device."""
    d = np.arange(R, dtype=np.float32) * dr
    half_w = np.arctan2(geom.resolution * AZ_HALF_WIDTH, np.maximum(d, 1e-6))
    w = np.clip(
        np.ceil(half_w / (2 * np.pi / A) * 2.0).astype(np.int32) + 1,
        1, A // 2,
    )
    lvl = np.floor(np.log2(np.maximum(w, 1))).astype(np.int32)
    return lvl, (w - (1 << lvl)).astype(np.int32)


def column_windows(
    geom: GridGeometry,
    num_azimuth: int,
    range_bin_factor: float,
    max_range: Optional[float],
    device,
) -> k1.ColumnWindows:
    """``_column_windows`` of one polar geometry, on ``device``. Callers
    compute it once per geometry and pass it to ``polar_smeared_field``."""
    A, R, dr = polar_dims(geom, num_azimuth, range_bin_factor, max_range)
    lvl, shift = _column_windows(geom, A, R, dr)
    return k1.ColumnWindows.from_numpy(lvl, shift, device)


def polar_smeared_field(
    geom: GridGeometry,
    sensor_origin: torch.Tensor,
    scat_flat: torch.Tensor,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
    exact_window: bool = False,
    impl: str = "auto",
    windows: Optional[k1.ColumnWindows] = None,
) -> torch.Tensor:
    """Scattered [R*A] min slopes -> azimuth-smeared height field [R, A]
    (K scans' [K, R*A] with sensor origins [K, 3] -> [K, R, A], one K1
    launch).

    ``impl``: "auto" runs K1 on a CUDA tensor and its plain twin on a CPU
    tensor; "pallas" is K1 and raises on a CPU tensor; "xla" is the plain
    twin on any device. ``windows`` defaults to ``column_windows(...)``.
    """
    if impl not in ("xla", "pallas", "auto"):
        raise ValueError(f"unknown polar_field_impl: {impl!r}")
    A, R, dr = polar_dims(geom, num_azimuth, range_bin_factor, max_range)
    if windows is None:
        windows = column_windows(
            geom, num_azimuth, range_bin_factor, max_range, scat_flat.device
        )
    nfold = max(1, int(math.ceil(1.0 / range_bin_factor)))
    scat = scat_flat.reshape(tuple(scat_flat.shape[:-1]) + (R, A))
    # The reference has K1's plain twin only, whatever ``impl`` names.
    return k1.polar_field_plain(scat, windows, sensor_origin, dr, nfold, exact_window)


def polar_lookup(
    geom: GridGeometry,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
) -> k4.PolarLookup:
    """The static part of the per-cell lookup into one polar geometry's
    field (K4's host constants)."""
    A, R, dr = polar_dims(geom, num_azimuth, range_bin_factor, max_range)
    return k4.PolarLookup(geom, A, R, dr)


def polar_resample(
    geom: GridGeometry,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    scat_flat: torch.Tensor,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
    exact_window: bool = False,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scattered [R*A] min slopes -> per-cell (min ray height, touched).

    The field is K1 (``impl`` as in ``polar_smeared_field``), the lookup K4
    with its index math: ``exact_window=True`` folds the window residual
    into the field so ONE read per cell replaces the two-read sparse-table
    form -- the same minimum set, bitwise-identical heights.
    """
    smeared = polar_smeared_field(
        geom, sensor_origin, scat_flat, num_azimuth, range_bin_factor,
        max_range, exact_window=exact_window, impl=impl,
    )
    lk = polar_lookup(geom, num_azimuth, range_bin_factor, max_range)
    return k4.resample_lookup(
        smeared, lk, position, sensor_origin, two_reads=not exact_window
    )


def ray_min_height_polar(
    geom: GridGeometry,
    position: torch.Tensor,
    xyz: torch.Tensor,
    ray_mask: torch.Tensor,
    sensor_origin: torch.Tensor,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell minimum ray height of a scan: (min_height [H, W], touched)."""
    key, vals, size = polar_scatter_spec(
        geom, position, xyz, ray_mask, sensor_origin, num_azimuth,
        range_bin_factor, max_range,
    )
    table = torch.full((size,), _INF, dtype=torch.float32, device=xyz.device)
    table.scatter_reduce_(0, key.long(), vals, "amin", include_self=True)
    return polar_resample(
        geom, position, sensor_origin, table[: size - 1], num_azimuth,
        range_bin_factor, max_range,
    )


def ray_min_height_sampled(
    geom: GridGeometry,
    position: torch.Tensor,
    xyz: torch.Tensor,
    ray_mask: torch.Tensor,
    sensor_origin: torch.Tensor,
    num_samples: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell minimum ray height by sampling each ray S times up to its
    map exit and scatter-minning the sample heights (the polar path's
    exactness oracle). Returns (min_height [H, W], touched).

    S defaults to 2 * (rows + cols). The arithmetic is the reference's
    compiled form: the sample fractions multiply by the f32 reciprocal of
    S, and each sample coordinate o + t * (p - o) is one FMA.
    """
    S = num_samples or 2 * (geom.rows + geom.cols)
    ncell = geom.num_cells
    dev = xyz.device
    dz = xyz[:, 2] - sensor_origin[2]
    dxy = xyz[:, :2] - sensor_origin[:2]
    ray_len_2d = sqrt_f32(fma_f32(dxy[:, 1], dxy[:, 1], dxy[:, 0] * dxy[:, 0]))
    ray_valid = ray_mask & (dz < 0.0) & (ray_len_2d >= 1e-4)

    t_exit = _clip_exit(geom, position, sensor_origin, xyz)
    frac = (torch.arange(S, dtype=torch.float32, device=dev) + 1.0) * recip_f32(S)
    t = t_exit[:, None] * frac[None, :]  # [N, S]
    sx = fma_f32(t, dxy[:, 0:1], sensor_origin[0])
    sy = fma_f32(t, dxy[:, 1:2], sensor_origin[1])
    sh = fma_f32(t, dz[:, None], sensor_origin[2])
    del t
    sids, s_inside = geom.cell_id_of(position, torch.stack([sx, sy], dim=-1))
    s_valid = ray_valid[:, None] & s_inside
    sids = torch.where(s_valid, sids, ncell)
    table = torch.full((ncell + 1,), _INF, dtype=torch.float32, device=dev)
    table.scatter_reduce_(
        0, sids.reshape(-1).long(), torch.where(s_valid, sh, _INF).reshape(-1),
        "amin", include_self=True,
    )
    ray_min = table[:ncell].reshape(geom.shape)
    touched = torch.isfinite(ray_min)
    return torch.where(touched, ray_min, np.nan), touched


def apply_raycasting(
    geom: GridGeometry,
    state: GridMapState,
    xyz: Optional[torch.Tensor],
    scan_mask: Optional[torch.Tensor],
    sensor_origin: torch.Tensor,
    cfg,
    obs_count: Optional[torch.Tensor] = None,
    method: str = "polar",
    num_samples: Optional[int] = None,
    num_azimuth: int = 2048,
    range_bin_factor: float = 0.5,
    max_range: Optional[float] = None,
    polar_table: Optional[torch.Tensor] = None,
    ray_min_touched: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    frame_nonempty=True,
) -> GridMapState:
    """Apply one scan's visibility update; ``cfg`` is a ``RaycastingConfig``.

    ``obs_count``: per-cell observed-point multiplicity from the
    rasterizer; counted here by a scatter-add of ``xyz`` / ``scan_mask``
    (the scan in the world frame) when absent. ``ray_min_touched``: the
    precomputed (min ray height, touched) fields; otherwise they come from
    ``polar_table`` (a pre-scattered [R*A] min-slope table) or from the
    scan itself: by the polar field, or with ``method="sampled"`` by
    ``ray_min_height_sampled`` (``num_samples`` per ray). ``xyz`` /
    ``scan_mask`` may be None when both fields are given, as in the
    pipeline.
    """
    if method not in ("polar", "sampled"):
        raise ValueError(f"unknown raycasting method: {method!r}")
    origin_inside = geom.is_inside(state.position, sensor_origin[:2])
    active = None if scan_mask is None else scan_mask & origin_inside

    # 1. Observed evidence (add, then clamp).
    if obs_count is None:
        ncell = geom.num_cells
        ids, inside = geom.cell_id_of(state.position, xyz[:, :2])
        obs_valid = active & inside
        ids_obs = torch.where(obs_valid, ids, ncell).long()
        obs_count_eff = (
            torch.zeros(ncell + 1, dtype=torch.float32, device=xyz.device)
            .scatter_add_(0, ids_obs, obs_valid.to(torch.float32))[:ncell]
            .reshape(geom.shape)
        )
    else:
        obs_count_eff = torch.where(origin_inside, obs_count, 0.0)
    add = obs_count_eff * cfg.log_odds_observed
    lo = state.layers[layers.visibility_logodds]
    lo_base = torch.where(torch.isnan(lo), 0.0, lo)
    lo1 = torch.where(
        add > 0.0, torch.clamp_max(lo_base + add, cfg.log_odds_max), lo
    )

    # 2. Per-cell min ray height; an all-masked frame keeps the previous
    # diagnostic layer.
    if ray_min_touched is not None:
        ray_min, ray_touched = ray_min_touched
    elif method == "polar" and polar_table is not None:
        ray_min, ray_touched = polar_resample(
            geom, state.position, sensor_origin, polar_table, num_azimuth,
            range_bin_factor, max_range, impl=cfg.polar_field_impl,
        )
    elif method == "sampled":
        ray_min, ray_touched = ray_min_height_sampled(
            geom, state.position, xyz, active, sensor_origin, num_samples
        )
    else:
        ray_min, ray_touched = ray_min_height_polar(
            geom, state.position, xyz, active, sensor_origin, num_azimuth,
            range_bin_factor, max_range,
        )
    frame_nonempty = torch.as_tensor(frame_nonempty, device=lo.device)
    ray_layer = torch.where(
        frame_nonempty,
        torch.where(ray_touched, ray_min, np.nan),
        state.layers[layers.raycasting],
    )
    ray_min_cmp = torch.where(ray_touched, ray_min, _INF)

    # 3. Resolve ghost cells.
    elev = state.layers[layers.elevation]
    conflict = (
        ray_touched
        & torch.isfinite(elev)
        & (elev > ray_min_cmp + cfg.height_conflict_threshold)
    )
    lo2 = torch.where(
        conflict,
        torch.where(torch.isnan(lo1), 0.0, lo1) - cfg.log_odds_ghost,
        lo1,
    )
    clear = conflict & (lo2 < cfg.clear_threshold)

    state = state.replace_layers(
        {layers.visibility_logodds: lo2, layers.raycasting: ray_layer}
    )
    cleared = {
        k: torch.where(clear, np.nan, v) for k, v in state.layers.items()
    }
    cleared[layers.ghost_removal] = torch.where(
        clear, 1.0, state.layers[layers.ghost_removal]
    )
    return GridMapState(layers=cleared, position=state.position)
