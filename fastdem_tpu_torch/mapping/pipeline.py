"""The FastDEM pipeline: preprocess -> map update -> estimate -> raycast
(port of ``fastdem_tpu/mapping/pipeline.py``: LOCAL and GLOBAL maps, full
or windowed, with the Kalman or the P^2 estimator).

``build_integrate(geom, cfg, device=...)`` returns the per-scan step

    integrate(state, xyz, mask, T_base_sensor, T_world_base
              [, intensity, color_packed]) -> (state, IntegrateAux)

on tensors on one device. ``FastDEM`` is the stateful facade. Per scan,
phase A transforms the points, attaches the LiDAR z-variance, filters,
rasterizes (with the polar slope scatter riding along), realizes the
polar ray field with K1 and looks it up per cell with K4; phase B moves
the LOCAL map, runs the estimator update, min/max, obstacle and the
raycast visibility update.

``build_integrate_sequence`` is batched replay: K stacked scans through
the same step in one call, with no host read between them, so its map
equals the per-scan loop's bit for bit. ``FastDEM.integrate_sequence``
takes a list of clouds and runs ``FastDEM.integrate`` on each, so every
scan keeps its own capacity.

On maps larger than the scan's reach, the rasterizer's tables and the
whole map update run on a sensor-centred window of the map and are
written back (``window_update``); the window's top-left cell stays on the
device, so no step reads it back to the host.

Configurations the port does not run yet raise ``NotImplementedError``
naming their ROADMAP item; none falls back to another computation.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from fastdem_tpu_torch.cloud import pointcloud as pc
from fastdem_tpu_torch.cloud import transform as tfm
from fastdem_tpu_torch.config import Config, EstimationType, MappingMode
from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.numerics import recip_f32, sum_sq
from fastdem_tpu_torch.grid import gridmap
from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.grid.gridmap import GridMapState, layers
from fastdem_tpu_torch.mapping import kalman as kalman_est
from fastdem_tpu_torch.mapping import p2 as p2_est
from fastdem_tpu_torch.mapping import rasterize as raster
from fastdem_tpu_torch.ops import resample as k4
from fastdem_tpu_torch.postprocess import raycasting as raycast
from fastdem_tpu_torch.sensors.models import create_sensor_model
from fastdem_tpu_torch.utils.colors import pack_rgb

log = logging.getLogger("fastdem_tpu_torch")


def _not_ported(what: str, where: str):
    return NotImplementedError(
        f"{what} is not ported to fastdem_tpu_torch yet (ROADMAP {where})"
    )


def _check_config(cfg: Config) -> None:
    if not isinstance(cfg, Config):
        raise TypeError(
            "fastdem_tpu_torch takes its own Config (fastdem_tpu_torch.config); "
            f"got {type(cfg)!r}"
        )


@dataclasses.dataclass
class IntegrateAux:
    """Per-scan auxiliary outputs (the observation-callback payloads)."""

    world_xyz: torch.Tensor  # preprocessed points in the map frame
    world_mask: torch.Tensor  # surviving-point mask after filters
    z_var: torch.Tensor  # world z-variance per point
    obs: raster.CellObservations  # rasterized per-cell observations
    # Surviving in-map points the update window missed (None when the
    # windowed update is off). Nonzero means the base->sensor offset
    # exceeded the built window margin and points were dropped.
    oow_points: Optional[torch.Tensor] = None


def estimator_layer_fills(cfg: Config) -> Dict[str, float]:
    _check_config(cfg)
    if cfg.mapping.estimation_type == EstimationType.P2_QUANTILE:
        return p2_est.layer_fills()
    return kalman_est.layer_fills()


def initial_layer_fills(
    cfg: Config, has_intensity: bool = False, has_color: bool = False
) -> Dict[str, float]:
    """The full layer set of a pipeline run."""
    fills = gridmap.default_layer_fills()
    fills.update(estimator_layer_fills(cfg))
    fills[layers.obstacle] = np.nan
    if has_intensity:
        fills[layers.intensity] = np.nan
    if has_color:
        fills[layers.color] = np.nan
    if cfg.raycasting.enabled:
        fills.update(raycast.layer_fills())
    return fills


def create_map_state(
    geom: GridGeometry,
    cfg: Config,
    position=(0.0, 0.0),
    has_intensity: bool = False,
    has_color: bool = False,
    *,
    device="cuda",
) -> GridMapState:
    return gridmap.create(
        geom,
        initial_layer_fills(cfg, has_intensity, has_color),
        position,
        device=device,
    )


def _estimate(state: GridMapState, cfg: Config, obs: raster.CellObservations):
    """Estimator update + bounds per touched cell."""
    if cfg.mapping.estimation_type == EstimationType.P2_QUANTILE:
        return p2_est.estimate(
            state, cfg.mapping.p2, obs.min_z, obs.min_z_var, obs.touched
        )
    return kalman_est.update(
        state, cfg.mapping.kalman, obs.min_z, obs.min_z_var, obs.touched
    )


def _update_minmax(state: GridMapState, obs: raster.CellObservations):
    """Accumulating min / max layers."""
    stored_min = state.layers[layers.elevation_min]
    stored_max = state.layers[layers.elevation_max]
    new_min = torch.where(
        obs.touched & (torch.isnan(stored_min) | (obs.min_z < stored_min)),
        obs.min_z,
        stored_min,
    )
    new_max = torch.where(
        obs.touched & (torch.isnan(stored_max) | (obs.max_z > stored_max)),
        obs.max_z,
        stored_max,
    )
    return state.replace_layers(
        {layers.elevation_min: new_min, layers.elevation_max: new_max}
    )


def _update_obstacle(
    state: GridMapState, obs: raster.CellObservations, frame_nonempty
):
    """Per-frame overwrite: obstacle = max_z iff max_z > min_z else NaN; an
    all-masked frame keeps the previous layer."""
    obstacle = torch.where(
        obs.touched & (obs.max_z > obs.min_z), obs.max_z, np.nan
    )
    obstacle = torch.where(frame_nonempty, obstacle, state.layers[layers.obstacle])
    return state.replace_layer(layers.obstacle, obstacle)


def _update_intensity(state: GridMapState, obs: raster.CellObservations):
    """Max-pool accumulation."""
    if obs.max_intensity is None or layers.intensity not in state.layers:
        return state
    stored = state.layers[layers.intensity]
    has_obs = ~torch.isnan(obs.max_intensity)
    new = torch.where(
        has_obs & (torch.isnan(stored) | (obs.max_intensity > stored)),
        obs.max_intensity,
        stored,
    )
    return state.replace_layer(layers.intensity, new)


def _update_color(state: GridMapState, obs: raster.CellObservations):
    """Write-through color (the min-z point's color)."""
    if obs.color is None or layers.color not in state.layers:
        return state
    stored = state.layers[layers.color]
    has_obs = ~torch.isnan(obs.color)
    return state.replace_layer(
        layers.color, torch.where(has_obs, obs.color, stored)
    )


class _Window:
    """The wr x wc block of a map whose top-left cell is (r0, c0), int32
    device scalars. Reads and writes index with device vectors (one gather
    or one index_put each), so neither costs a host sync."""

    def __init__(self, r0: torch.Tensor, c0: torch.Tensor, wr: int, wc: int):
        dev = r0.device
        rows = (r0 + torch.arange(wr, dtype=torch.int32, device=dev)).long()
        cols = (c0 + torch.arange(wc, dtype=torch.int32, device=dev)).long()
        self.index = (rows[:, None], cols[None, :])

    def read(self, layer: torch.Tensor) -> torch.Tensor:
        return layer[self.index]

    def write_(self, layer: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """Write ``values`` into the block of ``layer``, in place."""
        return layer.index_put_(self.index, values)

    def expand(self, geom: GridGeometry, values: torch.Tensor, fill) -> torch.Tensor:
        """A full-map tensor holding ``fill`` outside the block, ``values``
        in it."""
        full = torch.full(geom.shape, fill, dtype=values.dtype, device=values.device)
        return self.write_(full, values)


def _expand_obs(
    geom: GridGeometry, obs: raster.CellObservations, win: _Window
) -> raster.CellObservations:
    """Window-shaped observations expanded to the full map (NaN / False / 0
    outside the window), for the aux payload."""

    def put(f, fill):
        return None if f is None else win.expand(geom, f, fill)

    return raster.CellObservations(
        min_z=put(obs.min_z, np.nan),
        min_z_var=put(obs.min_z_var, np.nan),
        max_z=put(obs.max_z, np.nan),
        touched=put(obs.touched, False),
        max_intensity=put(obs.max_intensity, np.nan),
        color=put(obs.color, np.nan),
        voxel_count=put(obs.voxel_count, 0.0),
        extra=obs.extra,
    )


def build_integrate(
    geom: GridGeometry,
    cfg: Config,
    has_intensity: bool = False,
    has_color: bool = False,
    ray_num_azimuth: Optional[int] = None,
    ray_range_bin_factor: Optional[float] = None,
    ray_max_range: Optional[float] = None,
    ray_exact_window: bool = True,
    scatter_mode: str = "rows",
    voxel_count_mode: Optional[str] = None,
    polar_field_impl: Optional[str] = None,
    window_update: Optional[bool] = None,
    window_margin: float = 2.0,
    spmd_blocks: Optional[tuple] = None,
    *,
    device="cuda",
):
    """Build the per-scan integrate step for tensors on ``device``.

    Returned signature:
      integrate(state, xyz, mask, T_base_sensor, T_world_base,
                intensity=None, color_packed=None) -> (state, IntegrateAux)

    ``xyz`` is the sensor-frame cloud (f32[N, 3]); transforms are 4x4 f32.
    The arguments mean what they mean in the reference; ``polar_field_impl``
    "auto" runs K1 on CUDA and its plain twin on the CPU, "pallas" is K1
    only and "xla" the plain twin only. ``window_update`` None engages the
    windowed update where the window is at most half the map, False keeps
    the full-map update.
    """
    dev = resolve_device(device)
    phase_a, phase_b, moved_position = _build_phases(
        geom, cfg, ray_num_azimuth, ray_range_bin_factor, ray_max_range,
        scatter_mode, voxel_count_mode, ray_exact_window,
        polar_field_impl=polar_field_impl, window_update=window_update,
        window_margin=window_margin, spmd_blocks=spmd_blocks, device=dev,
    )
    local_mode = cfg.mapping.mode == MappingMode.LOCAL

    def integrate(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        # The post-move LOCAL position is pure pose arithmetic, so phase A
        # depends only on the inputs, not on the carried layers.
        position = (
            moved_position(state.position, T_wb[:2, 3])
            if local_mode
            else state.position
        )
        pa = phase_a(position, xyz, mask, T_bs, T_wb, intensity, color_packed)
        state = phase_b(state, T_wb, torch.any(mask), pa)
        obs, _ray, _origin, xyz_world, keep, z_var, win, oow = pa
        if win is not None:
            obs = _expand_obs(geom, obs, win)
        aux = IntegrateAux(
            world_xyz=xyz_world, world_mask=keep, z_var=z_var, obs=obs,
            oow_points=oow,
        )
        return state, aux

    return integrate


def _build_phases(
    geom: GridGeometry,
    cfg: Config,
    ray_num_azimuth: Optional[int],
    ray_range_bin_factor: Optional[float],
    ray_max_range: Optional[float],
    scatter_mode: str,
    voxel_count_mode: Optional[str],
    ray_exact_window: bool = True,
    polar_field_impl: Optional[str] = None,
    window_update: Optional[bool] = None,
    window_margin: float = 2.0,
    spmd_blocks: Optional[tuple] = None,
    *,
    device: torch.device,
):
    """Split the step into ``phase_a`` (per-scan work independent of the
    carried layers), ``phase_b`` (the sequential map update) and
    ``moved_position`` (gridmap.move's lattice walk of the position)."""
    _check_config(cfg)
    if voxel_count_mode is None:
        voxel_count_mode = cfg.raycasting.voxel_count_mode
    if ray_num_azimuth is None:
        ray_num_azimuth = int(cfg.raycasting.num_azimuth_bins)
    if ray_range_bin_factor is None:
        ray_range_bin_factor = float(cfg.raycasting.range_bin_factor)
    ray_range_explicit = ray_max_range is not None
    if ray_max_range is None and cfg.raycasting.max_range > 0:
        ray_max_range = float(cfg.raycasting.max_range)
        ray_range_explicit = True
    if scatter_mode not in ("rows", "packed", "twophase", "sort"):
        raise ValueError(f"unknown scatter_mode: {scatter_mode!r}")
    if scatter_mode != "rows":
        raise _not_ported(
            f"scatter_mode={scatter_mode!r}",
            "section 1, the scatter-mode note after item 19",
        )
    if spmd_blocks is not None:
        raise _not_ported("spmd_blocks (sharded maps)", "section 1, item 19")
    sensor = create_sensor_model(cfg.sensor_model)
    pf = cfg.point_filter
    local_mode = cfg.mapping.mode == MappingMode.LOCAL
    # Squared range bounds, clamped to the f32 range.
    _F32_MAX = 3.4028235e38
    rmin2 = min(pf.range_min * pf.range_min, _F32_MAX)
    rmax2 = min(pf.range_max * pf.range_max, _F32_MAX)
    # Polar-field range bound (see the reference for the derivation).
    window_margin = max(float(window_margin), 0.0)
    if ray_max_range is None and pf.range_max < 1e6:
        ray_max_range = float(pf.range_max) * 1.1 + window_margin
    if local_mode:
        half_diag = 0.5 * math.hypot(geom.rows, geom.cols) * geom.resolution
        local_bound = half_diag + window_margin + 2.0 * geom.resolution
        if ray_max_range is None or (
            not ray_range_explicit and ray_max_range > local_bound
        ):
            ray_max_range = local_bound

    # Update window: every cell a scan can touch lies within the point
    # filter's range bound (plus the base->sensor margin) of the sensor, so
    # the rasterizer's tables and the whole map update run on a window of
    # ~2 * bound around it, engaged when the window is at most half the
    # map. Results are identical to the full-map update. The bound derives
    # from the point filter only, never from raycasting.max_range.
    upd_bound = (
        float(pf.range_max) * 1.1 + window_margin if pf.range_max < 1e6 else None
    )
    if upd_bound is not None:
        _wcells = int(math.ceil(2.0 * upd_bound / geom.resolution)) + 4
        upd_wr, upd_wc = min(geom.rows, _wcells), min(geom.cols, _wcells)
    else:
        upd_wr, upd_wc = geom.rows, geom.cols
    # The sampled raycast scatters into the full map: it turns the window
    # off, as in the reference.
    sampled = cfg.raycasting.enabled and cfg.raycasting.method == "sampled"
    windowed = (
        window_update is not False
        and 2 * upd_wr * upd_wc <= geom.num_cells
        and not sampled
    )
    # Rows mode at any size: the reference switches to a packed rasterizer
    # above 2^19 cells only because the TPU pads the row table to 128
    # lanes; the card does not (4M cells x 4 lanes is ~64 MB).
    if cfg.raycasting.enabled and not sampled:
        # The per-cell lookups scale with the map: on maps larger than the
        # ray range, only a sensor-centred window is resampled (the update
        # window when that is engaged).
        if ray_max_range is not None:
            wcells = int(math.ceil(2.0 * ray_max_range / geom.resolution)) + 4
            ray_wr, ray_wc = min(geom.rows, wcells), min(geom.cols, wcells)
        else:
            ray_wr, ray_wc = geom.shape
        impl = (
            polar_field_impl
            if polar_field_impl is not None
            else cfg.raycasting.polar_field_impl
        )
        windows = raycast.column_windows(
            geom, ray_num_azimuth, ray_range_bin_factor, ray_max_range, device
        )
        lookup = raycast.polar_lookup(
            geom, ray_num_azimuth, ray_range_bin_factor, ray_max_range
        )

    def moved_position(position, target_xy):
        # Must match gridmap.move's arithmetic exactly.
        res = geom.resolution
        delta = gridmap.round_half_away(
            (target_xy - position) * recip_f32(res)
        ).to(torch.int32)
        return position + delta.to(torch.float32) * res

    def window_at(position, sensor_origin, wr, wc):
        """Top-left cell of the wr x wc window centred on the sensor,
        clipped into the map (int32 device scalars)."""
        sr, sc, _ = geom.index_of(position, sensor_origin[:2])
        r0 = torch.clamp(torch.clamp(sr, 0, geom.rows) - wr // 2, 0, geom.rows - wr)
        c0 = torch.clamp(torch.clamp(sc, 0, geom.cols) - wc // 2, 0, geom.cols - wc)
        return r0, c0

    def phase_a(position, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        # ---- 1. Preprocess ----
        T_ws = T_wb @ T_bs
        r3 = T_ws[2, :3]  # third row of the sensor->world rotation
        z_var = sensor.z_variance_world(xyz, r3)

        xyz_base = tfm.transform_points(xyz, T_bs)
        d2 = sum_sq(xyz_base)
        keep = (
            mask
            & (d2 >= rmin2)
            & (d2 <= rmax2)
            & (xyz_base[:, 2] >= pf.z_min)
            & (xyz_base[:, 2] <= pf.z_max)
        )
        xyz_world = tfm.transform_points(xyz_base, T_wb)
        sensor_origin = T_ws[:3, 3]

        # ---- 2. The sensor-centred update window ----
        upd_window = None
        win = None
        oow_points = None
        if windowed:
            ur0, uc0 = window_at(position, sensor_origin, upd_wr, upd_wc)
            upd_window = (ur0, uc0, upd_wr, upd_wc)
            win = _Window(*upd_window)
            # Surviving in-map points the window misses would be dropped:
            # count them, so the facade can warn.
            pr, pc_, in_map = geom.index_of(position, xyz_world[:, :2])
            in_win = (
                (pr >= ur0) & (pr < ur0 + upd_wr) & (pc_ >= uc0) & (pc_ < uc0 + upd_wc)
            )
            oow_points = torch.sum(keep & in_map & ~in_win).to(torch.int32)

        # ---- 3. Rasterize, with the polar slope scatter riding along ----
        extra = None
        ray_window = None
        ray = None
        if sampled:
            # Exactness first: every ray sampled S times and scatter-minned
            # into the full map; no K1 / K4.
            origin_inside = geom.is_inside(position, sensor_origin[:2])
            ray = raycast.ray_min_height_sampled(
                geom, position, xyz_world, keep & origin_inside, sensor_origin
            )
        elif cfg.raycasting.enabled:
            origin_inside = geom.is_inside(position, sensor_origin[:2])
            extra = raycast.polar_scatter_spec(
                geom, position, xyz_world, keep & origin_inside,
                sensor_origin, ray_num_azimuth, ray_range_bin_factor,
                ray_max_range,
            )
            if upd_window is not None:
                ray_window = upd_window
            elif (ray_wr, ray_wc) != geom.shape:
                r0, c0 = window_at(position, sensor_origin, ray_wr, ray_wc)
                ray_window = (r0, c0, ray_wr, ray_wc)

        obs = raster.rasterize_scatter_rows(
            geom,
            position,
            xyz_world,
            keep,
            z_var,
            intensity=intensity,
            color_packed=color_packed,
            with_voxel_count=cfg.raycasting.enabled,
            extra_min_scatter=extra,
            voxel_count_mode=voxel_count_mode,
            window=upd_window,
        )

        # ---- 4. The ray field (K1) and its per-cell lookup with the index
        # math (K4); with exact_window one read per cell covers the whole
        # azimuth window ----
        if cfg.raycasting.enabled and not sampled:
            smeared = raycast.polar_smeared_field(
                geom, sensor_origin, obs.extra,
                ray_num_azimuth, ray_range_bin_factor, ray_max_range,
                exact_window=ray_exact_window, impl=impl, windows=windows,
            )
            ray_min, ray_touched = k4.resample_lookup(
                smeared, lookup, position, sensor_origin, window=ray_window,
                two_reads=not ray_exact_window,
            )
            if ray_window is not None and upd_window is None:
                # Only the ray window is active: the full-map update takes
                # full-map fields.
                ray_win = _Window(*ray_window)
                ray_min = ray_win.expand(geom, ray_min, np.nan)
                ray_touched = ray_win.expand(geom, ray_touched, False)
            ray = (ray_min, ray_touched)
        return obs, ray, sensor_origin, xyz_world, keep, z_var, win, oow_points

    def update_layers(state, obs, ray, sensor_origin, frame_nonempty):
        """The map update on a state whose layer shapes match ``obs``."""
        state = _estimate(state, cfg, obs)
        state = _update_minmax(state, obs)
        state = _update_obstacle(state, obs, frame_nonempty)
        state = _update_intensity(state, obs)
        state = _update_color(state, obs)
        if cfg.raycasting.enabled:
            state = raycast.apply_raycasting(
                geom,
                state,
                None,
                None,
                sensor_origin,
                cfg.raycasting,
                obs_count=obs.voxel_count,
                ray_min_touched=ray,
                frame_nonempty=frame_nonempty,
            )
        return state

    def phase_b(state, T_wb, frame_nonempty, pa):
        obs, ray, sensor_origin, _xyz_world, _keep, _z_var, win, _oow = pa
        if local_mode:
            state = gridmap.move(geom, state, T_wb[:2, 3])
        if win is None:
            return update_layers(state, obs, ray, sensor_origin, frame_nonempty)

        # Windowed update: the same per-cell recurrences on a window of
        # every layer, written back into a copy of the layer. Every touched
        # cell is in the window, so outside it only the per-frame overwrite
        # layers change: NaN when the frame is nonempty, kept otherwise.
        views = {k: win.read(v) for k, v in state.layers.items()}
        vstate = update_layers(
            GridMapState(layers=views, position=state.position),
            obs, ray, sensor_origin, frame_nonempty,
        )
        new_layers = {}
        for k, full in state.layers.items():
            if k in (layers.obstacle, layers.raycasting):
                base = torch.where(frame_nonempty, np.nan, full)
            else:
                base = full.clone()
            new_layers[k] = win.write_(base, vstate.layers[k])
        return GridMapState(layers=new_layers, position=state.position)

    return phase_a, phase_b, moved_position


def build_integrate_sequence(
    geom: GridGeometry,
    cfg: Config,
    has_intensity: bool = False,
    has_color: bool = False,
    microbatch: int = 1,
    *,
    device="cuda",
    **step_kwargs,
):
    """Batched replay: K scans integrated by one call.

    Returned signature:
      integrate_sequence(state, xyz, mask, T_bs, T_wb,
                         intensity=None, color_packed=None) -> state
    with ``xyz`` f32[K, N, 3], ``mask`` bool[K, N], ``T_wb`` f32[K, 4, 4],
    ``T_bs`` f32[4, 4] (one extrinsic) or f32[K, 4, 4], optional channels
    [K, N], all on the step's device. Frame k's aux is not kept.

    The body is the per-scan step of ``build_integrate`` (same arguments),
    run frame after frame with no host read in between, so the map equals
    the one-scan-at-a-time loop's bit for bit on every layer. Padding
    frames replicate the previous pose with an all-False mask: an empty
    scan touches no cell and a repeated pose makes the LOCAL move a no-op.

    The reference's ``microbatch > 1`` (the irregular ops of several scans
    flattened into one program) answers a TPU dispatch cost and is not
    ported: it raises.
    """
    if microbatch < 1:
        raise ValueError("microbatch must be >= 1")
    if microbatch > 1:
        raise _not_ported(
            "build_integrate_sequence(microbatch > 1)",
            "section 1, the do-not-port list",
        )
    step = build_integrate(
        geom, cfg, has_intensity, has_color, device=device, **step_kwargs
    )

    def integrate_sequence(
        state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None
    ):
        static_tbs = T_bs.dim() == 2
        for k in range(xyz.shape[0]):
            state, _ = step(
                state,
                xyz[k],
                mask[k],
                T_bs if static_tbs else T_bs[k],
                T_wb[k],
                None if intensity is None else intensity[k],
                None if color_packed is None else color_packed[k],
            )
        return state

    return integrate_sequence


class FastDEM:
    """Host-side facade: owns the map state on ``device`` and the step.

    Not thread-safe, like the reference.
    """

    def __init__(
        self,
        geom: GridGeometry,
        cfg: Optional[Config] = None,
        position=(0.0, 0.0),
        frame_id: str = "map",
        has_intensity: bool = False,
        has_color: bool = False,
        auto_bucket: bool = True,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.geom = geom
        self.cfg = cfg or Config()
        self.frame_id = frame_id
        self.has_intensity = has_intensity
        self.has_color = has_color
        # Compact and re-pad scans to the capacity ladder when their valid
        # count sits well below capacity (see integrate()).
        self.auto_bucket = auto_bucket
        self.state = create_map_state(
            geom, self.cfg, position, has_intensity, has_color, device=self.device
        )
        # Base->sensor translation allowance baked into the update-window
        # and polar-field bounds; widened (with a step rebuild) when a
        # larger extrinsic shows up.
        self._window_margin = 2.0
        # Every this many scans, read the out-of-window point count back
        # (one host sync) as a backstop for what the extrinsic guard in
        # integrate() cannot see.
        self._oow_check_every = 64
        self._scan_counter = 0
        self._step = self._build_step()
        self.calibration = None  # provider with get_extrinsic(frame_id)
        self.odometry = None  # provider with get_pose_at(timestamp_ns)
        self.on_preprocessed = None
        self.on_rasterized = None
        self.last_aux: Optional[IntegrateAux] = None

    def _build_step(self):
        return build_integrate(
            self.geom, self.cfg, self.has_intensity, self.has_color,
            window_margin=self._window_margin, device=self.device,
        )

    # -- fluent setters: each rebuilds the step ------------------------------
    def _rebuild(self):
        self._step = self._build_step()
        # Estimator / raycast layer sets may change; keep existing layers.
        fills = initial_layer_fills(self.cfg, self.has_intensity, self.has_color)
        lyr = dict(self.state.layers)
        for name, fill in fills.items():
            if name not in lyr:
                lyr[name] = torch.full(
                    self.geom.shape, fill, dtype=torch.float32, device=self.device
                )
        self.state = GridMapState(layers=lyr, position=self.state.position)

    def set_mapping_mode(self, mode: MappingMode) -> "FastDEM":
        self.cfg.mapping.mode = mode
        self._rebuild()
        return self

    def set_estimator_type(self, est: EstimationType) -> "FastDEM":
        self.cfg.mapping.estimation_type = est
        self._rebuild()
        return self

    def set_sensor_model(self, sensor_type) -> "FastDEM":
        self.cfg.sensor_model.type = sensor_type
        self._rebuild()
        return self

    def set_height_filter(self, z_min: float, z_max: float) -> "FastDEM":
        self.cfg.point_filter.z_min = z_min
        self.cfg.point_filter.z_max = z_max
        self._rebuild()
        return self

    def set_range_filter(self, rmin: float, rmax: float) -> "FastDEM":
        self.cfg.point_filter.range_min = rmin
        self.cfg.point_filter.range_max = rmax
        self._rebuild()
        return self

    def enable_raycasting(self, enabled: bool = True) -> "FastDEM":
        self.cfg.raycasting.enabled = enabled
        self._rebuild()
        return self

    def set_calibration_provider(self, provider) -> "FastDEM":
        self.calibration = provider
        return self

    def set_odometry_provider(self, provider) -> "FastDEM":
        self.odometry = provider
        return self

    def has_transform_provider(self) -> bool:
        return self.calibration is not None and self.odometry is not None

    def reset(self) -> None:
        """Clear every layer to NaN."""
        self.state = gridmap.clear_all(self.state)

    # -- integration ---------------------------------------------------------
    def integrate(self, cloud, T_base_sensor=None, T_world_base=None) -> bool:
        """Integrate one scan. With explicit transforms the cloud is taken
        as given; without, the providers are queried. Returns False and
        drops the scan on any failure, like the reference."""
        if T_base_sensor is None or T_world_base is None:
            if not self.has_transform_provider():
                log.error(
                    "[FastDEM] Transform providers not set; use explicit "
                    "transforms or set providers first."
                )
                return False
            if cloud is None or cloud.empty():
                log.warning("[FastDEM] Received empty or null cloud. Skipping...")
                return False
            if not cloud.frame_id:
                log.error("[FastDEM] Input cloud has no frameId. Skipping...")
                return False
            T_base_sensor = self.calibration.get_extrinsic(cloud.frame_id)
            if T_base_sensor is None:
                log.warning(
                    "[FastDEM] Calibration not available for '%s'. Skipping...",
                    cloud.frame_id,
                )
                return False
            T_world_base = self.odometry.get_pose_at(cloud.timestamp_ns)
            if T_world_base is None:
                log.warning(
                    "[FastDEM] Odometry not available at %d. Skipping...",
                    cloud.timestamp_ns,
                )
                return False
        elif cloud is None or cloud.empty():
            log.warning("[FastDEM] Received empty cloud. Skipping...")
            return False

        if (
            self.auto_bucket
            and cloud.valid_count >= 0
            and pc.ladder_capacity(cloud.valid_count) < cloud.capacity * 0.75
        ):
            cloud = pc.compact_to_bucket(cloud)
        if cloud.device != self.device:
            cloud = cloud.to(self.device)

        intensity = cloud.channels.get("intensity") if self.has_intensity else None
        color_packed = None
        if self.has_color and "color" in cloud.channels:
            color_packed = pack_rgb(cloud.channels["color"])

        T_bs_host = _host_f32(T_base_sensor)
        self._guard_margin(T_bs_host)
        T_bs = torch.as_tensor(T_bs_host, device=self.device)
        T_wb = torch.as_tensor(
            T_world_base, dtype=torch.float32, device=self.device
        )
        self.state, aux = self._step(
            self.state, cloud.xyz, cloud.mask, T_bs, T_wb, intensity, color_packed
        )
        self.last_aux = aux
        self._scan_counter += 1
        if (
            aux.oow_points is not None
            and self._scan_counter % self._oow_check_every == 0
        ):
            n_oow = int(aux.oow_points)
            if n_oow:
                log.error(
                    "[FastDEM] %d in-map points fell OUTSIDE the update "
                    "window this scan and were dropped: the base->sensor "
                    "offset exceeds the window margin (%.2f m); widen it "
                    "or check extrinsics.", n_oow, self._window_margin,
                )
        if self.on_preprocessed is not None:
            self.on_preprocessed(aux)
        if self.on_rasterized is not None:
            self.on_rasterized(self.rasterized_cloud(aux))
        return True

    def _guard_margin(self, T_bs: np.ndarray) -> None:
        """The window and polar-field bounds assume the base->sensor xy
        offset stays under the margin: widen it (one rebuild) before
        integrating rather than drop points past the window."""
        off = float(np.hypot(T_bs[0, 3], T_bs[1, 3]))
        if off + 0.5 > self._window_margin:
            log.warning(
                "[FastDEM] base->sensor xy offset %.2f m exceeds the window "
                "margin %.2f m; widening to %.2f m (rebuild).",
                off, self._window_margin, off + 1.0,
            )
            self._window_margin = off + 1.0
            self._rebuild()

    def integrate_sequence(
        self, clouds, T_base_sensor=None, T_world_base=None, batch: int = 16
    ) -> int:
        """Integrate a list of scans in order: ``integrate`` on each, so the
        map afterwards is the ``integrate`` loop's, bit for bit, whatever
        the scans' sizes, and ``last_aux`` and the observation callbacks
        follow every scan.

        Transforms follow ``integrate``'s rule: explicit mode needs BOTH
        ``T_base_sensor`` (one 4x4 or one per cloud) and ``T_world_base``
        (one per cloud); otherwise the providers are queried per cloud and
        a failed lookup drops that scan. ``batch`` is the reference's count
        of frames per compiled call; the port's step has no compiled shape,
        so the value is only checked. Returns the number of scans
        integrated.
        """
        if batch < 1:
            raise ValueError("batch must be >= 1")
        n = len(clouds)
        tbs = twb = [None] * n
        if T_base_sensor is not None and T_world_base is not None:
            twb = _host_f32(T_world_base).reshape(-1, 4, 4)
            if twb.shape[0] != n:
                raise ValueError("T_world_base must provide one pose per cloud")
            tbs = _host_f32(T_base_sensor)
            tbs = [tbs] * n if tbs.shape == (4, 4) else tbs.reshape(-1, 4, 4)
            if len(tbs) != n:
                raise ValueError("T_base_sensor must be one 4x4 or one per cloud")
        return sum(self.integrate(c, b, w) for c, b, w in zip(clouds, tbs, twb))

    def rasterized_cloud(self, aux: IntegrateAux):
        """One point per touched cell at (cell center, min_z)."""
        x, y = self.geom.cell_centers(self.state.position)
        return x, y, aux.obs.min_z, aux.obs.touched


def _host_f32(T) -> np.ndarray:
    """A transform (numpy, a tensor on any device, or a list or tuple of
    either) as host f32."""
    if isinstance(T, torch.Tensor):
        T = T.detach().cpu()
    elif isinstance(T, (list, tuple)):
        T = [t.detach().cpu() if isinstance(t, torch.Tensor) else t for t in T]
    return np.asarray(T, dtype=np.float32)
