"""The plain per-scan map update, as the port's eager step computes it
(frozen copy of the port's ``mapping/pipeline.py``, with both of its
estimators, Kalman (``kalman.py``) and P^2 (``p2.py``), cut to the two
formulations the benchmark's configurations run):

  * the full-map update in rows mode, with the polar raycast (K1's and K4's
    plain twins) or without it;
  * the windowed update (a sensor-centred window of the map, written back)
    in rows mode, without the raycast.

Each scan: transform, LiDAR z-variance, range and height filters, the row
rasterizer, the estimator's update, min / max, obstacle, and the raycast's
visibility update; in LOCAL mode the map first moves with the robot.

``dtype`` is the precision the map layers are kept in between scans: the
configuration states float32; ``torch.bfloat16`` is the benchmark's control
(the same step with its state rounded to bfloat16 after every scan).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import kalman as kalman_est
from . import p2 as p2_est
from . import rasterize as raster
from . import raycasting as raycast
from . import transform as tfm
from .config import Config, EstimationType, MappingMode
from .geometry import GridGeometry
from .gridmap import GridMapState, layers
from . import gridmap
from .numerics import recip_f32, sum_sq
from .sensors import create_sensor_model


def _is_p2(cfg: Config) -> bool:
    return cfg.mapping.estimation_type == EstimationType.P2_QUANTILE


def initial_layer_fills(cfg: Config) -> Dict[str, float]:
    fills = gridmap.default_layer_fills()
    fills.update(p2_est.layer_fills() if _is_p2(cfg) else kalman_est.layer_fills())
    fills[layers.obstacle] = np.nan
    if cfg.raycasting.enabled:
        fills.update(raycast.layer_fills())
    return fills


def create_map_state(geom: GridGeometry, cfg: Config, device) -> GridMapState:
    return gridmap.create(geom, initial_layer_fills(cfg), (0.0, 0.0), device=device)


def _update_minmax(state: GridMapState, obs):
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


def _update_obstacle(state: GridMapState, obs, frame_nonempty):
    obstacle = torch.where(obs.touched & (obs.max_z > obs.min_z), obs.max_z, np.nan)
    obstacle = torch.where(frame_nonempty, obstacle, state.layers[layers.obstacle])
    return state.replace_layer(layers.obstacle, obstacle)


class _Window:
    def __init__(self, r0: torch.Tensor, c0: torch.Tensor, wr: int, wc: int):
        dev = r0.device
        rows = (r0 + torch.arange(wr, dtype=torch.int32, device=dev)).long()
        cols = (c0 + torch.arange(wc, dtype=torch.int32, device=dev)).long()
        self.index = (rows[:, None], cols[None, :])

    def read(self, layer: torch.Tensor) -> torch.Tensor:
        return layer[self.index]

    def write_(self, layer: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        return layer.index_put_(self.index, values)


def build_step(geom: GridGeometry, cfg: Config, window_margin: float = 2.0,
               dtype=torch.float32):
    """``step(state, xyz, mask, T_bs, T_wb) -> state`` on the tensors' device."""
    if cfg.raycasting.enabled and cfg.raycasting.method == "sampled":
        raise NotImplementedError("the reference has the polar raycast only")
    sensor = create_sensor_model(cfg.sensor_model)
    pf = cfg.point_filter
    local_mode = cfg.mapping.mode == MappingMode.LOCAL
    voxel_count_mode = cfg.raycasting.voxel_count_mode
    A = int(cfg.raycasting.num_azimuth_bins)
    rbf = float(cfg.raycasting.range_bin_factor)
    _F32_MAX = 3.4028235e38
    rmin2 = min(pf.range_min * pf.range_min, _F32_MAX)
    rmax2 = min(pf.range_max * pf.range_max, _F32_MAX)

    ray_max_range = None
    ray_range_explicit = False
    if cfg.raycasting.max_range > 0:
        ray_max_range = float(cfg.raycasting.max_range)
        ray_range_explicit = True
    if ray_max_range is None and pf.range_max < 1e6:
        ray_max_range = float(pf.range_max) * 1.1 + window_margin
    if local_mode:
        half_diag = 0.5 * math.hypot(geom.rows, geom.cols) * geom.resolution
        local_bound = half_diag + window_margin + 2.0 * geom.resolution
        if ray_max_range is None or (not ray_range_explicit and ray_max_range > local_bound):
            ray_max_range = local_bound

    upd_bound = float(pf.range_max) * 1.1 + window_margin if pf.range_max < 1e6 else None
    if upd_bound is not None:
        wcells = int(math.ceil(2.0 * upd_bound / geom.resolution)) + 4
        upd_wr, upd_wc = min(geom.rows, wcells), min(geom.cols, wcells)
    else:
        upd_wr, upd_wc = geom.rows, geom.cols
    windowed = 2 * upd_wr * upd_wc <= geom.num_cells
    eff_cells = upd_wr * upd_wc if windowed else geom.num_cells
    if eff_cells > (1 << 19):
        raise NotImplementedError("the reference has the rows rasterizer only")
    if cfg.raycasting.enabled:
        if windowed:
            raise NotImplementedError("the reference's raycast is the full-map one")
        wcells = int(math.ceil(2.0 * ray_max_range / geom.resolution)) + 4
        if (min(geom.rows, wcells), min(geom.cols, wcells)) != geom.shape:
            raise NotImplementedError("the reference's raycast covers the whole map")
        lookup = raycast.polar_lookup(geom, A, rbf, ray_max_range)
    windows = {}

    def moved_position(position, target_xy):
        res = geom.resolution
        delta = gridmap.round_half_away((target_xy - position) * recip_f32(res)).to(torch.int32)
        return position + delta.to(torch.float32) * res

    def window_at(position, sensor_origin, wr, wc):
        sr, sc, _ = geom.index_of(position, sensor_origin[:2])
        r0 = torch.clamp(torch.clamp(sr, 0, geom.rows) - wr // 2, 0, geom.rows - wr)
        c0 = torch.clamp(torch.clamp(sc, 0, geom.cols) - wc // 2, 0, geom.cols - wc)
        return r0, c0

    def update_layers(state, obs, ray, sensor_origin, frame_nonempty):
        if _is_p2(cfg):
            state = p2_est.estimate(
                state, cfg.mapping.p2, obs.min_z, obs.min_z_var, obs.touched
            )
        else:
            state = kalman_est.update(
                state, cfg.mapping.kalman, obs.min_z, obs.min_z_var, obs.touched
            )
        state = _update_minmax(state, obs)
        state = _update_obstacle(state, obs, frame_nonempty)
        if cfg.raycasting.enabled:
            state = raycast.apply_raycasting(
                geom, state, None, None, sensor_origin, cfg.raycasting,
                obs_count=obs.voxel_count, ray_min_touched=ray,
                frame_nonempty=frame_nonempty,
            )
        return state

    def step(state: GridMapState, xyz, mask, T_bs, T_wb) -> GridMapState:
        dev = xyz.device
        position = moved_position(state.position, T_wb[:2, 3]) if local_mode else state.position
        T_ws = T_wb @ T_bs
        z_var = sensor.z_variance_world(xyz, T_ws[2, :3])
        xyz_base = tfm.transform_points(xyz, T_bs)
        d2 = sum_sq(xyz_base)
        keep = (
            mask & (d2 >= rmin2) & (d2 <= rmax2)
            & (xyz_base[:, 2] >= pf.z_min) & (xyz_base[:, 2] <= pf.z_max)
        )
        xyz_world = tfm.transform_points(xyz_base, T_wb)
        sensor_origin = T_ws[:3, 3]

        upd_window = store = None
        if windowed:
            ur0, uc0 = window_at(position, sensor_origin, upd_wr, upd_wc)
            upd_window = (ur0, uc0, upd_wr, upd_wc)
            store = _Window(*upd_window)

        obs = raster.rasterize_scatter_rows(
            geom, position, xyz_world, keep, z_var,
            with_voxel_count=cfg.raycasting.enabled, window=upd_window,
            voxel_count_mode=voxel_count_mode, scope=None,
        )
        ray = None
        if cfg.raycasting.enabled:
            if dev not in windows:
                windows[dev] = raycast.column_windows(geom, A, rbf, ray_max_range, dev)
            origin_inside = geom.is_inside(position, sensor_origin[:2])
            polar = raycast.polar_scatter_spec(
                geom, position, xyz_world, keep & origin_inside, sensor_origin,
                A, rbf, ray_max_range,
            )
            field = raycast.polar_smeared_field(
                geom, sensor_origin, raster.scatter_min_table(*polar), A, rbf,
                ray_max_range, exact_window=True, impl="xla", windows=windows[dev],
            )
            ray = raycast.k4.resample_lookup(field, lookup, position, sensor_origin)

        if local_mode:
            state = gridmap.move(geom, state, T_wb[:2, 3])
        frame_nonempty = torch.any(mask)
        if store is None:
            state = update_layers(state, obs, ray, sensor_origin, frame_nonempty)
        else:
            views = {k: store.read(v) for k, v in state.layers.items()}
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
                new_layers[k] = store.write_(base, vstate.layers[k])
            state = GridMapState(layers=new_layers, position=state.position)
        if dtype != torch.float32:
            state = GridMapState(
                layers={k: v.to(dtype).to(torch.float32) for k, v in state.layers.items()},
                position=state.position,
            )
        return state

    step.moved_position = moved_position
    step.ray_max_range = ray_max_range
    return step
