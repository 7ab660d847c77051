"""The FastDEM pipeline: preprocess -> map update -> estimate -> raycast
(port of ``fastdem_tpu/mapping/pipeline.py``: LOCAL and GLOBAL maps, full
or windowed, with the Kalman or the P^2 estimator, in any of the
reference's four rasterizer formulations).

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
equals the per-scan loop's bit for bit. With ``microbatch=m`` (and in
``build_integrate_fused``, m = K) phase A runs over m scans at once: one
row scatter, one K1 launch and one K4 launch for the m scans; phase B
stays a loop over frames. ``FastDEM.integrate_sequence`` takes a list of
clouds and runs ``FastDEM.integrate`` on each, so every scan keeps its own
capacity.

``scatter_mode`` picks the rasterizer: "rows" (the default), "packed",
"twophase" or "sort" (``mapping/rasterize.py``). As in the reference,
rows becomes packed above 2^19 update cells (the window's cells when the
windowed update is on, else the map's).

On maps larger than the scan's reach, the rasterizer's tables and the
whole map update run on a sensor-centred window of the map and are
written back (``window_update``); the window's top-left cell stays on the
device, so no step reads it back to the host.

``build_integrate(spmd_blocks=(mx, my))`` is the step of one block of a
map split into blocks (``parallel.sharding`` runs a mesh of them).
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
from fastdem_tpu_torch.mapping import staging
from fastdem_tpu_torch.ops import resample as k4
from fastdem_tpu_torch.postprocess import raycasting as raycast
from fastdem_tpu_torch.sensors.models import create_sensor_model
from fastdem_tpu_torch.utils import graphs, tracing
from fastdem_tpu_torch.utils.colors import pack_rgb

log = logging.getLogger("fastdem_tpu_torch")

_INTEGRATE = tracing.name_id("facade.integrate")
_PREP = tracing.name_id("facade.prep")
_CALLBACKS = tracing.name_id("facade.callbacks")


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


def missing_layers(
    names, cfg: Config, has_intensity: bool, has_color: bool, shape, device
) -> Dict[str, torch.Tensor]:
    """The layers of ``cfg``'s set that ``names`` lacks, at their fills."""
    return {name: torch.full(shape, fill, dtype=torch.float32, device=device)
            for name, fill in initial_layer_fills(cfg, has_intensity, has_color).items()
            if name not in names}


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
    jit: bool = True,
    donate: bool = True,
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
    the full-map update. The step's ``scatter_mode`` attribute names the
    rasterizer that runs: as in the reference, rows becomes packed above
    2^19 update cells.

    ``spmd_blocks``: (mx, my) -- build the step of ONE block of a map split
    into mx x my blocks of [rows/mx, cols/my] cells. The step then takes
    the block's layers as ``state`` (the position stays the whole map's)
    and the block's coordinates as the keyword ``block=(i, j)``; the same
    step runs once per block. Each block updates the intersection of the
    global update window with itself, clamped onto the block, so the
    blocks need no exchange and together equal the unsharded windowed
    step. Needs GLOBAL mode and a configuration where the window engages,
    and a map the mesh divides (ValueError otherwise). ``aux.obs`` is
    None. ``parallel.sharding`` runs the blocks of a mesh and computes the
    part of a scan that does not depend on the block once per device.

    ``jit`` and ``donate`` are the reference's: with ``jit`` the step on
    CUDA tensors is captured into a CUDA graph per input signature (scan
    capacity, channels, the rank of ``T_bs``, ``block``) and replayed, one
    graph launch a scan (``utils/graphs.py``); with ``donate`` the state
    passed in is consumed and the returned state is the graph's own slots,
    updated in place (the windowed update writes its window into them).
    On the CPU ``jit`` runs the step as it is, on a copy of the state.
    ``jit=False`` is the eager step (``graphs.plain``), which dispatches
    every op from Python on a copy of the state; its ``fn`` runs on the
    state passed in.
    """
    dev = resolve_device(device)
    ph = _build_phases(
        geom, cfg, ray_num_azimuth, ray_range_bin_factor, ray_max_range,
        scatter_mode, voxel_count_mode, ray_exact_window,
        polar_field_impl=polar_field_impl, window_update=window_update,
        window_margin=window_margin, spmd_blocks=spmd_blocks, device=dev,
    )
    local_mode = cfg.mapping.mode == MappingMode.LOCAL

    if spmd_blocks is not None:

        def integrate_block(
            state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None, *, block
        ):
            sh = ph.shared(state.position, xyz, mask, T_bs, T_wb)
            pa = ph.block(sh, state.position, intensity, color_packed, block)
            state = ph.update(state, torch.any(mask), pa)
            aux = IntegrateAux(
                world_xyz=sh.xyz_world, world_mask=sh.keep, z_var=sh.z_var,
                obs=None, oow_points=sh.oow_points,
            )
            return state, aux

        return _compiled(integrate_block, jit, donate, scatter_mode=ph.scatter_mode)

    def integrate(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        # The post-move LOCAL position is pure pose arithmetic, so phase A
        # depends only on the inputs, not on the carried layers.
        position = (
            ph.moved_position(state.position, T_wb[:2, 3])
            if local_mode
            else state.position
        )
        sh = ph.shared(position, xyz, mask, T_bs, T_wb)
        pa = ph.block(sh, position, intensity, color_packed)
        if local_mode:
            state = gridmap.move(geom, state, T_wb[:2, 3])
        state = ph.update(state, torch.any(mask), pa)
        obs, win = pa.obs, pa.store
        if win is not None:
            obs = _expand_obs(geom, obs, win)
        aux = IntegrateAux(
            world_xyz=sh.xyz_world, world_mask=sh.keep, z_var=sh.z_var, obs=obs,
            oow_points=sh.oow_points,
        )
        return state, aux

    return _compiled(integrate, jit, donate, scatter_mode=ph.scatter_mode)


def _compiled(fn, jit: bool, donate: bool, **attrs):
    """``fn`` as the builders return it: captured per signature with
    ``jit`` (``graphs.jit``), on a copy of its state without
    (``graphs.plain``); ``attrs`` set on it."""
    step = graphs.jit(fn, donate=donate) if jit else graphs.plain(fn)
    for name, value in attrs.items():
        setattr(step, name, value)
    return step


@dataclasses.dataclass
class SharedScan:
    """The part of one scan's phase A that does not depend on a map block:
    computed once per device and shared by that device's blocks."""

    xyz_world: torch.Tensor
    keep: torch.Tensor
    z_var: torch.Tensor
    sensor_origin: torch.Tensor
    # Top-left cell of the global update window (int32 device scalars),
    # when the windowed update is on.
    gwin: Optional[tuple] = None
    in_gwin: Optional[torch.Tensor] = None
    oow_points: Optional[torch.Tensor] = None
    # (r0, c0, wr, wc) of the ray window of a full-map update, when the
    # ray reaches less than the map.
    ray_window: Optional[tuple] = None
    # The polar slope scatter's (keys, slopes, table size), then the ray
    # field [R, A] (K1's output); or the sampled raycast's full-map
    # (ray_min, touched).
    polar: Optional[tuple] = None
    field: Optional[torch.Tensor] = None
    ray_full: Optional[tuple] = None
    # The unsharded rasterizer's view of the scan (blocks only).
    scope: Optional[raster.UnshardedScan] = None


@dataclasses.dataclass
class BlockScan:
    """One block's (or the whole map's) phase A output."""

    obs: raster.CellObservations
    ray: Optional[tuple]
    sensor_origin: torch.Tensor
    # The window phase B updates, in the state's own cell offsets (None:
    # the whole state).
    store: Optional["_Window"]


@dataclasses.dataclass
class _Phases:
    shared: object  # (position, xyz, mask, T_bs, T_wb) -> SharedScan
    block: object  # (SharedScan, position, intensity, color, block=None) -> BlockScan
    update: object  # (state, frame_nonempty, BlockScan) -> state; no move
    moved_position: object
    scatter_mode: str  # the rasterizer that runs (after the switch to packed)
    # (positions [K, 2], xyz [K, N, 3], mask, T_bs, T_wb [K, 4, 4],
    # intensity, color) -> [BlockScan] * K: phase A of K scans at once;
    # None where the configuration has none (see _build_phases).
    batched: object = None


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
    full_blocks: bool = False,
    *,
    device: torch.device,
) -> _Phases:
    """Split the step into ``shared`` (the per-scan work that depends on
    the inputs only), ``block`` (the rest of phase A, for the whole map or
    for one block: rasterizer and K4), ``update`` (phase B's recurrences,
    after the LOCAL move) and ``moved_position`` (gridmap.move's lattice
    walk of the position).

    ``spmd_blocks`` = (mx, my) builds the phases of a map split into blocks:
    by default the windowed blocks of ``build_integrate(spmd_blocks=...)``;
    with ``full_blocks`` each block updates all of itself (the full-map
    update, any mode), for ``parallel.sharding``'s fallback.

    ``batched`` is phase A of K scans at once, for the full-map update in
    rows mode with the polar raycast or none (the reference's
    ``phase_a_batched``); None otherwise.
    """
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
    if voxel_count_mode == "span" and scatter_mode == "twophase":
        raise ValueError('voxel_count_mode="span" needs rows/packed mode')
    if scatter_mode == "sort" and cfg.raycasting.enabled:
        raise ValueError('scatter_mode="sort" requires raycasting disabled')
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
    # off, as in the reference; so do the twophase and sort rasterizers.
    sampled = cfg.raycasting.enabled and cfg.raycasting.method == "sampled"
    windowed = (
        window_update is not False
        and not full_blocks
        and scatter_mode in ("rows", "packed")
        and 2 * upd_wr * upd_wc <= geom.num_cells
        and not sampled
    )
    # Blocks (the reference's shard_map formulation): the global window is
    # clamped onto each block; a window of min(global window, block) cells
    # placed at clip(g0 - block0, 0, block - w') covers window-intersect-
    # block, and blocks are disjoint, so the blocks' updates tile the
    # global windowed update. Points are masked to the GLOBAL window, so a
    # block window clamped at a block edge never rasterizes a point the
    # unsharded step drops.
    upd_wr_g, upd_wc_g = upd_wr, upd_wc
    block_shape = None
    if spmd_blocks is not None:
        smx, smy = int(spmd_blocks[0]), int(spmd_blocks[1])
        if not full_blocks and local_mode:
            raise ValueError("spmd_blocks requires GLOBAL mapping mode")
        if not full_blocks and not windowed:
            raise ValueError(
                "spmd_blocks requires a configuration where the windowed "
                "update engages (finite point_filter.range_max with a "
                "window at most half the map; the polar raycast or none)"
            )
        if smx < 1 or smy < 1 or geom.rows % smx or geom.cols % smy:
            raise ValueError(
                f"map shape {geom.shape} not divisible by mesh {tuple(spmd_blocks)}"
            )
        block_shape = (geom.rows // smx, geom.cols // smy)
        upd_wr = min(upd_wr_g, block_shape[0])
        upd_wc = min(upd_wc_g, block_shape[1])
    # Which rasterizer runs: the reference turns rows into packed above
    # 2^19 update cells (its TPU pads the row table to 128 lanes), and the
    # port follows it, since the two differ at near-ties (packed's min_z
    # is the argmin point's). The update area is the window's (clamped
    # onto the block for windowed blocks) or the whole map's: full blocks
    # stand for the unsharded step, which updates the whole map.
    eff_cells = upd_wr * upd_wc if windowed else geom.num_cells
    if scatter_mode == "rows" and eff_cells > (1 << 19):
        scatter_mode = "packed"
    raster_fn = {
        "rows": raster.rasterize_scatter_rows,
        "packed": raster.rasterize_scatter_packed,
        "twophase": raster.rasterize_scatter,
        "sort": raster.rasterize,
    }[scatter_mode]
    scoped = scatter_mode != "sort"  # the sorted runs need no scope
    raster_kw = (
        {"voxel_count_mode": voxel_count_mode} if scatter_mode in ("rows", "packed") else {}
    )
    # The cells of the unsharded rasterizer (blocks only): they pick the
    # voxel count's path.
    scope_cells = upd_wr_g * upd_wc_g if windowed else geom.num_cells
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

    def prep(position, xyz, mask, T_bs, T_wb):
        """``shared`` up to the polar slope scatter's inputs (no K1)."""
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
        out = SharedScan(
            xyz_world=xyz_world, keep=keep, z_var=z_var, sensor_origin=sensor_origin
        )

        # ---- 2. The sensor-centred update window ----
        if windowed:
            ur0, uc0 = window_at(position, sensor_origin, upd_wr_g, upd_wc_g)
            out.gwin = (ur0, uc0)
            # Surviving in-map points the window misses would be dropped:
            # count them, so the facade can warn.
            pr, pc_, in_map = geom.index_of(position, xyz_world[:, :2])
            out.in_gwin = (
                (pr >= ur0) & (pr < ur0 + upd_wr_g) & (pc_ >= uc0) & (pc_ < uc0 + upd_wc_g)
            )
            out.oow_points = torch.sum(keep & in_map & ~out.in_gwin).to(torch.int32)
        if block_shape is not None:
            # Blocks quantize z over the unsharded rasterizer's points and
            # count voxels as it does.
            gwin = (*out.gwin, upd_wr_g, upd_wc_g) if windowed else None
            _, valid, _, _ = raster._window_ids(geom, position, xyz_world, keep, gwin)
            out.scope = raster.UnshardedScan(
                raster.z_range_of(xyz_world[:, 2], valid), valid, scope_cells
            )

        # ---- 3. The raycast: the polar slope scatter's inputs, or the
        # sampled rays ----
        if sampled:
            # Exactness first: every ray sampled S times and scatter-minned
            # into the full map; no K1 / K4.
            origin_inside = geom.is_inside(position, sensor_origin[:2])
            out.ray_full = raycast.ray_min_height_sampled(
                geom, position, xyz_world, keep & origin_inside, sensor_origin
            )
        elif cfg.raycasting.enabled:
            origin_inside = geom.is_inside(position, sensor_origin[:2])
            out.polar = raycast.polar_scatter_spec(
                geom, position, xyz_world, keep & origin_inside,
                sensor_origin, ray_num_azimuth, ray_range_bin_factor,
                ray_max_range,
            )
            if not windowed and (ray_wr, ray_wc) != geom.shape:
                out.ray_window = (
                    *window_at(position, sensor_origin, ray_wr, ray_wc), ray_wr, ray_wc
                )
        return out

    def field_of(polar, sensor_origin):
        """The polar ray fields (K1) from the slope scatter's inputs: one
        scan's [R, A], or K scans' [K, R, A] in one launch."""
        return raycast.polar_smeared_field(
            geom, sensor_origin, raster.scatter_min_table(*polar),
            ray_num_azimuth, ray_range_bin_factor, ray_max_range,
            exact_window=ray_exact_window, impl=impl, windows=windows,
        )

    def shared(position, xyz, mask, T_bs, T_wb):
        out = prep(position, xyz, mask, T_bs, T_wb)
        if out.polar is not None:
            out.field = field_of(out.polar, out.sensor_origin)
        return out

    def block(sh, position, intensity=None, color_packed=None, block=None):
        """Rasterize and look the field up (K4) for the whole map
        (``block`` None) or for block ``(i, j)``."""
        dev = sh.keep.device
        keep_r = sh.keep
        store = None
        host_cells = None  # a full block's (r0, c0, wr, wc) as host ints
        if block is None:
            upd_window = None
            if windowed:
                upd_window = (*sh.gwin, upd_wr, upd_wc)
                store = _Window(*upd_window)
            cells = upd_window
        else:
            bi, bj = (int(v) for v in block)
            br0 = torch.full((), bi * block_shape[0], dtype=torch.int32, device=dev)
            bc0 = torch.full((), bj * block_shape[1], dtype=torch.int32, device=dev)
            if windowed:
                # Two offsets: the rasterizer and K4 take the window in
                # global cells, phase B stores it in the block's own cells.
                lur0 = torch.clamp(sh.gwin[0] - br0, 0, block_shape[0] - upd_wr)
                luc0 = torch.clamp(sh.gwin[1] - bc0, 0, block_shape[1] - upd_wc)
                upd_window = (br0 + lur0, bc0 + luc0, upd_wr, upd_wc)
                store = _Window(lur0, luc0, upd_wr, upd_wc)
                keep_r = sh.keep & sh.in_gwin
            else:
                upd_window = (br0, bc0, *block_shape)
                host_cells = (bi * block_shape[0], bj * block_shape[1], *block_shape)
            cells = upd_window

        kw = dict(raster_kw, scope=sh.scope) if scoped else raster_kw
        obs = raster_fn(
            geom,
            position,
            sh.xyz_world,
            keep_r,
            sh.z_var,
            intensity=intensity,
            color_packed=color_packed,
            with_voxel_count=cfg.raycasting.enabled,
            window=upd_window,
            **kw,
        )

        # ---- 4. The per-cell lookup of the field with the index math
        # (K4); with exact_window one read per cell covers the whole
        # azimuth window ----
        ray = None
        if sh.ray_full is not None:
            # The sampled raycast (never windowed): the whole map's fields,
            # or a full block's part of them.
            ray = sh.ray_full
            if host_cells is not None:
                r0, c0, wr, wc = host_cells
                ray = tuple(t[r0:r0 + wr, c0:c0 + wc] for t in ray)
        elif sh.field is not None:
            ray_window = cells if cells is not None else sh.ray_window
            ray_min, ray_touched = k4.resample_lookup(
                sh.field, lookup, position, sh.sensor_origin, window=ray_window,
                two_reads=not ray_exact_window,
            )
            if sh.ray_window is not None:
                r0, c0, wr, wc = sh.ray_window
                if cells is None:
                    # Only the ray window is active: the full-map update
                    # takes full-map fields.
                    ray_win = _Window(r0, c0, wr, wc)
                    ray_min = ray_win.expand(geom, ray_min, np.nan)
                    ray_touched = ray_win.expand(geom, ray_touched, False)
                else:
                    # A full block: no ray reaches beyond the ray window.
                    rr = cells[0] + torch.arange(cells[2], dtype=torch.int32, device=dev)
                    cc = cells[1] + torch.arange(cells[3], dtype=torch.int32, device=dev)
                    inside = ((rr >= r0) & (rr < r0 + wr))[:, None] & (
                        (cc >= c0) & (cc < c0 + wc)
                    )[None, :]
                    ray_min = torch.where(inside, ray_min, np.nan)
                    ray_touched = ray_touched & inside
            ray = (ray_min, ray_touched)
        return BlockScan(obs=obs, ray=ray, sensor_origin=sh.sensor_origin, store=store)

    def batched(positions, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        """Phase A of K scans: each scan's preprocessing as the step runs
        it, then one row scatter for the K rasterizations, one scatter of
        the K polar slope tables, one K1 launch for the K fields
        [K, R, A] and one K4 launch for the K lookups. Each scan's
        BlockScan equals the one-scan phase A's bit for bit."""
        K = xyz.shape[0]
        static_tbs = T_bs.dim() == 2
        shs = [
            prep(positions[k], xyz[k], mask[k], T_bs if static_tbs else T_bs[k], T_wb[k])
            for k in range(K)
        ]
        sensor_origin = torch.stack([sh.sensor_origin for sh in shs])
        obs = raster.rasterize_scatter_rows_batched(
            geom, positions,
            torch.stack([sh.xyz_world for sh in shs]),
            torch.stack([sh.keep for sh in shs]),
            torch.stack([sh.z_var for sh in shs]),
            intensity=intensity,
            color_packed=color_packed,
            with_voxel_count=cfg.raycasting.enabled,
            voxel_count_mode=voxel_count_mode,
        )
        rays = [None] * K
        if cfg.raycasting.enabled:
            polar = (
                torch.stack([sh.polar[0] for sh in shs]),
                torch.stack([sh.polar[1] for sh in shs]),
                shs[0].polar[2],
            )
            field = field_of(polar, sensor_origin)
            window = None
            if shs[0].ray_window is not None:
                window = (
                    torch.stack([sh.ray_window[0] for sh in shs]),
                    torch.stack([sh.ray_window[1] for sh in shs]),
                    ray_wr, ray_wc,
                )
            ray_min, ray_touched = k4.resample_lookup(
                field, lookup, positions, sensor_origin, window=window,
                two_reads=not ray_exact_window,
            )
            for k, sh in enumerate(shs):
                rays[k] = (ray_min[k], ray_touched[k])
                if window is not None:
                    # The full-map update takes full-map fields.
                    win = _Window(*sh.ray_window)
                    rays[k] = (win.expand(geom, rays[k][0], np.nan),
                               win.expand(geom, rays[k][1], False))
        return [
            BlockScan(obs=raster.frame_of(obs, k), ray=rays[k],
                      sensor_origin=sensor_origin[k], store=None)
            for k in range(K)
        ]

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

    def update(state, frame_nonempty, pa):
        win = pa.store
        if win is None:
            return update_layers(state, pa.obs, pa.ray, pa.sensor_origin, frame_nonempty)

        # Windowed update: the same per-cell recurrences on a window of
        # every layer, written back into the layer in place (the step owns
        # its state: a graph's slots, or the copy ``graphs.plain`` and the
        # CPU path hand it). Every read precedes the first write. Every
        # touched cell is in the window, so outside it only the per-frame
        # overwrite layers change: NaN when the frame is nonempty, kept
        # otherwise.
        views = {k: win.read(v) for k, v in state.layers.items()}
        vstate = update_layers(
            GridMapState(layers=views, position=state.position),
            pa.obs, pa.ray, pa.sensor_origin, frame_nonempty,
        )
        new_layers = {}
        for k, full in state.layers.items():
            if k in (layers.obstacle, layers.raycasting):
                full.masked_fill_(frame_nonempty, np.nan)
            new_layers[k] = win.write_(full, vstate.layers[k])
        return GridMapState(layers=new_layers, position=state.position)

    # The reference batches phase A only in rows mode on the full map with
    # the polar raycast or none.
    has_batched = scatter_mode == "rows" and not windowed and not sampled and (
        block_shape is None
    )
    return _Phases(shared=shared, block=block, update=update, moved_position=moved_position,
                   scatter_mode=scatter_mode, batched=batched if has_batched else None)


def _phases_of(geom, cfg, device, step_kwargs, **pinned):
    """``_build_phases`` from ``build_integrate``'s keyword arguments (an
    unknown one raises TypeError), with ``pinned`` ones overriding them."""
    kw = dict(step_kwargs, **pinned)
    positional = [
        kw.pop(name, default) for name, default in (
            ("ray_num_azimuth", None), ("ray_range_bin_factor", None),
            ("ray_max_range", None), ("scatter_mode", "rows"),
            ("voxel_count_mode", None), ("ray_exact_window", True),
        )
    ]
    return _build_phases(geom, cfg, *positional, device=resolve_device(device), **kw)


def _replay_in_chunks(geom: GridGeometry, cfg: Config, ph: _Phases, chunk: Optional[int]):
    """K stacked scans, phase A ``chunk`` scans at a time (all K when
    ``chunk`` is None) through ``ph.batched`` (or scan by scan where the
    configuration has none), phase B frame by frame. LOCAL maps take each
    scan's post-move position from the pose-only lattice walk, on the
    device: no host read between the scans."""
    local_mode = cfg.mapping.mode == MappingMode.LOCAL

    def phase_a(positions, xyz, mask, T_bs, T_wb, intensity, color_packed):
        if ph.batched is not None:
            return ph.batched(positions, xyz, mask, T_bs, T_wb, intensity, color_packed)
        static_tbs = T_bs.dim() == 2
        return [
            ph.block(
                ph.shared(positions[k], xyz[k], mask[k], T_bs if static_tbs else T_bs[k],
                          T_wb[k]),
                positions[k],
                None if intensity is None else intensity[k],
                None if color_packed is None else color_packed[k],
            )
            for k in range(xyz.shape[0])
        ]

    def replay(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        K = xyz.shape[0]
        m = K if chunk is None else chunk
        if K % m:
            raise ValueError(
                f"K={K} frames not a multiple of microbatch={m}; pad with empty "
                "frames (see build_integrate_sequence)"
            )
        static_tbs = T_bs.dim() == 2
        for c0 in range(0, K, m):
            sl = slice(c0, c0 + m)
            positions, p = [], state.position
            for T in T_wb[sl]:
                if local_mode:
                    p = ph.moved_position(p, T[:2, 3])
                positions.append(p)
            pas = phase_a(
                torch.stack(positions), xyz[sl], mask[sl], T_bs if static_tbs else T_bs[sl],
                T_wb[sl], None if intensity is None else intensity[sl],
                None if color_packed is None else color_packed[sl],
            )
            for k, pa in enumerate(pas):
                if local_mode:
                    state = gridmap.move(geom, state, T_wb[c0 + k][:2, 3])
                state = ph.update(state, torch.any(mask[c0 + k]), pa)
        return state

    return replay


def build_integrate_sequence(
    geom: GridGeometry,
    cfg: Config,
    has_intensity: bool = False,
    has_color: bool = False,
    microbatch: int = 1,
    *,
    jit: bool = True,
    donate: bool = True,
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

    ``microbatch`` = m > 1: phase A runs over m consecutive scans at once
    (``_Phases.batched``: one row scatter, one K1 launch for the m fields,
    one K4 launch for the m lookups), phase B stays a loop over frames. K
    must be a multiple of m (ValueError otherwise, at the call). As in the
    reference the windowed update is off, m * (num_cells + 1) may not pass
    2^21 (ValueError), and a configuration without a batched phase A (not
    rows mode, or the sampled raycast) runs with m = 1 and a warning. The
    map equals the one-scan loop's on every layer.

    ``jit`` / ``donate`` as in ``build_integrate``: one CUDA graph per (K,
    N, channels) holds the whole K-scan call, the counterpart of the
    reference's jitted ``lax.scan`` over the K frames.
    """
    if microbatch < 1:
        raise ValueError("microbatch must be >= 1")
    if microbatch > 1:
        ph = _phases_of(geom, cfg, device, step_kwargs, window_update=False)
        if microbatch * (geom.num_cells + 1) > (1 << 21):
            raise ValueError(
                f"microbatch={microbatch} over {geom.num_cells} cells would build a "
                "scatter table past the reference's budget of 2^21 rows; reduce "
                "microbatch or the map size"
            )
        if ph.batched is not None:
            return _compiled(_replay_in_chunks(geom, cfg, ph, microbatch), jit, donate)
        log.warning(
            "microbatch=%d needs the 'rows' scatter path (without the sampled "
            "raycast method); running phase A scan by scan.", microbatch,
        )
    step = build_integrate(
        geom, cfg, has_intensity, has_color, jit=False, device=device, **step_kwargs
    ).fn  # on the state the sequence owns

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

    return _compiled(integrate_sequence, jit, donate)


def build_integrate_fused(
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
    *,
    jit: bool = True,
    donate: bool = True,
    device="cuda",
):
    """The K-fused replay step (the reference's ``build_integrate_fused``):
    phase A of all K scans of a call as one batch, then phase B frame by
    frame. Same signature and map as ``build_integrate_sequence``, with the
    windowed update off. In rows mode phase A is ``_Phases.batched`` (one
    row scatter, one K1 and one K4 launch for the K scans); in the other
    modes, and with the sampled raycast, it runs scan by scan before the
    first update. ``jit`` / ``donate`` as in ``build_integrate_sequence``."""
    ph = _phases_of(geom, cfg, device, dict(
        ray_num_azimuth=ray_num_azimuth, ray_range_bin_factor=ray_range_bin_factor,
        ray_max_range=ray_max_range, ray_exact_window=ray_exact_window,
        scatter_mode=scatter_mode, voxel_count_mode=voxel_count_mode,
    ), window_update=False)
    return _compiled(_replay_in_chunks(geom, cfg, ph, None), jit, donate)


class DeviceMap:
    """A one-device facade's map and step, by the rules of ``FastDEM``'s
    docstring: the facade's one way to its map (a mesh's map is the
    subclass ``parallel.sharding.MeshMap``, which the mesh makes).
    ``begin`` / ``end`` / ``check`` frame an ``integrate_sequence`` call."""

    def __init__(self, geom: GridGeometry, cfg: Config, position, has_intensity: bool,
                 has_color: bool, device: torch.device):
        self.geom, self.device = geom, device
        self.has_intensity, self.has_color = has_intensity, has_color
        self._state = create_map_state(geom, cfg, position, has_intensity, has_color,
                                       device=device)
        self.step = None

    def compile(self, cfg: Config, margin: float):
        """The step for ``cfg``, compiled and donating the map."""
        return build_integrate(
            self.geom, cfg, self.has_intensity, self.has_color, window_margin=margin,
            jit=True, donate=True, device=self.device,
        )

    def rebuild(self, cfg: Config, step) -> None:
        """``step`` (made for ``cfg``) in place of the old one, whose graphs
        go now; layers ``cfg`` adds are filled, the others kept."""
        if isinstance(self.step, graphs.CompiledStep):
            self.step.clear()
        self.step = step
        st = self._state
        new = missing_layers(st.layers, cfg, self.has_intensity, self.has_color,
                             self.geom.shape, self.device)
        self._state = GridMapState(layers={**st.layers, **new}, position=st.position)

    def scan(self, *inputs) -> IntegrateAux:
        """One step on the map (the step's arguments after the state)."""
        self._state, aux = self.step(self._state, *inputs)
        return aux

    @property
    def state(self) -> GridMapState:
        st = self._state
        return GridMapState(layers={k: v.clone() for k, v in st.layers.items()},
                            position=st.position.clone())

    @state.setter
    def state(self, value: GridMapState) -> None:
        self._state = value

    def live_state(self) -> GridMapState:
        return self._state

    def reset(self) -> None:
        if isinstance(self.step, graphs.CompiledStep) and self.step.holds(self._state):
            for v in self._state.layers.values():
                v.fill_(np.nan)
            return
        self._state = gridmap.clear_all(self._state)

    def begin(self, *counts) -> None:
        """One device: a call is checked against no other process."""

    end = begin  # end(scans, resets)

    def check(self):
        raise ValueError("mesh_check needs a facade built with mesh=")


class FastDEM:
    """Host-side facade: owns the map state on ``device`` and the step.

    Not thread-safe, like the reference.

    The step is compiled and donates its state, as the reference's jitted
    step would with ``donate_argnums``: on the card the map lives in the
    step's CUDA graph slots and each scan updates it there, with no copy of
    the map into the graph or out of it. ``state`` hands out a copy, so a
    value a caller holds never changes under later scans; a value set to
    ``state`` is kept as given and copied into the slots by the next scan;
    ``reset()`` clears the slots in place. ``live_state()`` is the map
    itself, for a reader that cannot race a scan (the node's timers).

    ``mesh`` (a ``parallel.sharding.BlockMesh``, e.g. ``make_global_mesh()``
    after ``parallel.distributed.init_distributed``): the map is held as
    the mesh's blocks, this process's on ``device`` (one of the mesh's
    devices here), and every scan runs ``build_sharded_integrate``'s step,
    compiled and donating its state (the blocks are the graphs' slots,
    updated in place; ``state`` hands out clones). Every rank is fed the
    same scans. On a mesh of several processes each ``integrate_sequence``
    call ends with one collective (``parallel.distributed.CallSync``), and
    the next call checks that every rank held the same scans. The aux has
    no per-cell observations (``aux.obs`` None), so ``on_rasterized`` is
    not served, and the node's ``run_postprocess`` raises
    NotImplementedError: a sharded map's chain is
    ``parallel.sharding.sharded_postprocess``.
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
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.geom = geom
        self.cfg = cfg or Config()
        self.frame_id = frame_id
        self.has_intensity = has_intensity
        self.has_color = has_color
        # Compact and re-pad scans to the capacity ladder when their valid
        # count sits well below capacity (see integrate()).
        self.auto_bucket = auto_bucket
        self._resets = 0
        # Base->sensor translation allowance baked into the update-window
        # and polar-field bounds; widened (with a step rebuild) when a
        # larger extrinsic shows up.
        self._window_margin = 2.0
        # Every this many scans, read the out-of-window point count back
        # (one host sync) as a backstop for what the extrinsic guard in
        # integrate() cannot see.
        self._oow_check_every = 64
        self._scan_counter = 0
        # A CUDA facade's scan inputs go through pinned buffers (_stage).
        self._ring = staging.StagingRing(self.device) if self.device.type == "cuda" else None
        new_map = DeviceMap if mesh is None else mesh.make_map
        self._map = new_map(geom, self.cfg, position, has_intensity, has_color, self.device)
        self._rebuild()
        self.calibration = None  # provider with get_extrinsic(frame_id)
        self.odometry = None  # provider with get_pose_at(timestamp_ns)
        self.on_preprocessed = None
        self.on_rasterized = None
        self.last_aux: Optional[IntegrateAux] = None

    @property
    def state(self):
        """The map: a ``GridMapState``, or with a mesh a ``ShardedState`` of
        this process's blocks, cloned (the step updates its own in place)."""
        return self._map.state

    @state.setter
    def state(self, value) -> None:
        self._map.state = value

    def live_state(self):
        """The map itself, not a copy: on the card, the tensors the next
        scan updates in place. For a reader that holds the lock every
        ``integrate`` of this facade runs under (``runtime.MappingDriver``'s)
        and enqueues its device reads on the current stream, or finishes
        them, before it lets the lock go. Every other reader takes
        ``state``."""
        return self._map.live_state()

    # The map's step, which ``chip_smoke.py`` reads and swaps.
    _step = property(lambda self: self._map.step,
                     lambda self, step: setattr(self._map, "step", step))

    # -- fluent setters: each rebuilds the step ------------------------------
    def _build_step(self):
        """The map's step for ``cfg`` and the margin (``port_bench`` wraps it)."""
        return self._map.compile(self.cfg, self._window_margin)

    def _rebuild(self):
        self._map.rebuild(self.cfg, self._build_step())

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
        """Clear every layer to NaN: in place where the map is the step's
        own (a mesh's blocks, the graph's slots), else into new tensors, so
        a value set to ``state`` is never written."""
        self._resets += 1
        self._map.reset()

    # -- integration ---------------------------------------------------------
    def integrate(self, cloud, T_base_sensor=None, T_world_base=None) -> bool:
        """Integrate one scan. With explicit transforms the cloud is taken
        as given; without, the providers are queried. Returns False and
        drops the scan on any failure, like the reference.

        On a CUDA facade the inputs go through a ring of pinned buffers
        (``staging.StagingRing``): a host cloud's points, mask and the
        channels the step reads, padded on the host to the step's capacity,
        and the transforms as host f32, in one asynchronous copy on the
        current stream; of a cloud already on a device only the transforms
        (a pose given as a CUDA tensor stays there). The call blocks only
        where the ring's next buffer is still being copied from, which
        bounds how far the host runs ahead of the device, and every 64th
        scan, on the out-of-window check. A CPU facade copies and pads as
        the reference does.

        Spans: ``facade.integrate`` (a new scan id unless the caller's
        thread carries one) around ``facade.prep`` (provider lookups, the
        bucket, the staging or the copy to the device and the pad, the
        transforms; ``facade.stage_wait`` inside it where the buffer was in
        flight), the step's ``step.call``, and ``facade.callbacks`` (the
        aux's trim, the out-of-window check and the observation
        callbacks). Counters: ``facade.staged`` (scans whose inputs went
        through the ring), ``facade.stage_waits`` (scans that waited for
        their buffer: the device set the pace)."""
        h = tracing.begin_scan(_INTEGRATE)
        try:
            sp = tracing.begin(_PREP)
            prepared = self._prepare(cloud, T_base_sensor, T_world_base)
            tracing.end(sp)
            if prepared is None:
                return False
            cloud, stepped, T_bs, T_wb, intensity, color_packed = prepared
            aux = self._map.scan(stepped.xyz, stepped.mask, T_bs, T_wb, intensity, color_packed)
            sp = tracing.begin(_CALLBACKS)
            self._finish(cloud, stepped, aux)
            tracing.end(sp)
            return True
        finally:
            tracing.end_scan(h)

    def _prepare(self, cloud, T_base_sensor, T_world_base):
        """The step's inputs on the device, or None when the scan is
        dropped: through the pinned ring on a CUDA facade (``_stage``),
        else copied and padded on the device."""
        if T_base_sensor is None or T_world_base is None:
            if not self.has_transform_provider():
                log.error(
                    "[FastDEM] Transform providers not set; use explicit "
                    "transforms or set providers first."
                )
                return None
            if cloud is None or cloud.empty():
                log.warning("[FastDEM] Received empty or null cloud. Skipping...")
                return None
            if not cloud.frame_id:
                log.error("[FastDEM] Input cloud has no frameId. Skipping...")
                return None
            T_base_sensor = self.calibration.get_extrinsic(cloud.frame_id)
            if T_base_sensor is None:
                log.warning(
                    "[FastDEM] Calibration not available for '%s'. Skipping...",
                    cloud.frame_id,
                )
                return None
            T_world_base = self.odometry.get_pose_at(cloud.timestamp_ns)
            if T_world_base is None:
                log.warning(
                    "[FastDEM] Odometry not available at %d. Skipping...",
                    cloud.timestamp_ns,
                )
                return None
        elif cloud is None or cloud.empty():
            log.warning("[FastDEM] Received empty cloud. Skipping...")
            return None

        if (
            self.auto_bucket
            and cloud.valid_count >= 0
            and pc.ladder_capacity(cloud.valid_count) < cloud.capacity * 0.75
        ):
            cloud = pc.compact_to_bucket(cloud)
        # The compiled step holds a graph per scan size: padding at the tail
        # to a power of two bounds them to one per doubling. The padding is
        # masked out, keeps the points' indices and, being at most the next
        # power of two, the rasterizer's argmin index width, so the map is
        # the unpadded scan's bit for bit.
        cap = pc.ladder_capacity(cloud.capacity, base=1)

        T_bs_host = _host_f32(T_base_sensor)
        self._guard_margin(T_bs_host)
        stepped = None
        if self._ring is not None:
            stepped, T_bs, T_wb = self._stage(cloud, cap, T_bs_host, T_world_base)
        else:
            T_bs = torch.as_tensor(T_bs_host, device=self.device)
            T_wb = torch.as_tensor(T_world_base, dtype=torch.float32, device=self.device)
        if stepped is None:
            if cloud.device != self.device:
                cloud = cloud.to(self.device)
            stepped = pc.pad_to(cloud, cap)

        intensity = stepped.channels.get("intensity") if self.has_intensity else None
        color_packed = None
        if self.has_color and "color" in stepped.channels:
            color_packed = pack_rgb(stepped.channels["color"])
        return cloud, stepped, T_bs, T_wb, intensity, color_packed

    def _stage(self, cloud, cap, T_bs_host, T_world_base):
        """A CUDA facade's inputs through its pinned ring
        (``staging.StagingRing``), in one asynchronous copy: the transforms
        as host f32 (a pose given as a CUDA tensor stays on the device) and
        a host cloud's points, mask and the channels the step reads, padded
        on the host to ``cap`` as ``pad_to`` pads. Returns (the padded
        cloud, or None for a cloud on a device, T_bs, T_wb)."""
        parts = {"T_bs": staging.Part(T_bs_host, T_bs_host.shape[0])}
        pose_on_device = isinstance(T_world_base, torch.Tensor) and T_world_base.is_cuda
        if not pose_on_device:
            T_wb_host = _host_f32(T_world_base)
            parts["T_wb"] = staging.Part(T_wb_host, T_wb_host.shape[0])
        host_cloud = cloud.device.type == "cpu"
        if host_cloud:
            used = [k for k, on in (("intensity", self.has_intensity),
                                    ("color", self.has_color)) if on and k in cloud.channels]
            parts["xyz"] = staging.Part(cloud.xyz.numpy(), cap, 1e9)
            parts["mask"] = staging.Part(cloud.mask.numpy(), cap, False)
            for k in used:
                parts[k] = staging.Part(cloud.channels[k].numpy(), cap)
        got = self._ring.put(parts)
        stepped = None
        if host_cloud:
            stepped = dataclasses.replace(
                cloud, xyz=got["xyz"], mask=got["mask"],
                channels={k: got[k] for k in used},
            )
        T_wb = (torch.as_tensor(T_world_base, dtype=torch.float32, device=self.device)
                if pose_on_device else got["T_wb"])
        return stepped, got["T_bs"], T_wb

    def _finish(self, cloud, stepped, aux) -> None:
        """After the step: the aux trimmed to the scan, the out-of-window
        backstop, the observation callbacks."""
        if stepped.capacity != cloud.capacity:
            n = cloud.capacity
            aux = dataclasses.replace(aux, world_xyz=aux.world_xyz[:n],
                                      world_mask=aux.world_mask[:n], z_var=aux.z_var[:n])
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

        This is JAX's ``integrate`` loop, not JAX's ``integrate_sequence``,
        and deliberately so. The reference's batched call pads every cloud
        of a call to one ``bucket_capacity`` (so a small scan beside a large
        one gets the large one's z quantum in the rasterizer), uses a
        channel only when every cloud carries it, and skips the margin
        guard, ``last_aux`` and the callbacks. The port does none of that:
        on mixed-size or mixed-channel calls its map equals JAX's loop
        (``tests/test_torch_replay.py::
        test_facade_sequence_mixed_sizes_against_jax_loop``) and differs
        from JAX's ``integrate_sequence``.

        Transforms follow ``integrate``'s rule: explicit mode needs BOTH
        ``T_base_sensor`` (one 4x4 or one per cloud) and ``T_world_base``
        (one per cloud); otherwise the providers are queried per cloud and
        a failed lookup drops that scan. ``batch`` is the reference's count
        of frames per compiled call; here each scan replays the step's CUDA
        graph of its capacity rounded up to a power of two
        (``build_integrate(jit=True)``, see ``integrate``), so the value is
        only checked. Returns the number of scans integrated.

        On a mesh of several processes every rank makes the same calls with
        the same scans. The call first checks the previous call's
        collective (``mesh_check``) and ends by enqueuing its own, which
        carries the scans this rank has integrated and its resets.
        """
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self._map.begin()
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
        done = sum(self.integrate(c, b, w) for c, b, w in zip(clouds, tbs, twb))
        self._map.end(self._scan_counter, self._resets)
        return done

    def mesh_check(self):
        """A mesh facade: the agreement of the last ``integrate_sequence``
        call (``parallel.distributed.Agreement``: the scans every rank had
        integrated, the resets), its collective waited for and checked
        first where it has not been; RuntimeError, on every rank, where the
        ranks' scans differ."""
        return self._map.check()

    def rasterized_cloud(self, aux: IntegrateAux):
        """One point per touched cell at (cell center, min_z)."""
        if aux.obs is None:
            raise NotImplementedError("a mesh facade's aux has no per-cell observations")
        x, y = self.geom.cell_centers(self._map.live_state().position)
        return x, y, aux.obs.min_z, aux.obs.touched


def _host_f32(T) -> np.ndarray:
    """A transform (numpy, a tensor on any device, or a list or tuple of
    either) as host f32."""
    if isinstance(T, torch.Tensor):
        T = T.detach().cpu()
    elif isinstance(T, (list, tuple)):
        T = [t.detach().cpu() if isinstance(t, torch.Tensor) else t for t in T]
    return np.asarray(T, dtype=np.float32)
