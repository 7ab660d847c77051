"""Application-edge bridges (port of ``fastdem_tpu/runtime/bridge.py``):
map -> structured cloud / grid message / normal markers / boundary.

The reference's bridge payloads as plain numpy structures, so any
transport can wrap them. Internal ('_'-prefixed) layers are left out,
color unpacks from the packed-float convention, and submap regions are
supported. Each function reads the layers it needs from the device once
(``interop.host_state``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.grid import gridmap as gm
from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.grid.gridmap import layers
from fastdem_tpu_torch.interop import host_state
from fastdem_tpu_torch.utils.colors import unpack_rgb


def host_cell_centers(geom: GridGeometry, position: np.ndarray):
    """World x / y of every cell centre (f32[rows, cols] each) for a host
    position, by the geometry's own f32 arithmetic on the CPU."""
    x, y = geom.cell_centers(torch.from_numpy(np.asarray(position, dtype=np.float32)))
    return x.numpy(), y.numpy()


def to_structured_cloud(
    geom: GridGeometry,
    state,
    elevation_layer: str = layers.elevation,
    submap: Optional[Tuple[slice, slice]] = None,
) -> np.ndarray:
    """Map -> numpy structured array (the PointCloud2 payload equivalent).

    One record per finite-elevation cell: x, y, z plus one float field per
    non-internal layer, and u8 r/g/b when a color layer exists.
    """
    float_layers = [
        name
        for name in state.layers
        if not gm.is_internal(name) and name not in (elevation_layer, layers.color)
    ]
    has_color = layers.color in state.layers
    lyr, position = host_state(
        state, [elevation_layer] + float_layers + ([layers.color] if has_color else [])
    )
    rs = submap[0] if submap else slice(None)
    cs = submap[1] if submap else slice(None)
    elev = lyr[elevation_layer][rs, cs]
    x, y = host_cell_centers(geom, position)
    x = x[rs, cs]
    y = y[rs, cs]
    finite = np.isfinite(elev)

    fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    fields += [(name, np.float32) for name in float_layers]
    if has_color:
        fields += [("r", np.uint8), ("g", np.uint8), ("b", np.uint8)]

    out = np.zeros(int(finite.sum()), dtype=np.dtype(fields))
    out["x"] = x[finite]
    out["y"] = y[finite]
    out["z"] = elev[finite]
    for name in float_layers:
        out[name] = lyr[name][rs, cs][finite]
    if has_color:
        packed = lyr[layers.color][rs, cs][finite]
        rgb = unpack_rgb(np.nan_to_num(packed))
        out["r"], out["g"], out["b"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    return out


def to_grid_message(
    geom: GridGeometry,
    state,
    frame_id: str = "map",
    timestamp_ns: int = 0,
) -> Dict:
    """Map -> dict with geometry metadata and the non-internal layer arrays
    (the grid_map_msgs equivalent)."""
    lyr, position = host_state(state, [k for k in state.layers if not gm.is_internal(k)])
    return {
        "frame_id": frame_id,
        "timestamp_ns": timestamp_ns,
        "resolution": geom.resolution,
        "size": (geom.rows, geom.cols),
        "length": geom.length,
        "position": np.asarray(position, dtype=np.float64),
        "layers": lyr,
    }


def to_normal_markers(
    geom: GridGeometry,
    state,
    arrow_length: float = 0.15,
    stride: int = 1,
    max_slope_deg: float = 45.0,
) -> Dict[str, np.ndarray]:
    """Surface-normal line segments colored by slope: from each cell centre
    along its normal, the color ramping green -> red over [0,
    max_slope_deg].

    Returns {'starts' f32[M,3], 'ends' f32[M,3], 'colors' f32[M,3]}.
    """
    req = (layers.elevation, layers.normal_x, layers.normal_y, layers.normal_z)
    if not all(k in state.layers for k in req):
        return {
            "starts": np.zeros((0, 3), np.float32),
            "ends": np.zeros((0, 3), np.float32),
            "colors": np.zeros((0, 3), np.float32),
        }
    lyr, position = host_state(state, req + (layers.slope,))
    elev = lyr[layers.elevation][::stride, ::stride]
    nx = lyr[layers.normal_x][::stride, ::stride]
    ny = lyr[layers.normal_y][::stride, ::stride]
    nz = lyr[layers.normal_z][::stride, ::stride]
    x, y = host_cell_centers(geom, position)
    x = x[::stride, ::stride]
    y = y[::stride, ::stride]
    ok = np.isfinite(elev) & np.isfinite(nx) & np.isfinite(ny) & np.isfinite(nz)

    starts = np.column_stack([x[ok], y[ok], elev[ok]]).astype(np.float32)
    normals = np.column_stack([nx[ok], ny[ok], nz[ok]]).astype(np.float32)
    ends = starts + arrow_length * normals

    if layers.slope in lyr:
        slope = lyr[layers.slope][::stride, ::stride][ok]
    else:
        slope = np.degrees(np.arccos(np.clip(np.abs(normals[:, 2]), 0, 1)))
    t = np.clip(np.nan_to_num(slope) / max_slope_deg, 0.0, 1.0)
    colors = np.column_stack([t, 1.0 - t, np.zeros_like(t)]).astype(np.float32)
    return {"starts": starts, "ends": ends, "colors": colors}


def to_map_boundary(geom: GridGeometry, state) -> np.ndarray:
    """Closed polygon of the map bounds, f32[5, 2] world xy."""
    pos = np.asarray(host_state(state, [])[1], dtype=np.float64)
    hx = 0.5 * geom.rows * geom.resolution
    hy = 0.5 * geom.cols * geom.resolution
    return np.array(
        [
            [pos[0] + hx, pos[1] + hy],
            [pos[0] + hx, pos[1] - hy],
            [pos[0] - hx, pos[1] - hy],
            [pos[0] - hx, pos[1] + hy],
            [pos[0] + hx, pos[1] + hy],
        ],
        dtype=np.float32,
    )
