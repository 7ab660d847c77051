"""Dense multi-layer grid map state (port of ``fastdem_tpu/grid/gridmap.py``).

``GridMapState`` holds ``{layer name: f32[H, W]}`` plus the f32[2] map
center, all on one device. Unmeasured cells hold NaN. Every op returns a
new state and leaves its input unchanged, like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .device import resolve_device
from .numerics import recip_f32
from .geometry import GridGeometry


class layers:
    """Canonical layer name constants."""

    elevation = "elevation"
    elevation_min = "elevation_min"
    elevation_max = "elevation_max"
    variance = "variance"
    n_points = "n_points"
    upper_bound = "upper_bound"
    lower_bound = "lower_bound"

    # Per-frame layers
    obstacle = "obstacle"
    intensity = "intensity"
    color = "color"

    # Post-processing layers
    elevation_inpainted = "elevation_inpainted"
    ghost_removal = "ghost_removal"
    raycasting = "raycasting"
    visibility_logodds = "_visibility_logodds"
    step = "step"
    slope = "slope"
    roughness = "roughness"
    curvature = "curvature"
    normal_x = "_normal_x"
    normal_y = "_normal_y"
    normal_z = "_normal_z"

    # Kalman estimator internals
    kalman_p = "_kalman_p"
    sample_mean = "_sample_mean"
    sample_m2 = "_sample_m2"

    # P2 quantile estimator internals
    p2_q = ("_p2_q0", "_p2_q1", "_p2_q2", "_p2_q3", "_p2_q4")
    p2_n = ("_p2_n0", "_p2_n1", "_p2_n2", "_p2_n3", "_p2_n4")


@dataclasses.dataclass
class GridMapState:
    """Per-frame map state.

    Attributes:
      layers: name -> f32[rows, cols].
      position: f32[2] world coordinates of the map center.
    """

    layers: Dict[str, torch.Tensor]
    position: torch.Tensor

    def get(self, name: str) -> torch.Tensor:
        return self.layers[name]

    def has(self, name: str) -> bool:
        return name in self.layers

    def replace_layer(self, name: str, value: torch.Tensor) -> "GridMapState":
        new = dict(self.layers)
        new[name] = value
        return GridMapState(layers=new, position=self.position)

    def replace_layers(self, updates: Mapping[str, torch.Tensor]) -> "GridMapState":
        new = dict(self.layers)
        new.update(updates)
        return GridMapState(layers=new, position=self.position)


def create(
    geom: GridGeometry,
    layer_fills: Mapping[str, float],
    position: Sequence[float] = (0.0, 0.0),
    *,
    device="cuda",
) -> GridMapState:
    """Allocate a map on ``device`` with each layer filled with a constant."""
    dev = resolve_device(device)
    lyr = {
        name: torch.full(geom.shape, fill, dtype=torch.float32, device=dev)
        for name, fill in layer_fills.items()
    }
    pos = torch.as_tensor(
        np.asarray(position, dtype=np.float32), device=dev
    ).clone()
    return GridMapState(layers=lyr, position=pos)


def default_layer_fills() -> Dict[str, float]:
    """The three always-present layers."""
    return {
        layers.elevation: np.nan,
        layers.elevation_min: np.nan,
        layers.elevation_max: np.nan,
    }


def clear_all(state: GridMapState) -> GridMapState:
    """Reset every layer to NaN."""
    return GridMapState(
        layers={k: torch.full_like(v, np.nan) for k, v in state.layers.items()},
        position=state.position,
    )


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``std::round`` semantics: ties round away from zero (``torch.round``
    rounds half to even). The sign is copied, so -0.0 stays -0.0."""
    return torch.copysign(torch.floor(torch.abs(x) + 0.5), x)


def move(
    geom: GridGeometry, state: GridMapState, new_center: torch.Tensor
) -> GridMapState:
    """Shift the map so its center tracks ``new_center`` (LOCAL mode).

    The center snaps to whole-cell offsets k = round(delta / res) and cells
    that enter the map are cleared to NaN: new[r, c] = old[r - kr, c - kc].

    The shift is a device tensor, so the roll is a gather with the index
    vectors ``(arange - k) mod n`` built on the device: the same data
    movement as a roll, with no host sync to read k.
    """
    res = geom.resolution
    delta = round_half_away(
        (new_center - state.position) * recip_f32(res)
    ).to(torch.int32)
    kr, kc = delta[0], delta[1]

    dev = state.position.device
    rr = torch.arange(geom.rows, dtype=torch.int32, device=dev)
    cc = torch.arange(geom.cols, dtype=torch.int32, device=dev)
    row_invalid = (rr < kr) | (rr >= geom.rows + kr)
    col_invalid = (cc < kc) | (cc >= geom.cols + kc)
    invalid = row_invalid[:, None] | col_invalid[None, :]
    src_r = torch.remainder(rr - kr, geom.rows).long()
    src_c = torch.remainder(cc - kc, geom.cols).long()

    def shift(a: torch.Tensor) -> torch.Tensor:
        rolled = a.index_select(0, src_r).index_select(1, src_c)
        return torch.where(invalid, np.nan, rolled)

    new_layers = {k: shift(v) for k, v in state.layers.items()}
    new_position = state.position + delta.to(torch.float32) * res
    return GridMapState(layers=new_layers, position=new_position)


