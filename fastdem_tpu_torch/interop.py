"""Carry the map state across packages.

The system has no weights: its carried state is the map, the layer arrays
plus the map center. ``state_from_numpy`` takes that state as numpy arrays
(for example ``{k: np.asarray(v) for k, v in jax_state.layers.items()}``
and ``np.asarray(jax_state.position)`` from the JAX package) and puts it on
a device; ``state_to_numpy`` gives it back as numpy arrays. A session can
thus start in one package and continue in the other.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.grid.gridmap import GridMapState


def state_from_numpy(
    layers: Mapping[str, np.ndarray], position, device
) -> GridMapState:
    """Numpy layers {name: f32[H, W]} and an f32[2] position -> GridMapState
    on ``device`` (the arrays are copied)."""
    dev = resolve_device(device)
    shapes = {np.shape(v) for v in layers.values()}
    if len(shapes) > 1:
        raise ValueError(f"layers differ in shape: {sorted(shapes)}")
    lyr = {
        name: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
        for name, v in layers.items()
    }
    pos = np.asarray(position, dtype=np.float32).reshape(2)
    return GridMapState(layers=lyr, position=torch.tensor(pos, device=dev))


def state_to_numpy(state: GridMapState) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """GridMapState -> ({name: f32[H, W]}, f32[2] position) on the host."""
    layers = {k: v.detach().cpu().numpy() for k, v in state.layers.items()}
    return layers, state.position.detach().cpu().numpy()
