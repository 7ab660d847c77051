"""Carry the map state across packages.

The system has no weights: its carried state is the map, the layer arrays
plus the map center. ``state_from_numpy`` takes that state as numpy arrays
(for example ``{k: np.asarray(v) for k, v in jax_state.layers.items()}``
and ``np.asarray(jax_state.position)`` from the JAX package) and puts it on
a device; ``state_to_numpy`` gives it back as numpy arrays. A session can
thus start in one package and continue in the other.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.grid.gridmap import GridMapState


def state_from_numpy(
    layers: Mapping[str, np.ndarray], position, device="cuda"
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


def to_host(arrays: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """Several tensors (or numpy arrays) as numpy arrays, in one read: the
    copies from a CUDA device are queued into pinned host buffers without
    waiting, and the stream is synchronised once for all of them. Host
    arrays pass through."""
    out = {}
    streams = set()
    for name, v in arrays.items():
        if not isinstance(v, torch.Tensor):
            out[name] = np.asarray(v)
            continue
        v = v.detach()
        if v.device.type == "cuda":
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v, non_blocking=True)
            streams.add(torch.cuda.current_stream(v.device))
            v = buf
        out[name] = v
    for stream in streams:
        stream.synchronize()
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def host_state(
    state, names: Optional[Iterable[str]] = None
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The layers ``names`` (all by default, in the state's order) and the
    position of a map state as host numpy arrays, read in one go (see
    ``to_host``). Every host-side reader of a map (IO, bridge, wire, the
    driver's publishers) goes through here."""
    keys = list(state.layers) if names is None else [n for n in names if n in state.layers]
    arrays = {("layer", k): state.layers[k] for k in keys}
    arrays[("position",)] = state.position
    host = to_host(arrays)
    return {k: host[("layer", k)] for k in keys}, host[("position",)]


def state_to_numpy(state: GridMapState) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """GridMapState -> ({name: f32[H, W]}, f32[2] position) on the host."""
    return host_state(state)
