"""SE(3) transforms for point clouds (port of ``fastdem_tpu/cloud/transform.py``,
the part the facade and the tests use). Transforms are f32[4, 4] tensors.
"""

from __future__ import annotations

import torch

from fastdem_tpu_torch.device import resolve_device


def make_transform(R=None, t=None, *, device="cuda") -> torch.Tensor:
    """Assemble a 4x4 transform from a 3x3 rotation and a translation, on
    ``device`` (the card unless the caller names the CPU)."""
    dev = resolve_device(device)
    T = torch.eye(4, dtype=torch.float32, device=dev)
    if R is not None:
        T[:3, :3] = torch.as_tensor(R, dtype=torch.float32, device=dev)
    if t is not None:
        T[:3, 3] = torch.as_tensor(t, dtype=torch.float32, device=dev)
    return T


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = torch.eye(4, dtype=T.dtype, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti


def compose(*Ts: torch.Tensor) -> torch.Tensor:
    out = torch.eye(4, dtype=torch.float32, device=Ts[0].device if Ts else None)
    for T in Ts:
        out = out @ T
    return out


def transform_points(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply T to f32[N, 3] points: R @ p + t."""
    return xyz @ T[:3, :3].T + T[:3, 3]
