"""Rigid transforms of points (frozen copy of the port's
``cloud/transform.py::transform_points``). Transforms are f32[4, 4]."""

from __future__ import annotations

import torch


def transform_points(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply T to f32[N, 3] points: R @ p + t."""
    return xyz @ T[:3, :3].T + T[:3, 3]
