"""Depth images -> point clouds (port of ``fastdem_tpu/cloud/depth.py``).

Back-projects a depth image through the pinhole intrinsics into an
organized cloud in the camera frame (+z forward, +x right, +y down), the
frame the RGB-D sensor model expects.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdem_tpu_torch.cloud.pointcloud import PointCloud
from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.numerics import div_f32


def depth_to_cloud(
    depth,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    rgb=None,
    depth_scale: float = 1.0,
    min_depth: float = 0.0,
    max_depth: float = np.inf,
    stride: int = 1,
    frame_id: str = "camera",
    timestamp_ns: int = 0,
    count_valid: bool = True,
    *,
    device=None,
) -> PointCloud:
    """Back-project a depth image into a camera-frame cloud.

    Args:
      depth: f32 / u16 [H, W] depth image, times ``depth_scale`` in meters
        (0.001 for millimetre u16 sensors); a tensor or a numpy array.
      fx, fy, cx, cy: pinhole intrinsics.
      rgb: optional u8 [H, W, 3] colour image.
      stride: pixel subsampling step.
      device: where the cloud is made; default the tensor's device, or
        the card for a numpy image.

    Returns a cloud of ceil(H / stride) * ceil(W / stride) points; invalid
    depths (<= 0, outside [min_depth, max_depth], non-finite) are masked
    and sit at the 1e9 sentinel. ``count_valid`` reads the valid count to
    the host (one sync), so the facade can compact a heavily masked frame.
    """
    if isinstance(depth, torch.Tensor) and device is None:
        dev = depth.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    if isinstance(depth, np.ndarray) and depth.dtype == np.uint16:
        depth = depth.astype(np.int32)  # torch has no u16 arithmetic
    d = torch.as_tensor(depth, device=dev).to(torch.float32)[::stride, ::stride] * depth_scale
    H, W = d.shape
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :] * stride
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None] * stride
    x = div_f32(u - cx, fx) * d
    y = div_f32(v - cy, fy) * d
    xyz = torch.stack([x, y, d], dim=-1).reshape(-1, 3)
    valid = (
        torch.isfinite(d) & (d > 0.0) & (d >= float(np.float32(min_depth)))
        & (d <= float(np.float32(max_depth)))
    ).reshape(-1)
    xyz = torch.where(valid[:, None], xyz, 1e9)
    channels = {}
    if rgb is not None:
        channels["color"] = torch.as_tensor(rgb, device=dev)[::stride, ::stride].reshape(-1, 3)
    return PointCloud(
        xyz=xyz,
        mask=valid,
        channels=channels,
        frame_id=frame_id,
        timestamp_ns=timestamp_ns,
        valid_count=int(valid.sum()) if count_valid else -1,
    )


def camera_to_base_transform(
    roll: float = -np.pi / 2, pitch: float = 0.0, yaw: float = -np.pi / 2, t=(0.0, 0.0, 0.0)
) -> np.ndarray:
    """Optical frame -> robot base (camera +z forward / +y down onto base +x
    forward / +z up), as host f32[4, 4]."""
    from fastdem_tpu_torch.cloud.transform import from_rpy

    return from_rpy(roll, pitch, yaw, t=t, device="cpu").numpy()
