"""SE(3) transforms for point clouds (port of ``fastdem_tpu/cloud/transform.py``).
Transforms are f32[4, 4] tensors.

``transform_cloud`` rotates points and normals but not the covariance
channel, as the reference's ``transformCloud`` does; covariances rotate
through ``rotate_covariances`` where a caller asks for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.numerics import sqrt_f32, sum_sq


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


def from_rpy(roll: float, pitch: float, yaw: float, t=(0.0, 0.0, 0.0), *,
             device="cuda") -> torch.Tensor:
    """ZYX Euler (yaw-pitch-roll) rotation + translation, on ``device``.
    The matrix is evaluated on the host in float64 and rounded once, so
    every device holds the same bits."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ],
        dtype=np.float64,
    ).astype(np.float32)
    return make_transform(R, np.asarray(t, dtype=np.float32), device=device)


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


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[:3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[:3, 3]


def transform_points(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply T to f32[N, 3] points: R @ p + t."""
    return xyz @ T[:3, :3].T + T[:3, 3]


def transform_cloud(cloud, T: torch.Tensor, frame_id: str | None = None):
    """Transform points and normals (normals are rotated, not translated);
    the covariance channel is left as it is. Optionally sets the frame."""
    new = dataclasses.replace(cloud, xyz=transform_points(cloud.xyz, T))
    if "normal" in cloud.channels:
        new = new.with_channel("normal", cloud.channels["normal"] @ T[:3, :3].T)
    if frame_id is not None:
        new = new.with_frame(frame_id)
    return new


def rotate_covariances(cov: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Batched R @ Sigma @ R^T for f32[N, 3, 3]."""
    return torch.einsum("ij,njk,lk->nil", R, cov, R)


# -- Lie helpers (deskew interpolation, registration) --------------------


def _norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm as the reference's compiled ``linalg.norm``: the
    squares accumulated by FMAs, a correctly rounded sqrt."""
    out = sqrt_f32(sum_sq(v, dim))
    return out.unsqueeze(dim) if keepdim else out


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z); branch-free
    Shepperd variant."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    zero = torch.zeros((), dtype=R.dtype, device=R.device)
    qw = sqrt_f32(torch.maximum(zero, 1.0 + tr)) / 2.0
    qx = sqrt_f32(torch.maximum(zero, 1.0 + m00 - m11 - m22)) / 2.0
    qy = sqrt_f32(torch.maximum(zero, 1.0 - m00 + m11 - m22)) / 2.0
    qz = sqrt_f32(torch.maximum(zero, 1.0 - m00 - m11 + m22)) / 2.0
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qw, qx, qy, qz])
    return q / _norm(q)


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) (w, x, y, z) f32[..., 4] -> f32[..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation; ``t`` may be a vector (returns [T, 4])."""
    d = torch.sum(q0 * q1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    t = torch.atleast_1d(torch.as_tensor(t, dtype=q0.dtype, device=q0.device))[:, None]
    # Lerp for nearly parallel quaternions.
    w0 = torch.where(sin_theta > 1e-6, torch.sin((1 - t) * theta) / sin_theta, 1 - t)
    w1 = torch.where(sin_theta > 1e-6, torch.sin(t * theta) / sin_theta, t)
    q = w0 * q0[None, :] + w1 * q1[None, :]
    return q / _norm(q, keepdim=True)


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle 3-vector -> rotation matrix (first order near
    zero)."""
    theta = _norm(omega)
    small = theta < 1e-8
    k = omega / torch.where(small, torch.ones_like(theta), theta)
    K = _hat(k)
    eye = torch.eye(3, dtype=torch.float32, device=omega.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(small, eye + _hat(omega), R)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (tx, ty, tz, wx, wy, wz) -> 4x4 transform (rotation about the
    origin, translation added directly: the registration solver's update
    convention)."""
    T = torch.eye(4, dtype=torch.float32, device=xi.device)
    T[:3, :3] = so3_exp(xi[3:])
    T[:3, 3] = xi[:3]
    return T


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector."""
    cos_theta = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    scale = torch.where(
        torch.abs(sin_theta) > 1e-8,
        theta / (2.0 * sin_theta),
        torch.full_like(theta, 0.5),
    )
    return scale * v
