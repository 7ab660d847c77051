"""Pose arithmetic of the benchmark's trajectories.

``interpolate`` is the odometry buffer's lookup between two timestamped
poses (the quaternion slerp of the reference node's TF bridge, as the
port's ``runtime/providers.py::TransformBuffer`` computes it), copied here
so that the poses a scan is generated and checked with are the benchmark's
own: the node looks them up in its buffer, the replay loop and the
reference are handed them.
"""

from __future__ import annotations

import numpy as np


def pose_from_quat(x, y, z, qw, qx, qy, qz) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )
    T[:3, 3] = (x, y, z)
    return T


def quat_from_pose(T) -> np.ndarray:
    R = T[:3, :3]
    tr = np.trace(R)
    qw = np.sqrt(max(0.0, 1 + tr)) / 2
    qx = np.sqrt(max(0.0, 1 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    qy = np.sqrt(max(0.0, 1 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    qz = np.sqrt(max(0.0, 1 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    qx = np.copysign(qx, R[2, 1] - R[1, 2])
    qy = np.copysign(qy, R[0, 2] - R[2, 0])
    qz = np.copysign(qz, R[1, 0] - R[0, 1])
    return np.array([qw, qx, qy, qz])


def interpolate(T0: np.ndarray, T1: np.ndarray, alpha: float) -> np.ndarray:
    """The pose at ``alpha`` in [0, 1] between two float64 poses, float32."""
    q0 = quat_from_pose(T0)
    q1 = quat_from_pose(T1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = np.clip(abs(np.dot(q0, q1)), -1.0, 1.0)
    theta = np.arccos(d)
    if np.sin(theta) > 1e-6:
        w0 = np.sin((1 - alpha) * theta) / np.sin(theta)
        w1 = np.sin(alpha * theta) / np.sin(theta)
    else:
        w0, w1 = 1 - alpha, alpha
    q = w0 * q0 + w1 * q1
    q = q / np.linalg.norm(q)
    t = (1 - alpha) * T0[:3, 3] + alpha * T1[:3, 3]
    return pose_from_quat(t[0], t[1], t[2], q[0], q[1], q[2], q[3])


def lookup(times_ns, poses, t_ns: int) -> np.ndarray:
    """The pose at ``t_ns`` from sorted odometry samples that bracket it,
    with the buffer's interpolation weight (integer nanoseconds)."""
    i = int(np.searchsorted(times_ns, t_ns, side="left"))
    if not 0 < i < len(times_ns):
        raise ValueError("the odometry samples do not bracket the scan time")
    t0, t1 = int(times_ns[i - 1]), int(times_ns[i])
    return interpolate(poses[i - 1], poses[i], (t_ns - t0) / (t1 - t0))


def rpy_matrix(roll: np.ndarray, pitch: np.ndarray, yaw: np.ndarray) -> np.ndarray:
    """Rotations Rz(yaw) Ry(pitch) Rx(roll), float64 [n, 3, 3]."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.empty(roll.shape + (3, 3))
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R
