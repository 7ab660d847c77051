"""Transform providers (port of ``fastdem_tpu/runtime/providers.py``):
the Calibration / Odometry interfaces and their implementations.

Failure is signalled by returning None; the facade drops the scan and
goes on. ``TransformBuffer`` is a host-side time-indexed pose buffer with
interpolation, a staleness bound and an optional latest-pose fallback: the
behaviour of the reference node's TF bridge without ROS. Host numpy only.
"""

from __future__ import annotations

import bisect
import logging
import threading
from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np

log = logging.getLogger("fastdem_tpu_torch.runtime")


class Calibration(Protocol):
    """Sensor extrinsics provider."""

    def get_base_frame(self) -> str: ...

    def get_extrinsic(self, sensor_frame: str) -> Optional[np.ndarray]:
        """T_base_sensor 4x4, or None if unavailable."""
        ...


class Odometry(Protocol):
    """Robot pose provider."""

    def get_world_frame(self) -> str: ...

    def get_pose_at(self, timestamp_ns: int) -> Optional[np.ndarray]:
        """T_world_base 4x4 at the given time, or None."""
        ...


# ---------------------------------------------------------------------------
# Static / mock providers
# ---------------------------------------------------------------------------


class StaticCalibration:
    """Fixed per-frame extrinsics (mock Calibration with failure injection)."""

    def __init__(self, base_frame: str = "base_link"):
        self._base = base_frame
        self._extrinsics: Dict[str, np.ndarray] = {}
        self.fail = False

    def set_extrinsic(self, sensor_frame: str, T: np.ndarray) -> None:
        self._extrinsics[sensor_frame] = np.asarray(T, dtype=np.float32)

    def get_base_frame(self) -> str:
        return self._base

    def get_extrinsic(self, sensor_frame: str) -> Optional[np.ndarray]:
        if self.fail or not sensor_frame:
            return None
        return self._extrinsics.get(sensor_frame)


class StaticOdometry:
    """Fixed pose (mock Odometry with failure injection)."""

    def __init__(self, world_frame: str = "map", T: Optional[np.ndarray] = None):
        self._world = world_frame
        self.pose = np.eye(4, dtype=np.float32) if T is None else np.asarray(T)
        self.fail = False

    def get_world_frame(self) -> str:
        return self._world

    def get_pose_at(self, timestamp_ns: int) -> Optional[np.ndarray]:
        return None if self.fail else self.pose


# ---------------------------------------------------------------------------
# TransformBuffer: tf2-like time-indexed pose store
# ---------------------------------------------------------------------------


class TransformBuffer:
    """Time-indexed pose buffer with interpolation + staleness semantics.

    As the reference's TF bridge: extrinsics are static and cached; poses
    are timestamped; a lookup farther than ``max_stale_time`` from the
    nearest buffered pose fails (warn), optionally falling back to the
    latest pose when ``use_latest_fallback``. ``timestamp_ns == 0`` means
    'latest' and skips the staleness check.
    """

    def __init__(
        self,
        base_frame: str = "base_link",
        world_frame: str = "map",
        max_stale_time: float = 0.1,
        use_latest_fallback: bool = False,
        max_buffer: int = 10000,
    ):
        self._base = base_frame
        self._world = world_frame
        self.max_stale_time = max_stale_time
        self.use_latest_fallback = use_latest_fallback
        self._extrinsics: Dict[str, np.ndarray] = {}
        self._times: List[int] = []
        self._poses: List[np.ndarray] = []
        self._max_buffer = max_buffer
        self._lock = threading.Lock()

    # -- feeding -----------------------------------------------------------
    def set_extrinsic(self, sensor_frame: str, T: np.ndarray) -> None:
        self._extrinsics[sensor_frame] = np.asarray(T, dtype=np.float32)

    def add_pose(self, timestamp_ns: int, T_world_base: np.ndarray) -> None:
        with self._lock:
            i = bisect.bisect_left(self._times, timestamp_ns)
            self._times.insert(i, timestamp_ns)
            self._poses.insert(i, np.asarray(T_world_base, dtype=np.float64))
            if len(self._times) > self._max_buffer:
                del self._times[0], self._poses[0]

    # -- Calibration -------------------------------------------------------
    def get_base_frame(self) -> str:
        return self._base

    def get_extrinsic(self, sensor_frame: str) -> Optional[np.ndarray]:
        if not sensor_frame:
            log.warning("Empty sensor_frame in get_extrinsic()")
            return None
        return self._extrinsics.get(sensor_frame)

    # -- Odometry ----------------------------------------------------------
    def get_world_frame(self) -> str:
        return self._world

    def latest(self) -> Optional[Tuple[int, np.ndarray]]:
        with self._lock:
            if not self._times:
                return None
            return self._times[-1], self._poses[-1]

    def get_pose_at(self, timestamp_ns: int) -> Optional[np.ndarray]:
        with self._lock:
            if not self._times:
                return None
            if timestamp_ns == 0:
                return self._poses[-1].astype(np.float32)
            i = bisect.bisect_left(self._times, timestamp_ns)
            candidates = []
            if i > 0:
                candidates.append(i - 1)
            if i < len(self._times):
                candidates.append(i)
            best = min(
                candidates, key=lambda j: abs(self._times[j] - timestamp_ns)
            )
            diff = abs(self._times[best] - timestamp_ns) / 1e9
            if diff > self.max_stale_time:
                log.warning(
                    "Robot pose time difference too large: %s sec (max: %s sec)",
                    diff,
                    self.max_stale_time,
                )
                if self.use_latest_fallback:
                    log.warning("Using latest transform as fallback for robot pose")
                    return self._poses[-1].astype(np.float32)
                return None
            # Interpolate between the two bracketing poses when possible.
            if (
                0 < i < len(self._times)
                and self._times[i - 1] <= timestamp_ns <= self._times[i]
                and self._times[i] > self._times[i - 1]
            ):
                return self._interpolate(
                    self._poses[i - 1],
                    self._poses[i],
                    (timestamp_ns - self._times[i - 1])
                    / (self._times[i] - self._times[i - 1]),
                ).astype(np.float32)
            return self._poses[best].astype(np.float32)

    @staticmethod
    def _interpolate(T0: np.ndarray, T1: np.ndarray, alpha: float) -> np.ndarray:
        from fastdem_tpu_torch.io.pcd import _pose_from_quat, _quat_from_pose

        q0 = _quat_from_pose(T0)
        q1 = _quat_from_pose(T1)
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
        return _pose_from_quat(t[0], t[1], t[2], q[0], q[1], q[2], q[3])
