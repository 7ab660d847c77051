"""Vectorized sensor noise models (port of ``fastdem_tpu/sensors/models.py``).

  * ConstantModel: sigma^2 * I
  * LiDARModel: Sigma = var_lat*I + (var_rad - var_lat) * d d^T with
    var_rad = max(sigma_r^2, 1e-6), var_lat = max((dist*sigma_theta)^2, 1e-6),
    fallback 0.01*I near the origin
  * RGBDModel (Nguyen et al. 2012): diag(var_lat, var_lat, var_norm),
    sigma_norm = a + b (d - c)^2, sigma_lat = f*d, fallback 0.01*I for d <= 0

The mapping pipeline reads only the world z-variance r3^T Sigma r3 (r3 the
third row of the sensor->world rotation), so ``z_variance_world`` never
builds the [N, 3, 3] covariance; ``compute_covariances`` does, for the
covariance channel.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from fastdem_tpu_torch.numerics import fma_f32, sqrt_f32, sum_sq

_MIN_VARIANCE = 1e-6
_FALLBACK_VARIANCE = 0.01


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class ConstantModel:
    """Isotropic constant uncertainty; sigma is a standard deviation."""

    uncertainty: float = 0.1

    @property
    def variance(self) -> float:
        return self.uncertainty * self.uncertainty

    def compute_covariances(self, xyz: torch.Tensor) -> torch.Tensor:
        n = xyz.shape[0]
        return (_eye3(xyz) * self.variance).expand(n, 3, 3)

    def z_variance_world(self, xyz: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
        return torch.full(
            (xyz.shape[0],), self.variance, dtype=torch.float32, device=xyz.device
        )


@dataclasses.dataclass(frozen=True)
class LiDARModel:
    """Radial / lateral beam noise model."""

    range_noise: float = 0.02
    angular_noise: float = 0.001

    def __post_init__(self):
        object.__setattr__(self, "range_noise", abs(self.range_noise))
        object.__setattr__(self, "angular_noise", abs(self.angular_noise))

    def _variances(self, xyz: torch.Tensor):
        dist_sq = sum_sq(xyz)
        dist = sqrt_f32(dist_sq)
        var_radial = max(self.range_noise**2, _MIN_VARIANCE)
        var_lateral = torch.clamp_min((dist * self.angular_noise) ** 2, _MIN_VARIANCE)
        near_origin = dist_sq < 1e-6
        return dist, var_radial, var_lateral, near_origin

    def compute_covariances(self, xyz: torch.Tensor) -> torch.Tensor:
        dist, var_r, var_l, near = self._variances(xyz)
        d = xyz / torch.clamp_min(dist, 1e-12)[:, None]
        eye = _eye3(xyz)
        cov = var_l[:, None, None] * eye + (var_r - var_l)[:, None, None] * (
            d[:, :, None] * d[:, None, :]
        )
        return torch.where(near[:, None, None], eye * _FALLBACK_VARIANCE, cov)

    def z_variance_world(self, xyz: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
        """r3^T Sigma r3 = var_lat + (var_rad - var_lat) * (r3 . d)^2."""
        dist, var_r, var_l, near = self._variances(xyz)
        d = xyz / torch.clamp_min(dist, 1e-12)[:, None]
        proj = fma_f32(d[:, 2], r3[2], fma_f32(d[:, 1], r3[1], d[:, 0] * r3[0]))
        var = fma_f32((var_r - var_l) * proj, proj, var_l)
        return torch.where(near, _FALLBACK_VARIANCE, var)


@dataclasses.dataclass(frozen=True)
class RGBDModel:
    """Structured-light depth noise (Nguyen et al. 2012)."""

    normal_a: float = 0.001
    normal_b: float = 0.002
    normal_c: float = 0.4
    lateral_factor: float = 0.001

    def _variances(self, xyz: torch.Tensor):
        depth = xyz[:, 2]
        diff = depth - self.normal_c
        sigma_norm = self.normal_a + self.normal_b * diff * diff
        var_norm = sigma_norm * sigma_norm
        sigma_lat = self.lateral_factor * depth
        var_lat = sigma_lat * sigma_lat
        invalid = depth <= 0.0
        return var_lat, var_norm, invalid

    def compute_covariances(self, xyz: torch.Tensor) -> torch.Tensor:
        var_lat, var_norm, invalid = self._variances(xyz)
        n = xyz.shape[0]
        cov = torch.zeros((n, 3, 3), dtype=torch.float32, device=xyz.device)
        cov[:, 0, 0] = var_lat
        cov[:, 1, 1] = var_lat
        cov[:, 2, 2] = var_norm
        fallback = _eye3(xyz) * _FALLBACK_VARIANCE
        return torch.where(invalid[:, None, None], fallback, cov)

    def z_variance_world(self, xyz: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
        """r3^T diag(vl, vl, vn) r3 = vl*(r3x^2 + r3y^2) + vn*r3z^2."""
        var_lat, var_norm, invalid = self._variances(xyz)
        w_lat = r3[0] * r3[0] + r3[1] * r3[1]
        w_norm = r3[2] * r3[2]
        var = var_lat * w_lat + var_norm * w_norm
        return torch.where(invalid, _FALLBACK_VARIANCE, var)


SensorModel = Union[ConstantModel, LiDARModel, RGBDModel]


def create_sensor_model(cfg) -> SensorModel:
    """Factory from a ``SensorModelConfig`` of the port's config module."""
    from fastdem_tpu_torch.config import SensorModelConfig, SensorType

    if not isinstance(cfg, SensorModelConfig):
        raise TypeError(
            "create_sensor_model takes the port's SensorModelConfig "
            f"(fastdem_tpu_torch.config), got {type(cfg)!r}"
        )
    if cfg.type == SensorType.LIDAR:
        return LiDARModel(cfg.lidar.range_noise, cfg.lidar.angular_noise)
    if cfg.type == SensorType.RGBD:
        return RGBDModel(
            cfg.rgbd.normal_a,
            cfg.rgbd.normal_b,
            cfg.rgbd.normal_c,
            cfg.rgbd.lateral_factor,
        )
    return ConstantModel(cfg.constant.uncertainty)
