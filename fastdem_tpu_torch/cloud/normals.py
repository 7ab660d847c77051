"""Normal and covariance estimation from local neighbourhoods (port of
``fastdem_tpu/cloud/normals.py``).

Per point, PCA over its kNN neighbourhood (the point itself included): the
normal is the smallest eigenvector, oriented toward the viewpoint;
covariances (for GICP) are the neighbourhood's covariance matrices,
optionally flattened to eigenvalues (eps, 1, 1).

The neighbours come from ``search.knn`` (exact on every method but
"bucket", so the indices are the reference's); the PCA tail runs after the
search on the same indices (the reference fuses it into its grid pass as
one device program; the result is the same). The moments follow the
reference's compiled order on the CPU: the mean sums the k + 1 neighbours
left to right, the covariance accumulates the products as a chain of FMAs,
and the divisions are true divisions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.cloud.pca import eigh3x3
from fastdem_tpu_torch.cloud.pointcloud import PointCloud
from fastdem_tpu_torch.cloud.search import knn
from fastdem_tpu_torch.numerics import dot_fma, sum_seq


def _neighborhood_cov(
    xyz: torch.Tensor, idx: torch.Tensor, include_self: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point covariance over gathered neighbours. Returns (cov, count)."""
    idx = idx.long()
    valid = idx >= 0
    pts = xyz[idx.clamp_min(0)]  # [N, k, 3]
    if include_self:
        pts = torch.cat([xyz[:, None, :], pts], dim=1)
        valid = torch.cat(
            [torch.ones((xyz.shape[0], 1), dtype=torch.bool, device=xyz.device), valid], dim=1
        )
    w = valid.to(torch.float32)[..., None]
    cnt = sum_seq(w[..., 0], 1)
    cnt_safe = torch.clamp_min(cnt, 1.0)[:, None]
    mean = sum_seq(pts * w, 1) / cnt_safe
    d = (pts - mean[:, None, :]) * w
    cov = dot_fma(d[..., :, None], d[..., None, :], 1) / cnt_safe[..., None]
    return cov, cnt


def _normals_tail(xyz: torch.Tensor, idx: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    cov, cnt = _neighborhood_cov(xyz, idx)
    lam, vec = eigh3x3(cov)
    normal = vec[..., 0]  # smallest eigenvector
    to_vp = vp[None, :] - xyz
    flip = dot_fma(normal, to_vp) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    # Degenerate neighbourhoods (fewer than 3 points) -> zero normal.
    ok = (cnt >= 3.0) & (lam[..., 2] > 1e-12)
    return torch.where(ok[:, None], normal, 0.0)


def estimate_normals(
    cloud: PointCloud,
    k: int = 10,
    viewpoint=(0.0, 0.0, 0.0),
    method: str = "auto",
    bucket_size: Optional[float] = None,
) -> PointCloud:
    """Adds a 'normal' channel; normals oriented toward ``viewpoint``. Runs
    on the cloud's device."""
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=cloud.xyz.device)
    idx, _ = knn(cloud.xyz, cloud.mask, k, bucket_size=bucket_size, method=method)
    return cloud.with_channel("normal", _normals_tail(cloud.xyz, idx, vp))


def _cov_tail(xyz: torch.Tensor, idx: torch.Tensor, epsilon: float, regularize: bool):
    cov, cnt = _neighborhood_cov(xyz, idx)
    if regularize:
        _, vec = eigh3x3(cov)
        # Eigenvalues replaced by (eps, 1, 1) in ascending-order slots.
        new_lam = torch.tensor([epsilon, 1.0, 1.0], dtype=torch.float32, device=cov.device)
        cov = dot_fma((vec * new_lam)[..., :, None, :], vec[..., None, :, :], -1)
    ok = cnt >= 3.0
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return torch.where(ok[:, None, None], cov, eye)


def estimate_covariances(
    cloud: PointCloud,
    k: int = 10,
    regularize: bool = True,
    epsilon: float = 1e-3,
    method: str = "auto",
    bucket_size: Optional[float] = None,
) -> PointCloud:
    """Adds a 'covariance' channel [N, 3, 3] (GICP-style). With
    ``regularize``, eigenvalues are flattened to (eps, 1, 1) along the
    principal axes, the standard plane-to-plane regularisation. Runs on the
    cloud's device."""
    idx, _ = knn(cloud.xyz, cloud.mask, k, bucket_size=bucket_size, method=method)
    cov = _cov_tail(cloud.xyz, idx, float(np.float32(epsilon)), regularize)
    return cloud.with_channel("covariance", cov)
