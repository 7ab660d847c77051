"""PCA terrain features: step, slope, roughness, curvature, normals (port of
``fastdem_tpu/postprocess/features.py``).

Per cell, a local PCA over the disk neighbourhood of world-frame
displacements d = (-dr * res, -dc * res, z_n - z_c) (grid row -> -x,
column -> -y), then
  step      = percentile z range over the window
  slope     = acos(|n_z|) in degrees
  roughness = sqrt(lambda_0)  (the smallest eigenvalue)
  curvature = |lambda_0 / trace| (0 where trace <= 0)
  normal    = the smallest eigenvector, flipped upward
under the reference's guards: finite centre, >= min_valid neighbours, a
valid PCA (trace >= f32 eps) and lambda_1 >= 1e-8. Skipped cells keep
their previous layer values.

The window sums run term by term in offset order, and the moment sums
against the per-offset constants are FMA chains in that order: both are
what the reference computes, bit for bit (``torch.sum`` and
``torch.einsum`` associate differently).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .pca import _EPS, acos_f32, eigvals3x3, eigvec3x3
from .numerics import fma_f32, sqrt_f32
from .stencil import (
    count_true,
    disk_offsets,
    sum_in_order,
    window_stack,
)

_MIN_EIGENVALUE = 1e-8
_DEGREES = float(np.float32(180.0 / np.pi))


def _fma_sum0(stack: torch.Tensor, factors) -> torch.Tensor:
    """sum_k stack[k] * factors[k] as the FMA chain acc = fma(x_k, f_k, acc)
    from +0, in offset order; a factor is a float or a tensor."""
    acc = torch.zeros_like(stack[0])
    for k in range(stack.shape[0]):
        acc = fma_f32(stack[k], factors[k], acc)
    return acc


def _masked_sum0(d: np.ndarray, finite: torch.Tensor) -> torch.Tensor:
    """``_fma_sum0`` against a 0/1 stack: each product is exactly d_k or 0,
    so the FMA is one f32 add of the masked constant."""
    acc = torch.zeros(finite.shape[1:], dtype=torch.float32, device=finite.device)
    for k in range(finite.shape[0]):
        acc = acc + torch.where(finite[k], float(d[k]), 0.0)
    return acc


def extract_features(
    elevation: torch.Tensor,
    cfg,
    resolution: float,
) -> Dict[str, torch.Tensor]:
    """Returns a dict of step / slope / roughness / curvature /
    normal_{x,y,z} and 'ok' (the update mask); ``cfg`` is a
    ``FeatureExtractionConfig``."""
    offsets = disk_offsets(cfg.analysis_radius, resolution)
    K = len(offsets)
    off = np.asarray(offsets, dtype=np.float32)
    dx = -off[:, 0] * resolution  # [K] (row -> -x), f32
    dy = -off[:, 1] * resolution  # [K] (col -> -y)

    win = window_stack(elevation, offsets)  # [K, H, W]
    finite = torch.isfinite(win)
    dz = torch.where(finite, win - elevation[None], 0.0)

    n = count_true(finite).to(torch.float32)  # valid neighbour count
    n_safe = torch.clamp_min(n, 1.0)

    sx = _masked_sum0(dx, finite)
    sy = _masked_sum0(dy, finite)
    sz = sum_in_order(dz)
    sxx = _masked_sum0(dx * dx, finite)
    syy = _masked_sum0(dy * dy, finite)
    sxy = _masked_sum0(dx * dy, finite)
    sxz = _fma_sum0(dz, dx.tolist())
    syz = _fma_sum0(dz, dy.tolist())
    szz = _fma_sum0(dz, dz)

    mx, my, mz = sx / n_safe, sy / n_safe, sz / n_safe

    def central(s, ma, mb):  # s / n - ma * mb, the product fused
        return fma_f32(-ma, mb, s / n_safe)

    cxx = central(sxx, mx, mx)
    cyy = central(syy, my, my)
    czz = central(szz, mz, mz)
    cxy = central(sxy, mx, my)
    cxz = central(sxz, mx, mz)
    cyz = central(syz, my, mz)

    cov = torch.stack(
        [
            torch.stack([cxx, cxy, cxz], dim=-1),
            torch.stack([cxy, cyy, cyz], dim=-1),
            torch.stack([cxz, cyz, czz], dim=-1),
        ],
        dim=-2,
    )  # [H, W, 3, 3]

    # Only the smallest eigenvector is used: the normal.
    lam = eigvals3x3(cov)  # [H, W, 3] ascending
    normal = eigvec3x3(cov, lam[..., 0])
    normal = torch.where(normal[..., 2:3] < 0.0, -normal, normal)
    trace_pca = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]

    # Step: the percentile range of the sorted window heights.
    zs = torch.sort(
        torch.where(finite, win, float("inf")), dim=0, stable=True
    ).values
    lo_i = torch.clamp((cfg.step_lower_percentile * (n - 1.0)).to(torch.int64), 0, K - 1)
    hi_i = torch.clamp((cfg.step_upper_percentile * (n - 1.0)).to(torch.int64), 0, K - 1)
    z_lo = torch.gather(zs, 0, lo_i[None])[0]
    z_hi = torch.gather(zs, 0, hi_i[None])[0]
    step = z_hi - z_lo

    trace = cxx + cyy + czz
    slope = acos_f32(torch.clamp(torch.abs(normal[..., 2]), 0.0, 1.0)) * _DEGREES
    roughness = sqrt_f32(torch.clamp_min(lam[..., 0], 0.0))
    curvature = torch.where(trace > 0.0, torch.abs(lam[..., 0] / trace), 0.0)

    ok = (
        torch.isfinite(elevation)
        & (n >= cfg.min_valid_neighbors)
        & (trace_pca >= _EPS)
        & (lam[..., 1] >= _MIN_EIGENVALUE)
    )
    return {
        "step": step,
        "slope": slope,
        "roughness": roughness,
        "curvature": curvature,
        "normal_x": normal[..., 0],
        "normal_y": normal[..., 1],
        "normal_z": normal[..., 2],
        "ok": ok,
    }


