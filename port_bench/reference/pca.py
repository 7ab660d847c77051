"""Batched closed-form symmetric 3x3 eigendecomposition (port of
``fastdem_tpu/cloud/pca.py``).

Analytic eigenvalues (the trigonometric method) and cross-product
eigenvectors over any leading batch shape: no iterative solver and no
data-dependent control flow. Eigenvalues ascend (the smallest first, the
surface-normal direction); ``valid`` is False for degenerate covariances
(trace below the f32 epsilon).

The arithmetic is the reference's compiled form on the CPU, so that the
two agree bit for bit except where a transcendental differs in its last
ulp:

- constant divisors are f32 reciprocal multiplies, and 3 * (t / 3) folds
  to t;
- a product whose only use is an add or a subtract is fused with it into
  one FMA (``fma_f32``); where both operands are products, the first one
  is fused and the second rounded on its own;
- ``acos(x)`` is ``atan2(sqrt((1 - x) * (1 + x)), x)`` with a correctly
  rounded square root.
"""

from __future__ import annotations

import math


import torch

from .numerics import fma_f32, recip_f32, sqrt_f32

_EPS = 1.1920929e-07  # float32 machine epsilon
_THIRD = recip_f32(3.0)
_SIXTH = recip_f32(6.0)
_TWO_PI_3 = 2.0 * math.pi / 3.0


def acos_f32(x: torch.Tensor) -> torch.Tensor:
    """acos as the reference lowers it: atan2(sqrt((1 - x)(1 + x)), x),
    the atan2 evaluated in double and rounded once."""
    y = sqrt_f32((1.0 - x) * (x + 1.0))
    return torch.atan2(y.double(), x.double()).float()


def cos_f32(x: torch.Tensor) -> torch.Tensor:
    """cos evaluated in double and rounded once: the same bits on the CPU
    and on CUDA, within a few ulps of the reference's vectorised cosf."""
    return torch.cos(x.double()).float()


def _sub_prod(x, y, u, v):
    """x * y - u * v with the first product fused: fma(x, y, -(u * v))."""
    return fma_f32(x, y, -(u * v))


def _add_prod(x, y, u, v):
    """x * y + u * v with the first product fused: fma(x, y, u * v)."""
    return fma_f32(x, y, u * v)


def eigvals3x3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of symmetric [..., 3, 3], f32[..., 3]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    t = a00 + a11 + a22
    q = t * _THIRD
    p1 = fma_f32(a12, a12, _add_prod(a01, a01, a02, a02))
    # b_ii = a_ii - t / 3, each with the product fused.
    neg_t = -t
    b00 = fma_f32(neg_t, _THIRD, a00)
    b11 = fma_f32(neg_t, _THIRD, a11)
    b22 = fma_f32(neg_t, _THIRD, a22)
    p2 = fma_f32(p1, 2.0, fma_f32(b22, b22, _add_prod(b00, b00, b11, b11)))
    p = sqrt_f32(torch.clamp_min(p2 * _SIXTH, 0.0))
    near_diag = p < 1e-12

    p_safe = torch.where(near_diag, 1.0, p)
    c00, c11, c22 = b00 / p_safe, b11 / p_safe, b22 / p_safe
    c01, c02, c12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    m0 = _sub_prod(c11, c22, c12, c12)
    m1 = _sub_prod(c01, c22, c12, c02)
    m2 = _sub_prod(c01, c12, c11, c02)
    detB = fma_f32(c02, m2, _sub_prod(c00, m0, c01, m1))
    r = torch.clamp(detB * 0.5, -1.0, 1.0)
    phi = acos_f32(r) * _THIRD

    two_p = p * 2.0
    h_max = two_p * cos_f32(phi)
    h_min = two_p * cos_f32(phi + _TWO_PI_3)
    # The reference evaluates each eigenvalue in its own loop: where q is
    # used once, t * (1/3) fuses into the add; lam_mid uses q twice, so
    # there the products 2p * cos fuse instead. 3 * q folds to t.
    lam_max = fma_f32(t, _THIRD, h_max)
    lam_min = fma_f32(t, _THIRD, h_min)
    lam_mid = (
        t
        - fma_f32(two_p, cos_f32(phi), q)
        - fma_f32(two_p, cos_f32(phi + _TWO_PI_3), q)
    )

    diag_sorted = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1).values
    lams = torch.stack([lam_min, lam_mid, lam_max], dim=-1)
    return torch.where(near_diag[..., None], diag_sorted, lams)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [_sub_prod(a1, b2, a2, b1), _sub_prod(a2, b0, a0, b2),
         _sub_prod(a0, b1, a1, b0)],
        dim=-1,
    )


def _norm_sq(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis (3), reduced from +0 with each
    square fused: fma(z, z, fma(y, y, x * x))."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return fma_f32(z, z, fma_f32(y, y, x * x))


def eigvec3x3(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric A for eigenvalue lam: the largest cross
    product of rows of (A - lam I) spans the null-space complement; e_z
    where every cross product vanishes (a repeated eigenvalue)."""
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cand = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
    norms = _norm_sq(cand)  # [..., 3]
    # torch.argmax returns the first maximum, as the reference does.
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(
        cand, -2, best[..., None, None].expand(*best.shape, 1, 3)
    )[..., 0, :]
    norm = sqrt_f32(_norm_sq(v))[..., None]
    fallback = torch.eye(3, dtype=A.dtype, device=A.device)[2]  # e_z
    return torch.where(norm > 1e-20, v / torch.clamp_min(norm, 1e-20), fallback)


