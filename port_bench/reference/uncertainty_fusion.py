"""Bilateral uncertainty fusion via weighted windowed ECDF quantiles (port
of ``fastdem_tpu/postprocess/uncertainty_fusion.py``).

For every cell with finite bounds, the neighbours within search_radius
contribute their (lower, upper) bounds, weighted by a Gaussian of the
distance times the inverse bound range 1 / (upper - lower + 1e-4); the
fused bounds are the weighted quantiles (quantile_lower of the lowers,
quantile_upper of the uppers), applied where >= min_valid_neighbors
contribute. Weights <= 1e-6 are skipped, and the quantile is the first
sorted value whose cumulative weight reaches p * total.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .stencil import (
    count_true,
    disk_offsets,
    offset_distances_sq,
    window_stack,
)

# The reference's compiler evaluates a cumulative sum over more than this
# many entries in blocks of this many, adding each block's carry after.
_SCAN_BLOCK = 16


def _cumsum0(w: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over axis 0 in the reference's association: one term
    at a time from +0 up to 16 entries; beyond that, in-block prefixes of
    16 plus the prefix of the earlier blocks' totals. (``torch.cumsum``
    accumulates f32 in double on the CPU.)"""
    K = w.shape[0]
    if K <= _SCAN_BLOCK:
        acc = torch.zeros_like(w[0])
        out = []
        for k in range(K):
            acc = acc + w[k]
            out.append(acc)
        return torch.stack(out)
    nb = -(-K // _SCAN_BLOCK)
    pad = torch.zeros((nb * _SCAN_BLOCK - K,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    blocks = torch.cat([w, pad]).reshape((nb, _SCAN_BLOCK) + tuple(w.shape[1:]))
    inblock = _cumsum0(blocks.transpose(0, 1)).transpose(0, 1)  # [nb, 16, ...]
    totals = _cumsum0(inblock[:, -1])
    carry = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    out = inblock + carry[:, None]
    return out.reshape((nb * _SCAN_BLOCK,) + tuple(w.shape[1:]))[:K]


def _weighted_quantile(values, weights, p):
    """Per-cell weighted quantile over window axis 0.

    values / weights: [K, H, W]; invalid entries must have weight 0 (they
    sort to the +inf tail). Returns [H, W], NaN where the total weight is 0.
    """
    order = torch.sort(
        torch.where(weights > 0.0, values, float("inf")), dim=0, stable=True
    ).indices
    v_sorted = torch.gather(values, 0, order)
    w_sorted = torch.gather(weights, 0, order)
    cum = _cumsum0(w_sorted)
    total = cum[-1]
    reached = cum >= p * total
    # The first index where the cumulative weight reaches the target.
    idx = torch.argmax(reached.to(torch.uint8), dim=0)
    out = torch.gather(v_sorted, 0, idx[None])[0]
    return torch.where(total > 0.0, out, float("nan"))


@functools.lru_cache(maxsize=64)
def _spatial_weights(search_radius, spatial_sigma, resolution, device) -> torch.Tensor:
    """The Gaussian weight of each disk offset, f32[K] on ``device``: made
    once per (disk, device), so a captured chain copies nothing from the
    host."""
    offsets = disk_offsets(search_radius, resolution)
    d2 = offset_distances_sq(offsets, resolution)  # [K]
    inv_2s2 = 1.0 / (2.0 * spatial_sigma * spatial_sigma)
    return torch.tensor(np.exp(-d2 * inv_2s2), dtype=torch.float32, device=device)


def fuse_bounds(
    upper: torch.Tensor,
    lower: torch.Tensor,
    cfg,
    resolution: float,
):
    """Returns (fused_upper, fused_lower); ``cfg`` is an
    ``UncertaintyFusionConfig``."""
    offsets = disk_offsets(cfg.search_radius, resolution)
    w_spatial = _spatial_weights(
        cfg.search_radius, cfg.spatial_sigma, resolution, upper.device
    )

    up_win = window_stack(upper, offsets)  # [K, H, W]
    lo_win = window_stack(lower, offsets)
    valid = torch.isfinite(up_win) & torch.isfinite(lo_win)
    rng = up_win - lo_win
    w = w_spatial[:, None, None] / (rng + 1e-4)
    # Non-finite values and weights <= 1e-6 are skipped.
    w = torch.where(valid & (w > 1e-6), w, 0.0)

    count = count_true(valid)
    fused_lo = _weighted_quantile(lo_win, w, cfg.quantile_lower)
    fused_up = _weighted_quantile(up_win, w, cfg.quantile_upper)

    # The centre must have finite bounds, enough neighbours must
    # contribute, and the fused bounds must be finite.
    center_ok = torch.isfinite(upper) & torch.isfinite(lower)
    apply = (
        center_ok
        & (count >= cfg.min_valid_neighbors)
        & torch.isfinite(fused_lo)
        & torch.isfinite(fused_up)
    )
    return (
        torch.where(apply, fused_up, upper),
        torch.where(apply, fused_lo, lower),
    )


