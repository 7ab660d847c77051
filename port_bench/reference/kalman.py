"""Dense per-cell 1D Kalman + Welford estimator update (port of
``fastdem_tpu/mapping/kalman.py``). The same recurrences, one masked
elementwise pass over the grid per scan:

  R = measurement_variance if > 0 else max_variance   (NaN -> R_max)
  first obs:  x = z, P = R, count = 1
  update:     P += Q; K = P/(P+R); x += K (z - x);
              P = clamp((1-K) P, min_var, max_var); count += 1
  Welford:    mean/m2/sample_var with count shared with the filter
  bounds:     x +/- 2 sqrt(max(0, sample_var))
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .gridmap import GridMapState, layers
from .numerics import fma_f32, sqrt_f32


def layer_fills() -> Dict[str, float]:
    """Initial fills for the Kalman estimator layers."""
    return {
        layers.variance: 0.0,
        layers.n_points: 0.0,
        layers.kalman_p: 0.0,
        layers.sample_mean: np.nan,
        layers.sample_m2: 0.0,
        layers.upper_bound: np.nan,
        layers.lower_bound: np.nan,
    }


def update(
    state: GridMapState,
    cfg,
    z: torch.Tensor,
    z_var: torch.Tensor,
    touched: torch.Tensor,
) -> GridMapState:
    """One scan's estimator update. ``z`` / ``z_var`` are dense [H, W]
    per-cell observations (NaN where untouched), ``touched`` the update
    mask; ``cfg`` is a ``KalmanConfig``."""
    x = state.layers[layers.elevation]
    P = state.layers[layers.kalman_p]
    count = state.layers[layers.n_points]
    mean = state.layers[layers.sample_mean]
    m2 = state.layers[layers.sample_m2]
    svar = state.layers[layers.variance]

    R = torch.where(z_var > 0.0, z_var, cfg.max_variance)

    is_new = torch.isnan(x)
    P_pred = P + cfg.process_noise
    K = P_pred / (P_pred + R)
    x_upd = fma_f32(K, z - x, x)  # one rounding, as the reference
    P_upd = torch.clamp((1.0 - K) * P_pred, cfg.min_variance, cfg.max_variance)
    cnt_upd = count + 1.0

    new_x = torch.where(is_new, z, x_upd)
    new_P = torch.where(is_new, R, P_upd)
    new_cnt = torch.where(is_new, 1.0, cnt_upd)

    # Welford, with the already-incremented count.
    mean_new = torch.isnan(mean)
    delta = z - mean
    w_mean = mean + delta / new_cnt
    delta2 = z - w_mean
    w_m2 = fma_f32(delta, delta2, m2)
    w_var = torch.where(
        new_cnt > 1.0, w_m2 / torch.clamp_min(new_cnt - 1.0, 1.0), 0.0
    )

    out_mean = torch.where(mean_new, z, w_mean)
    out_m2 = torch.where(mean_new, 0.0, w_m2)
    out_var = torch.where(mean_new, 0.0, w_var)

    # Bounds are recomputed only for touched cells.
    sigma = sqrt_f32(torch.clamp_min(torch.where(touched, out_var, svar), 0.0))
    center = torch.where(touched, new_x, x)
    upper = center + 2.0 * sigma
    lower = center - 2.0 * sigma

    def sel(new, old):
        return torch.where(touched, new, old)

    return state.replace_layers(
        {
            layers.elevation: sel(new_x, x),
            layers.kalman_p: sel(new_P, P),
            layers.n_points: sel(new_cnt, count),
            layers.sample_mean: sel(out_mean, mean),
            layers.sample_m2: sel(out_m2, m2),
            layers.variance: sel(out_var, svar),
            layers.upper_bound: sel(upper, state.layers[layers.upper_bound]),
            layers.lower_bound: sel(lower, state.layers[layers.lower_bound]),
        }
    )
