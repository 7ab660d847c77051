"""Dense P^2 online-quantile estimator (Jain & Chlamtac 1985), frozen copy
of the port's ``mapping/p2.py``: one masked elementwise pass over the grid
per scan, no data-dependent control flow.

Each rule follows upstream FastDEM's ``quantile_estimation.hpp``:

  * phase 1 (count < 5): q[count] = x; on reaching 5, sort q and set
    n = [0..4];
  * phase 2: interval k from strict comparisons, extreme markers clamped
    (q0 = min(q0, x), q4 = max(q4, x)); n[i] += 1 for i > k; desired
    positions n' = dn * count (pre-increment);
  * fading memory: rescale n when count exceeds max_sample_count;
  * interior markers i = 1..3 updated SEQUENTIALLY (n[i-1] may have moved
    at step i-1), parabolic with a linear fallback;
  * elevation = q[elevation_marker] once count >= 5, else x;
  * compute_bounds: variance = ((q3 - q1) / 2)^2, lower = q0, upper = q4.

``dn * count - n`` is one fused multiply-add (``numerics.fma_f32``), as the
port's step contracts it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .gridmap import GridMapState, layers
from .numerics import fma_f32


def layer_fills() -> Dict[str, float]:
    """Initial fills for the P^2 estimator layers."""
    fills: Dict[str, float] = {
        layers.variance: np.nan,
        layers.n_points: 0.0,
        layers.upper_bound: np.nan,
        layers.lower_bound: np.nan,
    }
    for name in layers.p2_q:
        fills[name] = np.nan
    for i, name in enumerate(layers.p2_n):
        fills[name] = float(i)
    return fills


def _marker_deltas(cfg) -> Tuple[float, ...]:
    """Desired-position increments dn, clamped to [0, 1] and monotonic."""
    dn = [min(max(v, 0.0), 1.0) for v in (cfg.dn0, cfg.dn1, cfg.dn2, cfg.dn3, cfg.dn4)]
    for i in range(1, 5):
        dn[i] = max(dn[i], dn[i - 1])
    return tuple(dn)


def _adjust_marker(qs, ns, i: int, count0: torch.Tensor, dn_i: float):
    """Interior marker ``i``'s new (q, n), from the markers as they stand:
    ``qs[i - 1]`` / ``ns[i - 1]`` already hold marker i - 1's update."""
    dn_i = torch.full((), dn_i, dtype=torch.float32, device=count0.device)
    d = fma_f32(count0, dn_i, -ns[i])  # n'[i] - n[i]
    cond = ((d >= 1.0) & (ns[i + 1] - ns[i] > 1.0)) | (
        (d <= -1.0) & (ns[i - 1] - ns[i] < -1.0)
    )
    sign = torch.where(d >= 0.0, 1.0, -1.0)

    # Parabolic, with the zero-denominator guard.
    d_right = ns[i + 1] - ns[i]
    d_left = ns[i] - ns[i - 1]
    d_span = ns[i + 1] - ns[i - 1]
    degen = (d_right == 0.0) | (d_left == 0.0) | (d_span == 0.0)
    sr = torch.where(d_right == 0.0, 1.0, d_right)
    sl = torch.where(d_left == 0.0, 1.0, d_left)
    ss = torch.where(d_span == 0.0, 1.0, d_span)
    t1 = (d_left + sign) * (qs[i + 1] - qs[i]) / sr
    t2 = (d_right - sign) * (qs[i] - qs[i - 1]) / sl
    q_par = torch.where(degen, qs[i], qs[i] + sign * (t1 + t2) / ss)

    # Linear, toward the neighbour j = i + sign.
    q_j = torch.where(sign > 0, qs[i + 1], qs[i - 1])
    n_j = torch.where(sign > 0, ns[i + 1], ns[i - 1])
    dn_j = n_j - ns[i]
    q_lin = torch.where(
        dn_j == 0.0,
        qs[i],
        qs[i] + sign * (q_j - qs[i]) / torch.where(dn_j == 0.0, 1.0, dn_j),
    )

    q_new = torch.where((qs[i - 1] < q_par) & (q_par < qs[i + 1]), q_par, q_lin)
    return torch.where(cond, q_new, qs[i]), torch.where(cond, ns[i] + sign, ns[i])


def _update_p2(q: torch.Tensor, n: torch.Tensor, count: torch.Tensor,
               x: torch.Tensor, cfg):
    """Core P^2 step on stacked markers q, n: f32[5, H, W]."""
    dn = _marker_deltas(cfg)
    count0 = torch.where(torch.isnan(count) | (count < 0.0), 0.0, count)
    phase1 = count0 < 5.0
    marker = torch.arange(5, dtype=torch.int32, device=x.device)[:, None, None]

    # Phase 1: insert x at slot count0, sort on reaching 5.
    slot = torch.floor(count0).to(torch.int32)
    q_p1 = torch.where(marker == slot[None], x[None], q)
    count_p1 = count0 + 1.0
    reached5 = (count_p1 >= 5.0)[None]
    q_p1 = torch.where(reached5, torch.sort(q_p1, dim=0).values, q_p1)
    n_p1 = torch.where(reached5, marker.to(torch.float32), n)

    # Phase 2.
    k = (
        (x >= q[1]).to(torch.int32)
        + (x >= q[2]).to(torch.int32)
        + (x >= q[3]).to(torch.int32)
    )
    qs = list(q.unbind(0))
    qs[0] = torch.where(x < q[0], x, q[0])
    qs[4] = torch.where(x > q[4], x, q[4])
    n2 = n + (marker > k[None]).to(torch.float32)
    count_p2 = count0 + 1.0
    if cfg.max_sample_count > 0.0:
        over = count_p2 > cfg.max_sample_count
        scale = torch.where(over, cfg.max_sample_count / count_p2, 1.0)
        n2 = n2 * scale[None]
        count_p2 = torch.where(over, cfg.max_sample_count, count_p2)

    ns = list(n2.unbind(0))
    for i in (1, 2, 3):
        qs[i], ns[i] = _adjust_marker(qs, ns, i, count0, dn[i])

    # Combine the phases.
    q_out = torch.where(phase1[None], q_p1, torch.stack(qs))
    n_out = torch.where(phase1[None], n_p1, torch.stack(ns))
    count_out = torch.where(phase1, count_p1, count_p2)
    return q_out, n_out, count_out


def _stack(state: GridMapState, names) -> torch.Tensor:
    return torch.stack([state.layers[n] for n in names])


def _elevation_marker(cfg) -> int:
    return min(max(cfg.elevation_marker, 0), 4)


def update(state: GridMapState, cfg, z: torch.Tensor, touched: torch.Tensor) -> GridMapState:
    """One scan's P^2 update; ``cfg`` is a ``P2Config``."""
    q = _stack(state, layers.p2_q)
    n = _stack(state, layers.p2_n)
    count = state.layers[layers.n_points]

    q_new, n_new, count_new = _update_p2(q, n, count, z, cfg)
    elev_new = torch.where(count_new >= 5.0, q_new[_elevation_marker(cfg)], z)

    upd = {layers.n_points: torch.where(touched, count_new, count)}
    for i, name in enumerate(layers.p2_q):
        upd[name] = torch.where(touched, q_new[i], q[i])
    for i, name in enumerate(layers.p2_n):
        upd[name] = torch.where(touched, n_new[i], n[i])
    upd[layers.elevation] = torch.where(touched, elev_new, state.layers[layers.elevation])
    return state.replace_layers(upd)


def compute_bounds(state: GridMapState, cfg, touched: torch.Tensor) -> GridMapState:
    """Per touched cell: elevation = q[marker], variance, lower / upper
    bound (elevation is overwritten here too, as upstream does)."""
    q = _stack(state, layers.p2_q)
    sigma = (q[3] - q[1]) * 0.5

    def sel(new, name):
        return torch.where(touched, new, state.layers[name])

    return state.replace_layers(
        {
            layers.elevation: sel(q[_elevation_marker(cfg)], layers.elevation),
            layers.variance: sel(sigma * sigma, layers.variance),
            layers.lower_bound: sel(q[0], layers.lower_bound),
            layers.upper_bound: sel(q[4], layers.upper_bound),
        }
    )


def estimate(state: GridMapState, cfg, z: torch.Tensor, z_var: torch.Tensor,
             touched: torch.Tensor) -> GridMapState:
    """``update`` then ``compute_bounds``: one scan's estimator step.
    ``z_var`` is unused (the signature is the Kalman update's)."""
    del z_var
    return compute_bounds(update(state, cfg, z, touched), cfg, touched)
