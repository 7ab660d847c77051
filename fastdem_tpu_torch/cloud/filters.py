"""Point-cloud filters as mask updates and sort-based reductions (port of
``fastdem_tpu/cloud/filters.py``).

  * crop box / range / x / y / z / angle, INSIDE (inclusive) or OUTSIDE:
    mask updates;
  * voxel grid in the CENTROID / NEAREST / ANY / CENTER modes and
    ``grid_max_z``: points sorted by (masked last, vz, vy, vx, index), one
    segment per voxel, per-voxel sums by ``index_add_`` and minima / maxima
    by ``scatter_reduce_``; the representative of a voxel is its lowest
    original index;
  * deskew (per-point pose interpolation) and the statistical and radius
    outlier removals.

Filters never compact: they intersect ``mask`` and keep the capacity
(``pointcloud.compact`` makes an exact-size cloud). Everything runs on the
cloud's device. The arithmetic is the reference's eager arithmetic: true
division (``numerics.div_f32``) and short sums added left to right.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np
import torch

from fastdem_tpu_torch.cloud import transform as tfm
from fastdem_tpu_torch.cloud.pointcloud import PointCloud
from fastdem_tpu_torch.grid.geometry import floor_i32
from fastdem_tpu_torch.numerics import div_f32, sqrt_f32, sum_seq, sum_sq


class FilterMode(enum.Enum):
    INSIDE = "inside"
    OUTSIDE = "outside"


class VoxelMode(enum.Enum):
    CENTROID = "centroid"
    NEAREST = "nearest"
    ANY = "any"
    CENTER = "center"


def _apply(cloud: PointCloud, keep: torch.Tensor, mode: FilterMode) -> PointCloud:
    if mode == FilterMode.OUTSIDE:
        keep = ~keep
    return cloud.with_mask(cloud.mask & keep)


# -- crops (inclusive INSIDE bounds) ---------------------------------------


def crop_box(cloud: PointCloud, min_pt, max_pt, mode: FilterMode = FilterMode.INSIDE):
    lo = torch.as_tensor(np.asarray(min_pt, np.float32), device=cloud.device)
    hi = torch.as_tensor(np.asarray(max_pt, np.float32), device=cloud.device)
    keep = ((cloud.xyz >= lo) & (cloud.xyz <= hi)).all(dim=-1)
    return _apply(cloud, keep, mode)


def crop_range(cloud: PointCloud, min_range: float, max_range: float,
               mode: FilterMode = FilterMode.INSIDE):
    d2 = sum_seq(cloud.xyz * cloud.xyz)
    lo = float(np.float32(min_range * min_range))
    hi = float(np.float32(max_range * max_range))
    return _apply(cloud, (d2 >= lo) & (d2 <= hi), mode)


def _crop_axis(cloud, axis, lo, hi, mode):
    v = cloud.xyz[:, axis]
    return _apply(cloud, (v >= float(np.float32(lo))) & (v <= float(np.float32(hi))), mode)


def crop_x(cloud, lo, hi, mode=FilterMode.INSIDE):
    return _crop_axis(cloud, 0, lo, hi, mode)


def crop_y(cloud, lo, hi, mode=FilterMode.INSIDE):
    return _crop_axis(cloud, 1, lo, hi, mode)


def crop_z(cloud, lo, hi, mode=FilterMode.INSIDE):
    return _crop_axis(cloud, 2, lo, hi, mode)


def crop_angle(cloud: PointCloud, min_angle: float, max_angle: float,
               mode: FilterMode = FilterMode.INSIDE):
    """Azimuth field-of-view crop by half-plane cross products (handles
    the wrap-around; eps = 1e-5)."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    cos_min, sin_min = f32(math.cos(min_angle)), f32(math.sin(min_angle))
    cos_max, sin_max = f32(math.cos(max_angle)), f32(math.sin(max_angle))
    wrap = min_angle > max_angle
    rng = (2 * math.pi - (min_angle - max_angle)) if wrap else (max_angle - min_angle)
    eps = f32(1e-5)
    x, y = cloud.xyz[:, 0], cloud.xyz[:, 1]
    c_min = cos_min * y - sin_min * x
    c_max = cos_max * y - sin_max * x
    if rng < math.pi:
        in_range = (c_min >= -eps) & (c_max <= eps)
    else:
        in_range = (c_min >= -eps) | (c_max <= eps)
    return _apply(cloud, in_range, mode)


# -- voxel grid ----------------------------------------------------------------


def voxel_coords(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Integer voxel coordinates i32[N, 3]: floor(xyz / voxel_size)."""
    return floor_i32(div_f32(xyz, voxel_size))


VOXEL_KEY_BITS = 1024  # 1024^3 = 2^30 keys fit int32


def voxel_key(coords: torch.Tensor) -> torch.Tensor:
    """Pack i32[N, 3] voxel coordinates into one sortable i32 key
    (clipped to +-512 per axis)."""
    B = VOXEL_KEY_BITS
    c = torch.clamp(coords + B // 2, 0, B - 1)
    return (c[..., 0] * B + c[..., 1]) * B + c[..., 2]


def _pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering int32 pairs (hi, lo) lexicographically."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2**31)


def _voxel_sort(mask: torch.Tensor, coords: torch.Tensor):
    """Sort points by (masked last, vz, vy, vx, index): two stable sorts
    of packed int64 keys, the less significant pair first.

    Returns (order, seg_id, is_head, valid_sorted): seg_id is the dense
    segment id of each sorted position (the invalid tail gets n), is_head
    marks the first point of each voxel."""
    n = coords.shape[0]
    invalid = (~mask).to(torch.int32)
    order = torch.sort(_pack2(coords[:, 1], coords[:, 0]), stable=True).indices
    k2 = _pack2(invalid, coords[:, 2])[order]
    order = order[torch.sort(k2, stable=True).indices]
    valid_s = mask[order]
    cs = coords[order]
    new_key = torch.ones(n, dtype=torch.bool, device=coords.device)
    if n > 1:
        new_key[1:] = (cs[1:] != cs[:-1]).any(dim=1)
    is_head = valid_s & new_key
    seg = torch.cumsum(is_head.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, seg, n)
    return order, seg, is_head, valid_s


def _unsort(order: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(sorted_vals)
    out[order] = sorted_vals
    return out


def voxel_unique_mask(xyz: torch.Tensor, mask: torch.Tensor, voxel_size: float):
    """Keep one representative per 3D voxel (its lowest original index)."""
    return unique_mask_of(voxel_coords(xyz, voxel_size), mask)


def unique_mask_of(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``voxel_unique_mask`` on coordinates already computed."""
    order, _, is_head, _ = _voxel_sort(mask, coords)
    return mask & _unsort(order, is_head)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)[:n]


def _segment_reduce(vals, seg, n, how, fill):
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, how, include_self=True)[:n]


def voxel_grid(cloud: PointCloud, voxel_size: float, mode: VoxelMode = VoxelMode.ANY):
    """Voxel-grid downsample. The output keeps the capacity; the surviving
    points are the voxels' representatives (the mask marks them)."""
    coords = voxel_coords(cloud.xyz, voxel_size)
    order, seg, is_head, valid_s = _voxel_sort(cloud.mask, coords)
    n = cloud.capacity
    keep = _unsort(order, is_head)
    if mode == VoxelMode.ANY:
        return cloud.with_mask(cloud.mask & keep)

    xyz_s = cloud.xyz[order]
    ones = valid_s.to(torch.float32)
    cnt = _segment_sum(ones, seg, n)
    sums = _segment_sum(xyz_s * ones[:, None], seg, n)
    centroid = sums / torch.clamp_min(cnt, 1.0)[:, None]
    head_seg = seg.clamp_max(n - 1)

    if mode == VoxelMode.NEAREST:
        diff = xyz_s - centroid[head_seg]
        d2 = sum_seq(diff * diff)
        d2 = torch.where(valid_s, d2, float("inf"))
        best = _segment_reduce(d2, seg, n, "amin", float("inf"))
        is_best = valid_s & (d2 <= best[head_seg])
        iota = torch.arange(n, device=seg.device)
        first = _segment_reduce(torch.where(is_best, iota, n), seg, n, "amin", n)
        keep_sorted = is_best & (iota == first[head_seg])
        return cloud.with_mask(cloud.mask & _unsort(order, keep_sorted))

    # CENTROID / CENTER place new points at the head slots.
    if mode == VoxelMode.CENTER:
        new_xyz_s = (coords[order].to(torch.float32) + 0.5) * voxel_size
    else:
        new_xyz_s = centroid[head_seg]
    out_xyz = _unsort(order, torch.where(is_head[:, None], new_xyz_s, xyz_s))
    out = dataclasses.replace(cloud, xyz=out_xyz, mask=cloud.mask & keep, valid_count=-1)

    if mode == VoxelMode.CENTROID:
        # Mean intensity / time / colour / normal per voxel; ring and label
        # keep the head point's value.
        ch = dict(out.channels)
        den = torch.clamp_min(cnt, 1.0)
        for name in ("intensity", "time"):
            if name in ch:
                v = ch[name][order].to(torch.float32)
                mean = (_segment_sum(v * ones, seg, n) / den)[head_seg]
                ch[name] = _unsort(order, torch.where(is_head, mean, ch[name][order]))
        if "color" in ch:
            v = ch["color"][order].to(torch.float32)
            mean = (_segment_sum(v * ones[:, None], seg, n) / den[:, None])[head_seg]
            ch["color"] = _unsort(order, torch.where(
                is_head[:, None], mean.to(torch.uint8), ch["color"][order]))
        if "normal" in ch:
            v = ch["normal"][order]
            m = _segment_sum(v * ones[:, None], seg, n)
            norm = sqrt_f32(sum_sq(m))[:, None]
            mean = (m / torch.clamp_min(norm, 1e-12))[head_seg]
            ch["normal"] = _unsort(order, torch.where(is_head[:, None], mean, ch["normal"][order]))
        out = dataclasses.replace(out, channels=ch)
    return out


def grid_max_z(cloud: PointCloud, cell_size: float) -> PointCloud:
    """Keep the highest point of each 2D (x, y) cell (the lowest index on
    ties)."""
    n = cloud.capacity
    c2 = floor_i32(div_f32(cloud.xyz[:, :2], cell_size))
    coords = torch.cat([c2, torch.zeros((n, 1), dtype=torch.int32, device=c2.device)], 1)
    order, seg, _, valid_s = _voxel_sort(cloud.mask, coords)
    z_s = torch.where(valid_s, cloud.xyz[order][:, 2], -float("inf"))
    zmax = _segment_reduce(z_s, seg, n, "amax", -float("inf"))
    head_seg = seg.clamp_max(n - 1)
    is_max = valid_s & (z_s >= zmax[head_seg])
    iota = torch.arange(n, device=seg.device)
    first = _segment_reduce(torch.where(is_max, iota, n), seg, n, "amin", n)
    keep_sorted = is_max & (iota == first[head_seg])
    return cloud.with_mask(cloud.mask & _unsort(order, keep_sorted))


# -- deskew ----------------------------------------------------------------------


def _into_end_frame(cloud: PointCloud, R: torch.Tensor, trans: torch.Tensor, T_end):
    """p' = T_end^-1 (R(t) p + t(t)); normals rotate by R_end^T R(t)."""
    R_end_inv = T_end[:3, :3].T
    world = torch.einsum("nij,nj->ni", R, cloud.xyz) + trans
    xyz = (world - T_end[:3, 3]) @ R_end_inv.T
    out = dataclasses.replace(cloud, xyz=xyz)
    if "normal" in cloud.channels:
        nrm = cloud.channels["normal"]
        n3 = torch.einsum("ij,njk,nk->ni", R_end_inv, R, nrm[:, :3])
        if nrm.shape[1] == 4:
            n3 = torch.cat([n3, nrm[:, 3:]], 1)
        out = out.with_channel("normal", n3)
    return out


def _as_mat(T, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T.cpu() if isinstance(T, torch.Tensor) else T,
                                      np.float32), device=dev)


def deskew(
    cloud: PointCloud,
    T_start,
    T_end,
    t0=None,
    t1=None,
    strategy: str = "channel",
) -> PointCloud:
    """Per-point motion compensation into the end-of-scan frame: each point
    moves by T_end^-1 T(t), T(t) interpolating T_start -> T_end (slerp
    rotation, lerp translation) at the point's normalised time.

      * explicit t0 / t1: the 'time' channel holds absolute stamps;
      * strategy="channel" (default): t0 / t1 are the valid min / max of
        the 'time' channel;
      * strategy="index": points in temporal order, alpha = i / (N - 1).
    Points outside [t0, t1] clamp to the end poses."""
    dev = cloud.device
    T_start, T_end = _as_mat(T_start, dev), _as_mat(T_end, dev)
    if strategy == "index":
        n = cloud.capacity
        alpha = torch.arange(n, dtype=torch.float32, device=dev) / max(n - 1, 1)
    elif "time" not in cloud.channels:
        return cloud  # nothing to compensate
    else:
        t = cloud.channels["time"]
        if t0 is None:
            t0 = torch.where(cloud.mask, t, float("inf")).amin()
        if t1 is None:
            t1 = torch.where(cloud.mask, t, -float("inf")).amax()
        t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
        t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
        alpha = torch.clamp((t - t0) / torch.clamp_min(t1 - t0, 1e-12), 0.0, 1.0)
    q0 = tfm.quat_from_matrix(T_start[:3, :3])
    q1 = tfm.quat_from_matrix(T_end[:3, :3])
    R = tfm.matrix_from_quat(tfm.slerp(q0, q1, alpha))
    trans = (1 - alpha)[:, None] * T_start[:3, 3] + alpha[:, None] * T_end[:3, 3]
    return _into_end_frame(cloud, R, trans, T_end)


def deskew_lookup(cloud: PointCloud, pose_lookup, num_waypoints: int = 16) -> PointCloud:
    """Deskew with a pose-lookup callable ``pose_lookup(t) -> 4x4``, sampled
    on the host at ``num_waypoints`` times spanning the scan's time
    channel; per-point poses interpolate between the bracketing waypoints,
    into the frame of the last waypoint."""
    if "time" not in cloud.channels:
        raise ValueError("deskew_lookup requires a 'time' channel")
    dev = cloud.device
    t_host = cloud.channels["time"].cpu().numpy()
    m_host = cloud.mask.cpu().numpy()
    if not m_host.any():
        return cloud
    t0 = float(t_host[m_host].min())
    t1 = float(t_host[m_host].max())
    W = max(2, num_waypoints)
    ts = np.linspace(t0, t1, W)
    poses = np.stack([np.asarray(pose_lookup(float(t)), np.float32) for t in ts])
    P = torch.as_tensor(poses, device=dev)
    quats = torch.stack([tfm.quat_from_matrix(P[i, :3, :3]) for i in range(W)])
    trans_w = P[:, :3, 3]

    t = cloud.channels["time"]
    u = torch.clamp(div_f32(t - float(np.float32(t0)), max(t1 - t0, 1e-12)), 0.0, 1.0) * (W - 1)
    i0 = torch.clamp(u.to(torch.int32), 0, W - 2).long()
    frac = u - i0.to(torch.float32)
    qa, qb = quats[i0], quats[i0 + 1]
    d = sum_seq(qa * qb)
    qb = torch.where(d[:, None] < 0, -qb, qb)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    den = torch.clamp_min(sin_t, 1e-12)
    w0 = torch.where(sin_t > 1e-6, torch.sin((1 - frac) * theta) / den, 1 - frac)
    w1 = torch.where(sin_t > 1e-6, torch.sin(frac * theta) / den, frac)
    q = w0[:, None] * qa + w1[:, None] * qb
    q = q / tfm._norm(q, keepdim=True)
    R = tfm.matrix_from_quat(q)
    trans = (1 - frac)[:, None] * trans_w[i0] + frac[:, None] * trans_w[i0 + 1]
    return _into_end_frame(cloud, R, trans, P[-1])


# -- outlier removal -------------------------------------------------------------


def _global_threshold(mean_d: torch.Tensor, m: torch.Tensor, std_mul: float) -> torch.Tensor:
    """mean + std_mul * std of mean_d over the valid points (population
    std), the sums taken in float64 so every device and summation order
    gives the same float32 threshold."""
    v = torch.where(m, mean_d, 0.0).double()
    nvalid = torch.clamp_min(m.sum(), 1).double()
    g_mean = (v.sum() / nvalid).float()
    dev = torch.where(m, mean_d - g_mean, 0.0).double()
    g_var = ((dev * dev).sum() / nvalid).float()
    return g_mean + std_mul * sqrt_f32(g_var)


def sor_mean_distance(dist: torch.Tensor) -> torch.Tensor:
    """Mean over each row's finite neighbour distances (0 where none)."""
    valid_nb = torch.isfinite(dist)
    cnt = valid_nb.sum(dim=1)
    s = sum_seq(torch.where(valid_nb, dist, 0.0), dim=1)
    return torch.where(cnt > 0, s / torch.clamp_min(cnt, 1).to(torch.float32), 0.0)


def statistical_outlier_removal(
    cloud: PointCloud,
    k: int = 20,
    std_mul: float = 1.0,
    method: str = "auto",
    bucket_size: Optional[float] = None,
) -> PointCloud:
    """Remove points whose mean kNN distance exceeds global_mean + std_mul
    * global_std (population std, inclusive <=). Masked points are left
    out of the statistics and of the output."""
    from fastdem_tpu_torch.cloud import search

    _, dist = search.knn(cloud.xyz, cloud.mask, k, method=method, bucket_size=bucket_size)
    mean_d = sor_mean_distance(dist)
    m = cloud.mask
    threshold = _global_threshold(mean_d, m, std_mul)
    return cloud.with_mask(m & (mean_d <= threshold))


def radius_outlier_removal(
    cloud: PointCloud,
    radius: float,
    min_neighbors: int = 2,
    method: str = "auto",
    per_bucket: int = 16,
) -> PointCloud:
    """Keep points with >= min_neighbors other points within ``radius``:
    "auto" / "brute" count exactly with the brute tile, "grid" through
    ``search.radius_search_grid`` (exact), "bucket" with the capped
    approximate bucket count."""
    from fastdem_tpu_torch.cloud import search

    if method in ("auto", "brute"):
        cnt = search.radius_count_brute(cloud.xyz, cloud.mask, radius)
    elif method == "grid":
        _, _, cnt = search.radius_search_grid(cloud.xyz, cloud.mask, radius, 1)
    else:
        grid = search.BucketGrid(cloud.xyz, cloud.mask, radius)
        cnt = grid.radius_count(
            cloud.xyz, radius, per_bucket=per_bucket,
            exclude_self_idx=torch.arange(cloud.capacity, dtype=torch.int32,
                                          device=cloud.device),
        )
    return cloud.with_mask(cloud.mask & (cnt >= min_neighbors))
