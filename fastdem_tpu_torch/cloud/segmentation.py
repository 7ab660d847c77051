"""Segmentation: RANSAC plane fit, euclidean clustering, ground extraction
(port of ``fastdem_tpu/cloud/segmentation.py``).

  * RANSAC plane: all hypothesis triples are drawn up front, from the
    reference's own PRNG stream (``utils/prng.py``, so a seed finds the
    reference's plane), and scored in one [M, N] distance pass, then
    refined by PCA over the inliers.
  * Euclidean clustering: min-label propagation with pointer jumping over
    the voxel-bucket neighbour graph (``search.BucketGrid``), in blocks of
    sweeps with one host read of the ``changed`` flag per block (the
    reference runs a ``lax.while_loop``).
  * Grid ground segmentation: per-cell robust minimum as the exact
    percentile order statistic, via a sort by (cell, z) (two stable sorts)
    and each point's cell head (a ``cummax`` of head positions), then the
    thickness-band classification.

Every function runs on the cloud's device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from fastdem_tpu_torch.cloud.pca import _cross, eigh3x3
from fastdem_tpu_torch.cloud.pointcloud import PointCloud
from fastdem_tpu_torch.cloud.search import BucketGrid
from fastdem_tpu_torch.grid.geometry import floor_i32
from fastdem_tpu_torch.numerics import div_f32, dot_fma, sqrt_f32, sum_seq, sum_sq
from fastdem_tpu_torch.utils import prng

_I32_MAX = 2**31 - 1

# Counted by ``euclidean_cluster`` (reset them to 0 to count a span): host
# reads of the propagation's flag, and the sweeps the propagation needed
# (those a per-sweep loop runs: up to the first that changes nothing).
host_reads = 0
sweeps = 0


# ---------------------------------------------------------------------------
# RANSAC plane
# ---------------------------------------------------------------------------


class PlaneModel(NamedTuple):
    coefficients: torch.Tensor  # [nx, ny, nz, d], |n| = 1, n.p + d = 0


@dataclasses.dataclass
class RansacResult:
    model: PlaneModel
    inliers: torch.Tensor  # bool[N]
    fitness: float
    iterations: int

    def success(self) -> bool:
        return self.fitness > 0.0


def _plane_dist(xyz: torch.Tensor, normal: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """|x . n + d| of points f32[N, 3] to planes n f32[M, 3], d [M]: f32[M,
    N]. The K=3 product term by term in the reference's CPU dot order (x0
    n0, then two FMAs), then the offset added once."""
    return torch.abs(dot_fma(normal[:, None, :], xyz[None, :, :]) + d[:, None])


def segment_plane(
    cloud: PointCloud,
    distance_threshold: float = 0.1,
    max_iterations: int = 100,
    seed: int = 0,
    refine: bool = True,
) -> RansacResult:
    """RANSAC plane fit; one batched hypothesis sweep. The triples are
    ``jax.random.randint(PRNGKey(seed), (M, 3), 0, N)``, bit for bit."""
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    n = cloud.capacity
    thr = float(np.float32(distance_threshold))
    idx = prng.randint(prng.prng_key(seed), (max_iterations, 3), 0, n, device=dev).long()
    p = xyz[idx]  # [M, 3, 3]
    v1 = p[:, 1] - p[:, 0]
    v2 = p[:, 2] - p[:, 0]
    normal = _cross(v1, v2)
    norm = sqrt_f32(sum_sq(normal))[:, None]
    ok = (norm[:, 0] > 1e-8) & mask[idx].all(dim=1)
    normal = normal / torch.clamp_min(norm, 1e-12)
    d = -sum_seq(normal * p[:, 0], 1)  # [M]

    dist = _plane_dist(xyz, normal, d)  # [M, N]
    inl = (dist <= thr) & mask[None, :]
    counts = torch.where(ok, inl.sum(dim=1), -1)
    best = int(torch.argmax(counts))  # the first maximum, as the reference
    best_normal, best_d, inliers = normal[best], d[best], inl[best]

    if refine:
        # PCA over the inliers; the moments accumulate in float64 (the
        # reference's f32 sums over N points have no fixed order to copy).
        w = inliers.to(torch.float64)
        x64 = xyz.double()
        cnt = torch.clamp_min(w.sum(), 1.0)
        mean = ((x64 * w[:, None]).sum(dim=0) / cnt).float()
        dd = (x64 - mean.double()) * w[:, None]
        cov = ((dd.T @ dd) / cnt).float()
        _, vec = eigh3x3(cov[None])
        nrm = vec[0, :, 0]
        if float(torch.dot(best_normal.double(), nrm.double())) < 0:
            nrm = -nrm
        best_normal = nrm
        best_d = -sum_seq(nrm * mean, 0)
        inliers = (_plane_dist(xyz, best_normal[None], best_d[None])[0] <= thr) & mask

    fitness = float(inliers.sum()) / max(int(mask.sum()), 1)
    return RansacResult(
        model=PlaneModel(torch.cat([best_normal, best_d.reshape(1)])),
        inliers=inliers,
        fitness=fitness,
        iterations=max_iterations,
    )


# ---------------------------------------------------------------------------
# Euclidean clustering
# ---------------------------------------------------------------------------


# Propagation sweeps per host read of the ``changed`` flag.
_SWEEPS_PER_READ = 4


def _sweeps(count: int):
    """``count`` propagation sweeps with no host read: ((labels, cand,
    active),) -> ((labels, cand, active), [active, sweeps the loop needed
    in the block]). ``active`` is False once a sweep changed nothing; the
    sweeps after it change nothing either."""

    def run(carry):
        labels, cand, active = carry
        n = labels.shape[0]
        tail = torch.full((1,), n, dtype=labels.dtype, device=labels.device)
        needed = torch.zeros((), dtype=torch.int64, device=labels.device)
        for _ in range(count):
            lab_ext = torch.cat([labels, tail])
            new = torch.minimum(labels, lab_ext[cand].amin(dim=1))
            # Pointer jumping accelerates convergence.
            new = torch.minimum(new, lab_ext[new.clamp_max(n - 1)])
            needed = needed + active.to(torch.int64)
            active = active & (new != labels).any()
            labels = new
        return (labels, cand, active), torch.stack([active.to(torch.int64), needed])

    return run


def _propagate(labels: torch.Tensor, cand: torch.Tensor, max_sweeps: int) -> torch.Tensor:
    """Min-label propagation to a fixpoint or ``max_sweeps`` sweeps, in
    eager blocks of ``_SWEEPS_PER_READ`` with one host read each, the last
    cut short at ``max_sweeps``. Not a CUDA graph: one made per call costs
    more than it saves (PERF.md), and one kept across calls would hold its
    copy of the [N, 27 * per_bucket] candidate table."""
    global host_reads, sweeps
    carry = (labels, cand, torch.ones((), dtype=torch.bool, device=labels.device))
    done = 0
    while done < max_sweeps:
        count = min(_SWEEPS_PER_READ, max_sweeps - done)
        carry, flags = _sweeps(count)(carry)
        done += count
        active, needed = flags.tolist()  # the block's one host read
        host_reads += 1
        sweeps += needed
        if not active:
            break
    return carry[0]


def euclidean_cluster(
    cloud: PointCloud,
    tolerance: float = 0.5,
    min_cluster_size: int = 1,
    max_cluster_size: Optional[int] = None,
    per_bucket: int = 16,
    max_sweeps: int = 64,
) -> torch.Tensor:
    """Connected components of the radius-``tolerance`` graph.

    Returns i32[N] labels (compacted, -1 for invalid / filtered points).
    Min-label propagation with pointer jumping (label = label[label]) until
    a fixpoint or ``max_sweeps`` sweeps. The sweeps run in blocks
    (``_propagate``: one host read of the flag per block), the last cut so
    the sweeps never pass ``max_sweeps``. A sweep at the fixpoint changes
    nothing, so the labels are those of a loop that reads the flag after
    every sweep. ``BucketGrid`` sizes its buckets on the host.
    """
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    n = cloud.capacity
    grid = BucketGrid(xyz, mask, tolerance)
    cand, cvalid = grid.candidates(xyz, per_bucket)
    cand = cand.long()
    diff = xyz[cand.clamp_min(0)] - xyz[:, None, :]
    d2 = sum_seq(diff * diff, -1)
    adj = cvalid & (d2 <= float(np.float32(tolerance * tolerance))) & mask[:, None]
    cand = torch.where(adj, cand, n)

    ar = torch.arange(n, device=dev)
    labels = _propagate(torch.where(mask, ar, n), cand, max_sweeps)

    # Compact labels + size filtering.
    root = mask & (labels == ar)
    compact = torch.cumsum(root.to(torch.int64), 0) - 1
    lab_compact = torch.where(mask, compact[labels.clamp(0, max(n - 1, 0))], -1)
    sizes = torch.bincount(torch.where(mask, lab_compact, n), minlength=n + 1)
    sz = sizes[lab_compact.clamp(0, max(n - 1, 0))]
    keep = mask & (sz >= min_cluster_size)
    if max_cluster_size is not None:
        keep = keep & (sz <= max_cluster_size)
    return torch.where(keep, lab_compact, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Grid ground segmentation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GroundSegConfig:
    """Mirrors nanoPCL's GroundSegConfig."""

    grid_resolution: float = 0.5
    cell_percentile: float = 0.2
    ground_thickness: float = 0.3
    max_ground_height: float = 0.5
    min_points_per_cell: int = 2


def segment_ground(
    cloud: PointCloud, config: Optional[GroundSegConfig] = None
) -> torch.Tensor:
    """Grid-based ground mask, the reference's semantics:
      * per 2D cell, robust_min = the floor(percentile * (count-1))-th
        sorted z (exact order statistic via a sort by (cell, z) and each
        point's cell head);
      * ground = z <= robust_min + ground_thickness (no lower bound);
      * obstacle-only cell when robust_min > max_ground_height (absolute)
        or the cell has < min_points_per_cell points.
    Returns bool[N] ground mask."""
    cfg = config or GroundSegConfig()
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    n = cloud.capacity
    coords = floor_i32(div_f32(xyz[:, :2], cfg.grid_resolution))
    B = 4096
    cell = (torch.clamp(coords[:, 0] + B // 2, 0, B - 1) * B
            + torch.clamp(coords[:, 1] + B // 2, 0, B - 1))
    cell = torch.where(mask, cell, _I32_MAX)

    # Sort by (cell, z): z first, then cell, both stable.
    order = torch.sort(xyz[:, 2], stable=True).indices
    order = order[torch.sort(cell[order], stable=True).indices]
    cell_s, z_s = cell[order], xyz[order, 2]
    valid_s = cell_s != _I32_MAX
    pos = torch.arange(n, device=dev)
    heads = valid_s & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                 cell_s[1:] != cell_s[:-1]])
    gid = torch.where(valid_s, torch.cumsum(heads.to(torch.int64), 0) - 1, n)
    cnt = torch.bincount(gid, minlength=n + 1)
    cnt[n] = 0
    cnt_s = cnt[gid]
    # Each point's cell head: the running max of head positions.
    head_pos = torch.cummax(torch.where(heads, pos, 0), 0).values
    pct = torch.tensor(np.float32(cfg.cell_percentile), device=dev)
    k = torch.floor(pct * torch.clamp_min(cnt_s - 1, 0).to(torch.float32)).to(torch.int64)
    robust_min = z_s[torch.clamp(head_pos + k, 0, max(n - 1, 0))]

    ground_s = (
        valid_s
        & (cnt_s >= cfg.min_points_per_cell)
        & (robust_min <= float(np.float32(cfg.max_ground_height)))
        & (z_s <= robust_min + torch.tensor(np.float32(cfg.ground_thickness), device=dev))
    )
    ground = torch.zeros(n, dtype=torch.bool, device=dev)
    ground[order] = ground_s
    return ground & mask
