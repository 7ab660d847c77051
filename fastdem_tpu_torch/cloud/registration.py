"""Point-cloud registration: ICP, point-to-plane, GICP, VGICP (port of
``fastdem_tpu/cloud/registration.py``, re-derived for the GPU).

Gauss-Newton over se(3) with per-iteration correspondences, optional robust
kernels (Huber / Cauchy / Tukey) and max-correspondence-distance gating:

  * ``icp``            point-to-point, e = R s + t - q
  * ``point_to_plane`` e = n_q . (R s + t - q); needs target normals
  * ``gicp``           plane-to-plane Mahalanobis with per-point
                       covariances Omega = (C_q + R C_s R^T)^-1
  * ``vgicp``          GICP against per-voxel target Gaussians; the
                       correspondence is the voxel CONTAINING the
                       transformed point (a dense lattice table, or the
                       sorted voxel keys), covariances Segal-regularised.

Optimizers: ``gn`` (fixed tiny damping) and ``lm`` (Levenberg-Marquardt
with the reference's adaptive schedule: linearize once per outer
iteration, re-solve per lambda trial, accept only error decreases).

The GPU form:

  * nearest-neighbour correspondences are the reference's Gram form
    ``|s|^2 + |t|^2 - 2 s.t`` in its CPU operation order (the K=3 products
    as FMA chains), over source-row tiles of at most ~1 GB with the first
    index winning ties, so indices and squared distances are the
    reference's bit for bit where no near-tie decides;
  * the transformed points and residual vectors are float32 as in the
    reference; the weights, Jacobians and sums over the points (H, g, the
    error) are float64, and so are the damped 6x6 solve and the
    retraction, whose transform rounds to float32;
  * ``align``'s ``driver="fused"`` keeps the loop's control flow on the
    device, the counterpart of the reference's ``lax.while_loop``
    program: the transform, lambda, the error, the correspondence count,
    the iteration count and the converged / done flags are device
    tensors, and one correspondence pass (a GN iteration, or LM's
    linearization or one of its lambda trials) is a unit that leaves them
    unchanged once done is set. The units run in blocks of
    ``_FUSED_BLOCK`` with one host read per block (done and the results):
    the first block eagerly, the later ones as one CUDA graph on a card,
    captured for the call and dropped with it. A block of one unit runs
    no pass after done; the card's PyTorch exposes no conditional graph
    node that would skip the masked units of a longer block (counted in
    ``passes_run`` against ``passes_used``). ``driver="host"``, the
    default, is the reference's host driver: one read per iteration or LM
    trial, and no capture. Both give the same result bit for bit.
  * the stall test follows nanoPCL's ``criteria.hpp``: a previous error
    <= 0 counts as stalled. The reference's Python divides by
    ``max(prev_err, 1e-30)`` and does not stall there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.cloud import normals as nrm
from fastdem_tpu_torch.cloud.filters import voxel_key
from fastdem_tpu_torch.cloud.pointcloud import PointCloud
from fastdem_tpu_torch.grid.geometry import floor_i32
from fastdem_tpu_torch.numerics import div_f32, dot_fma, recip_f32, sqrt_f32, sum_sq
from fastdem_tpu_torch.utils import graphs

_I32_MAX = 2**31 - 1
# Bytes one correspondence tile may take (its float64 FMA steps included),
# and the bytes per tile entry those steps hold at once.
_TILE_BYTES = {"cuda": 1 << 30, "cpu": 1 << 26}
_BYTES_PER_ENTRY = 40

# Counted by ``align`` (reset them to 0 to count a span): host reads of the
# loop's values, and correspondence passes run / needed for the result
# (the fused driver's masked passes are the difference).
host_reads = 0
passes_run = 0
passes_used = 0


@dataclasses.dataclass
class RegistrationResult:
    T: np.ndarray  # final source->target transform
    converged: bool
    iterations: int
    error: float
    num_correspondences: int


def _robust_weight(kernel: str, scale: float, r2: torch.Tensor) -> torch.Tensor:
    """IRLS weights from squared residual norms."""
    r = sqrt_f32(torch.clamp_min(r2, 1e-20))
    one = torch.ones_like(r)
    if kernel == "none":
        return one
    if kernel == "huber":
        return torch.where(r <= scale, one, torch.full_like(r, scale) / r)
    if kernel == "cauchy":
        u = div_f32(r, scale)
        return one / (1.0 + u * u)
    if kernel == "tukey":
        u = div_f32(r, scale)
        v = 1.0 - u * u
        return torch.where(r <= scale, v * v, 0.0)
    raise ValueError(f"unknown robust kernel '{kernel}'")


def _solve_gn(H: torch.Tensor, g: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """The damped normal equations (H + damping I) delta = -g."""
    H = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(H, -g).result  # no host read of the info


def _skew_batch(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _transform(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """R @ p + t as the reference's compiled product: each row of R as an
    FMA chain over x, y, z, then the translation added."""
    return dot_fma(xyz[:, None, :], T[None, :3, :3]) + T[:3, 3]


def _nearest(source_T: torch.Tensor, target: torch.Tensor, target_mask: torch.Tensor):
    """1-NN by the Gram form over source-row tiles. Returns (idx i64[Ns],
    d2 f32[Ns]); masked targets are +inf, ties go to the lowest index."""
    dev = source_T.device
    ns, nt = source_T.shape[0], target.shape[0]
    ss = sum_sq(source_T)
    tt = sum_sq(target)
    t64 = target.double()
    budget = _TILE_BYTES.get(dev.type, _TILE_BYTES["cpu"])
    rows = max(1, budget // max(1, nt * _BYTES_PER_ENTRY))
    idx = torch.empty(ns, dtype=torch.int64, device=dev)
    d2 = torch.empty(ns, dtype=torch.float32, device=dev)
    for r0 in range(0, ns, rows):
        s = source_T[r0:r0 + rows]
        # s . t as fma(s2, t2, fma(s1, t1, s0 * t0)): each product is exact
        # in float64, so one float64 add and a rounding to float32 is the
        # FMA (as numerics.fma_f32).
        dot = s[:, None, 0] * target[None, :, 0]
        for c in (1, 2):
            dot = torch.addcmul(dot.double(), s[:, None, c].double(),
                                t64[None, :, c]).float()
        tile = (ss[r0:r0 + rows, None] + tt[None, :]) - 2.0 * dot
        del dot
        tile = torch.where(target_mask[None, :], tile, float("inf"))
        # argmin returns the first minimum on every device.
        i = torch.argmin(tile, dim=1)
        idx[r0:r0 + rows] = i
        d2[r0:r0 + rows] = torch.gather(tile, 1, i[:, None])[:, 0]
    return idx, d2


def _se3_exp64(xi: torch.Tensor) -> torch.Tensor:
    """Twist (tx, ty, tz, wx, wy, wz) -> 4x4 float64 transform (Rodrigues
    about the origin, first order near zero; translation added directly).
    No host read."""
    w = xi[3:]
    theta = torch.linalg.vector_norm(w)
    small = theta < 1e-8
    K = _skew_batch(w / torch.where(small, torch.ones_like(theta), theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = torch.where(small, eye + _skew_batch(w), R)
    T[:3, 3] = xi[:3]
    return T


def _gn_step_factory(method: str, kernel: str, kernel_scale: float,
                     max_dist: float, corr: str = "nearest",
                     voxel_size: float = 0.5,
                     corr_dims: Optional[Tuple[int, int, int]] = None):
    """One iteration's functions for a configuration: ``step`` (linearize +
    damped solve + retraction), ``err_fn`` (the error only), ``linearize``
    and ``solve_retract``.

    ``corr``:
      * "nearest"      the Gram-form 1-NN tiles;
      * "voxel"        the containing voxel, a binary search of the sorted
                       voxel keys (no distance gate);
      * "voxel_dense"  the containing voxel of a dense [ncells] table over
                       the lattice-aligned box (``corr_dims``, origin in
                       the ``vox`` argument): an arithmetic id and a gather.
    """
    max_d2 = float(np.float32(max_dist * max_dist))
    inv_voxel = recip_f32(voxel_size)

    def correspond(src, s_mask, t_xyz, t_mask, vox):
        if corr == "voxel_dense":
            nx, ny, nz = corr_dims
            c = floor_i32((src - vox[None, :]) * inv_voxel)
            inb = (c >= 0).all(dim=1) & (c[:, 0] < nx) & (c[:, 1] < ny) & (c[:, 2] < nz)
            cc = torch.clamp_min(c, 0).to(torch.int64)
            key = ((cc[:, 0].clamp_max(nx - 1) * ny + cc[:, 1].clamp_max(ny - 1)) * nz
                   + cc[:, 2].clamp_max(nz - 1))
            return key, s_mask & inb & t_mask[key]
        if corr == "voxel":
            key = voxel_key(floor_i32(src * inv_voxel))
            n = vox.shape[0]
            pos = torch.searchsorted(vox, key.contiguous()).clamp(0, n - 1)
            return pos, s_mask & (vox[pos] == key) & t_mask[pos]
        idx, d2 = _nearest(src, t_xyz, t_mask)
        return idx, s_mask & (d2 <= max_d2) & torch.isfinite(d2)

    def linearize(T, s_xyz, s_mask, t_xyz, t_mask, t_normals, s_cov, t_cov, vox,
                  need_hessian=True):
        src = _transform(s_xyz, T)
        idx, valid = correspond(src, s_mask, t_xyz, t_mask, vox)
        e = src - t_xyz[idx]  # [N, 3]
        n_corr = valid.sum()
        if method == "icp":
            r2 = sum_sq(e).double()
            w = _robust_weight(kernel, kernel_scale, r2.float()).double() * valid
        elif method == "point_to_plane":
            nq = t_normals[idx]
            r = (nq.double() * e.double()).sum(dim=1)
            r2 = r * r
            w = _robust_weight(kernel, kernel_scale, r2.float()).double() * valid
        else:  # gicp / vgicp share the distribution form
            R = T[:3, :3].double()
            Cs = R @ s_cov.double() @ R.T
            Omega = _inv3x3(t_cov[idx].double() + Cs)  # [N, 3, 3]
            e64 = e.double()
            r2 = torch.einsum("ni,nij,nj->n", e64, Omega, e64)
            w = _robust_weight(kernel, kernel_scale, r2.float()).double() * valid
        err = (w * r2).sum() / torch.clamp_min(n_corr, 1)
        if not need_hessian:
            return None, None, err, n_corr
        src64 = src.double()
        if method == "point_to_plane":
            J = torch.cat([nq.double(), torch.linalg.cross(src64, nq.double())], dim=1)
            H = torch.einsum("ni,n,nj->ij", J, w, J)
            g = torch.einsum("ni,n,n->i", J, w, r)
            return H, g, err, n_corr
        # J_i = [I | -skew(R s + t)] acting on (dt, dw)
        eye = torch.eye(3, dtype=torch.float64, device=src.device).expand(src.shape[0], 3, 3)
        J = torch.cat([eye, -_skew_batch(src64)], dim=2)  # [N, 3, 6]
        if method == "icp":
            H = torch.einsum("nij,n,nik->jk", J, w, J)
            g = torch.einsum("nij,n,ni->j", J, w, e.double())
        else:
            JO = torch.einsum("nij,nik->njk", J, Omega)  # J^T Omega [N, 6, 3]
            H = torch.einsum("njk,nkl,n->jl", JO, J, w)
            g = torch.einsum("njk,nk,n->j", JO, e.double(), w)
        return H, g, err, n_corr

    def solve_retract(H, g, T, lam):
        delta = _solve_gn(H, g, damping=lam)
        T_new = (_se3_exp64(delta) @ T.double()).float()
        return T_new, delta.float()

    def step(T, lam, *args):
        H, g, err, n_corr = linearize(T, *args)
        T_new, delta = solve_retract(H, g, T, lam)
        return T_new, delta, err, n_corr

    def err_fn(T, *args):
        _, _, err, n_corr = linearize(T, *args, need_hessian=False)
        return err, n_corr

    return step, err_fn, linearize, solve_retract


def segal_regularize(cov: torch.Tensor, epsilon: float = 1e-3) -> torch.Tensor:
    """Plane-to-plane covariance regularisation (Segal et al., RSS 2009):
    eigenvalues replaced by [epsilon, 1, 1]. The eigenvectors are float32
    LAPACK's, as the reference's: near-repeated eigenvalues make them
    sensitive, and a float64 solve lands ~1e-5 away from both."""
    w, v = torch.linalg.eigh(cov.float())  # ascending eigenvalues
    w_reg = torch.ones_like(w)
    w_reg[..., 0] = float(np.float32(epsilon))
    return torch.einsum("...ij,...j,...kj->...ik", v, w_reg, v)


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Sums of ``values`` rows per segment id in [0, num), in float64."""
    out = torch.zeros((num,) + tuple(values.shape[1:]), dtype=torch.float64,
                      device=values.device)
    return out.index_add_(0, seg, values.double())


def voxel_distributions(
    cloud: PointCloud, voxel_size: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-voxel (sorted keys, means, covariances, valid) for VGICP targets.

    Returns (keys_sorted i32[N] with empty tail = INT32_MAX, mean f32[N, 3],
    cov f32[N, 3, 3], valid bool[N]); entry i < num_voxels describes voxel
    i (the voxels in key order). Runs on the cloud's device."""
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    n = cloud.capacity
    key = voxel_key(floor_i32(div_f32(xyz, voxel_size)))
    key = torch.where(mask, key, _I32_MAX)
    key_s, order = torch.sort(key, stable=True)
    pts = xyz[order]
    valid_s = key_s != _I32_MAX
    heads = valid_s & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                 key_s[1:] != key_s[:-1]])
    gid = torch.where(valid_s, torch.cumsum(heads.to(torch.int64), 0) - 1, n)
    ones = valid_s.to(torch.float32)
    cnt = _segment_sum(ones, gid, n + 1)[:n].float()
    sums = _segment_sum(pts * ones[:, None], gid, n + 1)[:n].float()
    mean = sums / torch.clamp_min(cnt, 1.0)[:, None]
    d = (pts - mean[gid.clamp_max(n - 1)]) * ones[:, None]
    covs = _segment_sum(d[:, :, None] * d[:, None, :], gid, n + 1)[:n].float()
    cov = covs / torch.clamp_min(cnt, 1.0)[:, None, None]
    # Regularise sparse voxels toward isotropic.
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    cov = torch.where((cnt >= 3.0)[:, None, None], cov + 1e-6 * eye,
                      eye * float(np.float32(voxel_size) ** 2))
    # Voxel i's key is the i-th head's key; the head keys in order first.
    head_keys = torch.sort(torch.where(heads, key_s, _I32_MAX)).values
    valid_voxel = torch.arange(n, device=dev) < heads.sum()
    mean = torch.where(valid_voxel[:, None], mean, 0.0)
    return head_keys, mean, cov, valid_voxel


def voxel_distribution_table(
    cloud: PointCloud, voxel_size: float, max_cells: int = 4_000_000
):
    """Dense per-voxel Gaussian table for VGICP targets.

    The box is the reference's, computed on the host from the valid points:
    a lattice-aligned origin (a multiple of the voxel side) with a one-voxel
    margin, the side grown 1.5x while the box exceeds ``max_cells``. One
    segment-sum pass then gives each cell's mean and covariance (pivoted at
    the cell corner).

    Returns (origin np.f32[3], dims (nx, ny, nz), mean f32[ncells, 3],
    cov f32[ncells, 3, 3], valid bool[ncells], effective voxel side)."""
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    pts = xyz[mask].cpu().numpy()
    if pts.shape[0] == 0:
        pts = np.zeros((1, 3), np.float32)
    b = float(voxel_size)
    lo = np.floor(pts.min(axis=0) / b) - 1
    hi = np.floor(pts.max(axis=0) / b) + 1
    while True:
        dims = (hi - lo + 1).astype(np.int64)
        if int(dims.prod()) <= max_cells:
            break
        b *= 1.5
        lo = np.floor(pts.min(axis=0) / b) - 1
        hi = np.floor(pts.max(axis=0) / b) + 1
    origin = (lo * b).astype(np.float32)
    dims = tuple(int(d) for d in dims)
    nx, ny, nz = dims
    ncells = nx * ny * nz

    org = torch.as_tensor(origin, device=dev)
    c = floor_i32(div_f32(xyz - org[None, :], b))
    hi_t = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32, device=dev)
    c = torch.minimum(torch.clamp_min(c, 0), hi_t)
    c64 = c.to(torch.int64)
    key = torch.where(mask, (c64[:, 0] * ny + c64[:, 1]) * nz + c64[:, 2], ncells)
    w = mask.to(torch.float32)
    cnt = _segment_sum(w, key, ncells + 1)[:ncells].float()
    # Pivot at the voxel corner for covariance stability (local extents).
    piv = c.to(torch.float32) * float(np.float32(b)) + org[None, :]
    d = (xyz - piv) * w[:, None]
    s1 = _segment_sum(d, key, ncells + 1)[:ncells].float()
    s2 = _segment_sum(d[:, :, None] * d[:, None, :], key, ncells + 1)[:ncells].float()
    cnt_safe = torch.clamp_min(cnt, 1.0)
    mu = s1 / cnt_safe[:, None]
    cov = s2 / cnt_safe[:, None, None] - mu[:, :, None] * mu[:, None, :]
    ix, iy, iz = torch.meshgrid(torch.arange(nx, device=dev), torch.arange(ny, device=dev),
                                torch.arange(nz, device=dev), indexing="ij")
    grid_pos = (torch.stack([ix, iy, iz], dim=-1).reshape(ncells, 3).to(torch.float32)
                * float(np.float32(b)) + org)
    mean = mu + grid_pos
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    cov = torch.where((cnt >= 3.0)[:, None, None], cov + 1e-6 * eye,
                      eye * float(np.float32(b) * np.float32(b)))
    valid = cnt >= 1.0
    mean = torch.where(valid[:, None], mean, 0.0)
    return origin, dims, mean, cov, valid, b


def _small(delta: np.ndarray, translation_eps: float, rotation_eps: float) -> bool:
    d = delta.astype(np.float32)
    return bool(np.sqrt(np.sum(d[:3] * d[:3], dtype=np.float32)) < np.float32(translation_eps)
                and np.sqrt(np.sum(d[3:] * d[3:], dtype=np.float32))
                < np.float32(rotation_eps))


def _stalled(prev_err: float, cur_err: float, relative_error_eps: float) -> bool:
    """nanoPCL's ``criteria.hpp`` is_stalled: a previous error <= 0 is
    stalled; otherwise |prev - cur| / prev < eps (float32)."""
    prev, cur = np.float32(prev_err), np.float32(cur_err)
    if prev <= 0:
        return True
    return bool(np.abs(prev - cur) / prev < np.float32(relative_error_eps))


def _small_t(delta: torch.Tensor, translation_eps: float, rotation_eps: float):
    """``_small`` on the device (float32, the squares summed left to right)."""
    d2 = delta * delta
    return ((torch.sqrt(d2[0] + d2[1] + d2[2]) < float(np.float32(translation_eps)))
            & (torch.sqrt(d2[3] + d2[4] + d2[5]) < float(np.float32(rotation_eps))))


def _stalled_t(prev: torch.Tensor, cur: torch.Tensor, relative_error_eps: float):
    """``_stalled`` on the device (float32)."""
    return (prev <= 0) | (torch.abs(prev - cur) / prev < float(np.float32(relative_error_eps)))


def _gn_unit(fns, c):
    """One Gauss-Newton iteration of the fused driver, on the device: the
    host loop's body with its branches as selections."""
    step = fns[0]

    def unit(s, args):
        T_new, delta, err_t, n_t = step(s["T"], 1e-6, *args)
        err = err_t.float()
        fail = n_t < c["min_correspondences"]
        conv = ~fail & (_small_t(delta, c["translation_eps"], c["rotation_eps"])
                        | _stalled_t(s["prev"], err, c["relative_error_eps"]))
        it = s["it"] + (~fail).to(torch.int64)
        return dict(s, T=torch.where(fail, s["T"], T_new), err=err, n=n_t, it=it, prev=err,
                    converged=conv, done=fail | conv | (it >= c["max_iterations"]))

    return unit


def _lm_unit(fns, c):
    """One pass of adaptive LM on the device: phase 0 evaluates the error at
    the start, phase 1 linearizes at T (the start of an iteration), phase 2
    tries one lambda. Each is one correspondence pass, as in the host loop
    (the linearization at the trial transform also gives the trial's
    error)."""
    _, _, linearize, solve_retract = fns
    lf = float(c["lambda_factor"])

    def unit(s, args):
        phase = s["phase"]
        T_try, delta_try = solve_retract(s["H"], s["g"], s["T"], s["lam"])
        trial = phase == 2
        H, g, err_t, n_t = linearize(torch.where(trial, T_try, s["T"]), *args)
        err = err_t.float()
        # Phase 0: the starting error. Phase 1: a new iteration.
        start_fail = n_t < c["min_correspondences"]
        it1 = s["it"] + 1
        no_trials = c["max_inner_iterations"] <= 0
        # Phase 2: a trial, accepted if the error drops.
        better = trial & (err < s["err"])
        trials = s["trials"] + 1
        acc_fail = better & (n_t < c["min_correspondences"])
        acc_conv = better & ~acc_fail & (
            _small_t(delta_try, c["translation_eps"], c["rotation_eps"])
            | _stalled_t(s["prev"], err, c["relative_error_eps"]))
        exhausted = trial & ~better & (trials >= c["max_inner_iterations"])
        start, lin = phase == 0, phase == 1
        return dict(
            s,
            T=torch.where(better, T_try, s["T"]),
            err=torch.where(start | better, err, s["err"]),
            n=torch.where(start | better, n_t, s["n"]),
            it=torch.where(lin, it1, s["it"]),
            prev=torch.where(lin, s["err"], s["prev"]),
            H=torch.where(lin, H, s["H"]),
            g=torch.where(lin, g, s["g"]),
            lam=torch.where(better, torch.clamp_min(s["lam"] / lf, 1e-12),
                            torch.where(trial, torch.clamp_max(s["lam"] * lf, 1e8), s["lam"])),
            trials=torch.where(lin, torch.zeros_like(trials),
                               torch.where(trial, trials, s["trials"])),
            phase=torch.where(start | better, torch.ones_like(phase),
                              torch.where(lin, torch.full_like(phase, 2), phase)),
            converged=(lin & no_trials) | acc_conv | exhausted,
            done=(start & (start_fail | (c["max_iterations"] <= 0))) | (lin & no_trials)
            | acc_fail | acc_conv | exhausted
            | (better & (s["it"] >= c["max_iterations"])),
        )

    return unit


# Correspondence passes per host read of the fused driver. One runs no
# pass after the loop is done.
_FUSED_BLOCK = 1


def _fused_block(unit, block: int):
    """``block`` masked units as one function of ((state, args),) ->
    ((state, args), the values the host reads: done, error, count,
    iterations, converged, passes used, T), the arguments passed through
    so the graph's later replays copy nothing into its slots."""

    def run(carry):
        s, args = carry
        for _ in range(block):
            active = ~s["done"]
            new = unit(s, args)
            s = {k: torch.where(active, new[k], v) for k, v in s.items()}
            s["used"] = s["used"] + active.to(torch.int64)
        head = torch.stack([s["done"].double(), s["err"].double(), s["n"].double(),
                            s["it"].double(), s["converged"].double(), s["used"].double()])
        return (s, args), torch.cat([head, s["T"].reshape(-1).double()])

    return run


def align(
    source: PointCloud,
    target: PointCloud,
    method: str = "gicp",
    init: Optional[np.ndarray] = None,
    max_iterations: int = 50,
    max_correspondence_distance: float = 1.0,
    translation_eps: float = 1e-4,
    rotation_eps: float = 1e-4,
    relative_error_eps: float = 1e-6,
    min_correspondences: int = 10,
    kernel: str = "none",
    kernel_scale: float = 1.0,
    knn_covariance: int = 10,
    voxel_size: float = 0.5,
    optimizer: str = "gn",
    init_lambda: float = 1e-3,
    lambda_factor: float = 10.0,
    max_inner_iterations: int = 10,
    covariance_epsilon: float = 1e-3,
    driver: str = "host",
    knn_method: str = "auto",
    knn_bucket_size: Optional[float] = None,
    correspondence: str = "dense",
) -> RegistrationResult:
    """Align source to target (nanopcl::registration::align equivalent), on
    the clouds' device (both clouds must share it).

    Correspondences: ``icp`` / ``point_to_plane`` / ``gicp`` take the
    nearest target point (Gram-form tiles, exact); ``vgicp`` takes the
    target voxel CONTAINING the transformed point, from the dense
    lattice-aligned table (``correspondence="dense"``) or the sorted voxel
    keys (``"sorted"``), with Segal-regularised voxel covariances.

    ``optimizer``: "gn" (Gauss-Newton, damping 1e-6) or "lm" (accept a trial
    step only if the re-evaluated error drops: lambda /= ``lambda_factor``
    on success, *= on failure, up to ``max_inner_iterations`` trials per
    outer step).

    ``knn_method`` / ``knn_bucket_size``: the neighbour search of the
    normal / covariance preparation (``search.knn``'s methods).

    ``driver``: "host" (the default) is the host loop, with one read per
    iteration or LM trial. "fused" keeps the loop's control flow on the
    device (see the module docstring): ``_FUSED_BLOCK`` correspondence
    passes (GN iterations, or LM linearizations and trials) per host
    read, the blocks after the first one CUDA graph on a card, captured
    for this call. Both give the same result bit for bit; any other value
    raises.
    """
    if optimizer not in ("gn", "lm"):
        raise ValueError(f"unknown optimizer: {optimizer!r}")
    if driver not in ("fused", "host"):
        raise ValueError(f"unknown driver: {driver!r}")
    if source.xyz.device != target.xyz.device:
        raise ValueError(
            f"source and target lie on different devices "
            f"({source.xyz.device} and {target.xyz.device})"
        )
    dev = source.xyz.device
    if isinstance(init, torch.Tensor):
        init = init.detach().cpu().numpy()
    T = torch.as_tensor(np.asarray(init if init is not None else np.eye(4), np.float32),
                        device=dev)

    t_normals = torch.zeros_like(target.xyz)
    s_cov = torch.zeros((source.capacity, 3, 3), dtype=torch.float32, device=dev)
    t_cov = torch.zeros((target.capacity, 3, 3), dtype=torch.float32, device=dev)
    t_xyz, t_mask = target.xyz, target.mask
    prep = dict(k=knn_covariance, method=knn_method, bucket_size=knn_bucket_size)

    if method == "point_to_plane":
        if "normal" not in target.channels:
            target = nrm.estimate_normals(target, **prep)
        t_normals = target.channels["normal"]
    elif method == "gicp":
        if "covariance" not in source.channels:
            source = nrm.estimate_covariances(source, **prep)
        if "covariance" not in target.channels:
            target = nrm.estimate_covariances(target, **prep)
        s_cov = source.channels["covariance"]
        t_cov = target.channels["covariance"]
    corr = "nearest"
    corr_dims = None
    vox = torch.zeros(1, dtype=torch.int32, device=dev)
    if method == "vgicp":
        if "covariance" not in source.channels:
            source = nrm.estimate_covariances(source, **prep)
        s_cov = source.channels["covariance"]
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        if correspondence == "dense":
            origin_v, dims_v, vmean, vcov, vvalid, b_eff = voxel_distribution_table(
                target, voxel_size)
            vox = torch.as_tensor(origin_v, device=dev)
            corr, corr_dims, voxel_size = "voxel_dense", dims_v, b_eff
        elif correspondence == "sorted":
            vox, vmean, vcov, vvalid = voxel_distributions(target, voxel_size)
            corr = "voxel"
        else:
            raise ValueError(f"unknown correspondence: {correspondence!r}")
        t_xyz, t_mask = vmean, vvalid
        t_cov = torch.where(vvalid[:, None, None], segal_regularize(vcov, covariance_epsilon),
                            eye)
        method = "gicp"
    elif method not in ("icp", "point_to_plane", "gicp"):
        raise ValueError(f"unknown method: {method!r}")

    factory = (method, kernel, kernel_scale, max_correspondence_distance, corr, voxel_size,
               corr_dims)
    args = (source.xyz, source.mask, t_xyz, t_mask, t_normals, s_cov, t_cov, vox)
    if driver == "fused":
        crit = dict(
            max_iterations=max_iterations, min_correspondences=min_correspondences,
            translation_eps=translation_eps, rotation_eps=rotation_eps,
            relative_error_eps=relative_error_eps, lambda_factor=lambda_factor,
            max_inner_iterations=max_inner_iterations,
        )
        return _align_fused(optimizer, factory, crit, T, init_lambda, args)
    step, err_fn, linearize, solve_retract = _gn_step_factory(*factory)
    passes = [0]

    def read(err_t, n_t, delta_t=None):
        """One host read of an iteration's error, count (and step)."""
        global host_reads
        parts = [err_t.reshape(1).double(), n_t.reshape(1).double()]
        if delta_t is not None:
            parts.append(delta_t.double())
        h = torch.cat(parts).cpu().numpy()
        host_reads += 1
        return float(np.float32(h[0])), int(h[1]), (h[2:] if delta_t is not None else None)

    converged = False
    err = float("inf")
    n_corr = 0
    it = 0
    if optimizer == "gn":
        prev_err = 3.4e38
        for it in range(1, max_iterations + 1):
            T_new, delta_t, err_t, n_t = step(T, 1e-6, *args)
            passes[0] += 1
            err, n_corr, delta = read(err_t, n_t, delta_t)
            if n_corr < min_correspondences:
                it -= 1  # failed result at the pre-step transform
                break
            T = T_new
            if (_small(delta, translation_eps, rotation_eps)
                    or _stalled(prev_err, err, relative_error_eps)):
                converged = True
                break
            prev_err = err
    else:  # adaptive LM
        lam = float(np.float32(init_lambda))
        err, n_corr, _ = read(*err_fn(T, *args))
        passes[0] += 1
        if n_corr < min_correspondences:
            it = 0
        else:
            for it in range(1, max_iterations + 1):
                accepted = False
                delta = np.zeros(6)
                prev_err = err
                # Linearize ONCE at T; lambda trials re-solve and re-check
                # the error only.
                H, g, _, _ = linearize(T, *args)
                passes[0] += 1
                for _ in range(max_inner_iterations):
                    T_try, delta_t = solve_retract(H, g, T, lam)
                    err_t, n_t = err_fn(T_try, *args)
                    passes[0] += 1
                    err_new, n_new, delta_new = read(err_t, n_t, delta_t)
                    if err_new < err:
                        lam = max(lam / lambda_factor, 1e-12)
                        T, err, n_corr, delta = T_try, err_new, n_new, delta_new
                        accepted = True
                        break
                    lam = min(lam * lambda_factor, 1e8)
                if accepted and n_corr < min_correspondences:
                    break  # failed: too few correspondences
                if not accepted:
                    converged = True  # no improving step: local minimum
                    break
                if (_small(delta, translation_eps, rotation_eps)
                        or _stalled(prev_err, err, relative_error_eps)):
                    converged = True
                    break

    global passes_run, passes_used
    passes_run += passes[0]
    passes_used += passes[0]
    return RegistrationResult(
        T=T.cpu().numpy(),
        converged=converged,
        iterations=it,
        error=err,
        num_correspondences=n_corr,
    )


def _align_fused(optimizer, factory, crit, T, init_lambda, args) -> RegistrationResult:
    """``align``'s fused driver: the GN or LM units of ``_gn_unit`` /
    ``_lm_unit`` in blocks of ``_FUSED_BLOCK``, one host read a block,
    until done. The first block runs eagerly; the later ones replay one
    graph captured for this call (it loads no kernel and makes no library
    handle that the first block did not)."""
    global host_reads, passes_run, passes_used
    max_iterations = crit["max_iterations"]
    if optimizer == "gn" and max_iterations <= 0:
        return RegistrationResult(T=T.cpu().numpy(), converged=False, iterations=0,
                                  error=float("inf"), num_correspondences=0)
    fns = _gn_step_factory(*factory)
    unit = (_gn_unit if optimizer == "gn" else _lm_unit)(fns, crit)
    block = _FUSED_BLOCK
    run = _fused_block(unit, block)
    dev = T.device

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    s = dict(T=T, err=scalar(np.inf, torch.float32), n=scalar(0, torch.int64),
             it=scalar(0, torch.int64), prev=scalar(np.float32(3.4e38), torch.float32),
             converged=scalar(False, torch.bool), done=scalar(False, torch.bool),
             used=scalar(0, torch.int64))
    units = max_iterations
    if optimizer == "lm":
        s.update(H=torch.zeros((6, 6), dtype=torch.float64, device=dev),
                 g=torch.zeros(6, dtype=torch.float64, device=dev),
                 lam=scalar(float(np.float32(init_lambda)), torch.float64),
                 trials=scalar(0, torch.int64), phase=scalar(0, torch.int64))
        units = 1 + max(max_iterations, 0) * (1 + max(crit["max_inner_iterations"], 0))
    carry = (s, tuple(args))
    for steps in range(1, -(-units // block) + 1):
        if steps == 2:
            run = graphs.jit(run, donate=True, warm=False)
        carry, head = run(carry)
        h = head.cpu().numpy()
        host_reads += 1
        if h[0]:
            break
    else:
        raise RuntimeError("the fused driver did not finish within its bound of passes")
    passes_run += steps * block
    passes_used += int(h[5])
    return RegistrationResult(
        T=h[6:].astype(np.float32).reshape(4, 4),
        converged=bool(h[4]),
        iterations=int(h[3]),
        error=float(np.float32(h[1])),
        num_correspondences=int(h[2]),
    )
