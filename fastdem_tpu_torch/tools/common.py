"""What the tools share: the config options, the scan sources, the
synthetic site of the batch DEM and the registration benchmark's scene."""

from __future__ import annotations

import glob
import os

import numpy as np

from fastdem_tpu_torch import presets


def add_config_args(ap) -> None:
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--preset", choices=presets.names(),
                       help="a built-in node preset (needs no PyYAML)")
    group.add_argument("--config", metavar="FILE.yaml",
                       help="a node config file (needs PyYAML)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to map on (default: cuda; there is no "
                         "fallback when it is absent)")
    ap.add_argument("--program-cache", default=None, metavar="DIR",
                    help="a program-cache bundle (runtime/aotcache.py): load the "
                         "built kernels and native IO from DIR, build missing ones "
                         "into it")


def enable_program_cache(args) -> None:
    """Enable ``--program-cache`` before anything is built."""
    if args.program_cache:
        from fastdem_tpu_torch.runtime import aotcache

        aotcache.enable(args.program_cache)


def site_terrain(x, y):
    """Ground height (m) of the synthetic site at world x, y."""
    return 1.5 * np.sin(x / 9.0) * np.cos(y / 13.0) + 0.4 * np.sin(x / 2.3 + y / 3.1)


def synthetic_site(num_points=500_000, size=100.0, seed=0, outliers=0.005,
                   floating=0.05):
    """A site's point-cloud map for the batch DEM: ``num_points`` points over
    a ``size`` x ``size`` m terrain (noise sigma 2 cm), of which a share
    ``floating`` hang 3-8 m above the ground (canopy, wires) and a share
    ``outliers`` are gross outliers, the points pushed 10x out from the
    centre; in random order, with intensity and a height-coded colour.
    Returns (xyz f32[N, 3], intensity f32[N], color u8[N, 3])."""
    rng = np.random.default_rng(seed)
    n_out = int(round(num_points * outliers))
    n_float = int(round(num_points * floating))
    xy = rng.uniform(-size / 2, size / 2, (num_points, 2))
    z = site_terrain(xy[:, 0], xy[:, 1]) + rng.normal(0.0, 0.02, num_points)
    z[:n_float] += rng.uniform(3.0, 8.0, n_float)
    xyz = np.column_stack([xy, z])
    xyz[n_float:n_float + n_out] *= 10.0
    xyz = xyz[rng.permutation(num_points)].astype(np.float32)
    intensity = rng.uniform(0.0, 255.0, num_points).astype(np.float32)
    level = np.clip((xyz[:, 2] + 2.0) * 40.0, 0, 255).astype(np.uint8)
    color = np.stack([level, 255 - level, np.full_like(level, 96)], axis=1)
    return xyz, intensity, color


def load_node_config(args):
    from fastdem_tpu_torch.runtime.node_config import NodeConfig

    if args.preset:
        return NodeConfig.from_preset(args.preset)
    return NodeConfig.load(args.config)


def synthetic_scans(n, num_points=30000, seed=0):
    """N synthetic VLP-16-like scans with a robot moving 0.3 m per scan
    along x: (sensor-frame xyz f32[N, 3], T_world_base, timestamp ns)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        ang = rng.uniform(0, 2 * np.pi, num_points)
        rad = rng.uniform(0.5, 7.0, num_points)
        x = rad * np.cos(ang)
        y = rad * np.sin(ang)
        wx = x + 0.3 * i
        z = 0.25 * np.sin(0.6 * wx) * np.cos(0.5 * y) - 1.0 + rng.normal(
            0, 0.02, num_points
        )
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.3 * i
        yield np.column_stack([x, y, z]).astype(np.float32), T_wb, (i + 1) * int(1e9)


def file_scans(scan_dir, trajectory):
    """The .pcd / .bin scans of a directory (sorted), with T_world_base
    from a TUM or KITTI trajectory (identity without one)."""
    from fastdem_tpu_torch.io import pcd as pcd_io

    files = sorted(
        glob.glob(os.path.join(scan_dir, "*.pcd"))
        + glob.glob(os.path.join(scan_dir, "*.bin"))
    )
    if not files:
        raise SystemExit(f"no .pcd/.bin scans in {scan_dir}")
    poses = None
    times = None
    if trajectory:
        times, poses = pcd_io.load_trajectory(trajectory)
    for i, f in enumerate(files):
        cloud = (
            pcd_io.load_kitti_bin(f, device="cpu") if f.endswith(".bin")
            else pcd_io.load_pcd(f, device="cpu")
        )
        T_wb = (
            poses[min(i, len(poses) - 1)]
            if poses is not None
            else np.eye(4, dtype=np.float32)
        )
        t_ns = int(times[min(i, len(times) - 1)] * 1e9) if times is not None else i
        yield cloud.xyz.numpy(), T_wb, t_ns


def scan_source(args):
    if args.synthetic:
        return synthetic_scans(args.synthetic)
    if args.scans:
        return file_scans(args.scans, args.trajectory)
    raise SystemExit("need --synthetic N or --scans DIR")


def make_cloud_np(n, rng, spread=10.0):
    """The registration benchmark's scene (the reference repo's
    ``tools/bench_cloud_ops.py``): ``n`` points uniform over a ``spread``
    half-width cube, flattened to a gently rolling surface (z = 0.1 sin x
    plus 2 cm noise). f32[n, 3]."""
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    xyz[:, 2] = (0.1 * np.sin(xyz[:, 0]) + 0.02 * rng.normal(size=n)).astype(np.float32)
    return xyz


def registration_pair(n, seed=0):
    """(source, target, T_true) of the registration benchmark: target =
    T_true * source with T_true = from_rpy(0.01, -0.02, 0.05, t=(0.3, -0.2,
    0.1)), so aligning source onto target recovers T_true. Host arrays."""
    from fastdem_tpu_torch.cloud.transform import from_rpy

    src = make_cloud_np(n, np.random.default_rng(seed))
    T_true = from_rpy(0.01, -0.02, 0.05, t=(0.3, -0.2, 0.1), device="cpu").numpy()
    tgt = ((T_true[:3, :3] @ src.T).T + T_true[:3, 3]).astype(np.float32)
    return src, tgt, T_true
