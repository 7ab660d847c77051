"""What the node and the replay tool share: the config options and the
scan sources."""

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
