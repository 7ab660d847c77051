"""fastdem_replay: offline mapping over a recorded scan sequence
on the port.

The scans are put on the device first, then integrated in one call of
``FastDEM.integrate_sequence``, which runs the per-scan step on each with
no host read in between; the map is the one the one-scan-at-a-time loop
gives, bit for bit. ``--batch`` is the reference tool's frames per
compiled call; it is checked and printed, and changes nothing here.

Scan sources (as the node's):
  --synthetic N           N synthetic VLP-16-like scans with a moving pose
  --scans DIR             directory of .pcd / .bin files (sorted), with
  --trajectory FILE       a TUM or KITTI trajectory supplying T_world_base

Outputs: the final map as npz (and optional PNG layers) under --out, and a
throughput line (scans/s, ms/scan) on stderr.

Usage:
  python -m fastdem_tpu_torch.tools.fastdem_replay --preset local_mapping \\
      --synthetic 64 --batch 16 [--out DIR] [--device cuda]
"""

import argparse
import os
import sys
import time

import numpy as np

from fastdem_tpu_torch.tools.common import add_config_args, load_node_config, scan_source


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(ap)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--scans", default=None)
    ap.add_argument("--trajectory", default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None,
                    help="directory for map.npz (default: write nothing)")
    ap.add_argument("--png", action="store_true",
                    help="also render elevation / variance PNGs")
    ap.add_argument("--sensor-height", type=float, default=1.0,
                    help="sensor z offset in the base frame (T_base_sensor)")
    ap.add_argument("--resume", default=None,
                    help="npz checkpoint to continue mapping from (same geometry)")
    args = ap.parse_args(argv)

    import torch

    from fastdem_tpu_torch.cloud.pointcloud import from_numpy
    from fastdem_tpu_torch.grid.geometry import GridGeometry
    from fastdem_tpu_torch.grid.gridmap import GridMapState
    from fastdem_tpu_torch.mapping.pipeline import FastDEM

    try:
        node_cfg = load_node_config(args)
    except OSError as e:
        print(f"error: cannot read config '{args.config}': {e}", file=sys.stderr)
        return 2
    geom = GridGeometry.from_length(
        node_cfg.map.width, node_cfg.map.height, node_cfg.map.resolution
    )
    mapper = FastDEM(geom, node_cfg.pipeline, device=args.device)
    if args.resume:
        from fastdem_tpu_torch.io.npz import load_npz

        g2, st, _meta = load_npz(args.resume, device=mapper.device)
        if (g2.rows, g2.cols) != (geom.rows, geom.cols) or abs(
            g2.resolution - geom.resolution
        ) > 1e-9:
            print(
                f"error: checkpoint geometry {g2.rows}x{g2.cols}@{g2.resolution} != "
                f"config {geom.rows}x{geom.cols}@{geom.resolution}",
                file=sys.stderr,
            )
            return 2
        # A checkpoint of another pipeline config gains the missing layers.
        lyr = dict(st.layers)
        for name, t in mapper.state.layers.items():
            lyr.setdefault(name, t)
        mapper.state = GridMapState(layers=lyr, position=st.position)
        print(f"[fastdem_replay] resumed from {args.resume}", file=sys.stderr)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = args.sensor_height

    clouds, poses = [], []
    for xyz, T_wb, t_ns in scan_source(args):
        clouds.append(from_numpy(xyz, timestamp_ns=t_ns, device=mapper.device))
        poses.append(T_wb)
    if not clouds:
        raise SystemExit("no scans to replay")
    poses = np.stack(poses).astype(np.float32)

    # Warm-up on the first scan (loads the kernels outside the timing), then
    # restore the map it started from.
    state0 = mapper.state
    mapper.integrate(clouds[0], T_bs, poses[0])
    if mapper.device.type == "cuda":
        torch.cuda.synchronize()
    mapper.state = state0

    t0 = time.perf_counter()
    n = mapper.integrate_sequence(clouds, T_bs, poses, batch=args.batch)
    if mapper.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(
        f"[fastdem_replay] {n} scans in {dt * 1e3:.1f} ms ({n / dt:.0f} scans/s, "
        f"{dt / max(n, 1) * 1e3:.3f} ms/scan, batch={args.batch}, device={mapper.device})",
        file=sys.stderr,
    )
    if args.out:
        save_artifacts(args, geom, mapper)
    return 0


def save_artifacts(args, geom, mapper):
    from fastdem_tpu_torch.io.npz import save_npz

    os.makedirs(args.out, exist_ok=True)
    out_npz = os.path.join(args.out, "map.npz")
    save_npz(out_npz, geom, mapper.state, frame_id=mapper.frame_id)
    print(f"[fastdem_replay] map -> {out_npz}", file=sys.stderr)
    if args.png:
        from fastdem_tpu_torch.io.png import save_png

        for layer in ("elevation", "variance"):
            if layer in mapper.state.layers:
                p = os.path.join(args.out, f"{layer}.png")
                if save_png(p, mapper.state, layer):
                    print(f"[fastdem_replay] {layer} -> {p}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
