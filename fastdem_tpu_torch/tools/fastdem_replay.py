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

With ``--prefetch N`` (``--scans`` only) the files stream through the
native ``ScanStream`` (N parser threads, ``fastdem_tpu_torch.native``):
parsing overlaps the device's work and memory holds one batch of scans,
each padded to ``--capacity`` points (a longer scan keeps its first
``--capacity``). The batches go through ``build_integrate_sequence``. It
raises when the native library cannot be built: it never parses in Python.

Outputs: the final map as npz (and optional PNG layers) under --out, and a
throughput line (scans/s, ms/scan) on stderr.

Usage:
  python -m fastdem_tpu_torch.tools.fastdem_replay --preset local_mapping \\
      --synthetic 64 --batch 16 [--out DIR] [--device cuda] [--program-cache DIR]
"""

import argparse
import os
import sys
import time

import numpy as np

from fastdem_tpu_torch.tools.common import (
    add_config_args,
    enable_program_cache,
    load_node_config,
    scan_source,
)


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
    ap.add_argument("--prefetch", type=int, default=0,
                    help="stream --scans through the native prefetching loader with N "
                         "parser threads")
    ap.add_argument("--capacity", type=int, default=32768,
                    help="point capacity per scan with --prefetch (longer scans are "
                         "truncated)")
    args = ap.parse_args(argv)
    enable_program_cache(args)

    import torch

    from fastdem_tpu_torch.cloud.pointcloud import from_numpy, ladder_capacity
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

    if args.prefetch > 0:
        if not args.scans:
            raise SystemExit("--prefetch requires --scans DIR")
        return run_prefetch(args, geom, mapper, T_bs)

    clouds, poses = [], []
    for xyz, T_wb, t_ns in scan_source(args):
        clouds.append(from_numpy(xyz, timestamp_ns=t_ns, device=mapper.device))
        poses.append(T_wb)
    if not clouds:
        raise SystemExit("no scans to replay")
    poses = np.stack(poses).astype(np.float32)

    # Warm-up on the first scan of each capacity the facade's graphs take
    # (a power of two, see ``FastDEM.integrate``): it loads the kernels and
    # captures outside the timing. Then restore the map it started from.
    state0 = mapper.state
    firsts = {ladder_capacity(c.capacity, base=1): c for c in reversed(clouds)}
    for c in firsts.values():
        mapper.integrate(c, T_bs, poses[0])
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


def run_prefetch(args, geom, mapper, T_bs):
    """Streaming replay: the native ScanStream parses files with a worker
    pool while the device integrates the previous batch, so wall time is
    max(parse, compute) rather than their sum, and memory holds one batch of
    scans whatever the sequence's length."""
    import glob

    import torch

    from fastdem_tpu_torch import native
    from fastdem_tpu_torch.io.pcd import load_trajectory
    from fastdem_tpu_torch.mapping.pipeline import build_integrate_sequence

    if not native.available():
        raise SystemExit(f"--prefetch needs the native scan IO library, which could not "
                         f"be built: {native.build_error}")
    files = sorted(glob.glob(os.path.join(args.scans, "*.pcd"))
                   + glob.glob(os.path.join(args.scans, "*.bin")))
    if not files:
        raise SystemExit(f"no .pcd/.bin scans in {args.scans}")
    poses = None
    if args.trajectory:
        _, poses = load_trajectory(args.trajectory)

    dev = mapper.device
    K, cap = args.batch, args.capacity
    seq = build_integrate_sequence(geom, mapper.cfg, device=dev)
    state = mapper.state
    eye = np.eye(4, dtype=np.float32)
    tbs = torch.as_tensor(T_bs, device=dev)

    # Warm-up on empty frames at the map's own position, its result
    # dropped: it loads the kernels and captures the step's graphs of both
    # signatures the replay uses, a batch of K frames and one frame (the
    # tail after the last full batch runs frame by frame: at microbatch 1
    # the batch equals the loop), so no capture lands in the timing.
    pos = state.position.cpu().numpy()
    warm = eye.copy()
    warm[0, 3], warm[1, 3] = pos[0], pos[1]
    for k in sorted({1, K}):
        seq(state, torch.full((k, cap, 3), 1e9, device=dev),
            torch.zeros((k, cap), dtype=torch.bool, device=dev), tbs,
            torch.as_tensor(warm, device=dev)[None].expand(k, 4, 4).contiguous())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    n_total = 0
    with native.ScanStream(files, cap, threads=args.prefetch, ring=max(2 * K, 8)) as stream:
        chunk_xyz, chunk_mask, chunk_pose = [], [], []

        def flush():
            nonlocal state
            calls = [slice(0, K)] if len(chunk_xyz) == K else [
                slice(k, k + 1) for k in range(len(chunk_xyz))]
            for c in calls:
                state = seq(state, torch.as_tensor(np.stack(chunk_xyz[c]), device=dev),
                            torch.as_tensor(np.stack(chunk_mask[c]), device=dev), tbs,
                            torch.as_tensor(np.stack(chunk_pose[c]), device=dev))
            chunk_xyz.clear()
            chunk_mask.clear()
            chunk_pose.clear()

        for i, (xyz, mask, _) in enumerate(stream):
            if not mask.any():
                continue  # a parse failure: warn and skip (ScanStream logs it)
            chunk_xyz.append(xyz)
            chunk_mask.append(mask)
            chunk_pose.append(poses[min(i, len(poses) - 1)].astype(np.float32)
                              if poses is not None else eye)
            n_total += 1
            if len(chunk_xyz) == K:
                flush()
        flush()
        errors = stream.errors
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mapper.state = state
    dt = time.perf_counter() - t0
    print(
        f"[fastdem_replay] {n_total} scans in {dt * 1e3:.1f} ms ({n_total / max(dt, 1e-9):.0f} "
        f"scans/s incl. file IO, {dt / max(n_total, 1) * 1e3:.3f} ms/scan, batch={K}, "
        f"prefetch={args.prefetch} threads, native=True, {errors} parse failures, "
        f"device={dev})",
        file=sys.stderr,
    )
    if args.out:
        save_artifacts(args, geom, mapper)
    return 0


if __name__ == "__main__":
    sys.exit(main())
