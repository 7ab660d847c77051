"""Multi-process block-sharded GLOBAL mapping worker (BASELINE.md
configuration 5) on the port.

Run one instance per process. The GLOBAL map's layers are split into a
mesh of blocks, each process owning a contiguous run of them; every
process is fed the same scan stream (scans are replicated: tiny next to
the map) through the facade (``FastDEM(mesh=...)``), which integrates it
into its own blocks with no exchange, and rank 0 writes the assembled npz
(``save_sharded_npz``: every rank takes part, no layer is assembled
whole).

The stream: ``--scans`` scans of ``--points`` points in rings out to 0.45 x
the map size (the reference tool's), or the scans of ``--scans-npz`` (an
npz with xyz f32[K, N, 3], T_bs f32[4, 4] and T_wb f32[K, 4, 4]).
``--mode local`` maps in LOCAL mode instead, the robot moving 0.8 m along
x and -0.3 m along y per synthetic scan (the blocks exchange the strips of
each move); ``--pp-out`` also writes the post-processing chain
run over the sharded map (halos exchanged between the processes);
``--ckpt`` writes a sharded checkpoint (``io/sharded_ckpt.py``).
The facade's step runs compiled, as CUDA graphs on a card (the whole scan
in GLOBAL mode, the scan after the strip exchange in LOCAL mode).
``--batched 1`` integrates the whole stream instead in one call of the
scan-batched replay (``sharding.build_sharded_integrate_sequence``, each
device's scans one CUDA graph in GLOBAL mode) over the facade's blocks.

Two processes on one machine (gloo; a free port for the coordinator):
  python -m fastdem_tpu_torch.tools.multihost_demo --pid 0 --nproc 2 \\
      --coordinator localhost:PORT --out mh.npz [--device cpu] &
  python -m fastdem_tpu_torch.tools.multihost_demo --pid 1 --nproc 2 \\
      --coordinator localhost:PORT --out mh.npz [--device cpu]
"""

import argparse
import sys

import numpy as np

# The robot's motion per synthetic scan in LOCAL mode (m): each move shifts
# the map across block edges.
LOCAL_STEP = (0.8, -0.3)


def synthetic_stream(scans: int, points: int, map_size: float, step=(0.0, 0.0)):
    """The reference tool's scan stream (identical on every process), the
    robot moving ``step`` metres per scan."""
    rng = np.random.default_rng(0)
    xyz = np.empty((scans, points, 3), np.float32)
    for k in range(scans):
        ang = rng.uniform(0, 2 * np.pi, points)
        rad = rng.uniform(0.5, map_size * 0.45, points)
        xyz[k] = np.column_stack(
            [rad * np.cos(ang), rad * np.sin(ang), 0.2 * np.sin(rad) - 1.0]
        )
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    T_wb = np.broadcast_to(np.eye(4, dtype=np.float32), (scans, 4, 4)).copy()
    T_wb[:, 0, 3] = step[0] * np.arange(scans)
    T_wb[:, 1, 3] = step[1] * np.arange(scans)
    return xyz, T_bs, T_wb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of rank 0 (needed with --nproc > 1)")
    ap.add_argument("--out", default=None, help="npz of the assembled map (rank 0 writes)")
    ap.add_argument("--ckpt", default=None, help="sharded checkpoint directory (every rank)")
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--scans-npz", default=None, help="the scans to feed, in place of rings")
    ap.add_argument("--map-size", type=float, default=40.0)
    ap.add_argument("--resolution", type=float, default=0.2)
    ap.add_argument("--range", type=float, default=None,
                    help="point_filter.range_max (default: half the map size)")
    ap.add_argument("--local-blocks", type=int, default=4, help="blocks per process")
    ap.add_argument("--mode", choices=("global", "local"), default="global",
                    help="local: a LOCAL map (the blocks_fullmap formulation, whose "
                         "move exchanges strips between processes)")
    ap.add_argument("--pp-out", default=None,
                    help="npz of the post-processing chain over the sharded map "
                         "(halos exchanged between processes; rank 0 writes)")
    ap.add_argument("--batched", type=int, default=0,
                    help="integrate all scans in one sharded replay call "
                         "(build_sharded_integrate_sequence) over the facade's blocks "
                         "instead of one facade integrate call per scan")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.nproc > 1 and not args.coordinator:
        ap.error("--coordinator HOST:PORT is needed with --nproc > 1")

    import torch

    # Several workers share one host: keep each one's thread pool small.
    torch.set_num_threads(2)

    from fastdem_tpu_torch.cloud import pointcloud as pc
    from fastdem_tpu_torch.config import Config, MappingMode
    from fastdem_tpu_torch.grid.geometry import GridGeometry
    from fastdem_tpu_torch.mapping.pipeline import FastDEM
    from fastdem_tpu_torch.parallel import sharding as sh
    from fastdem_tpu_torch.parallel.distributed import (
        init_distributed,
        make_global_mesh,
        save_sharded_npz,
        shutdown,
    )

    init_distributed(args.coordinator, args.nproc, args.pid)
    mesh = make_global_mesh(n=args.local_blocks * args.nproc, devices=[args.device])
    print(f"[mh] proc {mesh.rank}/{mesh.world} mesh {mesh.shape} blocks {mesh.local_slots()}",
          flush=True)

    geom = GridGeometry.from_length(args.map_size, args.map_size, args.resolution)
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL if args.mode == "global" else MappingMode.LOCAL
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = args.range if args.range is not None else args.map_size / 2

    if args.scans_npz:
        with np.load(args.scans_npz) as f:
            xyz, T_bs, T_wb = f["xyz"], f["T_bs"], f["T_wb"]
    else:
        xyz, T_bs, T_wb = synthetic_stream(
            args.scans, args.points, args.map_size,
            LOCAL_STEP if args.mode == "local" else (0.0, 0.0),
        )
    dev = mesh.local_devices()[0]
    mapper = FastDEM(geom, cfg, device=dev, mesh=mesh)
    K, n = xyz.shape[:2]
    if args.batched:
        run, _ = sh.build_sharded_integrate_sequence(geom, cfg, mesh)
        mapper.state = run(mapper.state, torch.tensor(xyz, device=dev),
                           torch.ones((K, n), dtype=torch.bool, device=dev),
                           torch.tensor(T_bs, device=dev), torch.tensor(T_wb, device=dev))
    else:
        run = mapper._map.step
        for x, T in zip(xyz, T_wb):
            mapper.integrate(pc.from_numpy(x, frame_id="lidar", device="cpu"), T_bs, T)
    state = mapper.state
    finite = sum(int(torch.isfinite(b["elevation"]).sum()) for b in state.blocks.values())
    print(f"[mh] proc {mesh.rank}: {run.formulation} ({run.compiled}), {K} scans, finite "
          f"cells (own blocks) = {finite}", flush=True)

    ok = True
    if args.out:
        ok = save_sharded_npz(args.out, geom, state)
        if mesh.rank == 0:
            print(f"[mh] wrote {args.out}: {ok}", flush=True)
    if args.pp_out:
        from fastdem_tpu_torch.config import PostProcessConfig

        pp = PostProcessConfig()
        pp.uncertainty_fusion.enabled = True
        pp.inpainting.enabled = True
        pp.feature_extraction.enabled = True
        out = sh.sharded_postprocess(geom, pp, mesh, state, median=(3, 5))
        ok = save_sharded_npz(args.pp_out, geom, out) and ok
    if args.ckpt:
        from fastdem_tpu_torch.io.sharded_ckpt import save_sharded

        save_sharded(args.ckpt, geom, state)
        if mesh.rank == 0:
            print(f"[mh] wrote checkpoint {args.ckpt}", flush=True)
    shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
