"""pcd2dem: point cloud -> DEM -> point cloud, on the port.

Loads a PCD (or a KITTI .bin), runs the batch DEM pipeline (statistical
outlier removal -> floating-point removal -> rasterization -> inpainting)
and writes the DEM back as a PCD of cell-centre points; optionally the map
as npz and its elevation as PNG.

Usage:
  python -m fastdem_tpu_torch.tools.pcd2dem IN.pcd|IN.bin OUT.pcd [resolution]
      [--method max|min|mean|minmax] [--sor-k K] [--sor-std S]
      [--height-threshold H] [--inpaint N] [--npz M.npz] [--png M.png]
      [--device cuda|cpu]
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("resolution", nargs="?", type=float, default=0.1)
    ap.add_argument("--method", default="max", choices=["max", "min", "mean", "minmax"])
    ap.add_argument("--npz", default=None, help="also save the map as npz")
    ap.add_argument("--png", default=None, help="also save the elevation as png")
    ap.add_argument("--sor-k", type=int, default=20)
    ap.add_argument("--sor-std", type=float, default=1.0)
    ap.add_argument("--height-threshold", type=float, default=2.0)
    ap.add_argument("--inpaint", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs without a card)")
    args = ap.parse_args(argv)

    from fastdem_tpu_torch.config import RasterMethod
    from fastdem_tpu_torch.device import resolve_device
    from fastdem_tpu_torch.io import pcd as pcd_io
    from fastdem_tpu_torch.mapping import batch

    device = resolve_device(args.device)
    try:
        if args.input.endswith(".bin"):
            cloud = pcd_io.load_kitti_bin(args.input, device=device)
        else:
            cloud = pcd_io.load_pcd(args.input, device=device)
    except (OSError, ValueError) as e:
        print(f"error: cannot read '{args.input}': {e}", file=sys.stderr)
        return 2
    n_in = cloud.count()
    print(f"loaded {n_in} points from {args.input}")
    if n_in == 0:
        print(f"error: '{args.input}' contains no points", file=sys.stderr)
        return 2

    cfg = batch.DEMConfig(
        resolution=args.resolution,
        method=RasterMethod(args.method),
        sor_k=args.sor_k,
        sor_std_mul=args.sor_std,
        height_threshold=args.height_threshold,
        inpaint_iterations=args.inpaint,
    )
    geom, state = batch.build_dem(cloud, cfg, device=device)
    print(
        f"DEM: {geom.rows}x{geom.cols} cells @ {geom.resolution} m "
        f"({geom.length[0]:.1f} x {geom.length[1]:.1f} m)"
    )
    out_cloud = batch.to_pointcloud(geom, state)
    if not pcd_io.save_pcd(args.output, out_cloud):
        print(f"ERROR: cannot write {args.output}", file=sys.stderr)
        return 1
    print(f"wrote {out_cloud.count()} DEM points -> {args.output}")
    if args.npz:
        from fastdem_tpu_torch.io.npz import save_npz

        save_npz(args.npz, geom, state)
        print(f"wrote map -> {args.npz}")
    if args.png:
        from fastdem_tpu_torch.io.png import save_png

        save_png(args.png, state, "elevation")
        print(f"wrote elevation image -> {args.png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
