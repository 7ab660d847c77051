"""fastdem_node: the streaming mapping application (the ROS node's
equivalent) on the port.

Loads a node config (a built-in preset or a YAML file), streams scans
through ``runtime.driver.MappingDriver`` under its timers (visualization,
snapshot post-processing) and writes artifacts (npz checkpoints, PNG
renders, an HTML viewer) instead of ROS topics. At the end it runs the
post-processing service once.

Scan sources:
  --synthetic N           N synthetic VLP-16-like scans with a moving pose
  --scans DIR             directory of .pcd / .bin files (sorted), with
  --trajectory FILE       a TUM (t x y z qx qy qz qw) or KITTI (12-float
                          3x4) trajectory supplying T_world_base per scan

Usage:
  python -m fastdem_tpu_torch.tools.fastdem_node --preset local_mapping \\
      --synthetic 20 --out DIR [--device cuda] [--program-cache DIR] \\
      [--trace-out spans.json]

``--trace-out`` writes the flight recorder's spans (``utils/tracing.py``)
as a Chrome trace when the node exits, also after an error or Ctrl-C.
"""

import argparse
import os
import sys
import time
from types import SimpleNamespace

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
    ap.add_argument("--out", required=True, help="directory of the artifacts")
    ap.add_argument("--sensor-height", type=float, default=1.0)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="throttle scan intake to N Hz (0 = as fast as possible)")
    ap.add_argument("--async-intake", action="store_true",
                    help="enqueue scans and integrate backlogs in batches "
                         "(oldest scans drop under overload)")
    ap.add_argument("--burst", type=int, default=8,
                    help="max scans per batch with --async-intake")
    ap.add_argument("--live-port", type=int, default=None,
                    help="serve the live 3D viewer on this port while mapping "
                         "(0 = pick a free port); browse the printed URL")
    ap.add_argument("--trace-out", default=None,
                    help="write the recorded spans as a Chrome trace (JSON) here at exit")
    args = ap.parse_args(argv)
    enable_program_cache(args)
    try:
        return run(args)
    finally:
        if args.trace_out:
            from fastdem_tpu_torch.utils import tracing

            n = tracing.export_chrome(args.trace_out)
            print(f"spans -> {args.trace_out}: {n}", file=sys.stderr)


def run(args):

    from fastdem_tpu_torch.cloud import pointcloud as pc
    from fastdem_tpu_torch.grid.gridmap import layers
    from fastdem_tpu_torch.interop import host_state
    from fastdem_tpu_torch.io.npz import save_npz
    from fastdem_tpu_torch.io.png import save_png
    from fastdem_tpu_torch.runtime import bridge
    from fastdem_tpu_torch.runtime.providers import StaticCalibration, TransformBuffer

    os.makedirs(args.out, exist_ok=True)
    try:
        cfg = load_node_config(args)
    except OSError as e:
        print(f"error: cannot read config '{args.config}': {e}", file=sys.stderr)
        return 2

    calib = StaticCalibration(cfg.tf.base_frame)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = args.sensor_height
    calib.set_extrinsic("lidar", T_bs)
    odom = TransformBuffer(cfg.tf.base_frame, cfg.tf.map_frame,
                           max_stale_time=cfg.tf.max_stale_time)
    driver = cfg.make_driver(
        device=args.device, calibration=calib, odometry=odom, artifact_dir=args.out,
        async_intake=args.async_intake, burst_batch=args.burst,
    )

    live = None
    if args.live_port is not None:
        from fastdem_tpu_torch.io.live_viewer import LiveViewer

        live = LiveViewer(port=args.live_port).start()
        driver.sinks["map"] = live.sink(driver.geom)
        print(f"live viewer: {live.url}", file=sys.stderr)

    source = scan_source(args)
    n_ok = 0
    t_start = time.time()
    with driver:
        for xyz, T_wb, t_ns in source:
            odom.add_pose(t_ns, T_wb)
            cloud = pc.from_numpy(xyz, frame_id="lidar", timestamp_ns=t_ns, device="cpu")
            if driver.on_scan(cloud):
                n_ok += 1
            if args.rate > 0:
                time.sleep(1.0 / args.rate)
        if args.async_intake:
            if not driver.drain(timeout=600.0):
                print("warning: intake queue did not drain; final artifacts miss "
                      "trailing scans", file=sys.stderr)
            n_ok = driver.scan_count
        # Final snapshot + post-processing (the run_postprocess service).
        result = driver.run_postprocess()
        state = driver.mapper.state

    dt = time.time() - t_start
    host_layers, position = host_state(state)
    host_map = SimpleNamespace(layers=host_layers, position=position)
    elev = host_layers[layers.elevation]
    drop = f", {driver.dropped_scans} dropped" if args.async_intake else ""
    print(
        f"integrated {n_ok} scans in {dt:.1f}s ({n_ok / dt:.1f} scans/s wall incl. "
        f"host IO{drop}); {np.isfinite(elev).sum()}/{elev.size} cells measured"
    )

    save_npz(os.path.join(args.out, "map_final.npz"), driver.geom, host_map)
    save_png(os.path.join(args.out, "elevation.png"), host_map, layers.elevation)
    if "slope" in result:
        save_png(os.path.join(args.out, "slope.png"),
                 SimpleNamespace(layers=result, position=position), "slope")
    np.save(os.path.join(args.out, "map_cloud.npy"),
            bridge.to_structured_cloud(driver.geom, host_map))
    print(f"artifacts -> {args.out}: map_final.npz elevation.png"
          f"{' slope.png' if 'slope' in result else ''} map_cloud.npy")
    if live is not None:
        live.publish(driver.geom, host_map, title="elevation (final)")
        live.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
