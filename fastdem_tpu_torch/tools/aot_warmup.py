"""Build a program-cache bundle for a node config (the cold-start story),
or report a bundle's health.

Runs the integrate / replay / post-processing paths a node with this
config will run, so that nvcc builds the kernels and g++ the native scan
IO into the bundle (``fastdem_tpu_torch/runtime/aotcache.py``). Ship the
bundle beside a checkpoint; ``fastdem_node --program-cache DIR`` (and
``fastdem_replay``) then start without building anything.

Usage:
  python -m fastdem_tpu_torch.tools.aot_warmup --preset local_mapping \\
      --bundle DIR [--capacities 32768,65536] [--replay-batches 16] \\
      [--canary] [--device cuda]
  python -m fastdem_tpu_torch.tools.aot_warmup --verify DIR [--canary]
"""

import argparse
import json
import sys

from fastdem_tpu_torch import presets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=presets.names(), default=None)
    ap.add_argument("--config", default=None, metavar="FILE.yaml",
                    help="a node config file (needs PyYAML)")
    ap.add_argument("--bundle", default=None, metavar="DIR")
    ap.add_argument("--capacities", default="32768",
                    help="comma-separated point capacities to run")
    ap.add_argument("--replay-batches", default="",
                    help="comma-separated integrate_sequence batch sizes")
    ap.add_argument("--canary", action="store_true",
                    help="record (or, with --verify, check) the canary build's hash")
    ap.add_argument("--verify", default=None, metavar="DIR",
                    help="report a bundle's health instead of building one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from fastdem_tpu_torch.runtime import aotcache

    if args.verify:
        print(json.dumps(aotcache.verify(args.verify, canary=args.canary), indent=2))
        return 0
    if not ((args.preset or args.config) and args.bundle):
        ap.error("--preset or --config, and --bundle, are required (or use --verify)")

    from fastdem_tpu_torch.grid.geometry import GridGeometry
    from fastdem_tpu_torch.tools.common import load_node_config

    cfg = load_node_config(args)
    geom = GridGeometry.from_length(cfg.map.width, cfg.map.height, cfg.map.resolution)
    caps = [int(c) for c in args.capacities.split(",") if c]
    batches = [int(b) for b in args.replay_batches.split(",") if b]
    manifest = aotcache.warmup(
        geom, cfg.pipeline, cfg.postprocess, bundle_dir=args.bundle, capacities=caps,
        replay_batches=batches, canary=args.canary,
        progress=lambda m: print(m, file=sys.stderr), device=args.device,
    )
    print(json.dumps(manifest, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
