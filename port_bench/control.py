"""The control of the check that decides ``correct``: the plain reference put
in the program's place with its map kept in bfloat16 between scans (the
nearest precision below the float32 that the configurations state), judged
against the float32 reference by the cell's own limits. It has to come out
not correct.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 [--seconds 30]

runs on the card, at the cell's own size: the same log, and the order of
scans that a run of ``--seconds`` integrates (the warm-up's scans, then the
window's, or a whole pass of a replay). The benchmark's runs do not run it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from port_bench.harness import bench, check, scans  # noqa: E402

def control_numbers(cell: str, seed: int, device, seconds: float = 30.0,
                    config=None, traffic=None) -> dict:
    _, _, cell_config, cell_traffic = bench.cell_inputs(cell)
    config = cell_config if config is None else config
    traffic = cell_traffic if traffic is None else traffic
    device = torch.device(device)
    log = scans.make_log(config, traffic, seed, device)
    loop = bench.loop(traffic["loop"])
    history = loop.history(traffic, log, seconds)
    ref = check.reference_map(config, log, history, device)
    ctl = check.reference_map(config, log, history, device, dtype=torch.bfloat16)
    ctl_layers = check.to_numpy(ctl.layers)
    ctl_pos = ctl.position.cpu().numpy()
    if loop.POSTPROCESS:
        return check.compare_maps(ctl_layers, ctl_pos, ref,
                                  check.to_numpy(check.reference_postprocess(config, ctl)),
                                  check.reference_postprocess(config, ref))
    return check.compare_maps(ctl_layers, ctl_pos, ref)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 2
    limits = bench.load_json(bench.limits_file(args.workload))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers, counts = control_numbers(args.workload, seed, "cuda", args.seconds)
        correct, _ = check.judge(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": correct,
                          "numbers": numbers, "counts": counts,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
