"""One run of one cell: the loader, the run and the result line.

Everything that belongs to one cell is found by name: the workload in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic mix (``traffic/<traffic>.json``, whose ``"loop"`` names the loop
``loops/<loop>.py``); the configuration's sensor names its generator
(``sensors/<generator>.py``, see ``scans.py``); its limits are
``limits/<workload>.json``; each metric ``<name>`` is read by
``metrics/<name>.py``'s ``read(ctx)``, which returns None where it finds
nothing to read.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from . import check, guard, scans, stats
from .parts import BENCH_DIR, ROOT, part


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def limits_file(name: str) -> Path:
    return BENCH_DIR / "limits" / f"{name}.json"


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with ``workloads`` only in those."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return part("metrics", name).read


def loop(name: str):
    """``loops/<name>.py``: its ``run`` and its ``history``."""
    return part("loops", name)


def cell_inputs(cell: str, root: Path = ROOT):
    bench = benchmark(root)
    w = workload(bench, cell)
    return bench, w, load_json(config_file(bench, w["config"])), load_json(traffic_file(w["traffic"]))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, out=print, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> dict:
    """Run ``cell`` on ``device``: the result line the benchmark prints,
    its compared numbers under ``checks``. ``config`` and ``traffic`` stand
    in for the cell's files (the tests run them at small sizes)."""
    device = torch.device(device)
    bench, w, cell_config, cell_traffic = cell_inputs(cell)
    config = cell_config if config is None else config
    traffic = cell_traffic if traffic is None else traffic
    limits = load_json(limits_file(cell))
    t_log = time.perf_counter()
    log = scans.make_log(config, traffic, seed, device)
    t_log = time.perf_counter() - t_log
    if device.type == "cuda":
        # The peak is the program's: the generator's scratch is not.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    geom = check.geometry(config)
    sizes = log.sizes()
    local = config["node"]["mapping"]["mode"] == "local"
    half = (0.5 * geom.rows * geom.resolution, 0.5 * geom.cols * geom.resolution)
    in_map = scans.in_map_counts(log, half, centred=local)
    run = loop(traffic["loop"]).run(config, traffic, log, seconds, trace, device)
    setup_s = run.setup_end - t_process

    ctx = SimpleNamespace(run=run, config=config, traffic=traffic, workload=w, geom=geom,
                          trace=run.trace, setup_s=setup_s)
    metrics: Dict[str, dict] = {}
    for m in metrics_for(bench, cell, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out(json.dumps({"info": {
        "cell": cell, "seed": seed, "scans_in_log": len(log),
        "points_per_scan_mean": float(sizes.mean()), "in_map_points_per_scan_mean": float(in_map.mean()),
        "capacities": sorted({check.capacity_of(int(n)) for n in sizes}),
        "window_s": run.window_s, "log_s": t_log, "counts": run.counts,
        "traced": None if run.trace is None else {
            "scans": run.trace.scans, "span_s": run.trace.window_s,
            "scans_per_s": stats.rate(run.trace.scans, run.trace.window_s),
            "device_events": run.trace.device_events},
        "samples": {k: dict(n=len(v), max=max(v) if v else None,
                            **{f"p{q}": stats.percentile(v, q) for q in (50, 90, 95, 98, 99)})
                    for k, v in run.samples.items()},
    }}))

    # The reference, after the window and the program's state are gone.
    ref_state = check.reference_map(config, log, run.history, device)
    ref_pp = check.reference_postprocess(config, ref_state) if run.pp is not None else None
    numbers, counts = check.compare_maps(run.layers, run.position, ref_state, run.pp, ref_pp)
    correct, rows = check.judge(numbers, limits)
    out(json.dumps({"compared": counts}))

    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info(device, run)}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps[:10]],
        }
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def device_info(device: torch.device, run) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(run.memory_peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}


def main(argv: Optional[List[str]] = None, t_process: Optional[float] = None) -> int:
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, w, _, _ = cell_inputs(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"error: the cell needs {w['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_process)
    found = guard.forbidden_modules()
    if found:
        print("error: modules of JAX or the JAX package are loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
