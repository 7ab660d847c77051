"""The ``mesh_replay`` loop: the ``replay`` loop on a block mesh of several
processes, one device each (BASELINE.json configuration 5).

The harness's process is rank 0 on its device (``cuda:0``). It starts ranks
1 .. n-1 (this file run as a script, rank r on ``cuda:<r>``), joins the
process group with them (the configuration's ``mesh.backend``: gloo for the
host, NCCL for the per-call collective on the cards; gloo alone on the
CPU) and hands them the configuration, the traffic and the log through it,
so the log is generated once. Every rank then runs the same loop through
its own ``FastDEM(mesh=...)``: the warm-up of every capacity, a barrier,
then calls of ``batch`` host clouds, pass after pass (``reset()`` before
each), a closed loop.

Rank 0 decides the window's end: after each call it broadcasts, without
waiting (gloo), whether ``seconds`` have passed, and the other ranks wait
for that word after the same call before they go on, which costs them
nothing, since their next call's check waits for rank 0's call anyway.
So every rank stops after the same call. ``counts.scans`` counts the
scans that every block integrated in the window, as the program's
per-call collective agreed them (``FastDEM.mesh_check``). After the
window the open pass is finished, the blocks are assembled on rank 0
(``sharding.gather_state``) for the check, and every rank's span table
(``utils/tracing.py``) and, in a traced run, its reduced device trace
(every rank traces its own sub-window) reach rank 0 as
``Run.rank_tables`` and ``Run.rank_traces``, which the ``mesh.*`` readers
read. Rank 0 keeps the ``replay`` loop's host samples of
``FastDEM.integrate``.

The harness's result line names the one device it hands a loop
(``bench.device_info``); a run of this loop uses one a rank, so on the
cards the loop has the line name them all (``Run.devices``, rank 0's
first): their count, their kind, which must be one, and the largest
rank's peak memory. Two ranks on one card fail the run.

Before it starts any process the loop checks that the program's facade
takes ``mesh=``, and exits 2 where it does not. Every wait between the
ranks has a timeout (``TIMEOUT_S``), rank 0 polls the other ranks after
each call, and they die with it (``PR_SET_PDEATHSIG``).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench.harness import check, runs  # noqa: E402
from port_bench.harness.parts import part  # noqa: E402
from port_bench.harness.trace import Tracer  # noqa: E402

# A run compares the map alone (no post-processing result).
POSTPROCESS = False
# Seconds any wait between the ranks may take: the process group's timeout,
# and rank 0's wait for each rank to exit.
TIMEOUT_S = 120.0
PR_SET_PDEATHSIG = 1


def history(traffic: dict, log, seconds: float) -> List[int]:
    """The replay loop's: the warm-up's scans, then one whole pass."""
    return part("loops", "replay").history(traffic, log, seconds)


def run(config: dict, traffic: dict, log, seconds: float, trace: bool, device) -> runs.Run:
    from fastdem_tpu_torch.mapping.pipeline import FastDEM
    from fastdem_tpu_torch.parallel.distributed import shutdown

    if "mesh" not in inspect.signature(FastDEM).parameters:
        print("error: the program's FastDEM takes no mesh=, so it cannot hold the map as "
              "blocks over several processes", file=sys.stderr, flush=True)
        raise SystemExit(2)
    _report_every_card()
    world = int(config["mesh"]["processes"])
    cuda = device.type == "cuda"
    backend = config["mesh"]["backend"] if cuda else "gloo"
    if cuda:
        from fastdem_tpu_torch.runtime.driver import build_kernels

        build_kernels()  # once, before the other ranks look for the libraries
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world", str(world),
             "--port", str(port), "--backend", backend, "--parent", str(os.getpid()),
             "--device", f"cuda:{r}" if cuda else "cpu"],
            cwd=str(ROOT), stdout=subprocess.DEVNULL,
        )
        for r in range(1, world)
    ]
    try:
        out = _replay(0, world, port, device, backend, (config, traffic, log, seconds, trace),
                      procs)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutdown()
        raise
    shutdown()
    for p in procs:
        try:
            p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs, 1) if p.returncode]
    if failed:
        raise RuntimeError(f"ranks exited with (rank, code) {failed}")
    return out


def cards_info(cards: List[dict]) -> dict:
    """The result line's ``device`` for a run on ``cards`` (one dict a
    rank: ``kind``, ``index``, ``memory_peak_bytes``)."""
    kinds = sorted({c["kind"] for c in cards})
    if len(kinds) != 1:
        raise RuntimeError(f"the ranks ran on cards of several kinds: {kinds}")
    indices = [c["index"] for c in cards]
    if len(set(indices)) != len(indices):
        raise RuntimeError(f"two ranks shared a card: the ranks' cards are {indices}")
    return {"platform": "gpu", "kind": kinds[0], "count": len(cards),
            "memory_peak_bytes": max(int(c["memory_peak_bytes"]) for c in cards)}


def _report_every_card() -> None:
    """Have the harness's ``device_info`` report ``Run.devices`` where a
    run carries them, and the one device it was handed otherwise."""
    from port_bench.harness import bench

    one = bench.device_info
    if getattr(one, "every_rank", False):
        return

    def device_info(device, run):
        cards = getattr(run, "devices", None)
        return cards_info(cards) if cards else one(device, run)

    device_info.every_rank = True
    bench.device_info = device_info


def _replay(rank: int, world: int, port: int, device, backend: str, payload, procs):
    """One rank's run; rank 0 returns the ``Run``, the others None."""
    import torch.distributed as dist

    from fastdem_tpu_torch.grid.geometry import GridGeometry
    from fastdem_tpu_torch.mapping.pipeline import FastDEM
    from fastdem_tpu_torch.parallel import sharding as sh
    from fastdem_tpu_torch.parallel.distributed import init_distributed, make_global_mesh
    from fastdem_tpu_torch.utils import tracing

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    init_distributed(f"localhost:{port}", world, rank, backend=backend, timeout_s=TIMEOUT_S)
    box = [payload]
    dist.broadcast_object_list(box, src=0)
    config, traffic, log, seconds, trace = box[0]
    lead = rank == 0

    ncfg = runs.program_config(config)
    geom = GridGeometry.from_length(ncfg.map.width, ncfg.map.height, ncfg.map.resolution)
    mesh = make_global_mesh(shape=tuple(config["mesh"]["shape"]), devices=[device])
    mapper = FastDEM(geom, ncfg.pipeline, device=device, mesh=mesh)
    clouds = runs.clouds(log)
    T_bs, T_wb = log.T_bs, log.T_wb
    batch = int(traffic["batch"])
    L = len(log)
    out = runs.Run()
    order = out.history

    # The facade's host span on rank 0, as the replay loop keeps it.
    spans: List[tuple] = []
    if lead:
        orig = mapper.integrate

        def integrate(cloud, *a, **k):
            t0 = time.perf_counter()
            ok = orig(cloud, *a, **k)
            spans.append((t0, time.perf_counter()))
            return ok

        mapper.integrate = integrate

    def call(b: int) -> int:
        chunk = clouds[b:b + batch]
        n = mapper.integrate_sequence(chunk, T_bs, T_wb[b:b + len(chunk)], batch=batch)
        order.extend(range(b, b + len(chunk)))
        if procs:
            gone = [(r, p.returncode) for r, p in enumerate(procs, 1) if p.poll() is not None]
            if gone:
                raise RuntimeError(f"ranks exited during the run: (rank, code) {gone}")
        return n

    # Warm-up: every capacity the log's scans take, on every rank.
    for i in runs.first_of_each_capacity(log):
        for _ in range(3):
            mapper.integrate_sequence([clouds[i]], T_bs, T_wb[i:i + 1], batch=batch)
            order.append(i)
    if trace and cuda:
        Tracer.warm(device)
    start = mapper.mesh_check()
    runs.sync(device)
    spans.clear()
    runs.settle()
    dist.barrier()

    tracer = Tracer() if trace else None
    t_trace = runs.trace_start(traffic, seconds)
    traced_from = traced_to = None
    attempted = n_done = calls = 0
    stop = torch.zeros(1, dtype=torch.int64)  # rank 0's word after each call
    posted = None
    b = L
    t_start = time.perf_counter()
    out.setup_end = t_start
    while True:
        if b >= L:
            b = 0
            mapper.reset()
            order.append(check.RESET)
        now = time.perf_counter() - t_start
        if tracer is not None and traced_from is None and now >= t_trace:
            runs.sync(device)
            out.counts["untraced_scans_per_s"] = attempted / (time.perf_counter() - t_start)
            tracer.start()
            traced_from = attempted
        n = call(b)
        attempted += min(batch, L - b)
        n_done += n
        calls += 1
        b = min(b + batch, L)
        now = time.perf_counter() - t_start
        if traced_from is not None and traced_to is None and (
                now >= t_trace + float(traffic["trace_s"])):
            tracer.stop()
            traced_to = attempted
        if lead:
            if posted is not None:
                posted.wait()
            stop[0] = int(now >= seconds)
            posted = dist.broadcast(stop, 0, async_op=True)
        else:
            dist.broadcast(stop, 0)
        if stop[0]:
            break
    runs.sync(device)
    t_end = time.perf_counter()
    if posted is not None:
        posted.wait()
    end = mapper.mesh_check()
    if traced_from is not None and traced_to is None:
        tracer.stop()
        traced_to = attempted
    window_spans = spans[: traced_from if traced_from is not None else len(spans)]
    # Finish the pass (outside the window): the map is compared after it.
    while b < L:
        call(b)
        b = min(b + batch, L)
    mapper.mesh_check()
    runs.sync(device)

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    reduced = None
    if traced_from is not None:
        reduced = tracer.reduce()
        if reduced is not None:
            reduced.scans = traced_to - traced_from
    mine = {"table": tracing.table(), "memory_peak_bytes": int(peak),
            "counters": tracing.counters(), "trace": reduced,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "index": device.index}
    every = [None] * world if lead else None
    dist.gather_object(mine, every, dst=0)
    full = sh.gather_state(mapper.state, device="cpu")
    if not lead:
        return None

    out.window_s = t_end - t_start
    out.attempted, out.failed = attempted, attempted - n_done
    out.counts["scans"] = end.scans - start.scans
    out.counts["calls"] = calls
    out.counts["passes"] = sum(1 for h in order if h == check.RESET)
    out.counts["ranks"] = world
    out.counts["mesh_backend"] = backend
    out.counts["mesh_collectives"] = every[0]["counters"].get("mesh.collectives", 0)
    for r, got in enumerate(every):
        out.counts[f"memory_peak_bytes.rank{r}"] = got["memory_peak_bytes"]
    out.samples["facade_host_ms"] = [(e - s) * 1e3 for s, e in window_spans]
    out.rank_tables = [got["table"] for got in every]
    out.rank_traces = [got["trace"] for got in every]
    out.trace = reduced
    if reduced is not None:
        out.counts["nccl_kernels_traced"] = sum(
            c for name, (c, _) in reduced.kernels.items() if "nccl" in name.lower())
    out.layers, out.position = runs.host_map(full)
    out.memory_peak_bytes = peak
    if cuda:
        out.devices = [{k: got[k] for k in ("kind", "index", "memory_peak_bytes")}
                       for got in every]
        cards_info(out.devices)  # one kind, one card a rank, or the run fails here
    return out


def _child(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of the mesh_replay loop (not rank 0)")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--parent", type=int, required=True)
    ap.add_argument("--device", required=True)
    args = ap.parse_args(argv)
    # Die with rank 0, also if it is killed.
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != args.parent:
        return 3
    if args.device == "cpu":
        torch.set_num_threads(2)
    try:
        _replay(args.rank, args.world, args.port, args.device, args.backend, None, [])
    finally:
        from fastdem_tpu_torch.parallel.distributed import shutdown

        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_child())
