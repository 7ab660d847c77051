"""The ``replay`` loop: offline map building from a recorded log. The
facade (``FastDEM``) integrates the log through ``integrate_sequence`` in
calls of ``batch`` scans with explicit transforms, pass after pass
(``reset()`` before each), a closed loop. The clouds are host clouds: their
copies to the device are part of the job."""

from __future__ import annotations

import gc
import time
from typing import List

import torch

from port_bench.harness import check, runs
from port_bench.harness.trace import Tracer

# A run compares the map alone (no post-processing result).
POSTPROCESS = False


def history(traffic: dict, log, seconds: float) -> List[int]:
    """The warm-up's scans, then one whole pass after a reset."""
    reps = runs.first_of_each_capacity(log)
    return [i for i in reps for _ in range(3)] + [check.RESET] + list(range(len(log)))


def run(config: dict, traffic: dict, log, seconds: float, trace: bool, device) -> runs.Run:
    from fastdem_tpu_torch.grid.geometry import GridGeometry
    from fastdem_tpu_torch.mapping.pipeline import FastDEM

    ncfg = runs.program_config(config)
    if device.type == "cuda":
        from fastdem_tpu_torch.runtime.driver import build_kernels

        build_kernels()
    geom = GridGeometry.from_length(ncfg.map.width, ncfg.map.height, ncfg.map.resolution)
    mapper = FastDEM(geom, ncfg.pipeline, device=device)
    clouds = runs.clouds(log)
    T_bs, T_wb = log.T_bs, log.T_wb
    batch = int(traffic["batch"])
    L = len(log)
    out = runs.Run()
    order = out.history

    # The facade's host span: time in each integrate call.
    spans: List[tuple] = []
    orig = mapper.integrate

    def integrate(cloud, *a, **k):
        t0 = time.perf_counter()
        ok = orig(cloud, *a, **k)
        spans.append((t0, time.perf_counter()))
        return ok

    mapper.integrate = integrate

    # Warm-up: every capacity the log's scans take, then a clear map.
    for i in runs.first_of_each_capacity(log):
        for _ in range(3):
            mapper.integrate_sequence([clouds[i]], T_bs, T_wb[i:i + 1], batch=batch)
            order.append(i)
    if trace and device.type == "cuda":
        Tracer.warm(device)
    runs.sync(device)
    spans.clear()
    runs.settle()

    tracer = Tracer() if trace else None
    t_trace = runs.trace_start(traffic, seconds)
    traced_from = traced_to = None
    traced_scans = 0
    n_done = attempted = 0
    b = 0
    mapper.reset()
    order.append(check.RESET)
    t_start = time.perf_counter()
    out.setup_end = t_start
    while True:
        now = time.perf_counter() - t_start
        if tracer is not None and traced_from is None and now >= t_trace:
            runs.sync(device)
            out.counts["untraced_scans_per_s"] = len(spans) / (time.perf_counter() - t_start)
            tracer.start()
            traced_from = len(spans)
        chunk = clouds[b:b + batch]
        n = mapper.integrate_sequence(chunk, T_bs, T_wb[b:b + len(chunk)], batch=batch)
        n_done += n
        attempted += len(chunk)
        order.extend(range(b, b + len(chunk)))
        b += len(chunk)
        now = time.perf_counter() - t_start
        if traced_from is not None and traced_to is None and now >= t_trace + float(traffic["trace_s"]):
            tracer.stop()
            traced_to = len(spans)
            traced_scans = traced_to - traced_from
        if now >= seconds:
            runs.sync(device)
            t_end = time.perf_counter()
            break
        if b >= L:
            b = 0
            mapper.reset()
            order.append(check.RESET)
    if tracer is not None and traced_to is None:
        tracer.stop()
        traced_to = len(spans)
        traced_scans = traced_to - traced_from
    window_spans = spans[: traced_from if traced_from is not None else len(spans)]
    # Finish the pass (outside the window): the map is compared after it.
    while 0 < b < L:
        chunk = clouds[b:b + batch]
        mapper.integrate_sequence(chunk, T_bs, T_wb[b:b + len(chunk)], batch=batch)
        order.extend(range(b, b + len(chunk)))
        b += len(chunk)
    runs.sync(device)

    out.window_s = t_end - t_start
    out.attempted, out.failed = attempted, attempted - n_done
    out.counts["scans"] = n_done
    out.counts["passes"] = sum(1 for h in order if h == check.RESET)
    out.samples["facade_host_ms"] = [(e - s) * 1e3 for s, e in window_spans]
    if tracer is not None:
        out.trace = tracer.reduce()
        if out.trace is not None:
            out.trace.scans = traced_scans
    out.layers, out.position = runs.host_map(mapper.state)
    out.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del mapper, clouds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
