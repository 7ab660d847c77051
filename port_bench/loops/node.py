"""The ``node`` loop: the online mapping node (``NodeConfig.make_driver``
with async intake, its timers on, sinks that only record receipt), offered
one scan every 1 / ``rate_hz`` seconds, an open loop: each scan is handed to
``on_scan`` at its due time whatever the node is doing. A scan's latency
runs from its due time to the completion on the device of its map update,
read from a CUDA event recorded in the facade's ``on_preprocessed``
callback (right after the step is enqueued)."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from port_bench.harness import runs
from port_bench.harness.trace import Tracer

# Scans a run integrates in its warm-up after the first of each capacity,
# about: until every timer has ticked once (the 1 Hz one last).
WARMUP_SCANS = 12

# A run ends with one run_postprocess(), whose result is compared too.
POSTPROCESS = True


def history(traffic: dict, log, seconds: float) -> List[int]:
    """The first scan of each capacity, then the warm-up's and the window's
    scans in order."""
    n = WARMUP_SCANS + int(round(seconds * float(traffic["rate_hz"])))
    return runs.first_of_each_capacity(log) + list(range(min(n, len(log))))


def run(config: dict, traffic: dict, log, seconds: float, trace: bool, device) -> runs.Run:
    from fastdem_tpu_torch.runtime.providers import StaticCalibration, TransformBuffer

    ncfg = runs.program_config(config)
    calib = StaticCalibration(ncfg.tf.base_frame)
    calib.set_extrinsic("lidar", log.T_bs)
    odom = TransformBuffer(ncfg.tf.base_frame, ncfg.tf.map_frame,
                           max_stale_time=ncfg.tf.max_stale_time,
                           max_buffer=len(log.odom_ns) + 1)
    for t_ns, T in zip(log.odom_ns, log.odom_T):
        odom.add_pose(int(t_ns), T)
    driver = ncfg.make_driver(device=device, calibration=calib, odometry=odom,
                              async_intake=True, burst_batch=int(traffic["burst_batch"]))
    received: Dict[str, List[float]] = {"map": [], "global_submap": [], "postprocess": []}
    for topic in received:
        driver.sinks[topic] = (lambda t: lambda payload: received[t].append(time.perf_counter()))(topic)

    clouds = runs.clouds(log)
    index_of = {int(s): i for i, s in enumerate(log.stamps_ns)}
    clock = runs.Completion(device)
    out = runs.Run()
    order = out.history
    marks: Dict[int, tuple] = {}
    current = [None]
    orig = driver.mapper.integrate

    def integrate(cloud, *a, **k):
        current[0] = index_of[int(cloud.timestamp_ns)]
        ok = orig(cloud, *a, **k)
        if ok:
            order.append(current[0])
        return ok

    def on_preprocessed(aux):
        marks[current[0]] = (time.perf_counter(), clock.mark())

    driver.mapper.integrate = integrate
    driver.mapper.on_preprocessed = on_preprocessed
    period = 1.0 / float(traffic["rate_hz"])

    # Warm-up: a scan of every capacity, then scans at the rate until every
    # timer has ticked, then one run_postprocess() with its default switches.
    nxt = 0
    for i in runs.first_of_each_capacity(log):
        driver.on_scan(clouds[i])
    driver.drain(timeout=120.0)
    timers = [name for name, rate in (("viz", driver.viz_rate), ("global", driver.global_rate),
                                      ("postprocess", driver.postprocess_rate)) if rate > 0]
    t_w = time.perf_counter()
    while not all(driver.tick_ms[name] for name in timers) or nxt < 3:
        driver.on_scan(clouds[nxt])
        nxt += 1
        t_w += period
        time.sleep(max(0.0, t_w - time.perf_counter()))
    driver.drain(timeout=120.0)
    driver.run_postprocess()
    if trace and device.type == "cuda":
        Tracer.warm(device)
    runs.sync(device)
    runs.settle()

    n_window = int(round(seconds * float(traffic["rate_hz"])))
    if nxt + n_window > len(log):
        raise ValueError(f"the log holds {len(log)} scans; the window needs {nxt + n_window}")
    tracer = Tracer() if trace else None
    t_trace = runs.trace_start(traffic, seconds)
    trace_first = trace_last = None
    t_traced = float("inf")
    viz_traced = pp_traced = None
    viz0 = len(driver.tick_ms["viz"])
    pp0 = len(driver.tick_ms["postprocess"])
    clock.start()
    t_start = time.perf_counter()
    out.setup_end = t_start
    due = [t_start + k * period for k in range(n_window)]
    handed = []
    for k in range(n_window):
        now = time.perf_counter()
        if tracer is not None and trace_first is None and now - t_start >= t_trace:
            t_traced = time.perf_counter()
            viz_traced = len(driver.tick_ms["viz"])
            pp_traced = len(driver.tick_ms["postprocess"])
            tracer.start()
            trace_first = k
        if tracer is not None and trace_first is not None and trace_last is None \
                and now - t_start >= t_trace + float(traffic["trace_s"]):
            tracer.stop()
            trace_last = k
        time.sleep(max(0.0, due[k] - time.perf_counter()))
        handed.append(time.perf_counter())
        driver.on_scan(clouds[nxt + k])
    time.sleep(max(0.0, t_start + seconds - time.perf_counter()))
    t_end = time.perf_counter()
    viz1 = len(driver.tick_ms["viz"])
    pp1 = len(driver.tick_ms["postprocess"])
    if tracer is not None and trace_last is None:
        tracer.stop()
        trace_last = n_window
    drained = driver.drain(timeout=60.0)
    runs.sync(device)
    t_gave_up = time.perf_counter()

    # Per-layer samples come from the part of the window before the traced
    # sub-window: the profiler's start stalls the scans in flight.
    window_idx = list(range(nxt, nxt + n_window))
    latency, enqueue, on_device, failed = [], [], [], 0
    for k, i in enumerate(window_idx):
        if i in marks:
            cb, ev = marks[i]
            done = clock.host_time(ev)
            latency.append((done - due[k]) * 1e3)
            if cb < t_traced:
                enqueue.append((cb - due[k]) * 1e3)
                on_device.append((done - cb) * 1e3)
        else:
            failed += 1
            latency.append((t_gave_up - due[k]) * 1e3)
    out.window_s = t_end - t_start
    out.attempted, out.failed = n_window, failed
    out.samples["scan_latency_ms"] = latency
    out.samples["enqueue_ms"] = enqueue
    out.samples["enqueued_to_done_ms"] = on_device
    out.samples["viz_tick_ms"] = list(driver.tick_ms["viz"])[viz0:viz1 if viz_traced is None else viz_traced]
    out.samples["pp_tick_ms"] = list(driver.tick_ms["postprocess"])[pp0:pp1 if pp_traced is None else pp_traced]
    out.counts.update(
        dropped=driver.dropped_scans, intake_errors=driver.intake_errors, drained=float(drained),
        generator_late_ms_max=max((h - d) * 1e3 for h, d in zip(handed, due)),
        received_map=len(received["map"]), received_global=len(received["global_submap"]),
        received_pp=len(received["postprocess"]),
    )
    if tracer is not None:
        out.trace = tracer.reduce()
        if out.trace is not None:
            out.trace.scans = (trace_last or n_window) - (trace_first or 0)

    # The answer: one run_postprocess() after the drain, then the map.
    out.pp = driver.run_postprocess()
    driver.close()
    out.layers, out.position = runs.host_map(driver.mapper.state)
    out.memory_peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del driver, clouds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
