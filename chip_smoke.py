#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device  -- the card's name and power limit (nvidia-smi).
  2. build   -- build K1 (fastdem_tpu_torch/csrc/polar_field.cu) with nvcc.
  3. K1      -- the kernel against its plain PyTorch twin on the card, at
                the three polar-field shapes of the reference's kernel
                test; kernel and plain medians at the flagship [515, 2048].
  4. main    -- FastDEM on the card, flagship configuration (15x15 m LOCAL
                map at 0.1 m, Kalman, LiDAR noise, polar raycast): 10 scans
                of 30,000 points with a moving robot; K1 must launch once
                per scan; heights are checked against the synthetic terrain.
  5. parity  -- the same 10 scans through FastDEM on the CPU (plain twins),
                every layer compared with the card's.
  6. time    -- ms/scan over a chain of 64 scans, CUDA events.

The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import fastdem_tpu_torch as fd  # noqa: E402
from fastdem_tpu_torch.ops import polar_field as k1  # noqa: E402
from fastdem_tpu_torch.postprocess import raycasting as raycast  # noqa: E402

N_SCANS = 10
N_POINTS = 30000
CHAIN = 64
# Scan xy spread (m): covers the whole 15x15 m map.
SPREAD = 10.0
NOISE_SIGMA = 0.01
K1_ATOL = 4e-6
# GPU vs CPU agreement: atan2 differs in the last ulp between the two
# devices, which can move a ray or a cell across a polar-bin boundary.
PARITY_RTOL = 1e-5
PARITY_ATOL = 1e-5
PARITY_MIN_SHARE = 0.999


def terrain(x, y):
    return 0.2 * np.sin(0.8 * x) * np.cos(0.6 * y)


def make_session(n_scans, seed):
    """Sensor-frame scans over a static world terrain, with robot poses.

    ``bench.make_scans`` gives the scan layout (xy and noise) in the sensor
    frame; z is re-sampled from the static world terrain at the points'
    world xy, with the noise scaled to ``NOISE_SIGMA``.
    """
    import bench

    rng = np.random.default_rng(seed)
    scans = bench.make_scans(n_scans, N_POINTS, rng, spread=SPREAD)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = []
    for k in range(n_scans):
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.137 * k
        T_wb[1, 3] = -0.061 * k
        xs = scans[k, :, 0].astype(np.float64)
        ys = scans[k, :, 1].astype(np.float64)
        noise = scans[k, :, 2] - (terrain(xs, ys) - 1.0)
        zs = terrain(xs + T_wb[0, 3], ys + T_wb[1, 3]) - 1.0
        zs = zs + noise * (NOISE_SIGMA / 0.02)
        scans[k, :, 2] = zs.astype(np.float32)
        poses.append(T_wb)
    return scans, T_bs, poses


def flagship_config():
    cfg = fd.Config()
    cfg.mapping.estimation_type = fd.EstimationType.KALMAN
    cfg.sensor_model.type = fd.SensorType.LIDAR
    cfg.raycasting.enabled = True
    return cfg


def run_session(device, scans, T_bs, poses):
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    mapper = fd.FastDEM(geom, flagship_config(), device=device)
    for k in range(len(poses)):
        cloud = fd.cloud.from_numpy(scans[k], frame_id="lidar", device=device)
        if not mapper.integrate(cloud, T_bs, poses[k]):
            raise RuntimeError(f"integrate refused scan {k}")
    return geom, mapper


def height_error(geom, mapper):
    """(mapped cells, median |elevation - terrain|) of the final map."""
    state = mapper.state
    rr, cc = torch.meshgrid(
        torch.arange(geom.rows, device=state.position.device),
        torch.arange(geom.cols, device=state.position.device),
        indexing="ij",
    )
    x, y = geom.position_of(state.position, rr, cc)
    elev = state.layers["elevation"].cpu().numpy()
    truth = terrain(x.cpu().numpy().astype(np.float64), y.cpu().numpy().astype(np.float64))
    mapped = np.isfinite(elev)
    return int(mapped.sum()), float(np.median(np.abs(elev[mapped] - truth[mapped])))


def compare_layers(ref_state, got_state):
    """Per layer: (NaN-set mismatches, finite value mismatches, cells)."""
    out = {}
    for name, ref_t in ref_state.layers.items():
        ref = ref_t.cpu().numpy()
        got = got_state.layers[name].cpu().numpy()
        nan_mis = int((np.isnan(ref) != np.isnan(got)).sum())
        both = np.isfinite(ref) & np.isfinite(got)
        close = np.isclose(got, ref, rtol=PARITY_RTOL, atol=PARITY_ATOL)
        val_mis = int((both & ~close).sum())
        out[name] = (nan_mis, val_mis, ref.size)
    return out


def cuda_median_ms(fn, reps):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_k1():
    """K1 against its plain twin at the reference test's three shapes."""
    dev = torch.device("cuda")
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    rng = np.random.default_rng(42)
    so = torch.tensor([0.07, -0.03, 1.2], dtype=torch.float32, device=dev)
    max_err = 0.0
    timing = None
    for num_az, rbf, maxr, exact in (
        (2048, 0.25, 12.81, True),
        (1024, 0.5, 9.0, True),
        (2048, 0.25, 12.81, False),
    ):
        A, R, dr = raycast.polar_dims(geom, num_az, rbf, maxr)
        tbl = rng.uniform(-2.0, 0.5, R * A).astype(np.float32)
        tbl[rng.random(R * A) < 0.97] = np.inf
        scat = torch.tensor(tbl, device=dev).reshape(R, A)
        win = raycast.column_windows(geom, num_az, rbf, maxr, dev)
        nfold = int(np.ceil(1.0 / rbf))
        got = k1.polar_field_cuda(scat, win, so, dr, nfold, exact)
        ref = k1.polar_field_plain(scat, win, so, dr, nfold, exact)
        torch.cuda.synchronize()
        got_np, ref_np = got.cpu().numpy(), ref.cpu().numpy()
        if not np.array_equal(np.isfinite(got_np), np.isfinite(ref_np)):
            raise AssertionError(f"K1 finite set differs at A={A} R={R} exact={exact}")
        fin = np.isfinite(ref_np)
        err = float(np.max(np.abs(got_np[fin] - ref_np[fin]))) if fin.any() else 0.0
        print(f"K1 [R={R}, A={A}] exact_window={exact}: identical finite sets "
              f"({int(fin.sum())} finite), max |diff| {err!r}")
        if err > K1_ATOL:
            raise AssertionError(f"K1 max |diff| {err} > {K1_ATOL}")
        max_err = max(max_err, err)
        if timing is None:  # the flagship shape [515, 2048], exact window
            def run_k1():
                k1.polar_field_cuda(scat, win, so, dr, nfold, exact)

            def run_plain():
                k1.polar_field_plain(scat, win, so, dr, nfold, exact)

            for fn in (run_k1, run_plain):
                for _ in range(5):
                    fn()
            torch.cuda.synchronize()
            ms = cuda_median_ms(run_k1, 200)
            plain_ms = cuda_median_ms(run_plain, 50)
            timing = (ms, plain_ms)
            print(f"K1 time at [{R}, {A}]: kernel {ms!r} ms, plain twin "
                  f"{plain_ms!r} ms (median, CUDA events, L2-warm input)")
    return (max_err,) + timing


def main() -> int:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a "
              "CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {count}")
    print("card name, power limit (nvidia-smi):")
    print(smi[0])
    card = smi[0]

    # ---- 2. build ----
    t0 = time.perf_counter()
    k1.library()
    build_s = time.perf_counter() - t0
    print(f"K1 build+load: {build_s!r} s ({'built' if k1.build_log else 'cached'})")
    if k1.build_log:
        print(k1.build_log.strip())

    # ---- 3. K1 vs plain twin ----
    max_err, k1_ms, plain_ms = phase_k1()
    torch.cuda.synchronize()

    # ---- 4. main path on the card ----
    scans, T_bs, poses = make_session(N_SCANS, seed=7)
    k1.launches = 0
    geom, gpu = run_session("cuda", scans, T_bs, poses)
    torch.cuda.synchronize()
    main_launches = k1.launches
    print(f"main path: {N_SCANS} scans on {kind}, K1 launches {main_launches}")
    if main_launches != N_SCANS:
        raise AssertionError(f"K1 launched {main_launches} times, want {N_SCANS}")
    mapped, med = height_error(geom, gpu)
    print(f"main path: {mapped} mapped cells, median |elevation - terrain| {med!r} m")
    if mapped <= 17000 or not med < 0.01:
        raise AssertionError("main path map fails the >17K cells / <0.01 m check")
    for name, t in gpu.state.layers.items():
        if t.shape != geom.shape or t.dtype != torch.float32:
            raise AssertionError(f"layer {name}: {t.dtype} {tuple(t.shape)}")

    # ---- 5. GPU against CPU ----
    _, cpu = run_session("cpu", scans, T_bs, poses)
    worst = 1.0
    for name, (nan_mis, val_mis, ncell) in compare_layers(cpu.state, gpu.state).items():
        share = 1.0 - max(nan_mis, val_mis) / ncell
        worst = min(worst, share)
        print(f"parity {name}: NaN-set mismatches {nan_mis}, value mismatches "
              f"{val_mis} of {ncell}")
    if worst < PARITY_MIN_SHARE:
        raise AssertionError(f"GPU/CPU agreement {worst} < {PARITY_MIN_SHARE}")
    print(f"parity: worst layer agrees on {worst!r} of cells")

    # ---- 6. time ----
    chain_scans, _, chain_poses = make_session(CHAIN, seed=11)
    clouds = [
        fd.cloud.from_numpy(chain_scans[k], frame_id="lidar", device="cuda")
        for k in range(CHAIN)
    ]
    timer = fd.FastDEM(geom, flagship_config(), device="cuda")
    for k in range(8):  # warm-up
        timer.integrate(clouds[k], T_bs, chain_poses[k])
    timer.reset()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(CHAIN):
        timer.integrate(clouds[k], T_bs, chain_poses[k])
    end.record()
    end.synchronize()
    ms_scan = start.elapsed_time(end) / CHAIN
    print(f"flagship: {ms_scan!r} ms/scan over a {CHAIN}-scan chain "
          f"(FastDEM.integrate, CUDA events) on {card}")

    print(json.dumps({"kernels": [{
        "name": "polar_field (K1)",
        "route": "cuda",
        "source": "fastdem_tpu_torch/csrc/polar_field.cu",
        "replaces": "fastdem_tpu/ops/pallas_polar.py:49",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
