#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on a CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device   -- the card's name and power limit (nvidia-smi).
  2. build    -- build K1 (csrc/polar_field.cu) and K4 (csrc/resample.cu),
                 one nvcc each, in parallel.
  3. K1       -- the kernel against its plain PyTorch twin on the card, bit
                 for bit, at the three polar-field shapes of the
                 reference's kernel test, the GLOBAL shape [962, 2048] and
                 edge shapes (folds of 1 and 10 rows, A = 1024, R = 517, a
                 tall [4096, 1024] field walked in row chunks); device
                 times (torch.profiler) at the flagship and GLOBAL shapes,
                 the column and the row kernel apart, beside the bound and
                 its share.
  4. K4       -- the per-cell lookup, whose kernel also computes the
                 indices, against its twin (resample_indices +
                 resample_plain), one and two reads, on the flagship's
                 whole map and a GLOBAL window with device offsets:
                 bit-identical, same NaN and touched sets; device times.
  5. exact    -- polar_resample with exact_window (K1-exact + K4 one read)
                 against the two-read form (K1 + K4 two reads) on a
                 scattered LiDAR table: bitwise-equal heights and touched.
  6. flagship -- FastDEM on the card (15x15 m LOCAL map at 0.1 m, Kalman,
                 LiDAR noise, polar raycast): 10 scans of 30,000 points with
                 a moving robot; K1 and K4 launch once per scan; heights
                 against the synthetic terrain; every layer against the
                 same session on the CPU.
  7. global   -- the fixed-origin 200x200 m GLOBAL map at 0.1 m, range
                 filter 20 m (windowed update, 484x484 window, polar field
                 [962, 2048]), Kalman: 10 scans of 30,000 points over a
                 moving robot; one K1 and one K4 launch per scan, no point
                 outside the window, terrain check, CPU agreement.
  8. window   -- windowed == full-map update on the card, bit for bit: a
                 40x40 m GLOBAL map at 0.1 m, range 6 m, Kalman and P^2.
  9. p2       -- the flagship configuration with the P^2 estimator, card
                 against CPU, terrain check.
 10. time     -- ms/scan over 32-scan chains (CUDA events): GLOBAL Kalman,
                 flagship P^2, flagship Kalman; device events and device ms
                 per scan (torch.profiler over a few scans) on each, beside
                 the device events one resample_indices call makes.
 11. postprocess -- the post-processing chain (uncertainty fusion,
                 inpainting, PCA features) plus the 3x3 median on the
                 flagship map of phase 6 (150x150) and on the GLOBAL map of
                 phase 7 (2000x2000), card against CPU on the same layers
                 (the 2000x2000 map on a 512x512 block of mapped cells, run
                 on the CPU with an 8-cell margin): NaN sets exact, values
                 within 2e-6 (slope 5e-3 degrees; roughness, where sqrt
                 amplifies, through its square within 1e-8); device ms,
                 wall ms, kernel launches and peak memory per chain.
 12. sampled  -- the polar path (K1 + K4, ray_min_height_polar) against the
                 sampled oracle on the card (the reference's LiDAR parity
                 scene, 12x12 m at 0.1 m): 90th percentile of |polar -
                 sampled| < 0.1 m, < 4% of cells > 0.15 m above it, polar
                 covering > 97% of its cells; then a 5-scan flagship
                 session with raycasting.method = "sampled", card against
                 CPU (no K1 / K4 launch on that path).
 13. node     -- the mapping node's driver (runtime.MappingDriver) from the
                 port's local_mapping preset on the card, fed 32 of the node
                 tool's synthetic 30,000-point scans through a
                 TransformBuffer three ways: sync intake, async intake in
                 bursts of 8, async intake with the post-processing timer
                 at the preset's 2 Hz. The three maps are bit-identical, K1
                 and K4 launch once per scan, no scan drops; run_postprocess
                 on the card against the CPU chain on the same snapshot (the
                 tolerances of phase 11); save_npz -> load_npz bitwise.
                 scans/s over 128 scans, sync and async with the timer off
                 and on (in turns) and with the preset's own timers, the
                 timers' host ms per tick (viz also with no scan coming
                 in), every run's map bit-identical; the node tool as a
                 subprocess (16 scans); the
                 GLOBAL node preset (200 m at 0.1 m) for 8 scans with its
                 viz tick's host ms.
 14. replay   -- FastDEM.integrate_sequence (batch 16) over 64 flagship
                 scans, and build_integrate_sequence on the same scans
                 stacked on the card in calls of 16, against the integrate
                 loop: bit-identical on every layer, one K1 and one K4
                 launch per scan, ms/scan of each (CUDA events, three of
                 each in turns); the replay tool as a subprocess (64
                 scans, batch 16); integrate_sequence with the poses as a
                 list of CUDA tensors == the numpy call, bitwise.
 15. batch DEM -- build_dem (DEMConfig defaults: SOR k 20, std 1.0,
                 floating-point cutoff 2 m, 3 inpainting passes) on a
                 synthetic 100x100 m site at 0.1 m, 500,000 points (0.5%
                 gross outliers, 5% floating 3-8 m up), intensity and
                 colour: median ms over 5 runs after a warm-up of the grid
                 kNN, SOR, remove_floating_points, rasterize_stats,
                 inpaint and the whole build_dem, the grid certificate's
                 hit rate and peak memory; voxel_grid and transform_cloud
                 at 500K (nanoPCL's bars). The card against the port on the
                 CPU on a 100,000-point crop: SOR and floating-point masks
                 equal, count / min / max / touched exact, mean and
                 variance to rtol 1e-5, inpainted elevation within 2e-6;
                 grid kNN == knn_brute on 4,096 sampled queries, distances
                 bitwise; the pcd2dem tool as a subprocess.
 16. rgbd     -- a 640x480 u16 depth image (307,200 pixels) of a ground
                 plane with boxes seen by a camera pitched down:
                 depth_to_cloud and camera_to_base_transform, 8 frames
                 through FastDEM.integrate (flagship map, SensorType.RGBD)
                 on the card against the CPU at the pipeline tolerances;
                 ms per frame.
 17. repairs  -- the 200 m GLOBAL map with raycasting.method = "sampled"
                 (the window off: rows mode over 4M cells), 3 scans, card
                 against CPU. (Phase 13 runs the driver with its lock taken
                 per scan; phase 14 the transforms as CUDA tensors.)
 18. cloud    -- the point-cloud library at nanoPCL's scale (median of 5
                 after a warm-up, synchronised host clock, peak memory):
                 estimate_normals / estimate_covariances at 100K points
                 (k 10, grid path), segment_plane at 100K x 100
                 hypotheses, euclidean_cluster at 100K, segment_ground on
                 the 500K synthetic site; align on the registration
                 benchmark's scene (tools/common.registration_pair): ICP
                 and GICP at 10K (LM), VGICP at 50K and 100K (LM, voxel
                 1.0, grid kNN prep), each with its iterations and its
                 translation error against T_true (< 0.05 m); ICP 10K's
                 correspondence ms per iteration (CUDA events around each
                 1-NN pass) against the rest; the card against the CPU on
                 10K points: normals, the ground mask, ICP's T.
 19. native IO -- the native scan IO library built (g++); 64 KITTI .bin
                 and 64 binary PCD flagship scans written by the port's
                 savers, parsed natively and in Python: bit for bit, ms per
                 scan each; the replay tool with --prefetch 2 over the 64
                 PCD scans against the same tool without it: the maps
                 bit-identical, one K1 and one K4 launch per scan, ms/scan
                 of each.

 20. sharded  -- the 200 m GLOBAL map of phase 7 on a 2x2 mesh of
                 1000x1000 blocks on the one card
                 (parallel.sharding.build_sharded_integrate, the windowed
                 formulation), 16 scans of 30,000 points: the step and the
                 16-scan sequence equal the unsharded windowed step bit for
                 bit on every layer, K1 once per scan (shared by the
                 blocks) and K4 once per block per scan, no point outside
                 the window; device events and device ms per scan and
                 ms/scan (three alternating turns) sharded against
                 unsharded; the post-processing chain per block with its
                 halo against the unsharded chain (phase 11's tolerances,
                 the bitwise share printed); two gloo processes of
                 tools/multihost_demo on the card, 2 blocks each, fed the
                 same 16 scans: save_sharded_npz byte for byte equal to
                 save_npz of the one-process map, and the sharded
                 checkpoint restored onto 1x4 and 4x1 meshes plus 4 scans
                 equal to the uninterrupted run; cold start of a flagship
                 node in a fresh process against an empty program-cache
                 bundle and against the filled one (no nvcc build), both
                 with enable alone up to the first scan, seconds from
                 process start to the first integrated scan (the first
                 then fills the bundle with warmup, its seconds and the
                 native g++ build's printed apart); the scaling report, strong and weak, as an
                 overhead probe of 4 blocks on one card.
 21. modes    -- the rasterizer's other formulations and the scan-batched
                 replay step: 16 flagship scans each through
                 build_integrate(scatter_mode=) packed, twophase (K1 and
                 K4 once per scan) and sort (raycast off), card against
                 CPU (phase 6's tolerances, decision layers equal; sort
                 bit for bit), terrain check; the switch to packed on the
                 200 m GLOBAL map with a 40 m range filter (a 924^2
                 window), 8 scans card against CPU; the sharded fallback
                 (blocks_fullmap) over packed on a 730^2 LOCAL map, 2x2
                 mesh, bit for bit against the unsharded packed step; 64
                 flagship scans through build_integrate_sequence
                 (microbatch 1, 4, 16) and build_integrate_fused (K = 16)
                 against the step loop (decision layers equal), K1 and K4
                 once per batch; the batched K1 and K4 against their
                 twins bit for bit at K = 4 and 16, their per-frame device
                 ms; device events, device ms and wall ms per scan of each
                 batch size, in alternating turns.
 22. graphs   -- the compiled step (utils/graphs.py): a step with a host
                 read refuses its capture; 32-scan chains
                 through build_integrate(jit=True) (CUDA graphs, the state
                 donated) against jit=False on the flagship Kalman and P2,
                 the 200 m GLOBAL map, the switch to packed (40 m range)
                 and the sampled raycast (16 scans): every layer and the
                 last aux bit for bit, K1 / K4 counted once per replay;
                 microbatch 16 and fused 16 over 32 scans, graph against
                 eager bit for bit; the post-processing chain at 150^2 and
                 2000^2 as a graph against the eager chain, every output
                 bit for bit on two calls; per path wall ms per scan
                 (CUDA events and host clock, eager and graph in mirrored
                 turns), device events and device ms per scan
                 (torch.profiler), capture seconds and graph memory per
                 signature; the node (sync intake, 128 scans) with graph
                 and eager steps in turns: scans/s, maps bit for bit.
                 Every earlier phase runs the default jit=True.
 23. last programs -- the 2x2 sharded 200 m GLOBAL map
                 (build_sharded_integrate jit=True, donate=True: one graph
                 a scan) against jit=False over 32 scans, every layer and
                 the last aux bit for bit and equal to the unsharded
                 graph step; the K = 16 sharded sequence as one graph (K1
                 16, K4 64 per replay); LOCAL's fallback on the flagship
                 map (the move a gather on the card) the same way; wall
                 ms/scan in mirrored turns, device events and ms per scan,
                 the trace's K1 / K4 events equal to the counters, capture
                 seconds and pools; two gloo processes running the
                 compiled sequence, byte for byte with one process; the
                 scaling report with both sides compiled; align's fused
                 driver against the host loop on streams of three
                 distinct pairs near ICP 10K GN and LM, GICP 10K and
                 VGICP 50K / 100K, every call cold (each fused call
                 captures its own graph): bit for bit, ms per align in
                 mirrored turns, host reads, masked passes;
                 euclidean_cluster on three distinct clouds near 100K /
                 500K points against a plain per-sweep loop, cold: labels
                 equal, ms in mirrored turns, sweeps, host reads.

The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import fastdem_tpu_torch as fd  # noqa: E402
from fastdem_tpu_torch.mapping.pipeline import build_integrate_sequence  # noqa: E402
from fastdem_tpu_torch.ops import cuda_build  # noqa: E402
from fastdem_tpu_torch.ops import polar_field as k1  # noqa: E402
from fastdem_tpu_torch.ops import resample as k4  # noqa: E402
from fastdem_tpu_torch.postprocess import apply_postprocess_fn, smooth_median  # noqa: E402
from fastdem_tpu_torch.postprocess import raycasting as raycast  # noqa: E402
from fastdem_tpu_torch.utils import profiling  # noqa: E402

N_SCANS = 10
N_POINTS = 30000
CHAIN = 32
# Scan xy spread (m): covers the whole 15x15 m flagship map.
SPREAD = 10.0
# GLOBAL: scans reach 18 m, inside the 20 m range filter.
GLOBAL_SPREAD = 18.0
GLOBAL_RANGE = 20.0
NOISE_SIGMA = 0.01
# The bound of a kernel: the larger of its bytes over the memory rate and
# its operations over the f32 rate outside the tensor cores (NVIDIA H100
# SXM data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per cell of K4's index math (two atan2f and one log2f
# counted at ~20 each) and its lookup.
K4_LOOKUP_OPS = 100
# GPU vs CPU agreement: atan2 differs in the last ulp between the two
# devices, which can move a ray or a cell across a polar-bin boundary.
PARITY_RTOL = 1e-5
PARITY_ATOL = 1e-5
PARITY_MIN_SHARE = 0.999
# Terrain check: median |elevation - terrain| on mapped cells. The P^2
# elevation is the 84% quantile marker, one noise sigma above the mean.
TERRAIN_TOL = {"kalman": 0.01, "p2": 0.02}
# Post-processing, card against CPU: the tolerances the C++ golden holds
# the reference to; roughness = sqrt(smallest eigenvalue), so where sqrt
# amplifies, its square is held instead.
PP_ATOL = 2e-6
PP_SLOPE_ATOL = 5e-3
PP_EIGEN_ATOL = 1e-8
PP_BLOCK = 512
# Cells a block's results depend on beyond it: three inpainting passes of
# radius 1, the features' 0.3 m disk (3 cells) and the 3x3 median.
PP_MARGIN = 8
PP_REPS = 5
# Scans under the profiler for the device events per scan (phase 10).
EVENT_SCANS = 8
# Profiler windows a measurement that may run again takes when one records
# no device event (profiling.device_profile).
PROFILE_ATTEMPTS = 3
# The node (phase 13) and replay (phase 14).
NODE_SCANS = 32
NODE_BURST = 8
NODE_RATE_SCANS = 128
GLOBAL_NODE_SCANS = 8
VIZ_TICKS = 5
LOCK_PROBE_S = 0.01
REPLAY_SCANS = 64
REPLAY_BATCH = 16
TOOL_TIMEOUT_S = 240
# The batch DEM (phase 15): BASELINE.md's nanoPCL scale.
DEM_POINTS = 500_000
DEM_SITE_M = 100.0
DEM_CROP_POINTS = 100_000
DEM_REPS = 5
DEM_KNN_SAMPLE = 4096
DEM_STATS_RTOL = 1e-5
DEM_ELEV_ATOL = 2e-6
# RGB-D (phase 16): BASELINE configuration 3.
RGBD_FRAMES = 8
RGBD_SHAPE = (480, 640)
# The sampled raycast on the GLOBAL map (phase 17).
SAMPLED_GLOBAL_SCANS = 3
SAMPLED_GLOBAL_POINTS = 20000
# The cloud library (phase 18): nanoPCL's benchmark scale (BASELINE.md:25-26).
CLOUD_POINTS = 100_000
CLOUD_K = 10
CLOUD_REPS = 5
PLANE_HYPOTHESES = 100
ICP_POINTS = 10_000
VGICP_POINTS = (50_000, 100_000)
ALIGN_T_TOL = 0.05
CLOUD_CROP = 10_000
CROP_ICP_ITERATIONS = 10
# The native scan IO (phase 19).
IO_SCANS = 64
# The block-sharded GLOBAL map (phase 20): scans before the checkpoint,
# scans after it, and alternating timing turns.
SHARD_SCANS = 16
RESUME_SCANS = 4
SHARD_TURNS = 3
# The rasterizer's other formulations and the scan-batched replay step
# (phase 21): scans per mode, the switch session (a 40 m range filter on
# the 200 m GLOBAL map: a 924^2 window), the LOCAL map of the sharded
# fallback (730^2 cells, above 2^19), the batched replay.
MODE_SCANS = 16
SWITCH_SCANS = 8
SWITCH_RANGE = 40.0
SWITCH_SPREAD = 36.0
SHARD_LOCAL_M = 73.0
BATCH_SCANS = 64
MICROBATCHES = (1, 4, 16)
FUSED_K = 16
BATCH_KERNEL_FRAMES = (4, 16)
BATCH_TURNS = 2
# The compiled step (phase 22): timing turns (each runs eager and graph
# twice, in mirrored order), scans under the profiler, and the sampled
# session's length.
GRAPH_TURNS = 1
GRAPH_PROFILE_SCANS = 8
GRAPH_SAMPLED_SCANS = 16
GRAPH_NODE_WARM = 8
# Phase 22's node on scans of varying size: this many scans, each cut to a
# size drawn in [lo, hi) (three powers of two: 8,192 / 16,384 / 32,768).
VARY_SCANS = 64
VARY_POINTS = (6000, 30000)
# The last compiled programs (phase 23): the sharded chain and the
# sequence's K, the LOCAL fallback's scans; the registration and
# clustering streams: this many distinct clouds a turn, each of the size
# plus k times the step (k = 0, 1, ...), in four mirrored turns.
SHARD_GRAPH_SCANS = 32
SHARD_SEQ_K = 16
STREAM_CLOUDS = 3
STREAM_STEP = 1_237
CLUSTER_POINTS = (100_000, 500_000)


def terrain(x, y):
    return 0.2 * np.sin(0.8 * x) * np.cos(0.6 * y)


def make_session(n_scans, seed, spread=SPREAD, start=(0.0, 0.0), step=(0.137, -0.061)):
    """Sensor-frame scans over a static world terrain, with robot poses.

    ``bench.make_scans`` gives the scan layout (xy and noise) in the sensor
    frame; z is re-sampled from the static world terrain at the points'
    world xy, with the noise scaled to ``NOISE_SIGMA``.
    """
    import bench

    rng = np.random.default_rng(seed)
    scans = bench.make_scans(n_scans, N_POINTS, rng, spread=spread)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = []
    for k in range(n_scans):
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = start[0] + step[0] * k
        T_wb[1, 3] = start[1] + step[1] * k
        xs = scans[k, :, 0].astype(np.float64)
        ys = scans[k, :, 1].astype(np.float64)
        noise = scans[k, :, 2] - (terrain(xs, ys) - 1.0)
        zs = terrain(xs + T_wb[0, 3], ys + T_wb[1, 3]) - 1.0
        zs = zs + noise * (NOISE_SIGMA / 0.02)
        scans[k, :, 2] = zs.astype(np.float32)
        poses.append(T_wb)
    return scans, T_bs, poses


def flagship_config(est="kalman"):
    cfg = fd.Config()
    cfg.mapping.estimation_type = (
        fd.EstimationType.P2_QUANTILE if est == "p2" else fd.EstimationType.KALMAN
    )
    cfg.sensor_model.type = fd.SensorType.LIDAR
    cfg.raycasting.enabled = True
    return cfg


def global_config():
    cfg = flagship_config()
    cfg.mapping.mode = fd.MappingMode.GLOBAL
    cfg.point_filter.range_max = GLOBAL_RANGE
    return cfg


def flagship_geom():
    return fd.GridGeometry.from_length(15.0, 15.0, 0.1)


def global_geom():
    return fd.GridGeometry.from_length(200.0, 200.0, 0.1)


def global_session_scans(n_scans, seed):
    # The robot crosses the map's middle, 1.9 m per scan.
    return make_session(n_scans, seed, spread=GLOBAL_SPREAD, start=(-12.0, 6.0),
                        step=(1.7, -0.85))


def run_session(device, geom, cfg, scans, T_bs, poses):
    """FastDEM over the scans; also returns the per-scan out-of-window
    counts (device tensors, read after the session)."""
    mapper = fd.FastDEM(geom, cfg, device=device)
    oow = []
    for k in range(len(poses)):
        cloud = fd.cloud.from_numpy(scans[k], frame_id="lidar", device=device)
        if not mapper.integrate(cloud, T_bs, poses[k]):
            raise RuntimeError(f"integrate refused scan {k}")
        oow.append(mapper.last_aux.oow_points)
    return mapper, oow


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


def check_parity(what, cpu_state, gpu_state):
    worst = 1.0
    for name, (nan_mis, val_mis, ncell) in compare_layers(cpu_state, gpu_state).items():
        share = 1.0 - max(nan_mis, val_mis) / ncell
        worst = min(worst, share)
        print(f"{what} parity {name}: NaN-set mismatches {nan_mis}, value "
              f"mismatches {val_mis} of {ncell}")
    if worst < PARITY_MIN_SHARE:
        raise AssertionError(f"{what}: GPU/CPU agreement {worst} < {PARITY_MIN_SHARE}")
    print(f"{what} parity: worst layer agrees on {worst!r} of cells")


def check_map(what, geom, mapper, est, min_cells):
    for name, t in mapper.state.layers.items():
        if tuple(t.shape) != geom.shape or t.dtype != torch.float32:
            raise AssertionError(f"{what} layer {name}: {t.dtype} {tuple(t.shape)}")
    mapped, med = height_error(geom, mapper)
    print(f"{what}: layers f32{list(geom.shape)}, {mapped} mapped cells, "
          f"median |elevation - terrain| {med!r} m")
    if mapped <= min_cells or not med < TERRAIN_TOL[est]:
        raise AssertionError(
            f"{what} map fails the >{min_cells} cells / <{TERRAIN_TOL[est]} m check"
        )


def drive(what, device, geom, cfg, scans, T_bs, poses, per_scan=1):
    """One main-path run on the card with the launch counts set to 0 just
    before it and read just after: (mapper, K1 launches, K4 launches).
    Each kernel must launch ``per_scan`` times per scan."""
    torch.cuda.synchronize()
    k1.launches = 0
    k4.launches = 0
    mapper, oow = run_session(device, geom, cfg, scans, T_bs, poses)
    torch.cuda.synchronize()
    l1, l4 = k1.launches, k4.launches
    n = len(poses) * per_scan
    print(f"{what}: {len(poses)} scans, K1 launches {l1}, K4 launches {l4}")
    if (l1, l4) != (n, n):
        raise AssertionError(f"{what}: K1/K4 launched {l1}/{l4} times, want {n} each")
    if oow[0] is not None:
        total = int(torch.stack(oow).sum())
        print(f"{what}: points outside the update window, all scans: {total}")
        if total:
            raise AssertionError(f"{what}: {total} points fell outside the window")
    return mapper, l1, l4


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


def device_profile(fn, reps, top=0, counts=None, attempts=1):
    """(device ms, device events, device ms by kernel name) per call of
    ``fn``: the CUDA events (kernels, copies, fills) of ``reps`` calls in
    one padded torch.profiler window, up to ``attempts`` windows
    (``profiling.device_profile``). ``top`` > 0 also prints that many ops
    by device time; a ``counts`` dict receives the events per call by
    name."""
    ms, events, by_name, prof = profiling.device_profile(fn, reps, attempts)
    if top:
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=top,
                                        max_name_column_width=50))
    if counts is not None:
        for name, (n, _) in by_name.items():
            counts[name] = counts.get(name, 0.0) + n
    return ms, events, {name: t for name, (_, t) in by_name.items()}


def time_pair(what, fn_kernel, fn_plain, reps=200, plain_reps=50):
    """(kernel, plain) device ms per call, and the kernel's device ms by
    kernel name; prints them with the per-call latency that CUDA events
    around one call see (host enqueue included)."""
    for fn in (fn_kernel, fn_plain):
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    ms, _, by_name = device_profile(fn_kernel, reps, attempts=PROFILE_ATTEMPTS)
    plain_ms = device_profile(fn_plain, plain_reps, attempts=PROFILE_ATTEMPTS)[0]
    lat, plain_lat = cuda_median_ms(fn_kernel, reps), cuda_median_ms(fn_plain, plain_reps)
    print(f"{what}: kernel {ms!r} ms, plain twin {plain_ms!r} ms (device time "
          f"per call, torch.profiler); per-call latency kernel {lat!r} ms, plain "
          f"{plain_lat!r} ms (median, CUDA events, host enqueue included)")
    return ms, plain_ms, by_name


def bound_of(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for ``nbytes`` of traffic and ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(R, A, nfold, win, exact):
    """K1 reads scat and the window tables once and writes the field once;
    per element it takes a suffix min, the affine height (three
    operations), nfold - 1 fold mins and one min per azimuth pass (lvl
    doublings, then one pass for a nonzero exact-window shift)."""
    lvl, shift = win.lvl.cpu().numpy(), win.shift.cpu().numpy()
    passes = int(lvl.sum()) + (int((shift > 0).sum()) if exact else 0)
    nbytes = 2 * R * A * 4 + 2 * R * 4 + 4
    return bound_of(nbytes, R * A * (3 + nfold) + A * passes)


def k4_lookup_bound(cells, reads):
    """The main path's K4 reads the field once or twice per cell (4 bytes
    each) and writes 5 bytes per cell; the position, origin and offsets
    are a few bytes."""
    return bound_of(cells * (4 * reads + 5) + 28, cells * K4_LOOKUP_OPS)


def kernel_split(by_name):
    """(column ms, row ms) of one K1 call's device time by kernel name."""
    col = sum(v for k, v in by_name.items() if "polar_column_kernel" in k)
    row = sum(v for k, v in by_name.items() if "polar_row_kernel" in k)
    return col, row


def phase_k1(card):
    """K1 against its plain twin, bit for bit, at the reference test's
    three shapes, the GLOBAL shape and edge shapes; device times at the
    flagship and GLOBAL shapes, split into the column and row kernels,
    beside the bound."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    so = torch.tensor([0.07, -0.03, 1.2], dtype=torch.float32, device=dev)
    fgeom = flagship_geom()
    timing = {}
    cases = [
        (flagship_geom(), 2048, 0.25, 12.81, True, "flagship"),
        (flagship_geom(), 1024, 0.5, 9.0, True, None),
        (flagship_geom(), 2048, 0.25, 12.81, False, None),
        (global_geom(), 2048, 0.25, GLOBAL_RANGE * 1.1 + 2.0, True, "global"),
    ]
    max_err = 0.0
    shapes = []
    for geom, num_az, rbf, maxr, exact, label in cases:
        A, R, dr = raycast.polar_dims(geom, num_az, rbf, maxr)
        win = raycast.column_windows(geom, num_az, rbf, maxr, dev)
        shapes.append((R, A, rbf, dr, win, exact, label))
    # Edge shapes: folds of 1 and 10 rows, A = 1024, R = 517 (off the
    # segment and strip sizes), and a tall field the column pass walks in
    # chunks of rows.
    for R, A, rbf in ((515, 2048, 1.0), (515, 2048, 0.1), (515, 1024, 0.25),
                      (517, 2048, 0.25), (4096, 1024, 0.25)):
        dr = fgeom.resolution * rbf
        lvl, shift = raycast._column_windows(fgeom, A, R, dr)
        shapes.append((R, A, rbf, dr, k1.ColumnWindows.from_numpy(lvl, shift, dev), True,
                       None))
    for R, A, rbf, dr, win, exact, label in shapes:
        tbl = rng.uniform(-2.0, 0.5, R * A).astype(np.float32)
        tbl[rng.random(R * A) < 0.97] = np.inf
        scat = torch.tensor(tbl, device=dev).reshape(R, A)
        nfold = int(np.ceil(1.0 / rbf))
        got = k1.polar_field_cuda(scat, win, so, dr, nfold, exact)
        ref = k1.polar_field_plain(scat, win, so, dr, nfold, exact)
        torch.cuda.synchronize()
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        same_fin = np.array_equal(np.isfinite(got), np.isfinite(ref))
        fin = np.isfinite(ref)
        err = float(np.max(np.abs(got[fin] - ref[fin]))) if fin.any() else 0.0
        bits = np.array_equal(got.view(np.int32), ref.view(np.int32))
        print(f"K1 [R={R}, A={A}] nfold={nfold} exact_window={exact}: identical finite "
              f"sets {same_fin} ({int(fin.sum())} finite), max |diff| {err!r}, "
              f"bit-identical {bits}")
        if not (same_fin and bits and err == 0.0):
            raise AssertionError(f"K1 differs from its twin at R={R} A={A}")
        max_err = max(max_err, err)
        if label:
            bound, by = k1_bound(R, A, nfold, win, exact)
            ms, plain_ms, by_name = time_pair(
                f"K1 time at [{R}, {A}], L2-warm input",
                lambda: k1.polar_field_cuda(scat, win, so, dr, nfold, exact),
                lambda: k1.polar_field_plain(scat, win, so, dr, nfold, exact),
            )
            col, row = kernel_split(by_name)
            print(f"K1 [{R}, {A}]: column kernel {col!r} ms, row kernel {row!r} ms "
                  f"({row / ms!r} of K1); bound {bound!r} ms ({by}), share of the bound "
                  f"{bound / ms!r}; on {card}")
            timing[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": by}
    return max_err, timing


def phase_k4(card):
    """K4 against its plain twin: the main path's lookup with its index
    math (the flagship's whole map, a GLOBAL window with device offsets),
    one and two reads: bit-identical heights, the same touched and NaN
    sets; device times."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(43)
    max_err = 0.0
    timing = {}
    for label, geom, maxr, pos, so, win in (
        ("flagship", flagship_geom(), 12.81, [0.2, -0.1], [0.31, -0.17, 1.05], None),
        ("global", global_geom(), GLOBAL_RANGE * 1.1 + 2.0, [0.0, 0.0],
         [-10.37, 5.21, 1.0], 484),
    ):
        lk = raycast.polar_lookup(geom, 2048, 0.25, maxr)
        field = rng.uniform(-2.0, 0.5, (lk.R, lk.A)).astype(np.float32)
        field[rng.random(field.shape) < 0.5] = np.inf
        field[rng.random(field.shape) < 0.001] = np.nan
        fld = torch.tensor(field, device=dev)
        pos_t, so_t = torch.tensor(pos, device=dev), torch.tensor(so, device=dev)
        window = None
        if win is not None:
            sr, sc, _ = geom.index_of(pos_t, so_t[:2])
            r0 = torch.clamp(torch.clamp(sr, 0, geom.rows) - win // 2, 0, geom.rows - win)
            c0 = torch.clamp(torch.clamp(sc, 0, geom.cols) - win // 2, 0, geom.cols - win)
            window = (r0, c0, win, win)
        cells = win * win if win else geom.num_cells
        for two in (False, True):
            got = k4.resample_lookup_cuda(fld, lk, pos_t, so_t, window, two)
            ref = k4.resample_lookup_plain(fld, lk, pos_t, so_t, window, two)
            torch.cuda.synchronize()
            max_err = max(max_err, check_same(
                f"K4 with its index math, {label} ({cells} cells"
                f"{', window' if window else ', whole map'}), {1 + two} read(s)", got, ref))
        bound, by = k4_lookup_bound(cells, 1)
        ms, plain_ms, _ = time_pair(
            f"K4 with its index math, time at [{lk.R}, {lk.A}] x {cells} cells, 1 read, "
            "L2-warm field",
            lambda: k4.resample_lookup_cuda(fld, lk, pos_t, so_t, window, False),
            lambda: k4.resample_lookup_plain(fld, lk, pos_t, so_t, window, False),
        )
        print(f"K4 with its index math, {label}: bound {bound!r} ms ({by}), share of the "
              f"bound {bound / ms!r}; on {card}")
        timing[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
    return max_err, timing


def check_same(what, got, ref):
    """Fails unless (ray_min, touched) equal the twin's bit for bit, with
    the same NaN and touched sets; returns max |diff| on finite cells."""
    (h, t), (h_ref, t_ref) = got, ref
    h_np, h_ref_np = h.cpu().numpy(), h_ref.cpu().numpy()
    same_bits = np.array_equal(h_np.view(np.int32), h_ref_np.view(np.int32))
    same_nan = np.array_equal(np.isnan(h_np), np.isnan(h_ref_np))
    same_touched = torch.equal(t, t_ref)
    print(f"{what}: bit-identical {same_bits}, same NaN set {same_nan}, same touched "
          f"{same_touched} ({int(t.sum())} touched)")
    if not (same_bits and same_nan and same_touched and int(t.sum()) > 0):
        raise AssertionError(f"{what}: K4 differs from its plain twin")
    fin = np.isfinite(h_ref_np)
    return float(np.max(np.abs(h_np[fin] - h_ref_np[fin]))) if fin.any() else 0.0


def phase_exact_window(dev="cuda"):
    """exact_window (one read) == two reads, on the card."""
    dev = torch.device(dev)
    geom = flagship_geom()
    scans, _, _ = make_session(1, seed=5)
    xyz = torch.tensor(scans[0], device=dev)
    pos = torch.tensor([0.2, -0.1], device=dev)
    origin = torch.tensor([0.3, -0.2, 1.0], device=dev)
    polar = (2048, 0.25, 12.81)
    key, vals, size = raycast.polar_scatter_spec(
        geom, pos, xyz, torch.ones(xyz.shape[0], dtype=torch.bool, device=dev),
        origin, *polar,
    )
    table = torch.full((size,), float("inf"), device=dev)
    table = table.scatter_reduce_(0, key.long(), vals, "amin")[: size - 1]
    h2, t2 = raycast.polar_resample(geom, pos, origin, table, *polar, exact_window=False)
    h1, t1 = raycast.polar_resample(geom, pos, origin, table, *polar, exact_window=True)
    same = torch.equal(t1, t2) and np.array_equal(h1.cpu().numpy(), h2.cpu().numpy(),
                                                  equal_nan=True)
    print(f"exact_window one read vs two reads on the card: {int(t1.sum())} "
          f"touched cells, bitwise equal {same}")
    if not same or t1.sum() < 10000:
        raise AssertionError("exact_window and two-read resample differ on the card")


def phase_window_equals_full(dev="cuda"):
    """The windowed update equals the full-map update on the card."""
    dev = torch.device(dev)
    geom = fd.GridGeometry.from_length(40.0, 40.0, 0.1)
    scans, T_bs, poses = make_session(5, seed=9, spread=5.8, start=(-4.0, 1.0),
                                      step=(1.3, 0.0))
    for est in ("kalman", "p2"):
        cfg = flagship_config(est)
        cfg.mapping.mode = fd.MappingMode.GLOBAL
        cfg.point_filter.range_max = 6.0
        states = []
        for window_update in (None, False):
            step = fd.build_integrate(geom, cfg, window_update=window_update, device=dev)
            s = fd.create_map_state(geom, cfg, device=dev)
            T_bs_d = torch.tensor(T_bs, device=dev)
            for k in range(len(poses)):
                s, aux = step(s, torch.tensor(scans[k], device=dev),
                              torch.ones(N_POINTS, dtype=torch.bool, device=dev),
                              T_bs_d, torch.tensor(poses[k], device=dev))
            if (aux.oow_points is None) != (window_update is False):
                raise AssertionError("the windowed update did not engage as built")
            states.append(s)
        differ = [k for k in states[0].layers if not np.array_equal(
            states[0].layers[k].cpu().numpy().view(np.int32),
            states[1].layers[k].cpu().numpy().view(np.int32))]
        cells = int((states[0].layers["n_points"] > 0).sum())
        print(f"windowed == full on the card, {est}: {len(states[0].layers)} layers, "
              f"{cells} observed cells, layers differing bitwise: {differ}")
        if differ or cells < 5000:
            raise AssertionError(f"windowed update differs from full-map ({est}): {differ}")


def chain_ms(geom, cfg, seed, session_fn):
    """ms/scan over a CHAIN-scan chain through FastDEM.integrate."""
    scans, T_bs, poses = session_fn(CHAIN + 8, seed)
    clouds = [fd.cloud.from_numpy(scans[k], frame_id="lidar", device="cuda")
              for k in range(CHAIN + 8)]
    timer = fd.FastDEM(geom, cfg, device="cuda")
    for k in range(8):  # warm-up
        timer.integrate(clouds[k], T_bs, poses[k])
    timer.reset()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(8, CHAIN + 8):
        timer.integrate(clouds[k], T_bs, poses[k])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CHAIN


def scan_profile(geom, cfg, seed, session_fn, scans=EVENT_SCANS):
    """(device events, device ms) per scan through FastDEM.integrate, under
    torch.profiler over ``scans`` scans after 8 warm-up scans."""
    scans_np, T_bs, poses = session_fn(scans + 8, seed)
    clouds = [fd.cloud.from_numpy(scans_np[k], frame_id="lidar", device="cuda")
              for k in range(scans + 8)]
    mapper = fd.FastDEM(geom, cfg, device="cuda")
    for k in range(8):
        mapper.integrate(clouds[k], T_bs, poses[k])
    torch.cuda.synchronize()
    it = iter(range(8, scans + 8))

    def one_scan():
        k = next(it)
        mapper.integrate(clouds[k], T_bs, poses[k])

    ms, events, _ = device_profile(one_scan, scans)
    return events, ms


def resample_indices_events():
    """Device events of one resample_indices call (the index math that K4
    now does in its kernel) on the flagship map and on the GLOBAL window."""
    dev = torch.device("cuda")
    out = {}
    for label, geom, maxr, win in (("flagship", flagship_geom(), 12.81, None),
                                   ("global window", global_geom(),
                                    GLOBAL_RANGE * 1.1 + 2.0, 484)):
        pos = torch.zeros(2, device=dev)
        so = torch.tensor([-10.37, 5.21, 1.0], device=dev)
        window = None
        if win is not None:
            r0 = torch.tensor(758, dtype=torch.int32, device=dev)
            window = (r0, r0.clone(), win, win)
        fn = (lambda: raycast.resample_indices(geom, pos, so, 2048, 0.25, maxr,
                                               window=window))
        fn()
        torch.cuda.synchronize()
        out[label] = device_profile(fn, 5, attempts=PROFILE_ATTEMPTS)[1]
    return out


def postprocess_config():
    """The chain as the reference's benchmark runs it: uncertainty fusion,
    inpainting and feature extraction, default parameters."""
    pp = fd.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    return pp


def run_chain(geom, pp, layers):
    """The chain plus the 3x3 median of its elevation."""
    out = apply_postprocess_fn(geom, pp)(*layers)
    out["elevation_smoothed"] = smooth_median(out["elevation"], 3, 5)
    return out


def compare_chain(what, ref, got):
    """Per layer: NaN sets exact, values within the tolerances; prints the
    bitwise-equal share of the finite cells."""
    failed = []
    for name in sorted(ref):
        r, g = ref[name].cpu().numpy(), got[name].cpu().numpy()
        nan_mis = int((np.isnan(r) != np.isnan(g)).sum())
        fin = np.isfinite(r) & np.isfinite(g)
        d = np.abs(r[fin] - g[fin])
        over = d > (PP_SLOPE_ATOL if name == "slope" else PP_ATOL)
        if name == "roughness":
            rr, gg = r[fin][over].astype(np.float64), g[fin][over].astype(np.float64)
            over_n = int((np.abs(rr * rr - gg * gg) > PP_EIGEN_ATOL).sum())
        else:
            over_n = int(over.sum())
        bits = float(np.mean(r[fin].view(np.int32) == g[fin].view(np.int32))) if fin.any() else 1.0
        print(f"{what} {name}: {int(fin.sum())} finite cells, NaN-set mismatches "
              f"{nan_mis}, over tolerance {over_n}, max |diff| {float(d.max(initial=0.0))!r}, "
              f"bitwise equal {bits!r}")
        if nan_mis or over_n:
            failed.append(name)
    if failed:
        raise AssertionError(f"{what}: card and CPU differ on {failed}")


def time_chain(what, geom, pp, layers, card, top=0):
    """Device ms (torch.profiler), wall ms (host clock around a
    synchronised call, median), device events and peak memory per chain;
    ``top`` > 0 prints the ops that take the most device time."""
    fn = apply_postprocess_fn(geom, pp)

    def run():
        return fn(*layers)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    dev_ms, events, _ = device_profile(run, PP_REPS, top, attempts=PROFILE_ATTEMPTS)
    walls = []
    for _ in range(PP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000.0)
    wall = float(np.median(walls))
    print(f"{what}: device {dev_ms!r} ms/chain (torch.profiler), wall {wall!r} ms/chain "
          f"(median of {PP_REPS}, host clock, synchronised), {events!r} device events "
          f"(kernel launches, copies, fills) per chain, peak memory "
          f"{peak / 2**20!r} MiB ({(peak - base) / 2**20!r} MiB above the "
          f"{base / 2**20!r} MiB held before the chain) on {card}")


def mapped_block(elev):
    """Top-left (r0, c0) of a PP_BLOCK square centred on the mapped cells,
    PP_MARGIN cells clear of the map edge."""
    rows, cols = torch.nonzero(torch.isfinite(elev), as_tuple=True)
    H, W = elev.shape
    out = []
    for idx, n in ((rows, H), (cols, W)):
        centre = int(idx.float().median().item())
        out.append(min(max(centre - PP_BLOCK // 2, PP_MARGIN), n - PP_BLOCK - PP_MARGIN))
    return out


def phase_postprocess(card, flagship_state, global_state):
    """The chain on the card against the CPU on the same layers, with its
    cost per chain at 150x150 and at 2000x2000."""
    pp = postprocess_config()
    names = ("elevation", "upper_bound", "lower_bound")

    geom = flagship_geom()
    layers = [flagship_state.layers[k] for k in names]
    torch.cuda.synchronize()
    k1.launches = k4.launches = 0
    gpu_out = run_chain(geom, pp, layers)
    torch.cuda.synchronize()
    print(f"postprocess 150x150: K1 launches {k1.launches}, K4 launches {k4.launches} "
          "(the chain is plain PyTorch)")
    cpu_out = run_chain(geom, pp, [t.cpu() for t in layers])
    compare_chain("postprocess 150x150", cpu_out, gpu_out)
    if int(torch.isfinite(gpu_out["slope"]).sum()) < 15000:
        raise AssertionError("postprocess 150x150: too few feature cells")
    time_chain("postprocess 150x150", geom, pp, layers, card)

    ggeom = global_geom()
    layers = [global_state.layers[k] for k in names]
    gpu_out = run_chain(ggeom, pp, layers)
    r0, c0 = mapped_block(layers[0])
    m, b = PP_MARGIN, PP_BLOCK
    crop = [t[r0 - m:r0 + b + m, c0 - m:c0 + b + m].cpu() for t in layers]
    cgeom = fd.GridGeometry(b + 2 * m, b + 2 * m, ggeom.resolution)
    cpu_out = {k: v[m:-m, m:-m] for k, v in run_chain(cgeom, pp, crop).items()}
    gpu_block = {k: v[r0:r0 + b, c0:c0 + b] for k, v in gpu_out.items()}
    mapped = int(torch.isfinite(gpu_block["elevation"]).sum())
    print(f"postprocess 2000x2000: compared the {b}x{b} block at ({r0}, {c0}), "
          f"{mapped} mapped cells; the CPU ran a {b + 2 * m}x{b + 2 * m} crop")
    if mapped < 50000:
        raise AssertionError("postprocess 2000x2000: the block holds too few mapped cells")
    compare_chain("postprocess 2000x2000 block", cpu_out, gpu_block)
    for k, v in gpu_out.items():
        if tuple(v.shape) != ggeom.shape:
            raise AssertionError(f"postprocess 2000x2000 {k}: shape {tuple(v.shape)}")
    time_chain("postprocess 2000x2000", ggeom, pp, layers, card, top=12)


def lidar_scene(rng, n):
    """The reference's raycast parity scene (tests/test_kernels_parity.py):
    ground points out to 8 m around the origin, 10% masked."""
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.3, 8.0, n)
    x, y = rad * np.cos(ang), rad * np.sin(ang)
    z = 0.3 * np.sin(x) * np.cos(y) + rng.normal(0, 0.03, n) - 1.0
    mask = rng.uniform(size=n) > 0.1
    return np.column_stack([x, y, z]).astype(np.float32), mask


def phase_sampled(card, dev="cuda"):
    """K1 + K4 (the polar path) against the sampled oracle on the card, then
    a sampled-method session, card against CPU."""
    dev = torch.device(dev)
    geom = fd.GridGeometry.from_length(12.0, 12.0, 0.1)
    rng = np.random.default_rng(42)
    xyz, mask = lidar_scene(rng, 4000)
    xyz, mask = torch.tensor(xyz, device=dev), torch.tensor(mask, device=dev)
    pos = torch.zeros(2, device=dev)
    l1, l4 = k1.launches, k4.launches
    origin = torch.tensor([0.3, -0.2, 0.8], device=dev)
    h_p, t_p = raycast.ray_min_height_polar(geom, pos, xyz, mask, origin)
    h_s, t_s = raycast.ray_min_height_sampled(geom, pos, xyz, mask, origin, num_samples=1200)
    both = t_p & t_s
    diff = (h_p[both] - h_s[both]).cpu().numpy()
    p90 = float(np.percentile(np.abs(diff), 90))
    high = float((diff > 0.15).mean())
    origin = torch.tensor([0.0, 0.0, 0.8], device=dev)
    _, t_p0 = raycast.ray_min_height_polar(geom, pos, xyz, mask, origin)
    _, t_s0 = raycast.ray_min_height_sampled(geom, pos, xyz, mask, origin, num_samples=1200)
    covered = float(t_p0[t_s0].float().mean())
    torch.cuda.synchronize()
    print(f"sampled oracle vs polar (K1 + K4 on the card, {k1.launches - l1} / "
          f"{k4.launches - l4} launches): {int(both.sum())} cells both touch, p90 "
          f"|polar - sampled| {p90!r} m (< 0.1), share > 0.15 m above {high!r} (< 0.04), "
          f"polar covers {covered!r} of the sampled cells (> 0.97)")
    if (k1.launches - l1, k4.launches - l4) != (2, 2):
        raise AssertionError("the polar path did not run K1 and K4")
    if int(both.sum()) <= 1000 or not (p90 < 0.1 and high < 0.04 and covered > 0.97):
        raise AssertionError("the polar path fails the sampled-oracle properties")

    geom = flagship_geom()
    cfg = flagship_config()
    cfg.raycasting.method = "sampled"
    scans, T_bs, poses = make_session(5, seed=23)
    gpu, _, _ = drive("sampled flagship", dev, geom, cfg, scans, T_bs, poses,
                      per_scan=0)
    check_map("sampled flagship", geom, gpu, "kalman", 17000)
    cpu, _ = run_session("cpu", geom, cfg, scans, T_bs, poses)
    check_parity("sampled flagship", cpu.state, gpu.state)


def node_stream(n_scans):
    """The node tool's synthetic scans as host clouds, a TransformBuffer
    holding their poses and the tool's calibration (sensor 1 m above the
    base)."""
    from fastdem_tpu_torch.runtime import StaticCalibration, TransformBuffer
    from fastdem_tpu_torch.tools.common import synthetic_scans

    calib = StaticCalibration("base_link")
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    calib.set_extrinsic("lidar", T_bs)
    odom = TransformBuffer("base_link", "map")
    clouds = []
    for xyz, T_wb, t_ns in synthetic_scans(n_scans):
        odom.add_pose(t_ns, T_wb)
        clouds.append(fd.cloud.from_numpy(xyz, frame_id="lidar", timestamp_ns=t_ns,
                                          device="cpu"))
    return clouds, calib, odom


def node_driver(node_cfg, calib, odom, pp_rate=0.0, viz_rate=0.0, global_rate=0.0, **kw):
    from fastdem_tpu_torch.runtime import MappingDriver

    return MappingDriver(
        fd.GridGeometry.from_length(node_cfg.map.width, node_cfg.map.height,
                                    node_cfg.map.resolution),
        node_cfg.pipeline, postprocess_cfg=node_cfg.postprocess, calibration=calib,
        odometry=odom, postprocess_rate=pp_rate, viz_rate=viz_rate,
        global_rate=global_rate, global_window=(node_cfg.map.width, node_cfg.map.height),
        device="cuda", **kw)


def feed_node(d, clouds):
    """Every scan through on_scan, then the queue drained; (host seconds
    from the first scan to the last integrated one, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in clouds:
        if not d.on_scan(c):
            raise AssertionError("the node refused a scan")
    if d.async_intake and not d.drain(timeout=300.0):
        raise AssertionError("the node's intake queue did not drain")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if (d.scan_count, d.dropped_scans, d.intake_errors) != (len(clouds), 0, 0):
        raise AssertionError(
            f"node: {d.scan_count} scans integrated, {d.dropped_scans} dropped, "
            f"{d.intake_errors} intake errors, of {len(clouds)}")
    return secs


def wait_ticks(d, topic, n):
    """Block until the driver's ``topic`` sink has been called n times."""
    done = threading.Event()
    count = [0]

    def sink(_payload):
        count[0] += 1
        if count[0] >= n:
            done.set()

    d.sinks[topic] = sink
    return done


def tick_summary(d):
    return ", ".join(f"{name} {len(ms)} ticks, median {float(np.median(ms))!r} host ms"
                     for name, ms in sorted(d.tick_ms.items()) if ms)


def run_tool(args):
    """A port tool as a subprocess from the checkout; its output lines."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    print(f"{args[0]}: exit {proc.returncode}; " + " | ".join(lines[-3:]))
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} failed:\n" + "\n".join(lines[-40:]))
    return lines


def phase_node(card):
    """Phase 13; returns the K1 and K4 launches of its three main-path
    runs."""
    import tempfile

    from fastdem_tpu_torch.io.npz import load_npz, save_npz
    from fastdem_tpu_torch.runtime import NodeConfig
    from fastdem_tpu_torch.runtime.driver import SNAPSHOT_LAYERS

    node_cfg = NodeConfig.from_preset("local_mapping")
    pp_rate = node_cfg.topics.post_process_rate
    clouds, calib, odom = node_stream(NODE_SCANS)
    maps = {}
    l1 = l4 = 0
    for way, kw in (("sync", {}),
                    ("async", dict(async_intake=True, burst_batch=NODE_BURST)),
                    ("async + pp timer", dict(async_intake=True, burst_batch=NODE_BURST,
                                              pp_rate=pp_rate))):
        with node_driver(node_cfg, calib, odom, **kw) as d:
            torch.cuda.synchronize()
            k1.launches = k4.launches = 0
            secs = feed_node(d, clouds)
            n1, n4 = k1.launches, k4.launches
            print(f"node {way}: {d.scan_count} scans in {secs!r} s, K1 launches {n1}, K4 "
                  f"launches {n4}, dropped {d.dropped_scans}; {tick_summary(d)}")
            if (n1, n4) != (NODE_SCANS, NODE_SCANS):
                raise AssertionError(f"node {way}: K1/K4 launched {n1}/{n4} times")
            l1, l4 = l1 + n1, l4 + n4
            maps[way] = {k: v.clone() for k, v in d.mapper.state.layers.items()}
            if way == "sync":
                geom = d.geom
                check_node_postprocess(d, SNAPSHOT_LAYERS)
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "map.npz")
                    if not save_npz(path, geom, d.mapper.state, frame_id="map"):
                        raise AssertionError("save_npz failed")
                    g2, s2, _ = load_npz(path)
                    size = os.path.getsize(path)
                same = (g2.rows, g2.cols) == (geom.rows, geom.cols) and all(
                    torch.equal(s2.layers[k].view(torch.int32), v.view(torch.int32))
                    for k, v in d.mapper.state.layers.items()
                ) and torch.equal(s2.position, d.mapper.state.position)
                print(f"node save_npz -> load_npz: {len(s2.layers)} layers, {size} bytes, "
                      f"bitwise equal {same}")
                if not same or set(s2.layers) != set(d.mapper.state.layers):
                    raise AssertionError("npz round trip is not bitwise")
    differ = [k for k in maps["sync"] for way in ("async", "async + pp timer")
              if not torch.equal(maps[way][k].view(torch.int32),
                                 maps["sync"][k].view(torch.int32))]
    mapped = int(torch.isfinite(maps["sync"]["elevation"]).sum())
    print(f"node: sync, async and async + pp timer maps, layers differing bitwise: "
          f"{differ}; {mapped} mapped cells")
    if differ or mapped < 15000:
        raise AssertionError(f"node maps differ across intakes: {differ}")
    node_rates(card, node_cfg)

    with tempfile.TemporaryDirectory() as tmp:
        run_tool(["fastdem_tpu_torch.tools.fastdem_node", "--preset", "local_mapping",
                  "--synthetic", "16", "--out", tmp])
        missing = [f for f in ("map_final.npz", "elevation.png", "slope.png")
                   if not os.path.getsize(os.path.join(tmp, f))]
        if missing:
            raise AssertionError(f"the node tool wrote no {missing}")
    global_node(card)
    return l1, l4


def check_node_postprocess(d, names):
    """run_postprocess on the card against the CPU chain on the same
    snapshot, at the tolerances of phase 11."""
    snap = d.snapshot()
    got = d.run_postprocess()
    cpu = apply_postprocess_fn(d.geom, d.pp_cfg)(*(snap.layers[k].cpu() for k in names))
    compare_chain("node run_postprocess", cpu, {k: torch.from_numpy(v) for k, v in got.items()})
    if int(np.isfinite(got["slope"]).sum()) < 15000:
        raise AssertionError("node run_postprocess: too few feature cells")


def node_rates(card, node_cfg):
    """scans/s of the node over NODE_RATE_SCANS scans: sync intake and async
    bursts with the post-processing timer off and on, in turns; then with
    the preset's own timers (viz, global, post-processing), the timers'
    host ms per tick while scans come in and, for viz, after they stop."""
    clouds, calib, odom = node_stream(NODE_RATE_SCANS)
    kw = dict(async_intake=True, burst_batch=NODE_BURST, max_queue=NODE_RATE_SCANS)
    pp_rate = node_cfg.topics.post_process_rate
    maps = []
    for label, rate, intake in (("sync, pp timer off", 0.0, {}),
                                ("async, pp timer off", 0.0, kw),
                                ("async, pp timer on", pp_rate, kw),
                                ("async, pp timer on", pp_rate, kw),
                                ("async, pp timer off", 0.0, kw),
                                ("sync, pp timer off", 0.0, {})):
        with node_driver(node_cfg, calib, odom, pp_rate=rate, **intake) as d:
            secs = feed_node(d, clouds)
            print(f"node {label} ({rate!r} Hz): {NODE_RATE_SCANS / secs!r} scans/s "
                  f"({secs * 1e3 / NODE_RATE_SCANS!r} ms/scan, host clock); "
                  f"{tick_summary(d)} on {card}")
            maps.append(d.mapper.state)
    t = node_cfg.topics
    with node_driver(node_cfg, calib, odom, pp_rate=t.post_process_rate,
                     viz_rate=t.publish_rate, global_rate=t.global_publish_rate, **kw) as d:
        ticked = wait_ticks(d, "map", VIZ_TICKS)
        waits, stop = [], threading.Event()

        def probe():
            # How long a reader waits for the driver's lock while scans
            # come in: one scan's integrate at most, with the lock per scan.
            while not stop.wait(LOCK_PROBE_S):
                t0 = time.perf_counter()
                with d._lock:
                    waits.append((time.perf_counter() - t0) * 1e3)

        prober = threading.Thread(target=probe)
        prober.start()
        secs = feed_node(d, clouds)
        stop.set()
        prober.join()
        print(f"node driver lock, waited by a reader every {LOCK_PROBE_S * 1e3!r} ms while "
              f"scans came in: {len(waits)} waits, median {float(np.median(waits))!r} ms, "
              f"p90 {float(np.percentile(waits, 90))!r} ms, max {max(waits)!r} ms on {card}")
        if not ticked.wait(timeout=30.0):
            raise AssertionError("the node's viz timer did not tick")
        print(f"node, the preset's timers (viz {t.publish_rate!r} Hz, global "
              f"{t.global_publish_rate!r} Hz, pp {t.post_process_rate!r} Hz): "
              f"{NODE_RATE_SCANS / secs!r} scans/s; while scans came in: "
              f"{tick_summary(d)} on {card}")
        busy = len(d.tick_ms["viz"])
        if not wait_ticks(d, "map", VIZ_TICKS).wait(timeout=30.0):
            raise AssertionError("the node's viz timer stopped")
        idle = list(d.tick_ms["viz"])[busy:]
        print(f"node viz tick with no scan coming in: {len(idle)} ticks, median "
              f"{float(np.median(idle))!r} host ms on {card}")
        maps.append(d.mapper.state)
    # The timers read the map while bursts integrate; no run's map may differ.
    differ = sorted({k for m in maps[1:] for k, v in m.layers.items()
                     if not torch.equal(v.view(torch.int32),
                                        maps[0].layers[k].view(torch.int32))})
    print(f"node, {NODE_RATE_SCANS} scans: the {len(maps)} runs above, layers differing "
          f"bitwise from the first: {differ}")
    if differ:
        raise AssertionError(f"node maps differ with the timers on: {differ}")


def global_node(card):
    """The GLOBAL node preset (200 m at 0.1 m, raycast off) for a few scans,
    its timers on; the viz tick's host ms on the 2000x2000 map."""
    from fastdem_tpu_torch.runtime import NodeConfig

    node_cfg = NodeConfig.from_preset("global_mapping_node")
    t = node_cfg.topics
    clouds, calib, odom = node_stream(GLOBAL_NODE_SCANS)
    with node_driver(node_cfg, calib, odom, pp_rate=t.post_process_rate,
                     viz_rate=t.publish_rate, global_rate=t.global_publish_rate,
                     async_intake=True, burst_batch=NODE_BURST) as d:
        ticked = wait_ticks(d, "map", VIZ_TICKS)
        secs = feed_node(d, clouds)
        if not ticked.wait(timeout=60.0):
            raise AssertionError("the GLOBAL node's viz timer did not tick")
        shape = tuple(d.mapper.state.layers["elevation"].shape)
        mapped = int(torch.isfinite(d.mapper.state.layers["elevation"]).sum())
        published = sum(1 for k in d.mapper.state.layers if not k.startswith("_"))
        print(f"global node: {d.scan_count} scans in {secs!r} s, map {shape}, {mapped} "
              f"mapped cells, {published} published layers of "
              f"{shape[0] * shape[1] * 4 / 2**20!r} MiB; {tick_summary(d)} on {card}")
    if mapped < 10000:
        raise AssertionError("the GLOBAL node mapped too few cells")


def phase_replay(card):
    """Phase 14; returns the K1 and K4 launches of the sequence run."""
    geom = flagship_geom()
    scans, T_bs, poses = make_session(REPLAY_SCANS, seed=29)
    clouds = [fd.cloud.from_numpy(scans[k], frame_id="lidar", device="cuda")
              for k in range(REPLAY_SCANS)]
    poses = np.stack(poses)

    # Each runner keeps its step (and its CUDA graphs) across the turns and
    # starts every turn from a fresh map: the turns time the steady state.
    mappers = {way: fd.FastDEM(geom, flagship_config(), device="cuda")
               for way in ("loop", "sequence")}

    def fresh(way):
        m = mappers[way]
        m.state = fd.create_map_state(geom, flagship_config(), device="cuda")
        return m

    def loop():
        m = fresh("loop")
        for k in range(REPLAY_SCANS):
            m.integrate(clouds[k], T_bs, poses[k])
        return SimpleNamespace(state=m.state)

    def sequence():
        m = fresh("sequence")
        if m.integrate_sequence(clouds, T_bs, poses, batch=REPLAY_BATCH) != REPLAY_SCANS:
            raise AssertionError("integrate_sequence dropped scans")
        return SimpleNamespace(state=m.state)

    xyz = torch.as_tensor(np.asarray(scans, np.float32), device="cuda")
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device="cuda")
    tbs_d = torch.as_tensor(T_bs, device="cuda")
    twb_d = torch.as_tensor(poses, device="cuda")
    seq = build_integrate_sequence(geom, flagship_config(), device="cuda")

    def stacked():
        state = fd.create_map_state(geom, flagship_config(), device="cuda")
        for lo in range(0, REPLAY_SCANS, REPLAY_BATCH):
            hi = lo + REPLAY_BATCH
            state = seq(state, xyz[lo:hi], mask[lo:hi], tbs_d, twb_d[lo:hi])
        # The donated state is the graph's slots, which the next turn reuses.
        return SimpleNamespace(state=fd.GridMapState(
            layers={k: v.clone() for k, v in state.layers.items()},
            position=state.position.clone()))

    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        m = fn()
        end.record()
        end.synchronize()
        return m, start.elapsed_time(end) / REPLAY_SCANS, (time.perf_counter() - t0) * 1e3 / REPLAY_SCANS

    for warm in (loop, sequence, stacked):
        warm()
    results = {}
    launches = None
    for label, fn in (("loop", loop), ("sequence", sequence), ("stacked", stacked),
                      ("stacked", stacked), ("sequence", sequence), ("loop", loop),
                      ("loop", loop), ("sequence", sequence), ("stacked", stacked)):
        k1.launches = k4.launches = 0
        m, ms, wall = timed(fn)
        torch.cuda.synchronize()
        if label == "sequence" and launches is None:
            launches = (k1.launches, k4.launches)
        if (k1.launches, k4.launches) != (REPLAY_SCANS, REPLAY_SCANS):
            raise AssertionError(f"replay {label}: K1/K4 launched {k1.launches}/"
                                 f"{k4.launches} times, want {REPLAY_SCANS} each")
        results.setdefault(label, (m, []))[1].append((ms, wall))
        print(f"replay {label}: {ms!r} ms/scan (CUDA events), {wall!r} ms/scan (host clock), "
              f"{REPLAY_SCANS} scans, K1/K4 launches {k1.launches}/{k4.launches} on {card}")
    loop_state = results["loop"][0].state
    differ = [(label, k) for label in ("sequence", "stacked")
              for k, v in loop_state.layers.items()
              if not torch.equal(results[label][0].state.layers[k].view(torch.int32),
                                 v.view(torch.int32))]
    med = {k: float(np.median([ms for ms, _ in v[1]])) for k, v in results.items()}
    print(f"replay: FastDEM.integrate_sequence (batch {REPLAY_BATCH}) and "
          f"build_integrate_sequence ({REPLAY_BATCH} stacked scans a call) vs the integrate "
          f"loop, layers differing bitwise: {differ}; median ms/scan (CUDA events) sequence "
          f"{med['sequence']!r}, stacked {med['stacked']!r}, loop {med['loop']!r} on {card}")
    if differ:
        raise AssertionError(f"batched replay differs from the loop on {differ}")
    check_map("replay", geom, results["sequence"][0], "kalman", 17000)
    # Transforms as a list of CUDA tensors, one per cloud.
    m = fd.FastDEM(geom, flagship_config(), device="cuda")
    n = m.integrate_sequence(clouds, torch.as_tensor(T_bs, device="cuda"),
                             [torch.as_tensor(T, device="cuda") for T in poses])
    differ = [k for k, v in loop_state.layers.items()
              if not torch.equal(m.state.layers[k].view(torch.int32), v.view(torch.int32))]
    print(f"replay: integrate_sequence with the poses as a list of {n} CUDA tensors, "
          f"layers differing bitwise from the loop: {differ}")
    if n != REPLAY_SCANS or differ:
        raise AssertionError(f"integrate_sequence with CUDA tensor poses: {n} scans, {differ}")
    run_tool(["fastdem_tpu_torch.tools.fastdem_replay", "--preset", "local_mapping",
              "--synthetic", str(REPLAY_SCANS), "--batch", str(REPLAY_BATCH)])
    return launches


def median_ms(fn, reps=DEM_REPS):
    """Median host ms of fn() over ``reps`` runs after one warm-up, each run
    synchronised with the card (the stages read counts and bounds back)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(runs)), runs


def dem_stages(cloud, cfg):
    """build_dem's stages one by one: (SOR cloud, geometry, position,
    floating-point-filtered cloud, stats, inpainted elevation)."""
    from fastdem_tpu_torch.cloud import filters
    from fastdem_tpu_torch.mapping import batch
    from fastdem_tpu_torch.mapping.rasterize import rasterize_stats
    from fastdem_tpu_torch.postprocess.inpainting import inpaint
    from fastdem_tpu_torch.utils.colors import pack_rgb

    sor = filters.statistical_outlier_removal(cloud, cfg.sor_k, cfg.sor_std_mul)
    geom, position = batch.bbox_geometry(sor.xyz, sor.mask, cfg.resolution)
    flt = batch.remove_floating_points(sor, geom, position, cfg.height_threshold,
                                       cfg.resolution)
    pos = torch.as_tensor(position, device=cloud.device)
    stats = rasterize_stats(geom, pos, flt.xyz, flt.mask, flt.channels["intensity"],
                            pack_rgb(flt.channels["color"]))
    elev = inpaint(stats.max_z, cfg.inpaint_iterations, min_valid_neighbors=2)
    return sor, geom, position, flt, stats, elev


def phase_batch_dem(card):
    """Phase 15: the batch DEM at 500K points on the card, its stage times,
    and the card against the CPU on a 100K crop."""
    import tempfile

    from fastdem_tpu_torch.cloud import filters, search, transform
    from fastdem_tpu_torch.io import pcd as pcd_io
    from fastdem_tpu_torch.mapping import batch
    from fastdem_tpu_torch.mapping.rasterize import rasterize_stats
    from fastdem_tpu_torch.postprocess.inpainting import inpaint
    from fastdem_tpu_torch.tools.common import site_terrain, synthetic_site
    from fastdem_tpu_torch.utils.colors import pack_rgb

    xyz, inten, col = synthetic_site(DEM_POINTS, DEM_SITE_M, seed=5)
    cloud = fd.cloud.from_numpy(xyz, intensity=inten, color=col, device="cuda")
    cfg = batch.DEMConfig()
    sor, geom, position, flt, stats, _ = dem_stages(cloud, cfg)
    pos = torch.as_tensor(position, device="cuda")
    T = transform.from_rpy(0.1, -0.05, 0.7, t=(3.0, -2.0, 0.5), device="cuda")
    knn_out = {}

    def knn_grid():
        knn_out["r"] = search.knn(cloud.xyz, cloud.mask, cfg.sor_k, method="grid")

    stages = [
        ("knn (grid, k 20)", knn_grid),
        ("statistical_outlier_removal", lambda: filters.statistical_outlier_removal(
            cloud, cfg.sor_k, cfg.sor_std_mul).mask.sum()),
        ("remove_floating_points", lambda: batch.remove_floating_points(
            sor, geom, position, cfg.height_threshold, cfg.resolution).mask.sum()),
        ("rasterize_stats", lambda: rasterize_stats(
            geom, pos, flt.xyz, flt.mask, flt.channels["intensity"],
            pack_rgb(flt.channels["color"]))),
        ("inpaint (3 passes)", lambda: inpaint(stats.max_z, cfg.inpaint_iterations,
                                               min_valid_neighbors=2)),
        ("voxel_grid (0.1 m, centroid)", lambda: filters.voxel_grid(
            cloud, 0.1, filters.VoxelMode.CENTROID).mask.sum()),
        ("transform_cloud", lambda: transform.transform_cloud(cloud, T)),
    ]
    times = {}
    for name, fn in stages:
        times[name] = median_ms(fn)
        if name.startswith("knn"):
            grid = search.last_grid_stats
            first = grid["passes"][0]
            print(f"batch DEM: knn grid certificate hit rate {first['certified'] / first['rows']!r} "
                  f"in the first pass (bucket {first['bucket']!r} m, cap {first['cap']}); "
                  f"passes {grid['passes']}; {grid['fallback']} of {grid['queries']} "
                  f"queries took the brute tile")
    # Where the kNN's time goes: its first grid pass over every query, and
    # the brute tile on as many queries as took it (its cost does not
    # depend on which).
    grid = search.last_grid_stats
    b0, cap0 = grid["passes"][0]["bucket"], grid["passes"][0]["cap"]

    def first_pass():
        g = search.DenseGrid(cloud.xyz, cloud.mask, b0, max_cells=search._GRID_MAX_CELLS)
        g.knn(cloud.xyz, cfg.sor_k, cap=cap0, self_pos=g.inv_order)

    tail = torch.as_tensor(np.random.default_rng(2).choice(DEM_POINTS, max(1, grid["fallback"]),
                                                             replace=False), device="cuda")
    times["knn: first grid pass"] = median_ms(first_pass, 3)
    times[f"knn: brute tile, {int(tail.numel())} queries"] = median_ms(
        lambda: search.knn_brute(cloud.xyz, cloud.mask, cfg.sor_k, queries=cloud.xyz[tail],
                                 self_indices=tail), 3)
    torch.cuda.reset_peak_memory_stats()
    times["build_dem"] = median_ms(lambda: batch.build_dem(cloud, cfg))
    peak = torch.cuda.max_memory_allocated()
    for name, (ms, runs) in times.items():
        print(f"batch DEM {DEM_POINTS} points: {name} median {ms!r} ms over {len(runs)} runs "
              f"{[round(r, 3) for r in runs]} on {card}")
    print(f"batch DEM: peak memory during build_dem {peak} bytes ({peak / 2**30!r} GiB)")
    dgeom, state = batch.build_dem(cloud, cfg)
    elev = state.layers["elevation"]
    x, y = dgeom.cell_centers(state.position)
    truth = site_terrain(x.cpu().numpy().astype(np.float64), y.cpu().numpy().astype(np.float64))
    e = elev.cpu().numpy()
    mapped = np.isfinite(e)
    med = float(np.median(np.abs(e[mapped] - truth[mapped])))
    print(f"batch DEM: {dgeom.rows}x{dgeom.cols} cells, {mapped.mean()!r} mapped, "
          f"median |elevation - terrain| {med!r} m; SOR kept {int(sor.mask.sum())}, "
          f"floating-point removal kept {int(flt.mask.sum())} of {DEM_POINTS}")
    if not (mapped.mean() > 0.99 and med < 0.05 and dgeom.rows >= 990):
        raise AssertionError("batch DEM fails the coverage / terrain check")

    # Grid kNN against the brute tile on sampled queries, on the card.
    rng = np.random.default_rng(1)
    sel = torch.as_tensor(rng.choice(DEM_POINTS, DEM_KNN_SAMPLE, replace=False), device="cuda")
    gi, gd = knn_out["r"]
    bi, bd = search.knn_brute(cloud.xyz, cloud.mask, cfg.sor_k, queries=cloud.xyz[sel],
                              self_indices=sel)
    same_d = torch.equal(gd[sel].view(torch.int32), bd.view(torch.int32))
    same_i = int((gi[sel] != bi).any(dim=1).sum())
    print(f"batch DEM: grid kNN vs knn_brute on {DEM_KNN_SAMPLE} queries: distances "
          f"bitwise equal {same_d}, rows with another index {same_i}")
    if not same_d:
        raise AssertionError("grid kNN distances differ from the brute tile")

    # The card against the CPU on a crop.
    half = DEM_SITE_M / 2 * np.sqrt(DEM_CROP_POINTS / DEM_POINTS)
    keep = (np.abs(xyz[:, 0]) <= half) & (np.abs(xyz[:, 1]) <= half)
    crop = {dev: fd.cloud.from_numpy(xyz[keep], intensity=inten[keep], color=col[keep],
                                     device=dev) for dev in ("cpu", "cuda")}
    t0 = time.perf_counter()
    ref = dem_stages(crop["cpu"], cfg)
    cpu_s = time.perf_counter() - t0
    got = dem_stages(crop["cuda"], cfg)
    _, got_state = batch.build_dem(crop["cuda"], cfg)
    bad = []
    for what, a, b in (("SOR mask", ref[0].mask, got[0].mask),
                       ("floating-point mask", ref[3].mask, got[3].mask)):
        if not torch.equal(a, b.cpu()):
            bad.append(what)
    for name in ("count", "min_z", "max_z", "touched"):
        a, b = getattr(ref[4], name), getattr(got[4], name).cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            bad.append(name)
    for name in ("mean", "variance"):
        a, b = getattr(ref[4], name).numpy(), getattr(got[4], name).cpu().numpy()
        if not np.allclose(b, a, rtol=DEM_STATS_RTOL, atol=1e-9, equal_nan=True):
            bad.append(name)
    e_ref = ref[5].numpy()
    for what, e_got in (("inpainted elevation", got[5]),
                        ("build_dem elevation", got_state.layers["elevation"])):
        e_got = e_got.cpu().numpy()
        if not (np.array_equal(np.isnan(e_ref), np.isnan(e_got))
                and np.nanmax(np.abs(e_ref - e_got)) <= DEM_ELEV_ATOL):
            bad.append(what)
    print(f"batch DEM crop ({int(keep.sum())} points, {ref[1].rows}x{ref[1].cols} cells): "
          f"card vs CPU (CPU {cpu_s!r} s), failing: {bad}; SOR kept {int(got[0].mask.sum())}, "
          f"floating-point removal kept {int(got[3].mask.sum())}")
    if bad:
        raise AssertionError(f"batch DEM card vs CPU: {bad}")

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "site.pcd"), os.path.join(tmp, "dem.pcd")
        if not pcd_io.save_pcd(src, crop["cpu"]):
            raise AssertionError("save_pcd failed")
        lines = run_tool(["fastdem_tpu_torch.tools.pcd2dem", src, dst, "0.1"])
        back = pcd_io.load_pcd(dst, device="cpu")
        print(f"pcd2dem tool: {back.capacity} DEM points; {lines[-1]}")
        if back.capacity < 0.9 * ref[1].num_cells:
            raise AssertionError("the pcd2dem tool wrote too few points")
    return times


def depth_image(cam_pos, R_wc, fx, fy, cx, cy, boxes):
    """u16 depth (mm) of the ground plane z = 0 and boxes (lo, hi corners),
    seen from a camera at ``cam_pos`` with rotation R_wc (optical frame ->
    world); 0 where a ray meets nothing within 10 m."""
    H, W = RGBD_SHAPE
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1) @ R_wc.T
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d[..., 2] < -1e-9, -cam_pos[2] / d[..., 2], np.inf)
        for lo, hi in boxes:
            t1 = (np.asarray(lo) - cam_pos) / d
            t2 = (np.asarray(hi) - cam_pos) / d
            tmin = np.minimum(t1, t2).max(-1)
            tmax = np.maximum(t1, t2).min(-1)
            hit = (tmax >= tmin) & (tmin > 0)
            t = np.where(hit, np.minimum(t, tmin), t)
    t = np.where(t < 10.0, t, 0.0)  # depth along the optical axis: d_c z = 1
    return np.round(t * 1000.0).astype(np.uint16)


def phase_rgbd(card):
    """Phase 16: depth frames through depth_to_cloud and the RGB-D sensor
    model into the flagship map, card against CPU; ms per frame."""
    from fastdem_tpu_torch.cloud import depth as dep
    from fastdem_tpu_torch.cloud import transform

    fx = fy = 525.0
    cx, cy = 319.5, 239.5
    pitch = np.deg2rad(35.0)
    R_level = dep.camera_to_base_transform()[:3, :3]
    R_pitch = transform.from_rpy(0.0, pitch, 0.0, device="cpu").numpy()[:3, :3]
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[:3, :3] = R_pitch @ R_level
    T_bs[:3, 3] = (0.2, 0.0, 1.0)
    boxes = [((2.0, -0.8, 0.0), (2.6, -0.2, 0.4)), ((3.0, 0.3, 0.0), (3.5, 1.0, 0.7)),
             ((4.2, -1.5, 0.0), (5.0, -0.6, 0.25)), ((5.5, 0.5, 0.0), (6.0, 1.6, 1.0))]
    frames, poses = [], []
    for k in range(RGBD_FRAMES):
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.25 * k
        T_wc = T_wb.astype(np.float64) @ T_bs.astype(np.float64)
        frames.append(depth_image(T_wc[:3, 3], T_wc[:3, :3], fx, fy, cx, cy, boxes))
        poses.append(T_wb)
    npix = frames[0].size

    def config():
        cfg = flagship_config()
        cfg.sensor_model.type = fd.SensorType.RGBD
        return cfg

    def run(device):
        m = fd.FastDEM(flagship_geom(), config(), device=device)
        clouds = []
        for k in range(RGBD_FRAMES):
            c = dep.depth_to_cloud(torch.as_tensor(frames[k].astype(np.int32), device=device),
                                   fx, fy, cx, cy, depth_scale=1e-3)
            if c.capacity != npix:
                raise AssertionError(f"depth_to_cloud made {c.capacity} points")
            clouds.append(c.valid_count)
            if not m.integrate(c, T_bs, poses[k]):
                raise AssertionError(f"rgbd frame {k} refused")
        return m, clouds

    run("cuda")  # warm-up
    torch.cuda.synchronize()
    k1.launches = k4.launches = 0
    t0 = time.perf_counter()
    gpu, valid = run("cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / RGBD_FRAMES
    l1, l4 = k1.launches, k4.launches
    cpu, _ = run("cpu")
    elev = gpu.state.layers["elevation"].cpu().numpy()
    mapped = int(np.isfinite(elev).sum())
    print(f"rgbd: {RGBD_FRAMES} frames of {npix} pixels ({min(valid)}-{max(valid)} valid "
          f"points), {ms!r} ms per frame (depth_to_cloud + integrate, host clock) on {card}; "
          f"{mapped} mapped cells, elevation {float(np.nanmin(elev))!r}.."
          f"{float(np.nanmax(elev))!r} m; K1/K4 launches {l1}/{l4}")
    if mapped < 1000 or abs(float(np.nanmedian(elev))) > 0.05 or not (
            0.2 < float(np.nanmax(elev)) <= 1.01):
        raise AssertionError("rgbd map fails the coverage / ground / box-height check")
    check_parity("rgbd", cpu.state, gpu.state)
    return l1, l4


def phase_sampled_global(card):
    """Phase 17: the sampled raycast on the 200 m GLOBAL map (window off,
    so rows mode over 4M cells), card against CPU."""
    cfg = global_config()
    cfg.raycasting.method = "sampled"
    geom = global_geom()
    scans, T_bs, poses = global_session_scans(SAMPLED_GLOBAL_SCANS, seed=23)
    scans = scans[:, :SAMPLED_GLOBAL_POINTS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu, oow = run_session("cuda", geom, cfg, scans, T_bs, poses)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SAMPLED_GLOBAL_SCANS
    if any(o is not None for o in oow):
        raise AssertionError("the sampled raycast ran windowed")
    check_map("sampled global", geom, gpu, "kalman", 20000)
    cpu, _ = run_session("cpu", geom, cfg, scans, T_bs, poses)
    check_parity("sampled global", cpu.state, gpu.state)
    print(f"sampled global: {SAMPLED_GLOBAL_SCANS} scans of {SAMPLED_GLOBAL_POINTS} points "
          f"on {geom.rows}x{geom.cols} cells (rows mode, no window), {ms!r} ms/scan "
          f"(host clock, first scans) on {card}")


def peak_mib(fn):
    """fn()'s result and the card's peak allocated MiB while it ran."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**20


def cloud_bench(what, fn, card, reps=CLOUD_REPS):
    ms, runs = median_ms(fn, reps)
    _, peak = peak_mib(fn)
    print(f"{what}: {ms!r} ms median of {reps} (runs {[round(r, 3) for r in runs]}), "
          f"peak {peak!r} MiB on {card}")
    return ms


def phase_cloud(card, dev="cuda"):
    """Phase 18: normals, segmentation and registration at nanoPCL's scale,
    and the card against the CPU on 10K points."""
    from fastdem_tpu_torch.cloud import normals, registration, segmentation
    from fastdem_tpu_torch.tools.common import make_cloud_np, registration_pair, synthetic_site

    rng = np.random.default_rng(31)
    xyz = make_cloud_np(CLOUD_POINTS, rng, spread=20.0)
    cloud = fd.cloud.from_numpy(xyz, device=dev)
    out = {}
    out["normals"] = cloud_bench(
        f"estimate_normals ({CLOUD_POINTS} points, k {CLOUD_K}, grid; nanoPCL ~50 ms)",
        lambda: normals.estimate_normals(cloud, k=CLOUD_K, method="grid"), card)
    out["covariances"] = cloud_bench(
        f"estimate_covariances ({CLOUD_POINTS} points, k {CLOUD_K}, grid)",
        lambda: normals.estimate_covariances(cloud, k=CLOUD_K, method="grid"), card)
    nrm = normals.estimate_normals(cloud, k=CLOUD_K, method="grid").channels["normal"]
    up = float((nrm[:, 2].abs() > 0.9).float().mean())
    if up < 0.9:
        raise AssertionError(f"normals of the rolling surface: only {up} near vertical")
    plane = segmentation.segment_plane(cloud, 0.05, max_iterations=PLANE_HYPOTHESES)
    out["segment_plane"] = cloud_bench(
        f"segment_plane ({CLOUD_POINTS} points x {PLANE_HYPOTHESES} hypotheses; fitness "
        f"{plane.fitness!r})",
        lambda: segmentation.segment_plane(cloud, 0.05, max_iterations=PLANE_HYPOTHESES), card)
    labels = segmentation.euclidean_cluster(cloud, tolerance=0.5)
    out["euclidean_cluster"] = cloud_bench(
        f"euclidean_cluster ({CLOUD_POINTS} points, tolerance 0.5; "
        f"{int(labels.max()) + 1} clusters)",
        lambda: segmentation.euclidean_cluster(cloud, tolerance=0.5), card)
    sxyz, _, _ = synthetic_site(DEM_POINTS, DEM_SITE_M, seed=5)
    site = fd.cloud.from_numpy(sxyz, device=dev)
    ground = segmentation.segment_ground(site)
    out["segment_ground"] = cloud_bench(
        f"segment_ground (synthetic site, {DEM_POINTS} points; ground share "
        f"{float(ground.float().mean())!r})",
        lambda: segmentation.segment_ground(site), card)

    cases = [("icp", ICP_POINTS, {}), ("gicp", ICP_POINTS, {})] + [
        ("vgicp", n, dict(voxel_size=1.0, knn_method="grid")) for n in VGICP_POINTS]
    for method, n, extra in cases:
        src, tgt, T_true = registration_pair(n, seed=n)
        s_c, t_c = fd.cloud.from_numpy(src, device=dev), fd.cloud.from_numpy(tgt, device=dev)
        kw = dict(method=method, optimizer="lm", **extra)
        res = registration.align(s_c, t_c, **kw)
        err_t = float(np.linalg.norm(res.T[:3, 3] - T_true[:3, 3]))
        bar = {"icp": 3.0, "gicp": None, "vgicp": {50_000: 16.0, 100_000: 54.0}.get(n)}[method]
        ms = cloud_bench(
            f"align {method} {n} points (LM): {res.iterations} iterations, converged "
            f"{res.converged}, translation error {err_t!r} m, {res.num_correspondences} "
            f"correspondences (nanoPCL: {bar} ms)",
            lambda: registration.align(s_c, t_c, **kw), card)
        out[f"{method}_{n}"] = ms
        if method != "vgicp":
            if not err_t < ALIGN_T_TOL:
                raise AssertionError(f"align {method} {n}: translation error {err_t} m")
            continue
        # The scene (z = 0.1 sin x) has no structure along y, which voxel
        # Gaussians flattened to planes cannot see: VGICP's error is the
        # reference's own (tests/test_torch_registration.py holds the port
        # to JAX on this scene), so it is held to the CPU run instead.
        ref = registration.align(fd.cloud.from_numpy(src, device="cpu"),
                                 fd.cloud.from_numpy(tgt, device="cpu"), **kw)
        err_h = float(np.linalg.norm(ref.T[:3, 3] - T_true[:3, 3]))
        t_diff = float(np.abs(res.T - ref.T).max())
        print(f"align {method} {n}: card vs CPU T max |diff| {t_diff!r}, translation error "
              f"card {err_t!r} / CPU {err_h!r} m (error along y "
              f"{float(res.T[1, 3] - T_true[1, 3])!r} m), iterations {res.iterations} / "
              f"{ref.iterations}")
        if not (t_diff <= 1e-5 and abs(err_t - err_h) <= 1e-5):
            raise AssertionError(f"align {method} {n}: the card disagrees with the CPU")

    # ICP 10K: the 1-NN passes (CUDA events around each) against the rest.
    src, tgt, T_true = registration_pair(ICP_POINTS, seed=ICP_POINTS)
    s_c, t_c = fd.cloud.from_numpy(src, device=dev), fd.cloud.from_numpy(tgt, device=dev)
    spans = []
    orig = registration._nearest

    def timed_nearest(*a):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        r = orig(*a)
        ev[1].record()
        spans.append(ev)
        return r

    registration._nearest = timed_nearest
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # The host driver: a replayed graph (the fused driver) makes no
        # Python call per pass to time.
        res = registration.align(s_c, t_c, method="icp", optimizer="lm", driver="host")
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        registration._nearest = orig
    corr = sum(a.elapsed_time(b) for a, b in spans)
    print(f"align icp {ICP_POINTS} (LM): {len(spans)} 1-NN passes over {res.iterations} "
          f"iterations; correspondence {corr!r} ms ({corr / max(res.iterations, 1)!r} ms per "
          f"iteration, {corr / max(len(spans), 1)!r} ms per pass), the rest (Jacobians, "
          f"solves, host reads) {total - corr!r} ms of {total!r} ms on {card}")
    out["icp_corr_ms_per_iter"] = corr / max(res.iterations, 1)

    # The card against the CPU on 10K points.
    crop = fd.cloud.from_numpy(xyz[:CLOUD_CROP], device=dev)
    crop_cpu = fd.cloud.from_numpy(xyz[:CLOUD_CROP], device="cpu")
    n_d = normals.estimate_normals(crop, k=CLOUD_K, method="grid").channels["normal"].cpu()
    n_h = normals.estimate_normals(crop_cpu, k=CLOUD_K, method="grid").channels["normal"]
    site_d = fd.cloud.from_numpy(sxyz[:CLOUD_CROP], device=dev)
    site_h = fd.cloud.from_numpy(sxyz[:CLOUD_CROP], device="cpu")
    g_d = segmentation.segment_ground(site_d).cpu()
    g_h = segmentation.segment_ground(site_h)
    # ICP's first CROP_ICP_ITERATIONS Gauss-Newton steps: a full solve on
    # this scene takes ~47 steps, ~30 s of the host's CPU.
    src, tgt, T_true = registration_pair(CLOUD_CROP, seed=3)
    kw = dict(method="icp", optimizer="gn", max_iterations=CROP_ICP_ITERATIONS)
    r_d = registration.align(fd.cloud.from_numpy(src, device=dev),
                             fd.cloud.from_numpy(tgt, device=dev), **kw)
    r_h = registration.align(fd.cloud.from_numpy(src, device="cpu"),
                             fd.cloud.from_numpy(tgt, device="cpu"), **kw)
    n_diff = float((n_d - n_h).abs().max())
    n_bits = float((n_d.view(torch.int32) == n_h.view(torch.int32)).all(1).float().mean())
    t_diff = float(np.abs(r_d.T - r_h.T).max())
    e_d = float(np.linalg.norm(r_d.T[:3, 3] - T_true[:3, 3]))
    e_h = float(np.linalg.norm(r_h.T[:3, 3] - T_true[:3, 3]))
    print(f"cloud library card vs CPU ({CLOUD_CROP} points): normals max |diff| {n_diff!r} "
          f"(bitwise on {n_bits!r}), ground masks equal {bool(torch.equal(g_d, g_h))}, ICP T "
          f"max |diff| {t_diff!r} after {r_d.iterations} / {r_h.iterations} GN steps, "
          f"translation error card {e_d!r} / CPU {e_h!r} m")
    if not (n_diff <= 1e-5 and torch.equal(g_d, g_h) and t_diff <= 1e-5
            and abs(e_d - e_h) <= 1e-5 and r_d.iterations == r_h.iterations):
        raise AssertionError("cloud library: the card disagrees with the CPU")
    return out


def phase_native_io(card, dev="cuda"):
    """Phase 19; returns the K1 and K4 launches of the prefetch replay."""
    import tempfile

    from fastdem_tpu_torch import native
    from fastdem_tpu_torch.io import pcd as pcd_io
    from fastdem_tpu_torch.io.npz import load_npz
    from fastdem_tpu_torch.tools import fastdem_replay

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native scan IO library did not build: {native.build_error}")
    print(f"native scan IO: {native._LIB} ready in {time.perf_counter() - t0!r} s")
    scans, T_bs, poses = make_session(IO_SCANS, seed=37)
    inten = np.random.default_rng(37).uniform(0, 255, scans.shape[:2]).astype(np.float32)
    launches = None
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {fmt: os.path.join(tmp, fmt) for fmt in ("bin", "pcd")}
        for fmt, d in dirs.items():
            os.makedirs(d)
            for k in range(IO_SCANS):
                c = fd.cloud.from_numpy(scans[k], intensity=inten[k], device="cpu")
                save = pcd_io.save_kitti_bin if fmt == "bin" else pcd_io.save_pcd
                if not save(os.path.join(d, f"{k:06d}.{fmt}"), c):
                    raise AssertionError(f"writing {fmt} scan {k} failed")
        for fmt, d in dirs.items():
            files = sorted(os.listdir(d))
            load = pcd_io.load_kitti_bin if fmt == "bin" else pcd_io.load_pcd
            ms, got = {}, {}
            for use_native in (True, False, True, False):
                t0 = time.perf_counter()
                got[use_native] = [load(os.path.join(d, f), use_native=use_native, device="cpu")
                                   for f in files]
                ms.setdefault(use_native, []).append(
                    (time.perf_counter() - t0) * 1e3 / len(files))
            differ = [f for f, a, b in zip(files, got[True], got[False])
                      if not (torch.equal(a.xyz.view(torch.int32), b.xyz.view(torch.int32))
                              and torch.equal(a.mask, b.mask)
                              and set(a.channels) == set(b.channels)
                              and all(torch.equal(a.channels[k], b.channels[k])
                                      for k in a.channels))]
            print(f"{fmt} scans ({IO_SCANS} x {N_POINTS} points): native {ms[True]!r} ms/scan, "
                  f"Python {ms[False]!r} ms/scan; files differing bitwise: {differ}")
            if differ:
                raise AssertionError(f"native and Python {fmt} parsers differ on {differ}")
        traj = os.path.join(tmp, "poses.txt")
        pcd_io.save_trajectory_kitti(traj, poses)
        maps, walls = {}, {}
        for label in ("plain", "prefetch", "prefetch", "plain"):
            out = os.path.join(tmp, f"out_{label}")
            args = ["--preset", "local_mapping", "--scans", dirs["pcd"], "--trajectory", traj,
                    "--batch", str(REPLAY_BATCH), "--out", out, "--device", dev]
            if label == "prefetch":
                args += ["--prefetch", "2", "--capacity", str(N_POINTS)]
            k1.launches = k4.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if fastdem_replay.main(args) != 0:
                raise AssertionError(f"replay {label} failed")
            torch.cuda.synchronize()
            walls.setdefault(label, []).append((time.perf_counter() - t0) * 1e3 / IO_SCANS)
            if dev == "cuda" and min(k1.launches, k4.launches) < IO_SCANS:
                raise AssertionError(f"replay {label}: K1/K4 launched {k1.launches}/"
                                     f"{k4.launches} times for {IO_SCANS} scans")
            if label == "prefetch" and launches is None:
                launches = (k1.launches, k4.launches)
            maps[label] = load_npz(os.path.join(out, "map.npz"), device="cpu")[1]
            print(f"replay tool {label}: K1/K4 launches {k1.launches}/{k4.launches}")
        differ = [k for k, v in maps["plain"].layers.items()
                  if not torch.equal(maps["prefetch"].layers[k].view(torch.int32),
                                     v.view(torch.int32))]
        print(f"replay tool over {IO_SCANS} PCD scans: --prefetch 2 {walls['prefetch']!r} "
              f"ms/scan, without {walls['plain']!r} ms/scan (host clock, tool start-up, "
              f"file IO and warm-up included) on {card}; layers differing bitwise: {differ}")
        if differ:
            raise AssertionError(f"prefetch replay differs from the plain replay on {differ}")
        if int(torch.isfinite(maps["prefetch"].layers["elevation"]).sum()) < 17000 * (
                N_POINTS / 30000):
            raise AssertionError("prefetch replay mapped too few cells")
    return launches


def shard_stream(n_scans, seed):
    """The GLOBAL session's scans on the card: (xyz, T_wb) per scan, the
    mask and T_bs (phase 20)."""
    scans, T_bs, poses = global_session_scans(n_scans, seed)
    dev = torch.device("cuda")
    stream = [(torch.tensor(scans[k], device=dev), torch.tensor(poses[k], device=dev))
              for k in range(n_scans)]
    mask = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    return stream, mask, torch.tensor(T_bs, device=dev), (scans, T_bs, poses)


def assert_bitwise(what, ref, got):
    """Every layer and the position bit for bit."""
    bad = [k for k, v in ref.layers.items()
           if not torch.equal(v.view(torch.int32), got.layers[k].view(torch.int32))]
    same_pos = torch.equal(ref.position.cpu(), got.position.cpu())
    print(f"{what}: {len(ref.layers)} layers bit for bit {not bad}, position equal {same_pos}")
    if bad or not same_pos:
        raise AssertionError(f"{what}: layers {bad} differ (position equal {same_pos})")


def chain_ms_of(run, stream, mask, T_bs, state):
    """ms/scan of one pass over the stream (CUDA events around it)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for xyz, pose in stream:
        state, _ = run(state, xyz, mask, T_bs, pose)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(stream), state


def run_worker_pair(args, timeout):
    """Two multihost_demo processes on one coordinator (a free port); both
    must exit 0 within ``timeout``; returns their output."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fastdem_tpu_torch.tools.multihost_demo", "--pid", str(p),
         "--nproc", "2", "--coordinator", f"localhost:{port}", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"multihost_demo exited {p.returncode}:\n{log[-3000:]}")
    return logs


COLD_START_CODE = r"""
import json, sys, time
t_import = time.time()
import numpy as np
import torch
import fastdem_tpu_torch as fd
from fastdem_tpu_torch import native
from fastdem_tpu_torch.ops import cuda_build
from fastdem_tpu_torch.runtime import aotcache
bundle, fill = sys.argv[1], sys.argv[2] == "fill"
geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
cfg = fd.Config()
cfg.sensor_model.type = fd.SensorType.LIDAR
cfg.raycasting.enabled = True
aotcache.enable(bundle)
rng = np.random.default_rng(0)
xyz = np.column_stack([rng.uniform(-7, 7, (30000, 2)),
                       rng.normal(-1.0, 0.02, 30000)]).astype(np.float32)
T_bs = np.eye(4, dtype=np.float32)
T_bs[2, 3] = 1.0
mapper = fd.FastDEM(geom, cfg, device="cuda")
assert mapper.integrate(fd.cloud.from_numpy(xyz, frame_id="lidar", device="cuda"), T_bs,
                        np.eye(4, dtype=np.float32))
torch.cuda.synchronize()
rep = {"first_scan_at": time.time(), "imports_from": t_import,
       "build_seconds": dict(cuda_build.build_seconds),
       "finite": int(torch.isfinite(mapper.state.layers["elevation"]).sum())}
if fill:
    # After the timed scan: the rest of the bundle (the native scan IO,
    # the manifest), the kernels being built already.
    rep["warmup_seconds"] = aotcache.warmup(geom, cfg, capacities=(32768,),
                                            device="cuda")["warmup_seconds"]
    rep["native_build_seconds"] = native.build_seconds
print(json.dumps(rep))
"""


def phase_sharded(card):
    """Phase 20: the block-sharded GLOBAL map; returns the K1 and K4
    launches of its sharded main-path runs (step and sequence)."""
    import tempfile

    from fastdem_tpu_torch.io.npz import save_npz
    from fastdem_tpu_torch.io.sharded_ckpt import load_sharded
    from fastdem_tpu_torch.parallel import sharding as sh
    from fastdem_tpu_torch.parallel.distributed import scaling_report

    ggeom, cfg = global_geom(), global_config()
    n_all = SHARD_SCANS + RESUME_SCANS
    stream, mask, T_bs, host = shard_stream(n_all, seed=23)
    first, rest = stream[:SHARD_SCANS], stream[SHARD_SCANS:]

    # ---- a. one process, a 2x2 mesh of 1000x1000 blocks on cuda:0 ----
    step1 = fd.build_integrate(ggeom, cfg, device="cuda")
    mesh = sh.make_mesh(4, shape=(2, 2), devices=["cuda"])
    stepN, shard = sh.build_sharded_integrate(ggeom, cfg, mesh)
    seqN, _ = sh.build_sharded_integrate_sequence(ggeom, cfg, mesh)
    print(f"phase 20 sharded: mesh {mesh.shape}, blocks "
          f"{tuple(shard(fd.create_map_state(ggeom, cfg, device='cuda')).blocks[(0, 0)]['elevation'].shape)}, "
          f"formulation {stepN.formulation} / {seqN.formulation}")
    if stepN.formulation != "shardmap_windowed" or seqN.formulation != "shardmap_windowed":
        raise AssertionError("phase 20: the windowed formulation did not engage")
    s1 = fd.create_map_state(ggeom, cfg, device="cuda")
    for xyz, pose in first:
        s1, _ = step1(s1, xyz, mask, T_bs, pose)
    torch.cuda.synchronize()
    k1.launches = k4.launches = 0
    sN = shard(fd.create_map_state(ggeom, cfg, device="cuda"))
    oow = []
    for xyz, pose in first:
        sN, aux = stepN(sN, xyz, mask, T_bs, pose)
        oow.append(aux.oow_points)
    torch.cuda.synchronize()
    l1, l4 = k1.launches, k4.launches
    n_oow = int(torch.stack(oow).sum())
    print(f"phase 20 sharded step: {SHARD_SCANS} scans, K1 launches {l1} "
          f"({l1 / SHARD_SCANS!r}/scan), K4 launches {l4} ({l4 / SHARD_SCANS!r}/scan), "
          f"points outside the window {n_oow}")
    if (l1, l4) != (SHARD_SCANS, 4 * SHARD_SCANS) or n_oow:
        raise AssertionError("phase 20: want K1 once per scan, K4 once per block per scan, "
                             "no point outside the window")
    assert_bitwise("phase 20 sharded step == unsharded windowed step", s1, sh.gather_state(sN))
    k1.launches = k4.launches = 0
    sS = seqN(shard(fd.create_map_state(ggeom, cfg, device="cuda")),
              torch.stack([x for x, _ in first]),
              mask.expand(SHARD_SCANS, -1), T_bs, torch.stack([p for _, p in first]))
    torch.cuda.synchronize()
    s1_, s4_ = k1.launches, k4.launches
    print(f"phase 20 sharded sequence ({SHARD_SCANS} stacked scans): K1 launches {s1_}, "
          f"K4 launches {s4_}")
    if (s1_, s4_) != (SHARD_SCANS, 4 * SHARD_SCANS):
        raise AssertionError("phase 20: the sequence's launches are off")
    assert_bitwise("phase 20 sharded sequence == unsharded windowed step", s1,
                   sh.gather_state(sS))
    del sS

    def events_per_scan(run, state):
        it = iter(rest)
        box = [state]

        def one():
            xyz, pose = next(it)
            box[0], _ = run(box[0], xyz, mask, T_bs, pose)

        ms, events, _ = device_profile(one, len(rest))
        return events, ms

    for what, run, state in (("unsharded", step1, s1), ("sharded 2x2", stepN, sN)):
        events, dev_ms = events_per_scan(run, state)
        print(f"phase 20 {what}: {events!r} device events per scan, {dev_ms!r} device ms "
              f"per scan (torch.profiler over {len(rest)} scans) on {card}")
    times = {"unsharded": [], "sharded 2x2": []}
    for _ in range(SHARD_TURNS):
        for what, run, state0 in (("unsharded", step1, fd.create_map_state(ggeom, cfg, device="cuda")),
                                  ("sharded 2x2", stepN, shard(fd.create_map_state(ggeom, cfg, device="cuda")))):
            ms, _ = chain_ms_of(run, first, mask, T_bs, state0)
            times[what].append(ms)
    for what, ms in times.items():
        print(f"phase 20 {what}: ms/scan over {SHARD_SCANS} scans, {SHARD_TURNS} turns "
              f"alternating (CUDA events): {ms!r} on {card}")

    # ---- c. the post-processing chain over the sharded map ----
    pp = postprocess_config()
    names = ("elevation", "upper_bound", "lower_bound")
    t0 = time.perf_counter()
    ppN = sh.gather_state(sh.sharded_postprocess(ggeom, pp, mesh, sN, median=(3, 5)))
    torch.cuda.synchronize()
    t_sh = time.perf_counter() - t0
    ref = run_chain(ggeom, pp, [s1.layers[k] for k in names])
    torch.cuda.synchronize()
    print(f"phase 20 sharded post-processing: halo {sh.postprocess_halo(pp, ggeom.resolution, 3)} "
          f"cells, {t_sh * 1e3!r} ms wall for the 4 blocks (first call)")
    compare_chain("phase 20 sharded post-processing vs unsharded", ref, ppN.layers)
    del ppN, ref

    with tempfile.TemporaryDirectory() as tmp:
        # ---- b. two gloo processes on the one card, 2 blocks each ----
        scans_npz = os.path.join(tmp, "scans.npz")
        scans, T_bs_np, poses = host
        np.savez(scans_npz, xyz=scans[:SHARD_SCANS], T_bs=T_bs_np,
                 T_wb=np.stack(poses[:SHARD_SCANS]))
        mh, ck = os.path.join(tmp, "mh.npz"), os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        logs = run_worker_pair(
            ["--local-blocks", "2", "--scans-npz", scans_npz,
             "--map-size", repr(ggeom.rows * ggeom.resolution),
             "--resolution", repr(ggeom.resolution), "--range", repr(GLOBAL_RANGE),
             "--out", mh, "--ckpt", ck,
             "--device", "cuda"], TOOL_TIMEOUT_S)
        print(f"phase 20 two gloo processes on the card: {time.perf_counter() - t0!r} s wall")
        for log in logs:
            print("\n".join(l for l in log.splitlines() if l.startswith("[mh]")))
        one = os.path.join(tmp, "one.npz")
        if not save_npz(one, ggeom, sh.gather_state(sN)):
            raise AssertionError("phase 20: save_npz failed")
        with open(mh, "rb") as f1, open(one, "rb") as f2:
            same = f1.read() == f2.read()
        print(f"phase 20 two-process save_sharded_npz == save_npz of the one-process map, "
              f"byte for byte: {same} ({os.path.getsize(mh)} bytes)")
        if not same:
            raise AssertionError("phase 20: the two-process map differs")
        # The uninterrupted run, then resumes from the checkpoint on 1x4
        # and 4x1 meshes.
        for xyz, pose in rest:
            s1, _ = step1(s1, xyz, mask, T_bs, pose)
        for shape in ((1, 4), (4, 1)):
            m2 = sh.make_mesh(4, shape=shape, devices=["cuda"])
            _, s3, _ = load_sharded(ck, m2)
            step3, _ = sh.build_sharded_integrate(ggeom, cfg, m2)
            for xyz, pose in rest:
                s3, _ = step3(s3, xyz, mask, T_bs, pose)
            assert_bitwise(f"phase 20 checkpoint -> {shape} mesh -> {RESUME_SCANS} scans == "
                           "uninterrupted", s1, sh.gather_state(s3))
            del s3

        # ---- d. cold start against an empty and a filled bundle ----
        # Both processes do the same work up to the first scan: enable the
        # bundle, integrate one scan. The first, on an empty bundle, builds
        # K1 and K4 on the way and then fills the rest of the bundle
        # (warmup, timed apart); the second finds everything built.
        bundle = os.path.join(tmp, "bundle")
        starts = {}
        for what, mode in (("empty bundle, enable", "fill"),
                           ("filled bundle, enable", "filled")):
            t_spawn = time.time()
            proc = subprocess.run([sys.executable, "-c", COLD_START_CODE, bundle, mode],
                                  cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                                  capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"phase 20 cold start ({what}): {proc.stderr[-3000:]}")
            rep = json.loads(proc.stdout.strip().splitlines()[-1])
            starts[mode] = rep
            print(f"phase 20 cold start, {what}: {rep['first_scan_at'] - t_spawn!r} s from "
                  f"process start to the first integrated scan "
                  f"({rep['first_scan_at'] - rep['imports_from']!r} s after the interpreter "
                  f"came up), cuda_build.build_seconds {rep['build_seconds']}, "
                  f"{rep['finite']} mapped cells")
        fill = starts["fill"]
        print(f"phase 20 bundle fill after the first scan: warmup "
              f"{fill['warmup_seconds']!r} s, native g++ build "
              f"{fill['native_build_seconds']!r} s")
        if set(fill["build_seconds"]) != {"polar_field.cu", "resample.cu"} or \
                starts["filled"]["build_seconds"] or not fill["native_build_seconds"]:
            raise AssertionError("phase 20: the empty bundle was not filled, or the filled "
                                 "one did not spare the builds")
        from fastdem_tpu_torch.runtime import aotcache

        health = aotcache.verify(bundle, canary=True)
        print(f"phase 20 bundle: {health['entries']} libraries "
              f"{[e['file'] for e in health['libraries']]}, toolchain drift "
              f"{health['toolchain_drift']}, canary {health['canary']}")

    # ---- e. the scaling report as an overhead probe (one card) ----
    for mode, geom in (("strong", ggeom),
                       ("weak", fd.GridGeometry.from_length(100.0, 100.0, 0.1))):
        rep = scaling_report(geom, cfg, scans=SHARD_SCANS, points=N_POINTS, mode=mode,
                             mesh=mesh, device="cuda")
        print(f"phase 20 scaling_report {mode} on one card, 4 blocks (an overhead probe, "
              f"not scaling: the blocks share the card): {json.dumps(rep)} on {card}")
    return l1 + s1_, l4 + s4_


def mode_session(mode, dev, scans, T_bs, poses):
    """The flagship scans through build_integrate(scatter_mode=mode) on
    ``dev`` (sort with the raycast off): (state, the step)."""
    cfg = flagship_config()
    cfg.raycasting.enabled = mode != "sort"
    geom = flagship_geom()
    step = fd.build_integrate(geom, cfg, scatter_mode=mode, device=dev)
    state = fd.create_map_state(geom, cfg, device=dev)
    T_bs_d = torch.tensor(T_bs, device=dev)
    mask = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    for k in range(len(poses)):
        state, _ = step(state, torch.tensor(scans[k], device=dev), mask, T_bs_d,
                        torch.tensor(poses[k], device=dev))
    return state, step


def check_decisions(what, cpu_state, gpu_state):
    """The decision layers (n_points, ghost_removal, obstacle) equal, NaN
    sets included."""
    bad = {}
    for name in ("n_points", "ghost_removal", "obstacle"):
        if name not in cpu_state.layers:
            continue
        a = cpu_state.layers[name].cpu().numpy()
        b = gpu_state.layers[name].cpu().numpy()
        n = int((~((a == b) | (np.isnan(a) & np.isnan(b)))).sum())
        if n:
            bad[name] = n
    print(f"{what}: decision layers card vs CPU, cells differing: {bad or 'none'}")
    if bad:
        raise AssertionError(f"{what}: decision layers differ {bad}")


def phase_scatter_modes(card):
    """Phase 21 a-c: packed, twophase and sort on the flagship, the switch
    to packed on the 200 m GLOBAL map with a 40 m range filter, and the
    sharded fallback over packed. Returns the K1 and K4 launches of these
    main-path runs."""
    from fastdem_tpu_torch.parallel import sharding as sh

    geom = flagship_geom()
    scans, T_bs, poses = make_session(MODE_SCANS, seed=31)
    l1 = l4 = 0
    for mode in ("packed", "twophase", "sort"):
        torch.cuda.synchronize()
        k1.launches = k4.launches = 0
        gpu, step = mode_session(mode, "cuda", scans, T_bs, poses)
        torch.cuda.synchronize()
        n = 0 if mode == "sort" else MODE_SCANS
        print(f"phase 21 {mode}: {MODE_SCANS} flagship scans on the card, step mode "
              f"{step.scatter_mode}, K1 launches {k1.launches}, K4 launches {k4.launches}")
        if step.scatter_mode != mode or (k1.launches, k4.launches) != (n, n):
            raise AssertionError(f"phase 21 {mode}: mode or launches off")
        l1, l4 = l1 + k1.launches, l4 + k4.launches
        cpu, _ = mode_session(mode, "cpu", scans, T_bs, poses)
        check_parity(f"phase 21 {mode}", cpu, gpu)
        check_decisions(f"phase 21 {mode}", cpu, gpu)
        if mode == "sort":
            assert_bitwise("phase 21 sort (no raycast) card == CPU", cpu, SimpleNamespace(
                layers={k: v.cpu() for k, v in gpu.layers.items()}, position=gpu.position))
        check_map(f"phase 21 {mode}", geom, SimpleNamespace(state=gpu), "kalman", 17000)

    # ---- b. the switch: the 200 m GLOBAL map, a 40 m range filter ----
    ggeom = global_geom()
    cfg = global_config()
    cfg.point_filter.range_max = SWITCH_RANGE
    gscans, gT_bs, gposes = make_session(SWITCH_SCANS, seed=37, spread=SWITCH_SPREAD,
                                         start=(-12.0, 6.0), step=(1.7, -0.85))
    gpu, s1, s4 = drive("phase 21 switch", "cuda", ggeom, cfg, gscans, gT_bs, gposes)
    mode = gpu._step.scatter_mode
    side = int(np.ceil(2 * (1.1 * SWITCH_RANGE + 2) / ggeom.resolution)) + 4
    print(f"phase 21 switch: 200 m GLOBAL map, range filter {SWITCH_RANGE} m, a {side}^2 "
          f"update window ({side * side} cells), step mode {mode}")
    if mode != "packed":
        raise AssertionError("phase 21: the step above 2^19 window cells is not packed")
    check_map("phase 21 switch", ggeom, gpu, "kalman", 80000)
    cpu, _ = run_session("cpu", ggeom, cfg, gscans, gT_bs, gposes)
    check_parity("phase 21 switch", cpu.state, gpu.state)
    check_decisions("phase 21 switch", cpu.state, gpu.state)
    del cpu, gpu
    l1, l4 = l1 + s1, l4 + s4

    # ---- c. the sharded fallback over packed: a LOCAL map above 2^19 cells ----
    lgeom = fd.GridGeometry.from_length(SHARD_LOCAL_M, SHARD_LOCAL_M, 0.1)
    lcfg = flagship_config()
    lscans, lT_bs, lposes = make_session(4, seed=41, spread=30.0, step=(0.73, -0.41))
    dev = torch.device("cuda")
    mask = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    T_bs_d = torch.tensor(lT_bs, device=dev)
    step1 = fd.build_integrate(lgeom, lcfg, device="cuda")
    mesh = sh.make_mesh(4, shape=(2, 2), devices=["cuda"])
    stepN, shard = sh.build_sharded_integrate(lgeom, lcfg, mesh)
    s1 = fd.create_map_state(lgeom, lcfg, device="cuda")
    for k in range(4):
        s1, _ = step1(s1, torch.tensor(lscans[k], device=dev), mask, T_bs_d,
                      torch.tensor(lposes[k], device=dev))
    torch.cuda.synchronize()
    k1.launches = k4.launches = 0
    sN = shard(fd.create_map_state(lgeom, lcfg, device="cuda"))
    for k in range(4):
        sN, _ = stepN(sN, torch.tensor(lscans[k], device=dev), mask, T_bs_d,
                      torch.tensor(lposes[k], device=dev))
    torch.cuda.synchronize()
    print(f"phase 21 sharded fallback: LOCAL {lgeom.shape} map ({lgeom.num_cells} cells), "
          f"2x2 mesh, formulation {stepN.formulation}, unsharded step mode "
          f"{step1.scatter_mode}, K1 launches {k1.launches}, K4 launches {k4.launches}")
    if stepN.formulation != "blocks_fullmap" or step1.scatter_mode != "packed":
        raise AssertionError("phase 21: the fallback or the packed mode did not engage")
    l1, l4 = l1 + k1.launches, l4 + k4.launches
    assert_bitwise("phase 21 sharded fallback over packed == unsharded packed step", s1,
                   sh.gather_state(sN))
    return l1, l4


def states_agree_loop(what, ref, got):
    """The batched step against the loop: every decision layer equal; the
    raycasting layer on all but max(1, cells / 1000) cells, each within
    0.06 (the reference's rule, tests/test_replay.py); prints the bitwise
    share."""
    bitwise = True
    for name, r in ref.layers.items():
        a, b = r.cpu().numpy(), got.layers[name].cpu().numpy()
        same = np.array_equal(a.view(np.int32), b.view(np.int32))
        bitwise &= same
        if name == "raycasting" and not same:
            nan_mis = int((np.isnan(a) != np.isnan(b)).sum())
            both = np.isfinite(a) & np.isfinite(b)
            ndiff = int((a[both] != b[both]).sum())
            maxd = float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0
            if nan_mis + ndiff > max(1, a.size // 1000) or maxd >= 0.06:
                raise AssertionError(f"{what}: raycasting layer {nan_mis} / {ndiff} / {maxd}")
        elif not same and not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{what}: layer {name} differs from the loop")
    if not torch.equal(ref.position.cpu(), got.position.cpu()):
        raise AssertionError(f"{what}: position differs from the loop")
    print(f"{what} vs the step loop: decision layers equal, every layer bitwise {bitwise}")


def phase_batched_replay(card):
    """Phase 21 d-f: microbatch and fused against the loop, the batched K1
    and K4 against their twins, and the cost per scan of each. Returns the
    K1 and K4 launches of the batched main-path runs."""
    from fastdem_tpu_torch.mapping.pipeline import build_integrate_fused

    geom = flagship_geom()
    cfg = flagship_config()
    cfg.mapping.mode = fd.MappingMode.LOCAL
    scans, T_bs, poses = make_session(BATCH_SCANS, seed=43)
    dev = torch.device("cuda")
    X = torch.tensor(np.asarray(scans), device=dev)
    M = torch.ones((BATCH_SCANS, N_POINTS), dtype=torch.bool, device=dev)
    TB = torch.tensor(T_bs, device=dev)
    P = torch.tensor(np.stack(poses), device=dev)
    runners = {
        f"microbatch {m}": build_integrate_sequence(geom, cfg, microbatch=m, device="cuda")
        for m in MICROBATCHES
    }
    runners[f"fused K={FUSED_K}"] = build_integrate_fused(geom, cfg, device="cuda")

    def run(fn, n=BATCH_SCANS, call=FUSED_K):
        state = fd.create_map_state(geom, cfg, device="cuda")
        for lo in range(0, n, call):
            state = fn(state, X[lo:lo + call], M[lo:lo + call], TB, P[lo:lo + call])
        return state

    step = fd.build_integrate(geom, cfg, device="cuda")
    ref = fd.create_map_state(geom, cfg, device="cuda")
    for k in range(BATCH_SCANS):
        ref, _ = step(ref, X[k], M[k], TB, P[k])
    l1 = l4 = 0
    for what, fn in runners.items():
        m = FUSED_K if what.startswith("fused") else int(what.split()[-1])
        torch.cuda.synchronize()
        k1.launches = k4.launches = 0
        got = run(fn)
        torch.cuda.synchronize()
        want = BATCH_SCANS // m
        print(f"phase 21 {what}: {BATCH_SCANS} flagship scans (LOCAL), K1 launches "
              f"{k1.launches}, K4 launches {k4.launches} (one per batch of {m})")
        if (k1.launches, k4.launches) != (want, want):
            raise AssertionError(f"phase 21 {what}: want {want} K1 / K4 launches")
        l1, l4 = l1 + k1.launches, l4 + k4.launches
        states_agree_loop(f"phase 21 {what}", ref, got)
    check_map("phase 21 batched", geom, SimpleNamespace(state=got), "kalman", 17000)

    # ---- e. the batched K1 and K4 against their twins ----
    rng = np.random.default_rng(47)
    A, R, dr = raycast.polar_dims(geom, 2048, 0.25, 12.81)
    win = raycast.column_windows(geom, 2048, 0.25, 12.81, dev)
    lk = raycast.polar_lookup(geom, 2048, 0.25, 12.81)
    timing = {}
    for K in BATCH_KERNEL_FRAMES:
        tbl = rng.uniform(-2.0, 0.5, (K, R, A)).astype(np.float32)
        tbl[rng.random(tbl.shape) < 0.97] = np.inf
        scat = torch.tensor(tbl, device=dev)
        so = torch.tensor(np.column_stack([rng.uniform(-0.5, 0.5, (K, 2)),
                                           rng.uniform(0.9, 1.1, K)]).astype(np.float32),
                          device=dev)
        pos = torch.tensor(rng.uniform(-0.2, 0.2, (K, 2)).astype(np.float32), device=dev)
        got = k1.polar_field_cuda(scat, win, so, dr, 4, True)
        ref1 = k1.polar_field_plain(scat, win, so, dr, 4, True)
        torch.cuda.synchronize()
        same1 = torch.equal(got.view(torch.int32), ref1.view(torch.int32))
        h, t = k4.resample_lookup_cuda(got, lk, pos, so)
        h_ref, t_ref = k4.resample_lookup_plain(got, lk, pos, so)
        torch.cuda.synchronize()
        same4 = torch.equal(h.view(torch.int32), h_ref.view(torch.int32)) and torch.equal(t, t_ref)
        print(f"phase 21 batched K1 [{K}, {R}, {A}] == twin bitwise {same1}; batched K4 "
              f"{K} x {geom.num_cells} cells == twin bitwise {same4} ({int(t.sum())} touched)")
        if not (same1 and same4 and int(t.sum()) > 0):
            raise AssertionError(f"phase 21: the batched K1 / K4 differ from their twins (K={K})")
        ms1, plain1, _ = time_pair(
            f"phase 21 batched K1, K={K}",
            lambda: k1.polar_field_cuda(scat, win, so, dr, 4, True),
            lambda: k1.polar_field_plain(scat, win, so, dr, 4, True), reps=50, plain_reps=5)
        ms4, plain4, _ = time_pair(
            f"phase 21 batched K4, K={K}",
            lambda: k4.resample_lookup_cuda(got, lk, pos, so),
            lambda: k4.resample_lookup_plain(got, lk, pos, so), reps=50, plain_reps=5)
        timing[K] = (ms1 / K, ms4 / K)
        b1, by1 = k1_bound(R, A, 4, win, True)
        b4, by4 = k4_lookup_bound(geom.num_cells, 1)
        print(f"phase 21 K={K}: K1 {ms1 / K!r} ms per frame (bound {b1!r} ms, {by1}; plain "
              f"{plain1 / K!r}), K4 {ms4 / K!r} ms per frame (bound {b4!r} ms, {by4}; plain "
              f"{plain4 / K!r}) on {card}")
    print(f"phase 21 per-frame ms (K1, K4) by batch size: {timing!r} on {card}")

    # ---- f. events, device ms and wall ms per scan, in alternating turns ----
    for what, fn in runners.items():
        fn_one = (lambda fn=fn: run(fn, n=FUSED_K))
        ms, events, _ = device_profile(fn_one, 1, attempts=PROFILE_ATTEMPTS)
        print(f"phase 21 {what}: {events / FUSED_K!r} device events per scan, "
              f"{ms / FUSED_K!r} device ms per scan (torch.profiler over {FUSED_K} scans) "
              f"on {card}")
    walls = {what: [] for what in runners}
    order = list(runners)
    for turn in range(BATCH_TURNS):
        for what in (order if turn % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(runners[what])
            torch.cuda.synchronize()
            walls[what].append((time.perf_counter() - t0) * 1e3 / BATCH_SCANS)
    for what, ms in walls.items():
        print(f"phase 21 {what}: wall ms/scan over {BATCH_SCANS} scans, {BATCH_TURNS} "
              f"alternating turns: {ms!r} on {card}")
    return l1, l4

def graph_paths():
    """Phase 22's one-scan paths: (name, geom, cfg, session)."""
    p2 = flagship_config("p2")
    switch = global_config()
    switch.point_filter.range_max = SWITCH_RANGE
    sampled = flagship_config()
    sampled.raycasting.method = "sampled"
    return (
        ("flagship kalman", flagship_geom(), flagship_config(),
         lambda: make_session(CHAIN, seed=53)),
        ("flagship p2", flagship_geom(), p2, lambda: make_session(CHAIN, seed=53)),
        ("global 200 m", global_geom(), global_config(),
         lambda: global_session_scans(CHAIN, seed=59)),
        ("switch to packed", global_geom(), switch,
         lambda: make_session(CHAIN, seed=61, spread=SWITCH_SPREAD, start=(-12.0, 6.0),
                              step=(1.7, -0.85))),
        ("sampled", flagship_geom(), sampled, lambda: make_session(GRAPH_SAMPLED_SCANS,
                                                                   seed=67)),
    )


def graph_turns(what, runners, card, n_scans, unit="scan", phase="phase 22"):
    """Wall ms per scan (``unit``) of each runner (a thunk over the whole
    chain from a fresh state), in alternating turns: CUDA events and the
    host clock."""
    walls = {k: [] for k in runners}
    order = list(runners)
    for turn in range(GRAPH_TURNS):
        for k in (order + order[::-1]) if turn == 0 else (order[::-1] + order):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            runners[k]()
            end.record()
            end.synchronize()
            walls[k].append((start.elapsed_time(end) / n_scans,
                             (time.perf_counter() - t0) * 1e3 / n_scans))
    for k, ms in walls.items():
        print(f"{phase} {what} {k}: wall ms/{unit} over {n_scans} {unit}s in alternating "
              f"turns (CUDA events, host clock): {ms!r} on {card}")
    return walls


def graph_stats(what, step, card, phase="phase 22"):
    for st in step.stats():
        print(f"{phase} {what}: capture {st.capture_seconds!r} s (slots, warm-up, capture, "
              f"first replay), graph pool {st.pool_bytes / 2**20!r} MiB, slots "
              f"{st.slot_bytes / 2**20!r} MiB, launches per replay "
              f"{st.launches_per_replay}, replays {st.replays} on {card}")


KERNEL_EVENTS = {"K1 column": "polar_column_kernel", "K1 row": "polar_row_kernel",
                 "K4": "lookup_kernel"}


def kernels_seen(what, counts, per_call, phase="phase 22"):
    """The K1 / K4 kernel events per call in a trace (``device_profile``'s
    ``counts``) against ``per_call`` (K1, K4), the launches the counters
    gave over the same calls; prints the trace's numbers."""
    seen = {k: sum(n for name, n in counts.items() if ev in name)
            for k, ev in KERNEL_EVENTS.items()}
    print(f"{phase} {what}: kernel events per call in the trace {seen!r}, launches per "
          f"call by the counters K1 {per_call[0]!r}, K4 {per_call[1]!r}")
    want = {"K1 column": per_call[0], "K1 row": per_call[0], "K4": per_call[1]}
    if any(abs(seen[k] - want[k]) > 1e-9 for k in want):
        raise AssertionError(f"{phase} {what}: the trace's K1 / K4 kernels {seen} differ "
                             f"from the counters' {want}")
    return seen


def check_aux(what, eager, graph):
    """The aux of the last scan, graph against eager, bit for bit."""
    pairs = [("world_xyz", eager.world_xyz, graph.world_xyz),
             ("world_mask", eager.world_mask, graph.world_mask)]
    pairs += [(f, getattr(eager.obs, f), getattr(graph.obs, f))
              for f in ("min_z", "max_z", "min_z_var", "touched", "voxel_count")
              if getattr(eager.obs, f) is not None]
    bad = [f for f, a, b in pairs if not torch.equal(
        a.view(torch.uint8) if a.dtype == torch.bool else a.view(torch.int32),
        b.view(torch.uint8) if b.dtype == torch.bool else b.view(torch.int32))]
    if bad:
        raise AssertionError(f"{what}: the graph's aux differs from eager on {bad}")


def phase_graphs(card, flagship_state, global_state):
    """Phase 22: every step and the chain as CUDA graphs against their
    eager form. Returns the K1 and K4 launches of the graph runs."""
    from fastdem_tpu_torch.mapping.pipeline import build_integrate_fused
    from fastdem_tpu_torch.utils import graphs

    dev = torch.device("cuda")
    # A step that reads the device from the host must refuse its capture
    # (and leave the process able to capture the paths below).
    eager = fd.build_integrate(flagship_geom(), flagship_config(), jit=False, device="cuda")

    def reads(state, *args):
        state, aux = eager(state, *args)
        float(state.position.sum())
        return state, aux

    scans, T_bs, poses = make_session(1, seed=53)
    try:
        graphs.jit(reads)(fd.create_map_state(flagship_geom(), flagship_config(), device="cuda"),
                          torch.tensor(scans[0], device=dev),
                          torch.ones(N_POINTS, dtype=torch.bool, device=dev),
                          torch.tensor(T_bs, device=dev), torch.tensor(poses[0], device=dev))
    except RuntimeError as err:
        print(f"phase 22 refusal: a step with a host read raised on capture: "
              f"{str(err)[:160]!r}")
    else:
        raise AssertionError("phase 22: a step with a host read was captured")
    l1 = l4 = 0
    for what, geom, cfg, session in graph_paths():
        scans, T_bs, poses = session()
        n = len(poses)
        X = [torch.tensor(x, device=dev) for x in scans]
        P = [torch.tensor(T, device=dev) for T in poses]
        TB = torch.tensor(T_bs, device=dev)
        M = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
        steps = {"eager": fd.build_integrate(geom, cfg, jit=False, device="cuda"),
                 "graph": fd.build_integrate(geom, cfg, device="cuda")}

        def chain(step, scans=range(n)):
            state = fd.create_map_state(geom, cfg, device="cuda")
            for k in scans:
                state, aux = step(state, X[k], M, TB, P[k])
            return state, aux

        ref, aux_e = chain(steps["eager"])
        torch.cuda.synchronize()
        k1.launches = k4.launches = 0
        got, aux_g = chain(steps["graph"])
        torch.cuda.synchronize()
        per_scan = 0 if cfg.raycasting.method == "sampled" else 1
        print(f"phase 22 {what}: {n} scans through the graph, step mode "
              f"{steps['graph'].scatter_mode}, K1 launches {k1.launches}, K4 launches "
              f"{k4.launches}")
        if (k1.launches, k4.launches) != (n * per_scan, n * per_scan):
            raise AssertionError(f"phase 22 {what}: K1 / K4 not counted once per replay")
        l1, l4 = l1 + k1.launches, l4 + k4.launches
        assert_bitwise(f"phase 22 {what} graph == eager", ref, got)
        check_aux(f"phase 22 {what}", aux_e, aux_g)
        del ref, got, aux_e, aux_g
        graph_turns(what, {k: (lambda s=s: chain(s)) for k, s in steps.items()}, card, n)
        for k, step in steps.items():
            state = [chain(step, range(GRAPH_PROFILE_SCANS))[0]]
            it = iter(range(GRAPH_PROFILE_SCANS, 2 * GRAPH_PROFILE_SCANS))

            def one(step=step, state=state, it=it):
                k_ = next(it)
                state[0], _ = step(state[0], X[k_], M, TB, P[k_])

            counts = {}
            k1.launches = k4.launches = 0
            ms, events, _ = device_profile(one, GRAPH_PROFILE_SCANS, counts=counts)
            print(f"phase 22 {what} {k}: {events!r} device events per scan, {ms!r} device "
                  f"ms per scan (torch.profiler over {GRAPH_PROFILE_SCANS} scans) on {card}")
            seen = kernels_seen(f"{what} {k}", counts,
                                (k1.launches / GRAPH_PROFILE_SCANS,
                                 k4.launches / GRAPH_PROFILE_SCANS))
            if seen["K4"] != per_scan:
                raise AssertionError(f"phase 22 {what} {k}: K4 ran {seen['K4']} times a scan")
        graph_stats(what, steps["graph"], card)
        del steps
        torch.cuda.empty_cache()

    # ---- the replay steps: microbatch 16 and fused 16 over 32 scans ----
    geom = flagship_geom()
    cfg = flagship_config()
    scans, T_bs, poses = make_session(CHAIN, seed=71)
    X = torch.tensor(np.asarray(scans), device=dev)
    M = torch.ones((CHAIN, N_POINTS), dtype=torch.bool, device=dev)
    TB = torch.tensor(T_bs, device=dev)
    P = torch.tensor(np.stack(poses), device=dev)
    for what, build in (("microbatch 16", lambda jit: build_integrate_sequence(
            geom, cfg, microbatch=FUSED_K, jit=jit, device="cuda")),
            ("fused 16", lambda jit: build_integrate_fused(geom, cfg, jit=jit, device="cuda"))):
        fns = {"eager": build(False), "graph": build(True)}

        def run(fn):
            state = fd.create_map_state(geom, cfg, device="cuda")
            for lo in range(0, CHAIN, FUSED_K):
                state = fn(state, X[lo:lo + FUSED_K], M[lo:lo + FUSED_K], TB,
                           P[lo:lo + FUSED_K])
            return state

        ref = run(fns["eager"])
        torch.cuda.synchronize()
        k1.launches = k4.launches = 0
        got = run(fns["graph"])
        torch.cuda.synchronize()
        want = CHAIN // FUSED_K
        print(f"phase 22 {what}: {CHAIN} scans through the graph, K1 launches {k1.launches}, "
              f"K4 launches {k4.launches}")
        if (k1.launches, k4.launches) != (want, want):
            raise AssertionError(f"phase 22 {what}: K1 / K4 not counted once per replay")
        l1, l4 = l1 + k1.launches, l4 + k4.launches
        assert_bitwise(f"phase 22 {what} graph == eager", ref, got)
        graph_turns(what, {k: (lambda f=f: run(f)) for k, f in fns.items()}, card, CHAIN)
        for k, fn in fns.items():
            counts = {}
            k1.launches = k4.launches = 0
            ms, events, _ = device_profile(lambda fn=fn: run(fn), 1, counts=counts)
            print(f"phase 22 {what} {k}: {events / CHAIN!r} device events per scan, "
                  f"{ms / CHAIN!r} device ms per scan (torch.profiler over {CHAIN} scans) "
                  f"on {card}")
            seen = kernels_seen(f"{what} {k}", counts, (k1.launches, k4.launches))
            if seen["K4"] != want:
                raise AssertionError(f"phase 22 {what} {k}: K4 ran {seen['K4']} times")
        graph_stats(what, fns["graph"], card)

    # ---- the post-processing chain at 150^2 and 2000^2 ----
    pp = postprocess_config()
    for what, g, state in (("chain 150x150", flagship_geom(), flagship_state),
                           ("chain 2000x2000", global_geom(), global_state)):
        layers = [state.layers[k] for k in ("elevation", "upper_bound", "lower_bound")]
        fns = {"eager": apply_postprocess_fn(g, pp)}
        fns["graph"] = graphs.jit(fns["eager"], donate=False)
        ref = fns["eager"](*layers)
        got = fns["graph"](*layers)
        again = fns["graph"](*layers)
        bad = [k for k, v in ref.items() for out in (got, again)
               if not torch.equal(out[k].view(torch.int32), v.view(torch.int32))]
        print(f"phase 22 {what}: {len(ref)} outputs, graph == eager bit for bit (NaN sets "
              f"included) on two calls: {not bad}")
        if bad:
            raise AssertionError(f"phase 22 {what}: the graph differs on {sorted(set(bad))}")
        del ref, got, again
        graph_turns(what, {k: (lambda f=f: f(*layers)) for k, f in fns.items()}, card, 1,
                    unit="chain")
        for k, fn in fns.items():
            ms, events, _ = device_profile(lambda fn=fn: fn(*layers), PP_REPS,
                                           attempts=PROFILE_ATTEMPTS)
            print(f"phase 22 {what} {k}: {events!r} device events, {ms!r} device ms per "
                  f"chain (torch.profiler over {PP_REPS}) on {card}")
        graph_stats(what, fns["graph"], card)
        del fns
        torch.cuda.empty_cache()

    # ---- the node, sync intake: graph against eager steps, in turns ----
    from fastdem_tpu_torch.runtime import NodeConfig

    node_cfg = NodeConfig.from_preset("local_mapping")
    clouds, calib, odom = node_stream(NODE_RATE_SCANS)
    rates = {"graph": [], "eager": []}
    maps = []
    for way in ("graph", "eager", "eager", "graph"):
        with node_driver(node_cfg, calib, odom) as d:
            if way == "eager":
                m = d.mapper
                m._step = fd.build_integrate(m.geom, m.cfg, jit=False,
                                             window_margin=m._window_margin, device="cuda")
            # The first scans capture the graph; the rate is taken after them.
            for c in clouds[:GRAPH_NODE_WARM]:
                d.on_scan(c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for c in clouds[GRAPH_NODE_WARM:]:
                if not d.on_scan(c):
                    raise AssertionError("phase 22 node: a scan was refused")
            torch.cuda.synchronize()
            rates[way].append((NODE_RATE_SCANS - GRAPH_NODE_WARM) / (time.perf_counter() - t0))
            if d.scan_count != NODE_RATE_SCANS:
                raise AssertionError(f"phase 22 node: {d.scan_count} scans integrated")
            maps.append(d.mapper.state)
    differ = sorted({k for m in maps[1:] for k, v in m.layers.items()
                     if not torch.equal(v.view(torch.int32), maps[0].layers[k].view(torch.int32))})
    print(f"phase 22 node, sync intake, scans/s over {NODE_RATE_SCANS - GRAPH_NODE_WARM} "
          f"scans after {GRAPH_NODE_WARM}, in turns: {rates!r}; "
          f"layers differing bitwise between the runs: {differ} on {card}")
    if differ:
        raise AssertionError(f"phase 22 node: the graph and eager maps differ on {differ}")

    # ---- the node on scans of varying size: a graph per power of two ----
    sizes = np.random.default_rng(83).integers(*VARY_POINTS, VARY_SCANS)
    full, calib, odom = node_stream(VARY_SCANS)
    vclouds = [fd.cloud.from_numpy(c.xyz[:n].numpy(), frame_id="lidar",
                                   timestamp_ns=c.timestamp_ns, device="cpu")
               for c, n in zip(full, sizes)]
    rungs = sorted({1 << int(n - 1).bit_length() for n in sizes})
    maps, rates = {}, {}
    for way in ("graph", "eager"):
        with node_driver(node_cfg, calib, odom) as d:
            if way == "eager":
                m = d.mapper
                m._step = fd.build_integrate(m.geom, m.cfg, jit=False,
                                             window_margin=m._window_margin, device="cuda")
            k1.launches = k4.launches = 0
            secs = feed_node(d, vclouds)
            rates[way] = VARY_SCANS / secs
            maps[way] = d.mapper.state
            if way == "graph":
                l1, l4 = l1 + k1.launches, l4 + k4.launches
                stats = d.mapper._step.stats()
                caps = sorted(sl.shape[0] for g in d.mapper._step.graphs.values()
                              for sl in g.slots if sl.dim() == 2 and sl.shape[1] == 3)
                print(f"phase 22 node, {VARY_SCANS} scans of {len(set(sizes.tolist()))} sizes in "
                      f"[{VARY_POINTS[0]}, {VARY_POINTS[1]}): graphs at capacities {caps} "
                      f"(powers of two spanned {rungs}), captures "
                      f"{[st.capture_seconds for st in stats]!r} s, the shared pool "
                      f"{sum(st.pool_bytes for st in stats) / 2**20!r} MiB, K1 / K4 launches "
                      f"{k1.launches} / {k4.launches} on {card}")
                if caps != rungs or (k1.launches, k4.launches) != (VARY_SCANS, VARY_SCANS):
                    raise AssertionError("phase 22 node, varying sizes: graphs or launches off")
    differ = sorted(k for k, v in maps["graph"].layers.items()
                    if not torch.equal(v.view(torch.int32), maps["eager"].layers[k].view(torch.int32)))
    print(f"phase 22 node, varying sizes, scans/s with the captures: {rates!r}; layers "
          f"differing bitwise, graph (padded) against eager (unpadded): {differ} on {card}")
    if differ:
        raise AssertionError(f"phase 22 node, varying sizes: the maps differ on {differ}")
    return l1, l4


def sharded_aux_equal(what, eager, graph):
    """The sharded step's last aux, graph against eager, bit for bit."""
    pairs = [(f, getattr(eager, f), getattr(graph, f))
             for f in ("world_xyz", "world_mask", "z_var", "oow_points")]
    bad = [f for f, a, b in pairs if (a is None) != (b is None) or a is not None and not
           torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))]
    if bad:
        raise AssertionError(f"{what}: the graph's aux differs from eager on {bad}")


def sharded_graph_path(what, card, mesh, geom, cfg, scans, T_bs, poses, unsharded_ok=True):
    """One sharded path's step, graph against eager over the whole session:
    bit for bit (and equal to the unsharded graph step), K1 / K4 counted
    once per scan / per block per scan, timed in turns, profiled, its
    graphs' stats. Returns (K1, K4) of the graph run and the graph step."""
    from fastdem_tpu_torch.parallel import sharding as sh

    ph = "phase 23"
    dev = torch.device("cuda")
    n = len(poses)
    X = [torch.tensor(x, device=dev) for x in scans]
    P = [torch.tensor(T, device=dev) for T in poses]
    TB = torch.tensor(T_bs, device=dev)
    M = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    steps = {"eager": sh.build_sharded_integrate(geom, cfg, mesh, jit=False)[0],
             "graph": sh.build_sharded_integrate(geom, cfg, mesh)[0]}
    print(f"{ph} {what}: formulation {steps['graph'].formulation}, compiled "
          f"{steps['graph'].compiled} (eager: {steps['eager'].compiled})")
    if steps["graph"].compiled != "whole":
        raise AssertionError(f"{ph} {what}: the scan is not one graph")

    def chain(step, ks=range(n)):
        state = sh.shard_state(fd.create_map_state(geom, cfg, device="cuda"), mesh)
        aux = None
        for k in ks:
            state, aux = step(state, X[k], M, TB, P[k])
        return state, aux

    ref, aux_e = chain(steps["eager"])
    torch.cuda.synchronize()
    k1.launches = k4.launches = 0
    got, aux_g = chain(steps["graph"])
    torch.cuda.synchronize()
    l1, l4 = k1.launches, k4.launches
    print(f"{ph} {what}: {n} scans through the graph, K1 launches {l1}, K4 launches {l4}")
    if (l1, l4) != (n, 4 * n):
        raise AssertionError(f"{ph} {what}: K1 / K4 not counted once per scan / block")
    assert_bitwise(f"{ph} {what} graph == eager", sh.gather_state(ref), sh.gather_state(got))
    sharded_aux_equal(f"{ph} {what}", aux_e, aux_g)
    one = fd.build_integrate(geom, cfg, device="cuda")
    s1 = fd.create_map_state(geom, cfg, device="cuda")
    for k in range(n):
        s1, _ = one(s1, X[k], M, TB, P[k])
    assert_bitwise(f"{ph} {what} graph == unsharded graph step", s1, sh.gather_state(got))
    del ref, got, s1, one
    graph_turns(what, {k: (lambda s=s: chain(s)) for k, s in steps.items()}, card, n, phase=ph)
    for k, step in steps.items():
        state = [chain(step, range(GRAPH_PROFILE_SCANS))[0]]
        it = iter(range(GRAPH_PROFILE_SCANS, 2 * GRAPH_PROFILE_SCANS))

        def one_scan(step=step, state=state, it=it):
            k_ = next(it)
            state[0], _ = step(state[0], X[k_], M, TB, P[k_])

        counts = {}
        k1.launches = k4.launches = 0
        ms, events, _ = device_profile(one_scan, GRAPH_PROFILE_SCANS, counts=counts)
        print(f"{ph} {what} {k}: {events!r} device events per scan, {ms!r} device ms per "
              f"scan (torch.profiler over {GRAPH_PROFILE_SCANS} scans) on {card}")
        kernels_seen(f"{what} {k}", counts, (k1.launches / GRAPH_PROFILE_SCANS,
                                             k4.launches / GRAPH_PROFILE_SCANS), phase=ph)
    for g in steps["graph"].per_device.values():
        graph_stats(what, g, card, phase=ph)
    return l1, l4, steps["graph"]


def cluster_per_sweep(cloud, tolerance, per_bucket=16, max_sweeps=64):
    """Euclidean clustering as a plain loop that reads the ``changed`` flag
    after every sweep, on the port's candidate search: (labels, sweeps).
    The reference of the sweep blocks in ``euclidean_cluster``."""
    from fastdem_tpu_torch.cloud.search import BucketGrid

    xyz, mask = cloud.xyz, cloud.mask
    n = cloud.capacity
    cand, cvalid = BucketGrid(xyz, mask, tolerance).candidates(xyz, per_bucket)
    cand = cand.long()
    diff = xyz[cand.clamp_min(0)] - xyz[:, None, :]
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # left to right, as euclidean_cluster
    cand = torch.where(cvalid & (d2 <= float(np.float32(tolerance * tolerance)))
                       & mask[:, None], cand, n)
    ar = torch.arange(n, device=xyz.device)
    labels = torch.where(mask, ar, n)
    tail = torch.tensor([n], device=xyz.device)
    sweeps = 0
    for _ in range(max_sweeps):
        lab_ext = torch.cat([labels, tail])
        new = torch.minimum(labels, lab_ext[cand].amin(dim=1))
        new = torch.minimum(new, lab_ext[new.clamp_max(n - 1)])
        sweeps += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    root = mask & (labels == ar)
    compact = torch.cumsum(root.to(torch.int64), 0) - 1
    return torch.where(mask, compact[labels.clamp(0, n - 1)], -1).to(torch.int32), sweeps


def align_stream(card, ph):
    """align's fused driver against its host loop on a stream of distinct
    pairs (sizes and targets), every call cold: the fused driver captures
    its graph in each call and drops it on return. Turns host, fused,
    fused, host over the same pairs."""
    from fastdem_tpu_torch.cloud import registration as reg
    from fastdem_tpu_torch.tools.common import registration_pair

    dev = torch.device("cuda")
    cases = [("icp", "gn", ICP_POINTS, {}), ("icp", "lm", ICP_POINTS, {}),
             ("gicp", "lm", ICP_POINTS, {})] + [
        ("vgicp", "lm", n, dict(voxel_size=1.0, knn_method="grid")) for n in VGICP_POINTS]
    for method, opt, n0, extra in cases:
        sizes = [n0 + k * STREAM_STEP for k in range(STREAM_CLOUDS)]
        pairs = []
        for n in sizes:
            src, tgt, _ = registration_pair(n, seed=n)
            pairs.append((fd.cloud.from_numpy(src, device=dev),
                          fd.cloud.from_numpy(tgt, device=dev)))
        kw = dict(method=method, optimizer=opt, **extra)
        results, times, counts = {}, {"host": [], "fused": []}, {}
        for way in ("host", "fused", "fused", "host"):
            for k, (s_c, t_c) in enumerate(pairs):
                reg.host_reads = reg.passes_run = reg.passes_used = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = reg.align(s_c, t_c, driver=way, **kw)
                torch.cuda.synchronize()
                times[way].append((time.perf_counter() - t0) * 1e3)
                counts[way, k] = (reg.host_reads, reg.passes_run, reg.passes_used)
                prev = results.setdefault(k, r)
                same = (np.array_equal(r.T.view(np.int32), prev.T.view(np.int32))
                        and (r.error, r.iterations, r.converged, r.num_correspondences)
                        == (prev.error, prev.iterations, prev.converged,
                            prev.num_correspondences))
                if not same:
                    raise AssertionError(f"{ph} align {method} {sizes[k]} ({opt}) {way}: "
                                         "differs from the host loop")
        for k, n in enumerate(sizes):
            (h_reads, _, h_passes), (reads, run, used) = counts["host", k], counts["fused", k]
            print(f"{ph} align {method} {n} ({opt}): {results[k].iterations} iterations, "
                  f"converged {results[k].converged}, {h_passes} correspondence passes; fused "
                  f"bit for bit with the host loop; host reads per align host {h_reads}, fused "
                  f"{reads}; fused passes run {run} (masked after done {run - used})")
            if used != h_passes or run != used or reads != used:
                raise AssertionError(f"{ph} align {method} {n}: fused passes off")
        print(f"{ph} align {method} {n0}+ ({opt}) stream of {STREAM_CLOUDS} distinct pairs, "
              f"every call cold, turns host / fused / fused / host: ms per align host "
              f"{times['host']!r}, fused {times['fused']!r}; medians host "
              f"{float(np.median(times['host']))!r}, fused {float(np.median(times['fused']))!r} "
              f"on {card}")
        del pairs
    torch.cuda.empty_cache()


def cluster_stream(card, ph):
    """euclidean_cluster's sweep blocks against the plain per-sweep loop on
    distinct clouds near each size, every call cold. Turns loop, blocks,
    blocks, loop."""
    from fastdem_tpu_torch.cloud import segmentation as segm
    from fastdem_tpu_torch.tools.common import make_cloud_np

    dev = torch.device("cuda")
    for n0 in CLUSTER_POINTS:
        clouds = []
        for k in range(STREAM_CLOUDS):
            n = n0 + k * STREAM_STEP
            xyz = make_cloud_np(n, np.random.default_rng(n), spread=20.0 * (n / 100_000) ** 0.5)
            clouds.append(fd.cloud.from_numpy(xyz, device=dev))
        labels, times, counts = {}, {"loop": [], "blocks": []}, {}
        for way in ("loop", "blocks", "blocks", "loop"):
            for k, cloud in enumerate(clouds):
                segm.host_reads = segm.sweeps = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if way == "loop":
                    got, loop_sweeps = cluster_per_sweep(cloud, tolerance=0.5)
                else:
                    got = segm.euclidean_cluster(cloud, tolerance=0.5)
                torch.cuda.synchronize()
                times[way].append((time.perf_counter() - t0) * 1e3)
                counts[way, k] = ((loop_sweeps, loop_sweeps) if way == "loop"
                                  else (segm.host_reads, segm.sweeps))
                if not torch.equal(labels.setdefault(k, got), got):
                    raise AssertionError(f"{ph} euclidean_cluster {cloud.capacity}: the sweep "
                                         "blocks differ from the per-sweep loop")
        for k, cloud in enumerate(clouds):
            (l_reads, l_sweeps), (reads, sweeps) = counts["loop", k], counts["blocks", k]
            print(f"{ph} euclidean_cluster {cloud.capacity} points: {sweeps} sweeps "
                  f"({l_sweeps} in the loop), host reads blocks {reads} / loop {l_reads}, "
                  f"{int(labels[k].max()) + 1} clusters, labels equal")
            if sweeps != l_sweeps:
                raise AssertionError(f"{ph} euclidean_cluster: sweeps off")
        print(f"{ph} euclidean_cluster {n0}+ stream of {STREAM_CLOUDS} distinct clouds, every "
              f"call cold, turns loop / blocks / blocks / loop: ms loop {times['loop']!r}, "
              f"blocks {times['blocks']!r}; medians loop {float(np.median(times['loop']))!r}, "
              f"blocks {float(np.median(times['blocks']))!r} on {card}")
        del clouds, labels
    torch.cuda.empty_cache()


def phase_last_programs(card):
    """Phase 23: the block-sharded step and sequence and LOCAL's fallback
    as CUDA graphs against their eager form, two processes and the scaling
    report compiled, registration's fused driver against its host loop and
    clustering's sweep blocks against the per-sweep loop. Returns the K1
    and K4 launches of the graph runs."""
    import tempfile

    from fastdem_tpu_torch.io.npz import save_npz
    from fastdem_tpu_torch.parallel import sharding as sh
    from fastdem_tpu_torch.parallel.distributed import scaling_report

    ph = "phase 23"
    dev = torch.device("cuda")
    mesh = sh.make_mesh(4, shape=(2, 2), devices=["cuda"])
    ggeom, gcfg = global_geom(), global_config()

    # ---- a. the windowed step: 32 scans, 2x2 on the card ----
    gscans, gT_bs, gposes = global_session_scans(SHARD_GRAPH_SCANS, seed=89)
    l1, l4, gstep = sharded_graph_path("sharded windowed 2x2", card, mesh, ggeom, gcfg,
                                       gscans, gT_bs, gposes)

    # ---- b. the sequence: K scans as one graph ----
    K = SHARD_SEQ_K
    XS = torch.tensor(np.asarray(gscans[:K]), device=dev)
    PS = torch.tensor(np.stack(gposes[:K]), device=dev)
    TB = torch.tensor(gT_bs, device=dev)
    MS = torch.ones((K, N_POINTS), dtype=torch.bool, device=dev)
    seqs = {"eager": sh.build_sharded_integrate_sequence(ggeom, gcfg, mesh, jit=False)[0],
            "graph": sh.build_sharded_integrate_sequence(ggeom, gcfg, mesh)[0]}

    def seq_run(fn):
        return fn(sh.shard_state(fd.create_map_state(ggeom, gcfg, device="cuda"), mesh),
                  XS, MS, TB, PS)

    ref = seq_run(seqs["eager"])
    for call in range(2):
        torch.cuda.synchronize()
        k1.launches = k4.launches = 0
        got = seq_run(seqs["graph"])
        torch.cuda.synchronize()
        print(f"{ph} sharded sequence K = {K} ({seqs['graph'].compiled}), call {call + 1}: K1 "
              f"launches {k1.launches}, K4 launches {k4.launches} per replay")
        if (k1.launches, k4.launches) != (K, 4 * K):
            raise AssertionError(f"{ph} sequence: want K1 {K} and K4 {4 * K} per replay")
        l1, l4 = l1 + k1.launches, l4 + k4.launches
        assert_bitwise(f"{ph} sharded sequence graph == eager", sh.gather_state(ref),
                       sh.gather_state(got))
    loop = sh.shard_state(fd.create_map_state(ggeom, gcfg, device="cuda"), mesh)
    for k in range(K):
        loop, _ = gstep(loop, XS[k], MS[k], TB, PS[k])
    assert_bitwise(f"{ph} sharded sequence graph == the graph step loop",
                   sh.gather_state(loop), sh.gather_state(got))
    del ref, got, loop
    graph_turns(f"sharded sequence K = {K}", {k: (lambda f=f: seq_run(f)) for k, f in seqs.items()},
                card, K, phase=ph)
    for k, fn in seqs.items():
        counts = {}
        k1.launches = k4.launches = 0
        ms, events, _ = device_profile(lambda fn=fn: seq_run(fn), 1, counts=counts)
        print(f"{ph} sharded sequence K = {K} {k}: {events / K!r} device events per scan, "
              f"{ms / K!r} device ms per scan (torch.profiler over one call) on {card}")
        kernels_seen(f"sharded sequence {k}", counts, (k1.launches, k4.launches), phase=ph)
    for g in seqs["graph"].per_device.values():
        graph_stats(f"sharded sequence K = {K}", g, card, phase=ph)
    del seqs
    torch.cuda.empty_cache()

    # ---- c. LOCAL's fallback on the flagship map, moves across blocks ----
    lscans, lT_bs, lposes = make_session(SHARD_GRAPH_SCANS, seed=97)
    a1, a4, _ = sharded_graph_path("sharded LOCAL fallback 2x2 (flagship)", card, mesh,
                                   flagship_geom(), flagship_config(), lscans, lT_bs, lposes)
    l1, l4 = l1 + a1, l4 + a4
    cells = np.round((np.asarray(lposes)[-1][:2, 3] - np.asarray(lposes)[0][:2, 3]) / 0.1)
    print(f"{ph} sharded LOCAL fallback: the map moved {cells.tolist()} cells over the session "
          f"(blocks of 75x75 cells)")
    torch.cuda.empty_cache()

    # ---- d. two gloo processes, the compiled sequence, against one process ----
    with tempfile.TemporaryDirectory() as tmp:
        scans_npz, mh, one = (os.path.join(tmp, f) for f in ("scans.npz", "mh.npz", "one.npz"))
        np.savez(scans_npz, xyz=np.asarray(gscans[:K]), T_bs=gT_bs, T_wb=np.stack(gposes[:K]))
        t0 = time.perf_counter()
        logs = run_worker_pair(
            ["--local-blocks", "2", "--scans-npz", scans_npz, "--batched", "1",
             "--map-size", repr(ggeom.rows * ggeom.resolution),
             "--resolution", repr(ggeom.resolution), "--range", repr(GLOBAL_RANGE),
             "--out", mh, "--device", "cuda"], TOOL_TIMEOUT_S)
        print(f"{ph} two gloo processes, the compiled sequence: "
              f"{time.perf_counter() - t0!r} s wall")
        lines = [ln for log in logs for ln in log.splitlines() if ln.startswith("[mh]")]
        print("\n".join(lines))
        if sum("(whole)" in ln for ln in lines) != 2:
            raise AssertionError(f"{ph}: the workers did not run whole-scan graphs")
        state = sh.shard_state(fd.create_map_state(ggeom, gcfg, device="cuda"), mesh)
        for k in range(K):
            state, _ = gstep(state, XS[k], MS[k], TB, PS[k])
        if not save_npz(one, ggeom, sh.gather_state(state)):
            raise AssertionError(f"{ph}: save_npz failed")
        with open(mh, "rb") as f1, open(one, "rb") as f2:
            same = f1.read() == f2.read()
        print(f"{ph} two-process compiled save_sharded_npz == save_npz of the one-process "
              f"compiled map, byte for byte: {same} ({os.path.getsize(mh)} bytes)")
        if not same:
            raise AssertionError(f"{ph}: the two-process map differs")
    del state, gstep
    torch.cuda.empty_cache()

    # ---- e. the scaling report, both sides compiled ----
    for mode, geom in (("strong", ggeom),
                       ("weak", fd.GridGeometry.from_length(100.0, 100.0, 0.1))):
        rep = scaling_report(geom, gcfg, scans=SHARD_SCANS, points=N_POINTS, mode=mode,
                             mesh=mesh, device="cuda")
        print(f"{ph} scaling_report {mode}, both sides compiled, 4 blocks on one card (an "
              f"overhead probe): {json.dumps(rep)} on {card}")
        if rep["compiled"] != "whole":
            raise AssertionError(f"{ph}: the scaling report's sharded side is not compiled")
    torch.cuda.empty_cache()

    # ---- f. registration: the fused driver against the host loop ----
    align_stream(card, ph)

    # ---- g. clustering: blocks of sweeps against the per-sweep loop ----
    cluster_stream(card, ph)
    return l1, l4


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
    cuda_build.build(k1.SOURCE, k4.SOURCE)
    k1.library()
    k4.library()
    print(f"K1 + K4 build+load: {time.perf_counter() - t0!r} s wall (parallel nvcc)")
    for src in (k1.SOURCE, k4.SOURCE):
        secs = cuda_build.build_seconds.get(src.name)
        print(f"{src.name}: " + (f"built in {secs!r} s" if secs is not None else "cached"))
        if src.name in cuda_build.build_logs:
            print(cuda_build.build_logs[src.name].strip())

    # ---- 3.-5. kernels against their twins ----
    k1_err, k1_ms = phase_k1(card)
    k4_err, k4_ms = phase_k4(card)
    phase_exact_window()
    torch.cuda.synchronize()

    launches = {"K1": 0, "K4": 0}

    def add_launches(l1, l4):
        launches["K1"] += l1
        launches["K4"] += l4

    # ---- 6. flagship main path, and the same scans on the CPU ----
    geom = flagship_geom()
    scans, T_bs, poses = make_session(N_SCANS, seed=7)
    gpu, l1, l4 = drive("flagship", "cuda", geom, flagship_config(), scans, T_bs, poses)
    add_launches(l1, l4)
    check_map("flagship", geom, gpu, "kalman", 17000)
    cpu, _ = run_session("cpu", geom, flagship_config(), scans, T_bs, poses)
    check_parity("flagship", cpu.state, gpu.state)

    # ---- 7. GLOBAL 200 m windowed map ----
    ggeom = global_geom()
    gscans, gT_bs, gposes = global_session_scans(N_SCANS, seed=17)
    ggpu, l1, l4 = drive("global", "cuda", ggeom, global_config(), gscans, gT_bs, gposes)
    add_launches(l1, l4)
    check_map("global", ggeom, ggpu, "kalman", 80000)
    gcpu, _ = run_session("cpu", ggeom, global_config(), gscans, gT_bs, gposes)
    check_parity("global", gcpu.state, ggpu.state)
    del gcpu

    # ---- 8. windowed == full on the card ----
    phase_window_equals_full()

    # ---- 9. P^2 flagship ----
    pgpu, l1, l4 = drive("p2 flagship", "cuda", geom, flagship_config("p2"), scans,
                         T_bs, poses)
    add_launches(l1, l4)
    check_map("p2 flagship", geom, pgpu, "p2", 17000)
    pcpu, _ = run_session("cpu", geom, flagship_config("p2"), scans, T_bs, poses)
    check_parity("p2 flagship", pcpu.state, pgpu.state)

    # ---- 10. time ----
    for label, n in resample_indices_events().items():
        print(f"resample_indices ({label}): {n!r} device events per call, the index "
              "math K4 now computes in its kernel")
    for what, g, cfg, seed, fn in (
        ("global kalman", ggeom, global_config(), 19, global_session_scans),
        ("flagship p2", geom, flagship_config("p2"), 11, make_session),
        ("flagship kalman", geom, flagship_config(), 11, make_session),
    ):
        ms = chain_ms(g, cfg, seed, lambda n, s, fn=fn: fn(n, s))
        print(f"{what}: {ms!r} ms/scan over a {CHAIN}-scan chain "
              f"(FastDEM.integrate, CUDA events) on {card}")
        events, dev_ms = scan_profile(g, cfg, seed, lambda n, s, fn=fn: fn(n, s))
        print(f"{what}: {events!r} device events per scan, {dev_ms!r} device ms per "
              f"scan (torch.profiler over {EVENT_SCANS} scans) on {card}")

    # ---- 11. postprocess chain, card against CPU, and its cost ----
    phase_postprocess(card, gpu.state, ggpu.state)

    # ---- 12. the sampled raycast ----
    phase_sampled(card)

    # ---- 13. the mapping node ----
    add_launches(*phase_node(card))

    # ---- 14. batched replay ----
    add_launches(*phase_replay(card))

    # ---- 15. the batch DEM ----
    phase_batch_dem(card)

    # ---- 16. RGB-D ----
    add_launches(*phase_rgbd(card))

    # ---- 17. the repairs: sampled raycast on the GLOBAL map ----
    phase_sampled_global(card)

    # ---- 18. normals, segmentation, registration ----
    t0 = time.perf_counter()
    phase_cloud(card)
    print(f"phase 18: {time.perf_counter() - t0!r} s")

    # ---- 19. the native scan IO and the prefetch replay ----
    t0 = time.perf_counter()
    add_launches(*phase_native_io(card))
    print(f"phase 19: {time.perf_counter() - t0!r} s")

    # ---- 20. the block-sharded GLOBAL map, two processes, cold start ----
    t0 = time.perf_counter()
    add_launches(*phase_sharded(card))
    print(f"phase 20: {time.perf_counter() - t0!r} s")

    # ---- 21. packed / twophase / sort, the switch to packed, the batched
    # replay step ----
    t0 = time.perf_counter()
    add_launches(*phase_scatter_modes(card))
    add_launches(*phase_batched_replay(card))
    print(f"phase 21: {time.perf_counter() - t0!r} s")

    # ---- 22. the compiled step: CUDA graphs against the eager step ----
    t0 = time.perf_counter()
    add_launches(*phase_graphs(card, gpu.state, ggpu.state))
    print(f"phase 22: {time.perf_counter() - t0!r} s")

    # ---- 23. the last compiled programs: the sharded step and sequence,
    # registration's fused driver, clustering's sweep blocks ----
    t0 = time.perf_counter()
    add_launches(*phase_last_programs(card))
    print(f"phase 23: {time.perf_counter() - t0!r} s")

    k1_main = k1_ms["flagship"]
    k4_main = k4_ms["global"]
    print(json.dumps({"kernels": [
        {
            "name": "polar_field (K1)",
            "route": "cuda",
            "source": "fastdem_tpu_torch/csrc/polar_field.cu",
            "replaces": "fastdem_tpu/ops/pallas_polar.py:49",
            "launches": launches["K1"],
            "max_abs_err": k1_err,
            "ms": k1_main["ms"],
            "plain_ms": k1_main["plain_ms"],
            "bound_ms": k1_main["bound_ms"],
            "bound_by": k1_main["bound_by"],
            "library_ms": None,
        },
        {
            "name": "resample (K4, with its index math)",
            "route": "cuda",
            "source": "fastdem_tpu_torch/csrc/resample.cu",
            "replaces": "fastdem_tpu/ops/pallas_resample.py:36",
            "launches": launches["K4"],
            "max_abs_err": k4_err,
            "ms": k4_main["ms"],
            "plain_ms": k4_main["plain_ms"],
            "bound_ms": k4_main["bound_ms"],
            "bound_by": k4_main["bound_by"],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
