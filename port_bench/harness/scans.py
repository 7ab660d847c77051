"""The benchmark's scan generator: a sensor driven along a trajectory
through a seeded scene, as one log of scans.

The sensor is the configuration's ``sensor`` group; its ``generator`` names
the file ``sensors/<generator>.py`` that says which rays the sensor casts
(``directions(sensor)``: unit vectors in the sensor frame) and what it
delivers of their hits (``returns(t, directions, sensor, gen)``: the points
and which rays return). A new sensor is a new file there. Every sensor has
a ``max_range_m`` and a ``height_m`` above the base.

The scene (the ``scene`` group) is a smooth heightfield (a sum of
``terrain_waves`` plane waves) with ``boxes`` axis-aligned boxes standing
on it, scattered around the trajectory but clear of it, so that rays above
the horizon hit something too. The base rides on the terrain with small
roll and pitch.

The trajectory (the traffic's ``motion`` group) is odometry sampled at
``odometry_hz``; each scan is stamped ``stamp_offset_ms`` after an odometry
sample, and its pose is the odometry buffer's interpolation there
(``poses.lookup``), so the node, which looks poses up in its buffer, and the
replay loop, which is handed them, integrate the same poses.

Every number comes from ``seed``: the scene and the trajectory from a numpy
generator on the host, the sensor's noise from a ``torch.Generator`` on the
device the rays are cast on. Rays are cast in chunks of scans with a march
along each ray against the heightfield (secant refined) and a slab test
against every box.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from . import poses
from .parts import part

# First scan stamp; a stamp of 0 means "latest" to the odometry buffer.
T0_NS = 1_000_000_000
# Ray march samples: geometric from MARCH_T0 metres to the sensor's range.
MARCH_T0 = 0.3
MARCH_GROWTH = 1.025
# Box hits closer than this to the sensor are ignored (a box the sensor
# sits in).
BOX_T_MIN = 0.05


@dataclasses.dataclass
class Log:
    xyz: List[np.ndarray]  # per scan, f32 [N_k, 3], sensor frame
    T_wb: np.ndarray  # f32 [n, 4, 4], the scans' poses (world <- base)
    T_bs: np.ndarray  # f32 [4, 4], base <- sensor
    stamps_ns: np.ndarray  # int64 [n]
    odom_ns: np.ndarray  # int64 [m]
    odom_T: np.ndarray  # f64 [m, 4, 4]

    def __len__(self) -> int:
        return len(self.xyz)

    def sizes(self) -> np.ndarray:
        return np.array([x.shape[0] for x in self.xyz], dtype=np.int64)


def _terrain(sc: dict, rng: np.random.Generator):
    """Plane waves (amplitude, kx, ky, phase) of the heightfield."""
    n = int(sc["terrain_waves"])
    amp = rng.uniform(*sc["terrain_amplitude_m"], size=n)
    wl = rng.uniform(*sc["terrain_wavelength_m"], size=n)
    ang = rng.uniform(0.0, 2 * math.pi, size=n)
    phase = rng.uniform(0.0, 2 * math.pi, size=n)
    k = 2 * math.pi / wl
    return np.stack([amp, k * np.cos(ang), k * np.sin(ang), phase], axis=1)


def height_np(waves: np.ndarray, x, y):
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    h = np.zeros(np.broadcast(x, y).shape)
    for a, kx, ky, ph in waves:
        h = h + a * np.sin(kx * x + ky * y + ph)
    return h


def _height_t(waves: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = torch.zeros_like(x)
    for i in range(waves.shape[0]):
        a, kx, ky, ph = waves[i]
        h = h + a * torch.sin(kx * x + ky * y + ph)
    return h


def trajectory(motion: dict, n_scans: int, rng: np.random.Generator, waves: np.ndarray):
    """Odometry samples (int64 ns, f64 [m, 4, 4]) covering ``n_scans``."""
    hz = float(motion["odometry_hz"])
    period_ns = int(round(1e9 / hz))
    scan_ns = int(round(1e9 / float(motion["scan_hz"])))
    t_end = T0_NS + n_scans * scan_ns + 2 * period_ns
    odom_ns = np.arange(T0_NS - 2 * period_ns, t_end + period_ns, period_ns, dtype=np.int64)
    t = (odom_ns - T0_NS).astype(np.float64) * 1e-9
    dt = period_ns * 1e-9
    yaw_amp = math.radians(float(motion["yaw_wave_deg"]))
    yaw_period = float(motion["yaw_period_s"])
    yaw = math.radians(float(motion["heading_deg"])) + yaw_amp * np.sin(
        2 * math.pi * t / yaw_period + rng.uniform(0, 2 * math.pi)
    )
    v = float(motion["speed_mps"])
    x = float(motion["start_xy"][0]) + np.concatenate([[0.0], np.cumsum(v * np.cos(yaw[:-1]) * dt)])
    y = float(motion["start_xy"][1]) + np.concatenate([[0.0], np.cumsum(v * np.sin(yaw[:-1]) * dt)])
    rp = math.radians(float(motion["roll_pitch_deg"]))
    roll = rp * np.sin(2 * math.pi * t / 3.1 + rng.uniform(0, 2 * math.pi))
    pitch = rp * np.sin(2 * math.pi * t / 4.7 + rng.uniform(0, 2 * math.pi))
    T = np.tile(np.eye(4), (len(t), 1, 1))
    T[:, :3, :3] = poses.rpy_matrix(roll, pitch, yaw)
    T[:, 0, 3], T[:, 1, 3] = x, y
    T[:, 2, 3] = height_np(waves, x, y)
    return odom_ns, T


def _boxes(sc: dict, rng: np.random.Generator, waves: np.ndarray, path_xy: np.ndarray):
    """Boxes (lo [B, 3], hi [B, 3]) around the path, none within the path's
    clearance."""
    n = int(sc["boxes"])
    m = float(sc["margin_m"])
    lo_xy, hi_xy = path_xy.min(axis=0) - m, path_xy.max(axis=0) + m
    clear = float(sc["path_clearance_m"])
    centres = []
    while len(centres) < n:
        c = rng.uniform(lo_xy, hi_xy, size=(4 * n, 2))
        half = rng.uniform(*sc["box_width_m"], size=(4 * n, 2)) / 2
        d = np.min(
            np.linalg.norm(c[:, None, :] - path_xy[None, ::10, :], axis=2), axis=1
        ) - np.linalg.norm(half, axis=1)
        for ci, hi in zip(c[d > clear], half[d > clear]):
            centres.append((ci, hi))
    c = np.array([ci for ci, _ in centres[:n]])
    half = np.array([hi for _, hi in centres[:n]])
    ground = height_np(waves, c[:, 0], c[:, 1])
    top = ground + rng.uniform(*sc["box_height_m"], size=n)
    lo = np.concatenate([c - half, (ground - 0.5)[:, None]], axis=1)
    hi = np.concatenate([c + half, top[:, None]], axis=1)
    return lo, hi


def make_log(config: dict, traffic: dict, seed: int, device, chunk: int = 4) -> Log:
    """The log of ``traffic["log_scans"]`` scans for ``seed``."""
    sensor, scene, motion = config["sensor"], config["scene"], traffic["motion"]
    generator = part("sensors", sensor["generator"])
    n = int(traffic["log_scans"])
    rng = np.random.default_rng(seed)
    waves = _terrain(scene, rng)
    odom_ns, odom_T = trajectory(motion, n, rng, waves)
    scan_ns = int(round(1e9 / float(motion["scan_hz"])))
    stamps = T0_NS + np.arange(n, dtype=np.int64) * scan_ns + int(
        round(float(motion["stamp_offset_ms"]) * 1e6)
    )
    T_wb = np.stack([poses.lookup(odom_ns, odom_T, int(s)) for s in stamps])
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = float(sensor["height_m"])
    lo, hi = _boxes(scene, rng, waves, odom_T[:, :2, 3])

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    f32 = dict(dtype=torch.float32, device=dev)
    d_s = torch.as_tensor(generator.directions(sensor), **f32)
    waves_t = torch.as_tensor(waves, **f32)
    lo_t, hi_t = torch.as_tensor(lo, **f32), torch.as_tensor(hi, **f32)
    rmax = float(sensor["max_range_m"])
    k = int(math.ceil(math.log(rmax / MARCH_T0) / math.log(MARCH_GROWTH))) + 1
    t_s = torch.as_tensor(MARCH_T0 * MARCH_GROWTH ** np.arange(k), **f32).clamp_(max=rmax)
    T_ws = torch.as_tensor(T_wb.astype(np.float64) @ T_bs.astype(np.float64), **f32)

    pts, counts = [], []
    for c0 in range(0, n, chunk):
        Tw = T_ws[c0:c0 + chunk]
        o = Tw[:, None, :3, 3]  # [c, 1, 3]
        d = torch.einsum("cij,mj->cmi", Tw[:, :3, :3], d_s)  # [c, M, 3]
        # Ground: the first march sample below the terrain, secant refined.
        p = o[:, :, None, :] + d[:, :, None, :] * t_s[None, None, :, None]
        f = p[..., 2] - _height_t(waves_t, p[..., 0], p[..., 1])  # [c, M, K]
        below = f < 0
        hit = below.any(dim=2)
        first = torch.argmax(below.to(torch.int8), dim=2).clamp_(min=1)
        f1 = torch.gather(f, 2, first[..., None])[..., 0]
        f0 = torch.gather(f, 2, (first - 1)[..., None])[..., 0]
        t1, t0 = t_s[first], t_s[first - 1]
        t_ground = t0 + (t1 - t0) * f0 / (f0 - f1)
        t_ground = torch.where(hit, t_ground, torch.inf)
        del p, f, below
        # Boxes: the slab test, the nearest entry.
        inv = 1.0 / d
        t_box = torch.full_like(t_ground, torch.inf)
        for b0 in range(0, lo_t.shape[0], 64):
            a = (lo_t[None, None, b0:b0 + 64] - o[:, :, None, :]) * inv[:, :, None, :]
            b = (hi_t[None, None, b0:b0 + 64] - o[:, :, None, :]) * inv[:, :, None, :]
            tmin = torch.minimum(a, b).amax(dim=3)
            tmax = torch.maximum(a, b).amin(dim=3)
            ok = (tmax >= tmin) & (tmin > BOX_T_MIN)
            t_box = torch.minimum(t_box, torch.where(ok, tmin, torch.inf).amin(dim=2))
        xyz, keep = generator.returns(torch.minimum(t_ground, t_box), d_s, sensor, gen)
        for i in range(xyz.shape[0]):
            pts.append(xyz[i][keep[i]])
            counts.append(int(keep[i].sum()))
    flat = torch.cat(pts).cpu().numpy()
    xyz = np.split(flat, np.cumsum(counts)[:-1])
    return Log(xyz=xyz, T_wb=T_wb.astype(np.float32), T_bs=T_bs, stamps_ns=stamps,
               odom_ns=odom_ns, odom_T=odom_T)


def in_map_counts(log: Log, half_extent_xy, centred: bool) -> np.ndarray:
    """Points per scan whose world xy lies within ``half_extent_xy`` of the
    robot (``centred``, a LOCAL map) or of the origin (a GLOBAL map)."""
    out = []
    for xyz, T in zip(log.xyz, log.T_wb.astype(np.float64) @ log.T_bs.astype(np.float64)):
        w = xyz.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        c = T[:2, 3] if centred else np.zeros(2)
        inside = (np.abs(w[:, 0] - c[0]) < half_extent_xy[0]) & (np.abs(w[:, 1] - c[1]) < half_extent_xy[1])
        out.append(int(inside.sum()))
    return np.array(out, dtype=np.int64)
