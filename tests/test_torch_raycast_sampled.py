"""The port's sampled raycast against the JAX package, on the CPU.

``ray_min_height_sampled`` mirrors the reference's jitted form (the form
its pipeline runs): the same touched set and the same heights, bit for bit,
on the LiDAR scenes of ``tests/test_kernels_parity.py``. The port's polar
path (K1's and K4's plain twins here) keeps the reference's properties
against this oracle, and a session through ``build_integrate`` with
``raycasting.method = "sampled"`` matches JAX's with the decision layers
(touched, ghost removal, point counts, the elevation NaN set) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.postprocess import raycasting as ray_j
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.ops import polar_field as k1
from fastdem_tpu_torch.ops import resample as k4
from fastdem_tpu_torch.postprocess import raycasting as ray_t
from test_kernels_parity import lidar_scene
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

POS = np.zeros(2, np.float32)


def scene(rng, n=4000):
    xyz, mask, _, _ = lidar_scene(rng, n=n)
    return np.asarray(xyz), np.asarray(mask)


@pytest.mark.parametrize("num_samples", [1200, None])
def test_sampled_matches_jax(rng, num_samples):
    gj, gt = GeomJ.from_length(12.0, 12.0, 0.1), GeomT.from_length(12.0, 12.0, 0.1)
    xyz, mask = scene(rng)
    origin = np.array([0.3, -0.2, 0.8], np.float32)
    h_j, t_j = jax.jit(ray_j.ray_min_height_sampled, static_argnums=(0, 5))(
        gj, POS, xyz, mask, origin, num_samples)
    h_t, t_t = ray_t.ray_min_height_sampled(
        gt, torch.tensor(POS), torch.tensor(xyz), torch.tensor(mask),
        torch.tensor(origin), num_samples)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=1e-6)
    assert t_t.sum() > 10000


def test_polar_properties_against_sampled(rng):
    """``TestRaycastParity`` on the port: on cells both touch, the 90th
    percentile of |polar - sampled| is below 0.1 m and fewer than 4% read
    more than 0.15 m above the oracle; polar covers > 97% of the oracle's
    cells (origin at the map centre)."""
    g = GeomT.from_length(12.0, 12.0, 0.1)
    pos = torch.tensor(POS)
    xyz, mask = scene(rng)
    xyz, mask = torch.tensor(xyz), torch.tensor(mask)
    launches = (k1.launches, k4.launches)
    origin = torch.tensor([0.3, -0.2, 0.8])
    h_p, t_p = ray_t.ray_min_height_polar(g, pos, xyz, mask, origin)
    h_s, t_s = ray_t.ray_min_height_sampled(g, pos, xyz, mask, origin, num_samples=1200)
    both = t_p & t_s
    assert both.sum() > 1000
    diff = (h_p[both] - h_s[both]).numpy()
    assert np.percentile(np.abs(diff), 90) < 0.1
    assert (diff > 0.15).mean() < 0.04
    origin = torch.tensor([0.0, 0.0, 0.8])
    _, t_p = ray_t.ray_min_height_polar(g, pos, xyz, mask, origin)
    _, t_s = ray_t.ray_min_height_sampled(g, pos, xyz, mask, origin, num_samples=1200)
    assert t_p[t_s].float().mean() > 0.97
    # The CPU path ran the kernels' plain twins only.
    assert (k1.launches, k4.launches) == launches


def sampled_config(pkg):
    cfg = pkg.Config()
    cfg.raycasting.enabled = True
    cfg.raycasting.method = "sampled"
    return cfg


def test_sampled_session_matches_jax():
    geom_j = fj.GridGeometry.from_length(8.0, 8.0, 0.1)
    geom_t = ft.GridGeometry.from_length(8.0, 8.0, 0.1)
    mj = fj.FastDEM(geom_j, sampled_config(fj))
    mt = ft.FastDEM(geom_t, sampled_config(ft), device="cpu")
    rng = np.random.default_rng(21)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 0.9
    from fastdem_tpu.cloud import pointcloud as pc_j

    for k in range(4):
        n = 6000
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.4, 3.8, n)
        x, y = rad * np.cos(ang), rad * np.sin(ang)
        z = 0.2 * np.sin(x) * np.cos(y) - 0.9 + rng.normal(0, 0.02, n)
        # A few floating points leave ghosts for later scans to clear.
        z[:60] += 0.6
        xyz = np.column_stack([x, y, z]).astype(np.float32)
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3], T_wb[1, 3] = 0.11 * k, -0.07 * k
        assert mj.integrate(pc_j.from_numpy(xyz, frame_id="lidar"), T_bs, T_wb)
        assert mt.integrate(ft.cloud.from_numpy(xyz, frame_id="lidar", device="cpu"), T_bs,
                            T_wb)
    assert mt.last_aux.oow_points is None  # the window stays off
    lj, lt = mj.state.layers, mt.state.layers
    assert set(lj) == set(lt)
    for name in ("n_points", "ghost_removal", "obstacle", "elevation_min", "elevation_max"):
        np.testing.assert_array_equal(lt[name].numpy(), np.asarray(lj[name]), err_msg=name)
    for name in ("raycasting", "elevation", "_visibility_logodds"):
        np.testing.assert_array_equal(np.isnan(lt[name].numpy()), np.isnan(np.asarray(lj[name])),
                                      err_msg=name)
    for name, ref in lj.items():
        np.testing.assert_allclose(lt[name].numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=name)
    assert torch.isfinite(lt["raycasting"]).sum() > 3000
