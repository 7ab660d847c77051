"""The port's windowed map update (``window_update``) against its full-map
update and against the JAX package.

The cases of ``tests/test_window_update.py`` on the port: on maps larger
than the scan's reach the rasterizer and the whole map update run on a
sensor-centred window and are written back, and every layer, the aux
observations and the position must equal the full-map path's bit for bit.
Then windowed GLOBAL sessions of the port are held against JAX's at the
session tolerances of ``tests/test_torch_pipeline.py`` (rtol 1e-5, atol
1e-6 on >= 99.9% of cells, ``n_points`` and the elevation NaN set exact).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.mapping import pipeline as pl_j
from fastdem_tpu_torch.cloud.pointcloud import from_numpy
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

ESTIMATORS = ["kalman", "p2"]


def config(pkg, mode="GLOBAL", est="kalman", raycast=True, **point_filter):
    cfg = pkg.Config()
    cfg.mapping.mode = getattr(pkg.MappingMode, mode)
    cfg.mapping.estimation_type = (
        pkg.EstimationType.P2_QUANTILE if est == "p2" else pkg.EstimationType.KALMAN
    )
    cfg.raycasting.enabled = raycast
    cfg.point_filter.range_max = 6.0
    for k, v in point_filter.items():
        setattr(cfg.point_filter, k, v)
    return cfg


def scans(K=5, N=4096, step_x=2.0, x0=-4.0, seed=0):
    """The scan stream of ``tests/test_window_update.py::_run``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(K):
        ang = rng.uniform(0, 2 * np.pi, N)
        rad = rng.uniform(0.5, 5.8, N)
        px = x0 + step_x * k
        x, y = rad * np.cos(ang), rad * np.sin(ang)
        z = 0.2 * np.sin(0.6 * (x + px)) * np.cos(0.5 * y) - 1.0 + rng.normal(0, 0.02, N)
        xyz = np.stack([x, y, z], -1).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = px
        mask = np.ones(N, bool)
        mask[:37] = False
        out.append((xyz, mask, pose, rng.random(N).astype(np.float32)))
    return out


T_BS = np.eye(4, dtype=np.float32)
T_BS[2, 3] = 1.0


def run_port(geom, cfg, window_update, stream, **kw):
    step = ft.build_integrate(geom, cfg, has_intensity=True,
                              window_update=window_update, device="cpu", **kw)
    s = ft.create_map_state(geom, cfg, has_intensity=True, device="cpu")
    aux = None
    for xyz, mask, pose, inten in stream:
        s, aux = step(s, torch.tensor(xyz), torch.tensor(mask), torch.tensor(T_BS),
                      torch.tensor(pose), torch.tensor(inten))
    return s, aux


def run_jax(geom, cfg, window_update, stream):
    step = pl_j.build_integrate(geom, cfg, has_intensity=True, donate=False,
                                window_update=window_update)
    s = pl_j.create_map_state(geom, cfg, has_intensity=True)
    for xyz, mask, pose, inten in stream:
        s, _ = step(s, jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(T_BS),
                    jnp.asarray(pose), jnp.asarray(inten))
    return s


def assert_exact(s1, a1, s2, a2):
    assert set(s1.layers) == set(s2.layers)
    for k in s1.layers:
        np.testing.assert_array_equal(s1.layers[k].numpy(), s2.layers[k].numpy(),
                                      err_msg=f"layer {k}")
    np.testing.assert_array_equal(s1.position.numpy(), s2.position.numpy())
    for f in ("min_z", "min_z_var", "max_z", "touched", "max_intensity", "voxel_count"):
        va, vb = getattr(a1.obs, f), getattr(a2.obs, f)
        if va is None:
            assert vb is None
            continue
        np.testing.assert_array_equal(va.numpy(), vb.numpy(), err_msg=f"aux obs.{f}")


def geom40():
    return ft.GridGeometry.from_length(40.0, 40.0, 0.1)


@pytest.mark.parametrize("raycast", [False, True])
@pytest.mark.parametrize("est", ESTIMATORS)
def test_global_windowed_exact(raycast, est):
    cfg = config(ft, est=est, raycast=raycast)
    stream = scans()
    s1, a1 = run_port(geom40(), cfg, False, stream)
    s2, a2 = run_port(geom40(), cfg, None, stream)
    assert a1.oow_points is None and int(a2.oow_points) == 0
    assert a2.obs.touched.shape == geom40().shape
    assert_exact(s1, a1, s2, a2)
    assert (s2.layers["n_points"] > 0).sum() > 3000


def test_local_big_map_windowed_exact():
    """LOCAL: the window comes from the post-move position and the update
    runs after the roll."""
    cfg = config(ft, mode="LOCAL")
    stream = scans(step_x=1.3)
    s1, a1 = run_port(geom40(), cfg, False, stream)
    s2, a2 = run_port(geom40(), cfg, None, stream)
    assert_exact(s1, a1, s2, a2)


def test_small_map_auto_stays_full():
    """The window would cover most of the flagship 15 m map: no window."""
    geom = ft.GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg = ft.Config()
    cfg.raycasting.enabled = True
    s, aux = run_port(geom, cfg, None, scans(K=1))
    assert aux.oow_points is None


def test_small_ray_max_range_does_not_shrink_window():
    """raycasting.max_range bounds the polar field only; the update window
    derives from the point filter."""
    cfg = config(ft)
    cfg.raycasting.max_range = 3.0
    stream = scans()
    s1, a1 = run_port(geom40(), cfg, False, stream)
    s2, a2 = run_port(geom40(), cfg, None, stream)
    assert_exact(s1, a1, s2, a2)


def test_sensor_near_map_edge_windowed_exact():
    """Clipping the window at the map boundary changes nothing."""
    cfg = config(ft)
    stream = scans(x0=-18.5, step_x=1.0)
    s1, a1 = run_port(geom40(), cfg, False, stream)
    s2, a2 = run_port(geom40(), cfg, None, stream)
    assert_exact(s1, a1, s2, a2)


class TestExtrinsicMarginGuard:
    """A base->sensor offset beyond the built margin never drops points
    silently: the step counts them, the facade widens the margin."""

    def boom(self):
        T_bs = np.eye(4, dtype=np.float32)
        T_bs[0, 3] = 3.0
        T_bs[2, 3] = 1.0
        rng = np.random.default_rng(5)
        N = 4096
        ang = rng.uniform(0, 2 * np.pi, N)
        rad = rng.uniform(0.5, 5.8, N)
        xyz = np.stack([rad * np.cos(ang) - T_bs[0, 3], rad * np.sin(ang),
                        rng.normal(-2.0, 0.05, N)], -1).astype(np.float32)
        return T_bs, xyz

    def step_once(self, T_bs, xyz, **kw):
        geom, cfg = geom40(), config(ft, raycast=False)
        step = ft.build_integrate(geom, cfg, device="cpu", **kw)
        s = ft.create_map_state(geom, cfg, device="cpu")
        n = xyz.shape[0]
        return step(s, torch.tensor(xyz), torch.ones(n, dtype=torch.bool),
                    torch.tensor(T_bs), torch.eye(4))

    def test_oow_points_reported_and_zero_with_wide_margin(self):
        T_bs, xyz = self.boom()
        _, aux = self.step_once(T_bs, xyz, window_margin=0.0)
        assert int(aux.oow_points) > 0
        _, aux = self.step_once(T_bs, xyz, window_margin=4.0)
        assert int(aux.oow_points) == 0

    def test_widened_margin_matches_full_map(self):
        T_bs, xyz = self.boom()
        s1, _ = self.step_once(T_bs, xyz, window_update=False, window_margin=2.0)
        s2, _ = self.step_once(T_bs, xyz, window_update=None, window_margin=4.0)
        for k in s1.layers:
            np.testing.assert_array_equal(s1.layers[k].numpy(), s2.layers[k].numpy(),
                                          err_msg=f"layer {k}")

    def test_facade_widens_margin_on_boom_extrinsic(self, caplog):
        T_bs, xyz = self.boom()
        mapper = ft.FastDEM(geom40(), config(ft, raycast=False), device="cpu")
        assert mapper._window_margin == 2.0
        with caplog.at_level(logging.WARNING, logger="fastdem_tpu_torch"):
            assert mapper.integrate(from_numpy(xyz, device="cpu"), T_bs, np.eye(4))
        assert mapper._window_margin > 3.0
        assert any("window margin" in r.message for r in caplog.records)
        assert int(mapper.last_aux.oow_points) == 0

    def test_facade_backstop_reports_dropped_points(self, caplog):
        """A step built with a margin the extrinsic exceeds (what a dynamic
        extrinsic would do): the periodic read-back logs the drop."""
        T_bs, xyz = self.boom()
        T_bs[0, 3] = 1.4  # within the facade's 2 m margin: no widening
        mapper = ft.FastDEM(geom40(), config(ft, raycast=False), device="cpu")
        mapper._step = ft.build_integrate(mapper.geom, mapper.cfg, window_margin=0.0,
                                          device="cpu")
        mapper._oow_check_every = 1
        with caplog.at_level(logging.ERROR, logger="fastdem_tpu_torch"):
            assert mapper.integrate(from_numpy(xyz, device="cpu"), T_bs, np.eye(4))
        assert int(mapper.last_aux.oow_points) > 0
        assert any("OUTSIDE the update window" in r.message for r in caplog.records)


def layers_agree(layers_j, state_t, min_share=0.999):
    assert set(layers_j) == set(state_t.layers)
    for name, ref in layers_j.items():
        ref = np.asarray(ref)
        got = state_t.layers[name].numpy()
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
        assert close.mean() >= min_share, f"{name}: {np.count_nonzero(~close)} cells differ"
    np.testing.assert_array_equal(np.asarray(layers_j["n_points"]),
                                  state_t.layers["n_points"].numpy())
    np.testing.assert_array_equal(np.isnan(np.asarray(layers_j["elevation"])),
                                  torch.isnan(state_t.layers["elevation"]).numpy())


@pytest.mark.parametrize("est,mode", [("kalman", "GLOBAL"), ("p2", "GLOBAL"),
                                      ("kalman", "LOCAL")])
def test_windowed_session_matches_jax(est, mode):
    """The port's windowed session against JAX's windowed session."""
    stream = scans(K=6, step_x=1.3)
    geom_j = fj.GridGeometry.from_length(40.0, 40.0, 0.1)
    sj = run_jax(geom_j, config(fj, mode=mode, est=est), None, stream)
    st, aux = run_port(geom40(), config(ft, mode=mode, est=est), None, stream)
    assert int(aux.oow_points) == 0
    np.testing.assert_array_equal(np.asarray(sj.position), st.position.numpy())
    layers_agree(sj.layers, st)
    assert (st.layers["n_points"] > 0).sum() > 3000
