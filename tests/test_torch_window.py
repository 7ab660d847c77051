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
from test_torch_graphs import recorded  # noqa: F401 (fixture)
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


def raw_bits(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint8)


def assert_same_bits(s1, a1, s2, a2):
    """``assert_exact``, bit for bit (NaN payloads and signed zeros too)."""
    assert set(s1.layers) == set(s2.layers)
    for k in s1.layers:
        np.testing.assert_array_equal(raw_bits(s1.layers[k]), raw_bits(s2.layers[k]),
                                      err_msg=f"layer {k}")
    np.testing.assert_array_equal(raw_bits(s1.position), raw_bits(s2.position))
    for f in ("min_z", "min_z_var", "max_z", "touched", "max_intensity", "voxel_count"):
        va, vb = getattr(a1.obs, f), getattr(a2.obs, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(raw_bits(va), raw_bits(vb), err_msg=f"aux obs.{f}")


@pytest.mark.parametrize("raycast", [False, True])
@pytest.mark.parametrize("est", ESTIMATORS)
def test_donated_windowed_step_writes_its_slots_in_place(recorded, raycast, est):
    """The windowed GLOBAL step through ``build_integrate(jit=True,
    donate=True)`` on the graphs' recording double: after every scan the
    map and the aux observations equal the eager windowed step's and the
    full-map step's bit for bit; the returned layers are the graph's
    slots, written in place, so the graph copies no donated output into
    its slot; and the steps that do not own the state passed in (without
    ``donate``, and ``jit=False``) leave it as it was, bit for bit."""
    geom, cfg = geom40(), config(ft, est=est, raycast=raycast)

    def build(**kw):
        return ft.build_integrate(geom, cfg, has_intensity=True, device="cpu", **kw)

    steps = {"donated": build(), "not donated": build(donate=False),
             "eager": build(jit=False), "full map": build(window_update=False, jit=False)}
    states = {name: ft.create_map_state(geom, cfg, has_intensity=True, device="cpu")
              for name in steps}
    for xyz, mask, pose, inten in scans():
        args = tuple(torch.tensor(a) for a in (xyz, mask, T_BS, pose, inten))
        aux = {}
        for name, step in steps.items():
            held = states[name]
            kept = {k: v.clone() for k, v in held.layers.items()}
            states[name], aux[name] = step(held, *args)
            if name in ("not donated", "eager"):
                for k, v in kept.items():
                    np.testing.assert_array_equal(raw_bits(held.layers[k]), raw_bits(v),
                                                  err_msg=f"{name}: layer {k} passed in")
        for name in ("not donated", "eager", "full map"):
            assert_same_bits(states["donated"], aux["donated"], states[name], aux[name])
        (graph,) = steps["donated"].graphs.values()
        got = list(states["donated"].layers.values()) + [states["donated"].position]
        assert all(t is s for t, s in zip(got, graph.slots))
    assert int(aux["donated"].oow_points) == 0
    assert graph.stats.replays == len(scans())
    assert graph.stats.slot_copies_per_replay == graph.stats.slot_copies == 0
    assert (states["donated"].layers["n_points"] > 0).sum() > 3000


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
        mapper._map.step = ft.build_integrate(mapper.geom, mapper.cfg, window_margin=0.0,
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


def _rows_vs_packed_scans(rng, k_scans=3, n=10000):
    """Sensor-frame ring scans over a terrain, with near-ties in z
    (``test_torch_replay.near_ties``): point pairs 4 um apart in z, the
    higher one at the lower index."""
    from test_torch_replay import near_ties

    out = []
    for k in range(k_scans):
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, 8.0, n)
        x, y = rad * np.cos(ang), rad * np.sin(ang)
        z = 0.3 * np.sin(0.5 * x) - 1.0 + rng.normal(0, 0.02, n)
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.5 * k
        out.append((near_ties(np.column_stack([x, y, z]).astype(np.float32)), T))
    return out


def assert_layers_bitwise(layers_j, state_t):
    """Every layer equal to JAX's bit for bit (NaN sets exact; NaN
    payloads not compared)."""
    assert set(layers_j) == set(state_t.layers)
    for name, ref in layers_j.items():
        a, b = np.asarray(ref), state_t.layers[name].numpy()
        nan = np.isnan(a)
        np.testing.assert_array_equal(np.isnan(b), nan, err_msg=f"{name}: NaN set")
        np.testing.assert_array_equal(b[~nan].view(np.int32), a[~nan].view(np.int32),
                                      err_msg=name)


def test_rows_above_2_19_cells_against_jax_packed():
    """The smallest square map above 2^19 cells (725 x 725 at 0.1 m,
    GLOBAL, no window, raycast off): JAX's pipeline switches rows mode to
    ``rasterize_scatter_packed`` there, and so does the port, so every
    layer equals JAX's bit for bit.

    Before the port switched, its rows mode read the exact min from its
    own lane where packed mode takes the argmin point's z (among z within
    one quantum the lowest index wins): on these near-tie scans (20,000
    points each, every second point 4 um above its neighbour, 10,180
    mapped cells) ``elevation_min`` differed on 22.7% of the mapped cells,
    ``elevation`` and the bounds on 28.0%, and ``obstacle`` was set on 864
    more cells.
    """
    rng = np.random.default_rng(4)
    gj = fj.GridGeometry.from_length(72.5, 72.5, 0.1)
    gt = ft.GridGeometry.from_length(72.5, 72.5, 0.1)
    assert gt.num_cells == 525625 > (1 << 19)
    mj = fj.FastDEM(gj, config(fj, raycast=False, range_max=1e9))
    mt = ft.FastDEM(gt, config(ft, raycast=False, range_max=1e9), device="cpu")
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    from fastdem_tpu.cloud import pointcloud as pc_j

    for xyz, T in _rows_vs_packed_scans(rng):
        assert mj.integrate(pc_j.from_numpy(xyz, frame_id="lidar"), T_bs, T)
        assert mt.integrate(from_numpy(xyz, frame_id="lidar", device="cpu"), T_bs, T)
    assert mt.last_aux.oow_points is None  # no window
    assert mt._map.step.scatter_mode == "packed"
    mapped = np.isfinite(np.asarray(mj.state.layers["elevation"]))
    assert mapped.sum() > 8000
    assert_layers_bitwise(mj.state.layers, mt.state)
    # The map holds near-ties that packed mode resolves by index: min_z is
    # the upper point in many cells, where rows mode would take the lower.
    obstacle = np.isfinite(mt.state.layers["obstacle"].numpy())
    assert 0.02 < obstacle.sum() / mapped.sum() < 0.9


def test_windowed_switch_to_packed_against_jax():
    """A windowed GLOBAL map whose window passes 2^19 cells: 261 x 261 m at
    0.2 m (1305^2 = 1.7M cells) with an 80 m range filter gives a window
    of ceil(2 (1.1 * 80 + 2) / 0.2) + 4 = 904 cells a side (817,216), so
    both pipelines rasterize in packed mode on the window. Two near-tie
    scans; every layer equal to JAX's bit for bit."""
    rng = np.random.default_rng(6)
    maps = []
    for pkg in (fj, ft):
        cfg = config(pkg, raycast=False, range_max=80.0)
        geom = pkg.GridGeometry.from_length(261.0, 261.0, 0.2)
        kw = {} if pkg is fj else {"device": "cpu"}
        maps.append(pkg.FastDEM(geom, cfg, **kw))
    assert maps[1].geom.num_cells == 1305 ** 2
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    from fastdem_tpu.cloud import pointcloud as pc_j

    assert maps[1]._map.step.scatter_mode == "packed"
    for xyz, T in _rows_vs_packed_scans(rng, k_scans=2, n=20000):
        xyz = xyz * np.array([8.0, 8.0, 1.0], np.float32)  # out to 64 m
        assert maps[0].integrate(pc_j.from_numpy(xyz, frame_id="lidar"), T_bs, T)
        assert maps[1].integrate(from_numpy(xyz, frame_id="lidar", device="cpu"), T_bs, T)
    aux = maps[1].last_aux
    assert int(aux.oow_points) == 0 and aux.obs.touched.shape == (1305, 1305)
    assert_layers_bitwise(maps[0].state.layers, maps[1].state)
    assert (maps[1].state.layers["n_points"] > 0).sum() > 4000


def test_sampled_raycast_on_a_large_global_map():
    """The sampled raycast turns the update window off, so on a GLOBAL map
    above 2^19 cells it rasterizes the whole map, in packed mode as JAX
    does: every layer equals JAX's bit for bit."""
    rng = np.random.default_rng(8)
    maps = []
    for pkg in (fj, ft):
        cfg = config(pkg, range_max=8.0)
        cfg.raycasting.method = "sampled"
        geom = pkg.GridGeometry.from_length(72.5, 72.5, 0.1)
        kw = {} if pkg is fj else {"device": "cpu"}
        maps.append(pkg.FastDEM(geom, cfg, **kw))
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    from fastdem_tpu.cloud import pointcloud as pc_j

    for xyz, T in _rows_vs_packed_scans(rng, k_scans=2, n=1500):
        assert maps[0].integrate(pc_j.from_numpy(xyz, frame_id="lidar"), T_bs, T)
        assert maps[1].integrate(from_numpy(xyz, frame_id="lidar", device="cpu"), T_bs, T)
    got = maps[1].state.layers
    assert maps[1].last_aux.oow_points is None
    assert maps[1]._map.step.scatter_mode == "packed"
    assert_layers_bitwise(maps[0].state.layers, maps[1].state)
    assert torch.isfinite(got["elevation"]).sum() > 1000
    assert torch.isfinite(got["raycasting"]).sum() > 1000
