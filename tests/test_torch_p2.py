"""The port's P^2 quantile estimator against the JAX package's.

(a) The dense update, scan after scan on random maps made with numpy from
    a seed, equals ``fastdem_tpu.mapping.p2`` on the CPU bit for bit, for
    the default marker increments and for another set. Fading memory is
    off there, as in every preset: with it on, the reference's compiler
    fuses the rescaled marker positions into multiply-adds in a pattern
    set by its fusion decisions, so the port is held instead to the
    independent scalar P^2 of ``tests/test_p2.py`` at that test's own
    tolerance.
(b) The golden session (``tests/test_goldens.py::run_session("p2")``) on
    the port reproduces ``goldens/session_p2.npz`` at the golden test's
    tolerance.
(c) A P^2 session started in JAX continues in the port as it does in JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.cloud import pointcloud as pc_j
from fastdem_tpu.config.config import P2Config as P2ConfigJ
from fastdem_tpu.grid import gridmap as gm_j
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.mapping import p2 as p2_j
from fastdem_tpu_torch.config import P2Config as P2ConfigT
from fastdem_tpu_torch.grid import gridmap as gm_t
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.mapping import p2 as p2_t
from test_p2 import ScalarP2
from test_torch_pipeline import GOLDEN_LAYERS, assert_layers_agree, run_golden_session_port
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (24, 31)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "session_p2.npz")


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


@pytest.mark.parametrize(
    "kw",
    [{}, dict(dn1=0.2, dn2=0.45, dn3=0.9, elevation_marker=2)],
    ids=["default", "other_markers"],
)
def test_p2_estimate_matches_jax_bitwise(rng, kw):
    cfg_j, cfg_t = P2ConfigJ(**kw), P2ConfigT(**kw)
    fills = {**gm_j.default_layer_fills(), **p2_j.layer_fills()}
    fills_t = {**gm_t.default_layer_fills(), **p2_t.layer_fills()}
    assert list(fills) == list(fills_t)
    np.testing.assert_array_equal(list(fills.values()), list(fills_t.values()))
    sj = gm_j.create(GeomJ(SHAPE[0], SHAPE[1], 0.1), fills)
    st = gm_t.create(GeomT(SHAPE[0], SHAPE[1], 0.1), fills, device="cpu")
    step_j = jax.jit(lambda s, z, t: p2_j.estimate(s, cfg_j, z, z, t))
    for scan in range(40):
        touched = rng.random(SHAPE) < 0.8
        z = np.where(touched, rng.normal(0.3, 0.05, SHAPE), np.nan).astype(np.float32)
        if scan == 20:  # cells cleared to NaN (a ghost clear) restart at phase 1
            for k in fills:
                st.layers[k][:3] = np.nan
            sj = sj.replace_layers({k: v.at[:3].set(np.nan) for k, v in sj.layers.items()})
        sj = step_j(sj, jnp.asarray(z), jnp.asarray(touched))
        zt = torch.tensor(z)
        st = p2_t.estimate(st, cfg_t, zt, zt, torch.tensor(touched))
        for k in sj.layers:
            np.testing.assert_array_equal(bits(sj.layers[k]), bits(st.layers[k]),
                                          err_msg=f"scan {scan}, layer {k}")
    assert (st.layers["n_points"] >= 30).any()
    assert torch.isfinite(st.layers["variance"]).sum() > 100


def test_p2_fading_memory_matches_scalar_oracle(rng):
    cfg = P2ConfigT(max_sample_count=50.0)
    geom = GeomT(1, 1, 0.1)
    state = gm_t.create(geom, {**gm_t.default_layer_fills(), **p2_t.layer_fills()},
                        device="cpu")
    vals = rng.normal(0.0, 1.0, size=150).astype(np.float32)
    oracle = ScalarP2([cfg.dn0, cfg.dn1, cfg.dn2, cfg.dn3, cfg.dn4], max_count=50.0)
    touched = torch.ones((1, 1), dtype=torch.bool)
    for v in vals:
        oracle.add(float(v))
        z = torch.full((1, 1), float(v))
        state = p2_t.estimate(state, cfg, z, z, touched)
    q = [float(state.layers[name][0, 0]) for name in ft.layers.p2_q]
    np.testing.assert_allclose(q, oracle.q, rtol=1e-3, atol=1e-4)
    assert float(state.layers["n_points"][0, 0]) == pytest.approx(oracle.count)


def test_golden_session_p2():
    state = run_golden_session_port("p2")
    with np.load(GOLDEN) as data:
        for name in GOLDEN_LAYERS:
            np.testing.assert_allclose(
                state.layers[name].numpy(), data[name], rtol=1e-5, atol=1e-6,
                equal_nan=True, err_msg=f"port/{name} differs from the golden",
            )


def test_p2_session_carried_from_jax_into_port():
    import bench

    geom_j = fj.GridGeometry.from_length(15.0, 15.0, 0.1)
    geom_t = ft.GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg_j, cfg_t = fj.Config(), ft.Config()
    for c, pkg in ((cfg_j, fj), (cfg_t, ft)):
        c.raycasting.enabled = True
        c.mapping.estimation_type = pkg.EstimationType.P2_QUANTILE
    mj, mt = fj.FastDEM(geom_j, cfg_j), ft.FastDEM(geom_t, cfg_t, device="cpu")
    scans = bench.make_scans(8, 8000, np.random.default_rng(3))
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = [np.eye(4, dtype=np.float32) for _ in range(8)]
    for k, T in enumerate(poses):
        T[0, 3] = 0.1 * k
    for k in range(5):
        assert mj.integrate(pc_j.from_numpy(scans[k], frame_id="lidar"), T_bs, poses[k])
    layers = {k: np.asarray(v) for k, v in mj.state.layers.items()}
    assert set(ft.layers.p2_q) <= set(layers)
    mt.state = ft.state_from_numpy(layers, np.asarray(mj.state.position), device="cpu")
    back, _ = ft.state_to_numpy(mt.state)
    for k, v in layers.items():
        np.testing.assert_array_equal(back[k].view(np.int32), v.view(np.int32))
    for k in range(5, 8):
        assert mj.integrate(pc_j.from_numpy(scans[k], frame_id="lidar"), T_bs, poses[k])
        assert mt.integrate(ft.cloud.from_numpy(scans[k], frame_id="lidar", device="cpu"), T_bs, poses[k])
    assert_layers_agree(mj.state.layers, mt.state)
    assert torch.isfinite(mt.state.layers["elevation"]).sum() > 5000
