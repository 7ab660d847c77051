"""The port's integrate path end to end, against the JAX package.

(a) The frozen golden session (``tests/test_goldens.py::run_session``,
    Kalman) rebuilt on the port reproduces ``goldens/session_kalman.npz``
    at the golden test's own tolerance.
(b) Three flagship-shape scans (30K points, 15x15 m at 0.1 m, Kalman,
    LiDAR, polar raycast) through both packages: every layer agrees.
(c) A session started in JAX and carried into the port with
    ``state_from_numpy`` continues as it does in JAX.
(d) The facade's probes, setters and the configurations that raise.
(e) The CUDA facade's staging (``mapping/staging.py``) packed on the host
    into a plain buffer: bit for bit what the device copy and ``pad_to``
    give, and the map of a facade that stages equals the plain one's.

Layers are compared at rtol 1e-5, atol 1e-6 (NaN = NaN) on at least 99.9%
of cells: last-ulp atan2 / hypot differences between the libraries can
move a ray or a cell across a polar-bin boundary. ``n_points`` and the NaN
set of ``elevation`` must match exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.cloud import pointcloud as pc_j
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "session_kalman.npz")
GOLDEN_LAYERS = (
    "elevation", "elevation_min", "elevation_max", "variance", "n_points",
    "upper_bound", "lower_bound", "obstacle", "_visibility_logodds",
)


def run_golden_session_port(estimator="kalman"):
    """``tests/test_goldens.py::run_session(estimator)`` on the port."""
    geom = ft.GridGeometry.from_length(12.0, 12.0, 0.2)
    cfg = ft.Config()
    cfg.mapping.estimation_type = (
        ft.EstimationType.P2_QUANTILE if estimator == "p2" else ft.EstimationType.KALMAN
    )
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = 10.0
    m = ft.FastDEM(geom, cfg, device="cpu")
    rng = np.random.default_rng(1234)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 0.8
    for k in range(6):
        n = 6000
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, 5.5, n)
        x = rad * np.cos(ang)
        y = rad * np.sin(ang)
        z = 0.25 * np.sin(0.7 * x) * np.cos(0.5 * y) - 0.8 + rng.normal(0, 0.02, n)
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.1 * k
        cloud = ft.cloud.from_numpy(
            np.column_stack([x, y, z]).astype(np.float32), frame_id="lidar", device="cpu"
        )
        assert m.integrate(cloud, T_bs, T_wb)
    return m.state


def test_golden_session_kalman():
    state = run_golden_session_port()
    with np.load(GOLDEN) as data:
        for name in GOLDEN_LAYERS:
            np.testing.assert_allclose(
                state.layers[name].numpy(), data[name], rtol=1e-5, atol=1e-6,
                equal_nan=True, err_msg=f"port/{name} differs from the golden",
            )


def flagship_pair():
    geom_j = fj.GridGeometry.from_length(15.0, 15.0, 0.1)
    geom_t = ft.GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg_j, cfg_t = fj.Config(), ft.Config()
    cfg_j.raycasting.enabled = True
    cfg_t.raycasting.enabled = True
    return fj.FastDEM(geom_j, cfg_j), ft.FastDEM(geom_t, cfg_t, device="cpu")


def session(n_scans, seed):
    rng = np.random.default_rng(seed)
    scans = bench.make_scans(n_scans, 30000, rng)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    poses = []
    for k in range(n_scans):
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.137 * k
        T_wb[1, 3] = -0.05 * k
        poses.append(T_wb)
    return scans, T_bs, poses


def assert_layers_agree(layers_j, state_t):
    assert set(layers_j) == set(state_t.layers)
    for name, ref in layers_j.items():
        ref = np.asarray(ref)
        got = state_t.layers[name].numpy()
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
        assert close.mean() >= 0.999, f"{name}: {np.count_nonzero(~close)} cells differ"
    np.testing.assert_array_equal(
        np.asarray(layers_j["n_points"]), state_t.layers["n_points"].numpy()
    )
    np.testing.assert_array_equal(
        np.isnan(np.asarray(layers_j["elevation"])),
        torch.isnan(state_t.layers["elevation"]).numpy(),
    )


def test_flagship_scans_match_jax():
    mj, mt = flagship_pair()
    scans, T_bs, poses = session(3, seed=7)
    for k in range(3):
        assert mj.integrate(pc_j.from_numpy(scans[k], frame_id="lidar"), T_bs, poses[k])
        assert mt.integrate(ft.cloud.from_numpy(scans[k], frame_id="lidar", device="cpu"), T_bs, poses[k])
    np.testing.assert_array_equal(np.asarray(mj.state.position), mt.state.position.numpy())
    assert_layers_agree(mj.state.layers, mt.state)
    assert torch.isfinite(mt.state.layers["elevation"]).sum() > 10000
    # The aux payload: surviving points and per-cell observations.
    aux_j, aux_t = mj.last_aux, mt.last_aux
    np.testing.assert_array_equal(np.asarray(aux_j.world_mask), aux_t.world_mask.numpy())
    np.testing.assert_array_equal(np.asarray(aux_j.obs.touched), aux_t.obs.touched.numpy())


def test_session_carried_from_jax_into_port():
    mj, mt = flagship_pair()
    scans, T_bs, poses = session(6, seed=11)
    for k in range(3):
        assert mj.integrate(pc_j.from_numpy(scans[k], frame_id="lidar"), T_bs, poses[k])
    layers = {k: np.asarray(v) for k, v in mj.state.layers.items()}
    mt.state = ft.state_from_numpy(layers, np.asarray(mj.state.position), device="cpu")
    back, pos = ft.state_to_numpy(mt.state)
    for k, v in layers.items():
        np.testing.assert_array_equal(back[k].view(np.int32), v.view(np.int32))
    np.testing.assert_array_equal(pos, np.asarray(mj.state.position))
    for k in range(3, 6):
        assert mj.integrate(pc_j.from_numpy(scans[k], frame_id="lidar"), T_bs, poses[k])
        assert mt.integrate(ft.cloud.from_numpy(scans[k], frame_id="lidar", device="cpu"), T_bs, poses[k])
    assert_layers_agree(mj.state.layers, mt.state)


class _Calibration:
    def get_extrinsic(self, frame_id):
        if frame_id != "lidar":
            return None
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = 1.0
        return T


class _Odometry:
    def get_pose_at(self, timestamp_ns):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 1e-9 * timestamp_ns
        return T


def small_mapper():
    geom = ft.GridGeometry.from_length(6.0, 6.0, 0.2)
    cfg = ft.Config()
    cfg.raycasting.enabled = True
    return geom, ft.FastDEM(geom, cfg, device="cpu")


def small_cloud(rng, frame_id="lidar", timestamp_ns=0):
    n = 2000
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.3, 2.8, n)
    xyz = np.column_stack([rad * np.cos(ang), rad * np.sin(ang),
                           rng.normal(-1.0, 0.02, n)]).astype(np.float32)
    return ft.cloud.from_numpy(xyz, frame_id=frame_id, timestamp_ns=timestamp_ns,
                               device="cpu")


def test_facade_probes(rng):
    geom, m = small_mapper()
    eye = np.eye(4, dtype=np.float32)
    # An empty cloud is refused.
    empty = ft.cloud.from_numpy(np.zeros((0, 3), np.float32), frame_id="lidar",
                                device="cpu")
    assert not m.integrate(empty, eye, eye)
    # No providers and no transforms: refused.
    assert not m.integrate(small_cloud(rng))
    assert m.last_aux is None
    # With providers the scan integrates and equals the explicit call.
    m.set_calibration_provider(_Calibration()).set_odometry_provider(_Odometry())
    cloud = small_cloud(rng, timestamp_ns=int(0.4e9))
    assert m.integrate(cloud)
    _, m2 = small_mapper()
    assert m2.integrate(cloud, _Calibration().get_extrinsic("lidar"),
                        _Odometry().get_pose_at(int(0.4e9)))
    for k, v in m.state.layers.items():
        np.testing.assert_array_equal(v.numpy(), m2.state.layers[k].numpy())
    assert not m.integrate(small_cloud(rng, frame_id="camera"))
    assert not m.integrate(small_cloud(rng, frame_id=""))
    # reset clears every layer.
    m.reset()
    assert all(torch.isnan(v).all() for v in m.state.layers.values())


def test_facade_setters_rebuild(rng):
    geom, m = small_mapper()
    step = m._map.step
    m.enable_raycasting(False)
    assert m._map.step is not step
    assert m.integrate(small_cloud(rng), np.eye(4, dtype=np.float32),
                       np.eye(4, dtype=np.float32))
    assert torch.isnan(m.state.layers["raycasting"]).all()  # not updated
    m.set_height_filter(-0.5, 0.5)  # every point is filtered out
    m.reset()
    assert m.integrate(small_cloud(rng), np.eye(4, dtype=np.float32),
                       np.eye(4, dtype=np.float32))
    assert torch.isnan(m.state.layers["elevation"]).all()
    m.set_height_filter(-ft.config.FLOAT_MAX, ft.config.FLOAT_MAX)
    m.set_sensor_model(ft.SensorType.CONSTANT)
    m.set_mapping_mode(ft.MappingMode.GLOBAL)
    m.set_range_filter(0.0, 100.0)
    assert m.integrate(small_cloud(rng), np.eye(4, dtype=np.float32),
                       np.eye(4, dtype=np.float32))
    # The map was empty, so every touched cell starts at P = R = 0.03^2,
    # the constant model's variance.
    p = m.state.layers["_kalman_p"][torch.isfinite(m.state.layers["elevation"])]
    assert p.numel() > 100
    np.testing.assert_allclose(p.numpy(), 0.03 * 0.03, rtol=1e-6)
    # P^2 adds its layers and keeps the existing ones.
    m.set_estimator_type(ft.EstimationType.P2_QUANTILE)
    assert set(ft.layers.p2_q) | set(ft.layers.p2_n) <= set(m.state.layers)
    assert "_kalman_p" in m.state.layers
    np.testing.assert_array_equal(m.state.layers["_p2_n3"].numpy(), 3.0)
    m.reset()
    assert m.integrate(small_cloud(rng), np.eye(4, dtype=np.float32),
                       np.eye(4, dtype=np.float32))
    assert (m.state.layers["n_points"] == 1).sum() > 100
    assert torch.isfinite(m.state.layers["_p2_q0"]).sum() > 100


def test_unported_configurations_raise():
    geom = ft.GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg = ft.Config()
    cfg.raycasting.enabled = True
    # Every scatter mode is ported (tests/test_torch_scatter_modes.py).
    for mode in ("rows", "packed", "twophase"):
        assert ft.build_integrate(geom, cfg, scatter_mode=mode, device="cpu").scatter_mode == mode
    # Blocks are ported; a LOCAL map refuses them, as in the reference.
    with pytest.raises(ValueError, match="GLOBAL"):
        ft.build_integrate(geom, cfg, spmd_blocks=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="unknown scatter_mode"):
        ft.build_integrate(geom, cfg, scatter_mode="bogus", device="cpu")

    def cfg_with(**changes):
        c = ft.Config()
        c.raycasting.enabled = True
        for path, value in changes.items():
            obj, attr = c, path.split("__")
            for a in attr[:-1]:
                obj = getattr(obj, a)
            setattr(obj, attr[-1], value)
        return c

    # More than 2^19 cells unwindowed, or a window above 2^19 cells (a 40 m
    # range filter at 0.1 m): the port switches to its packed rasterizer
    # there, as the reference does.
    large = [
        (ft.GridGeometry.from_length(80.0, 80.0, 0.1),
         cfg_with(mapping__mode=ft.MappingMode.GLOBAL)),
        (ft.GridGeometry.from_length(200.0, 200.0, 0.1),
         cfg_with(mapping__mode=ft.MappingMode.GLOBAL, point_filter__range_max=40.0)),
    ]
    for g, c in large:
        assert ft.build_integrate(g, c, device="cpu").scatter_mode == "packed"

    # What earlier raised now builds and integrates one scan: P^2, the
    # windowed update (a 2 m range filter on a 60 m GLOBAL map), the
    # windowed resample alone (an explicit ray range below the map) and the
    # sampled raycast, which turns the window off.
    rng = np.random.default_rng(0)
    now_ported = [
        (geom, cfg_with(mapping__estimation_type=ft.EstimationType.P2_QUANTILE), False),
        (ft.GridGeometry.from_length(60.0, 60.0, 0.2),
         cfg_with(mapping__mode=ft.MappingMode.GLOBAL, point_filter__range_max=2.0), True),
        (ft.GridGeometry.from_length(60.0, 60.0, 0.2),
         cfg_with(mapping__mode=ft.MappingMode.GLOBAL, point_filter__range_max=2.0,
                  raycasting__method="sampled"), False),
        (geom, cfg_with(mapping__mode=ft.MappingMode.GLOBAL, raycasting__max_range=3.0),
         False),
    ]
    for g, c, windowed in now_ported:
        m = ft.FastDEM(g, c, device="cpu")
        assert m.integrate(small_cloud(rng), np.eye(4, dtype=np.float32),
                           np.eye(4, dtype=np.float32))
        assert (m.state.layers["n_points"] > 0).sum() > 50
        assert torch.isfinite(m.state.layers["raycasting"]).sum() > 50
        assert (m.last_aux.oow_points is not None) == windowed


def test_integrate_sequence_takes_lists_of_tensors(rng):
    """Transforms given as lists (or tuples) of tensors, one per cloud --
    on any device, tracked by autograd or not -- map exactly as the same
    transforms given as numpy arrays. (``np.asarray`` of such a list raises
    for CUDA tensors and for tensors that require grad; the card's case is
    ``test_torch_cuda.py::test_integrate_sequence_takes_cuda_tensor_lists``.)"""
    clouds = [small_cloud(rng, timestamp_ns=k) for k in range(3)]
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 0.3
    poses = []
    for k in range(3):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.2 * k
        poses.append(T)
    _, ref = small_mapper()
    assert ref.integrate_sequence(clouds, T_bs, np.stack(poses)) == 3
    for tbs, twb in ((torch.tensor(T_bs), [torch.tensor(T) for T in poses]),
                     ([torch.tensor(T_bs)] * 3, tuple(torch.tensor(T) for T in poses)),
                     (torch.tensor(T_bs), [torch.tensor(T, requires_grad=True) for T in poses])):
        _, m = small_mapper()
        assert m.integrate_sequence(clouds, tbs, twb) == 3
        for k, v in m.state.layers.items():
            np.testing.assert_array_equal(v.numpy().view(np.int32),
                                          ref.state.layers[k].numpy().view(np.int32), err_msg=k)


def test_wrong_package_config_and_missing_cuda():
    geom = ft.GridGeometry.from_length(3.0, 3.0, 0.1)
    with pytest.raises(TypeError, match="its own Config"):
        ft.FastDEM(geom, fj.Config(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ft.FastDEM(geom, ft.Config(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ft.cloud.from_numpy(np.zeros((4, 3), np.float32), device="cuda")


def test_cloud_and_transform_default_to_the_card():
    """from_numpy and make_transform build on the card unless the caller
    names the CPU; without a card their defaults raise."""
    from fastdem_tpu_torch.cloud import transform as tf_t

    xyz = np.zeros((4, 3), np.float32)
    assert ft.cloud.from_numpy(xyz, device="cpu").device.type == "cpu"
    assert tf_t.make_transform(np.eye(3), [1.0, 2.0, 3.0], device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert ft.cloud.from_numpy(xyz).device.type == "cuda"
        assert tf_t.make_transform().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ft.cloud.from_numpy(xyz)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf_t.make_transform(np.eye(3), [1.0, 2.0, 3.0])


def test_auto_bucket_compacts_sparse_clouds(rng):
    geom, m = small_mapper()
    _, ref = small_mapper()
    xyz = small_cloud(rng).xyz.numpy()
    sparse = np.full((16384, 3), np.nan, dtype=np.float32)
    sparse[::8][: xyz.shape[0]] = xyz
    cloud = ft.cloud.from_numpy(sparse, frame_id="lidar", device="cpu")
    eye = np.eye(4, dtype=np.float32)
    assert m.integrate(cloud, eye, eye)
    assert m.last_aux.world_xyz.shape[0] == 4096  # compacted to the ladder
    assert ref.integrate(ft.cloud.from_numpy(xyz, frame_id="lidar", device="cpu"), eye,
                         eye)
    for k, v in m.state.layers.items():
        np.testing.assert_array_equal(v.numpy(), ref.state.layers[k].numpy())


def test_transform_helpers_match_jax(rng):
    from fastdem_tpu.cloud import transform as tf_j
    from fastdem_tpu_torch.cloud import transform as tf_t

    a, b = rng.uniform(-np.pi, np.pi, 2)
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]], dtype=np.float32)
    R2 = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(b), -np.sin(b)],
                   [0.0, np.sin(b), np.cos(b)]], dtype=np.float32)
    t = rng.normal(size=3).astype(np.float32)
    Tj = tf_j.compose(tf_j.make_transform(R, t), tf_j.make_transform(R2))
    Tt = tf_t.compose(tf_t.make_transform(R, t, device="cpu"),
                      tf_t.make_transform(R2, device="cpu"))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tf_t.inverse(Tt).numpy(), np.asarray(tf_j.inverse(Tj)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((tf_t.inverse(Tt) @ Tt).numpy(), np.eye(4), atol=1e-6)
    xyz = rng.uniform(-10, 10, (5000, 3)).astype(np.float32)
    ref = jax.jit(tf_j.transform_points)(jnp.asarray(xyz), Tj)
    got = tf_t.transform_points(torch.tensor(xyz), Tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


class _HostRing:
    """``staging.StagingRing`` on plain host memory: the same packing, one
    buffer a scan, no device."""

    def put(self, parts):
        from fastdem_tpu_torch.mapping import staging

        secs, nbytes = staging.plan(parts)
        buf = torch.empty(nbytes, dtype=torch.uint8)
        staging.pack(buf.numpy(), parts, secs)
        return staging.unpack(buf, secs)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


TRANSFORMS = {
    "numpy f64": lambda T: T.astype(np.float64),
    "numpy f32": lambda T: T.astype(np.float32),
    "torch f64": lambda T: torch.tensor(T, dtype=torch.float64),
}


@pytest.mark.parametrize("n, capacity", [(4096, 4096), (3001, 3008)])
@pytest.mark.parametrize("kind", list(TRANSFORMS))
def test_staging_packs_as_pad_to(rng, n, capacity, kind):
    """A host cloud packed for a CUDA facade (``FastDEM._stage`` on a host
    ring) gives, bit for bit, ``pad_to(cloud, ladder_capacity(cap, base=1))``
    with the channels the step reads, and ``torch.as_tensor(T, float32)``
    for both transforms; a cloud at a power of two keeps its capacity."""
    from fastdem_tpu_torch.cloud import pointcloud as pc
    from fastdem_tpu_torch.mapping.pipeline import _host_f32

    geom = ft.GridGeometry.from_length(6.0, 6.0, 0.2)
    m = ft.FastDEM(geom, ft.Config(), has_intensity=True, has_color=True, device="cpu")
    m._ring = _HostRing()
    xyz = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    xyz[5] = np.nan  # an invalid row keeps its 1e9 and its False
    cloud = ft.cloud.from_numpy(
        xyz, frame_id="lidar", device="cpu", capacity=capacity,
        intensity=rng.uniform(0, 255, n).astype(np.float32),
        color=rng.integers(0, 256, (n, 3), dtype=np.uint8),
        ring=rng.integers(0, 16, n, dtype=np.int32),
    )
    T = np.eye(4) + rng.normal(0.0, 0.3, (4, 4))  # f64 entries that round
    T_bs, T_wb = TRANSFORMS[kind](T), TRANSFORMS[kind](T.T)
    cap = pc.ladder_capacity(cloud.capacity, base=1)
    stepped, got_bs, got_wb = m._stage(cloud, cap, _host_f32(T_bs), T_wb)

    ref = pc.pad_to(cloud, cap)
    assert stepped.capacity == cap == 4096
    for name, a, b in (("xyz", ref.xyz, stepped.xyz), ("mask", ref.mask, stepped.mask),
                       ("intensity", ref.channels["intensity"], stepped.channels["intensity"]),
                       ("color", ref.channels["color"], stepped.channels["color"])):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    assert set(stepped.channels) == {"intensity", "color"}  # what the step reads
    for T_in, T_got in ((T_bs, got_bs), (T_wb, got_wb)):
        want = torch.as_tensor(T_in, dtype=torch.float32)
        assert T_got.dtype == torch.float32 and T_got.shape == (4, 4)
        assert torch.equal(_bits(want), _bits(T_got))


def test_staging_facade_maps_as_the_plain_facade(rng):
    """Scans of three sizes, with intensity, through a facade that stages
    (on a host ring) map as the plain facade's, bit for bit, and its aux
    is trimmed to each scan."""
    geom = ft.GridGeometry.from_length(6.0, 6.0, 0.2)
    cfg = ft.Config()
    cfg.raycasting.enabled = True
    plain = ft.FastDEM(geom, cfg, has_intensity=True, device="cpu")
    staged = ft.FastDEM(geom, cfg, has_intensity=True, device="cpu")
    staged._ring = _HostRing()
    T_bs = np.eye(4)
    T_bs[2, 3] = 0.8
    for k, n in enumerate((2000, 1024, 1500)):
        xyz = small_cloud(rng).xyz.numpy()[:n]
        cloud = ft.cloud.from_numpy(xyz, frame_id="lidar", device="cpu",
                                    intensity=rng.uniform(0, 1, n).astype(np.float32))
        T_wb = np.eye(4)
        T_wb[0, 3] = 0.15 * k
        for m in (plain, staged):
            assert m.integrate(cloud, T_bs, T_wb)
        assert staged.last_aux.world_xyz.shape == (n, 3)
    for k, v in plain.state.layers.items():
        np.testing.assert_array_equal(staged.state.layers[k].numpy().view(np.int32),
                                      v.numpy().view(np.int32), err_msg=k)
