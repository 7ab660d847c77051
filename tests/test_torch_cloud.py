"""The port's point-cloud library against the JAX package's, on the CPU:
the container's helpers, transforms, the crop and voxel filters, both
deskews, the outlier removals and depth images.

Tolerances: masks exactly (every filter keeps exactly JAX's points);
voxel-grid points and channels bit for bit; transforms, deskewed points
and normals to rtol 1e-6 / atol 2e-6 (trigonometric functions differ in
the last bit between the libraries); depth clouds bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import filters as fj
from fastdem_tpu.cloud import pointcloud as pj
from fastdem_tpu.cloud import transform as tj
from fastdem_tpu_torch.cloud import filters as ft
from fastdem_tpu_torch.cloud import pointcloud as pt
from fastdem_tpu_torch.cloud import transform as tt
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-6, atol=2e-6)


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits(ref, got, what=""):
    np.testing.assert_array_equal(bits(got), bits(ref), err_msg=what)


@pytest.fixture(scope="module")
def clouds():
    """The same 5,000-point cloud (2% NaN rows, every channel) in both
    packages."""
    rng = np.random.default_rng(5)
    n = 5000
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    xyz[rng.random(n) < 0.02] = np.nan
    ch = dict(
        intensity=rng.uniform(0, 100, n).astype(np.float32),
        time=rng.uniform(0, 0.1, n).astype(np.float32),
        color=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        ring=rng.integers(0, 16, n).astype(np.int32),
    )
    return pj.from_numpy(xyz, **ch), pt.from_numpy(xyz, device="cpu", **ch)


def assert_cloud(cj, ct, exact=True):
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    assert sorted(ct.channels) == sorted(cj.channels)
    if exact:
        assert_bits(cj.xyz, ct.xyz, "xyz")
        for k in cj.channels:
            assert_bits(cj.channels[k], ct.channels[k], k)
    else:
        m = np.asarray(cj.mask)
        np.testing.assert_allclose(ct.xyz.numpy()[m], np.asarray(cj.xyz)[m], **TOL)


def test_container_helpers(clouds):
    cj, ct = clouds
    rng = np.random.default_rng(0)
    idx = rng.choice(cj.capacity, 300, replace=False)
    assert_cloud(pj.extract(cj, idx), pt.extract(ct, idx))
    assert_cloud(pj.erase(cj, idx), pt.erase(ct, torch.tensor(idx)))
    other = pj.from_numpy(np.ones((7, 3), np.float32), intensity=np.ones(7, np.float32))
    other_t = pt.from_numpy(np.ones((7, 3), np.float32), intensity=np.ones(7, np.float32),
                            device="cpu")
    assert_cloud(pj.merge(cj, other), pt.merge(ct, other_t))
    m = ct.mask.clone()
    m[:10] = False
    assert ct.with_mask(m).valid_count == -1 and ct.valid_count == int(ct.mask.sum())
    assert torch.equal(ct.with_channel("label", torch.zeros(ct.capacity)).channels["label"],
                       torch.zeros(ct.capacity))


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-np.pi, np.pi, 3)
    t = rng.normal(size=3)
    Tj = np.asarray(tj.from_rpy(*rpy, t=t))
    Tt = tt.from_rpy(*rpy, t=t, device="cpu")
    np.testing.assert_allclose(Tt.numpy(), Tj, **TOL)
    np.testing.assert_array_equal(tt.rotation(Tt).numpy(), Tt.numpy()[:3, :3])
    np.testing.assert_array_equal(tt.translation(Tt).numpy(), Tt.numpy()[:3, 3])
    R = Tt[:3, :3]
    q_j = np.asarray(tj.quat_from_matrix(jnp.asarray(Tj[:3, :3])))
    q_t = tt.quat_from_matrix(R)
    np.testing.assert_allclose(q_t.numpy(), q_j, **TOL)
    np.testing.assert_allclose(tt.matrix_from_quat(q_t).numpy(),
                               np.asarray(tj.matrix_from_quat(jnp.asarray(q_j))), **TOL)
    q1 = tt.quat_from_matrix(tt.from_rpy(0.3, -0.2, 1.0, device="cpu")[:3, :3])
    ts = np.linspace(0, 1, 7).astype(np.float32)
    np.testing.assert_allclose(
        tt.slerp(q_t, q1, torch.tensor(ts)).numpy(),
        np.asarray(tj.slerp(jnp.asarray(q_j), jnp.asarray(q1.numpy()), jnp.asarray(ts))), **TOL)
    for w in (rng.normal(size=3).astype(np.float32), np.full(3, 1e-9, np.float32)):
        np.testing.assert_allclose(tt.so3_exp(torch.tensor(w)).numpy(),
                                   np.asarray(tj.so3_exp(jnp.asarray(w))), **TOL)
    xi = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(tt.se3_exp(torch.tensor(xi)).numpy(),
                               np.asarray(tj.se3_exp(jnp.asarray(xi))), **TOL)
    np.testing.assert_allclose(tt.so3_log(R).numpy(), np.asarray(tj.so3_log(jnp.asarray(Tj[:3, :3]))),
                               rtol=1e-5, atol=1e-5)
    cov = rng.normal(size=(20, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tt.rotate_covariances(torch.tensor(cov), R).numpy(),
                               np.asarray(tj.rotate_covariances(jnp.asarray(cov), jnp.asarray(Tj[:3, :3]))),
                               rtol=1e-5, atol=1e-5)


def test_transform_cloud_rotates_normals_only(clouds):
    cj, ct = clouds
    T = tt.from_rpy(0.2, 0.1, -0.7, t=(5.0, -3.0, 1.0), device="cpu")
    a = tj.transform_cloud(cj, jnp.asarray(T.numpy()), frame_id="map")
    b = tt.transform_cloud(ct, T, frame_id="map")
    assert b.frame_id == "map"
    assert_cloud(a, b, exact=False)
    np.testing.assert_allclose(b.channels["normal"].numpy(), np.asarray(a.channels["normal"]), **TOL)
    # Normals are rotated, not translated.
    np.testing.assert_allclose(b.channels["normal"].norm(dim=1).numpy(),
                               ct.channels["normal"].norm(dim=1).numpy(), rtol=1e-5)


CROPS = [
    ("crop_box", ([-1, -1, -1], [1, 2, 1])),
    ("crop_range", (0.5, 2.5)),
    ("crop_x", (-1, 1)),
    ("crop_y", (-2, 0.5)),
    ("crop_z", (-0.5, 0.3)),
    ("crop_angle", (0.3, 2.0)),
    ("crop_angle", (2.0, 0.3)),
    ("crop_angle", (-2.5, 2.5)),
]


@pytest.mark.parametrize("mode", ["INSIDE", "OUTSIDE"])
def test_crops_match_jax(clouds, mode):
    cj, ct = clouds
    for name, args in CROPS:
        a = getattr(fj, name)(cj, *args, mode=fj.FilterMode[mode])
        b = getattr(ft, name)(ct, *args, mode=ft.FilterMode[mode])
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask), err_msg=name)


@pytest.mark.parametrize("mode", ["ANY", "NEAREST", "CENTER", "CENTROID"])
def test_voxel_grid_matches_jax(clouds, mode):
    """Every mode: the same representatives (mask exactly) and the same
    points and channels, bit for bit."""
    cj, ct = clouds
    a = fj.voxel_grid(cj, 0.37, fj.VoxelMode[mode])
    b = ft.voxel_grid(ct, 0.37, ft.VoxelMode[mode])
    assert 300 < int(b.mask.sum()) < int(ct.mask.sum())
    assert_cloud(a, b)


def test_voxel_helpers_match_jax(clouds):
    cj, ct = clouds
    for size in (0.2, 0.5):
        np.testing.assert_array_equal(
            ft.voxel_unique_mask(ct.xyz, ct.mask, size).numpy(),
            np.asarray(fj.voxel_unique_mask(cj.xyz, cj.mask, size)))
    m = np.asarray(cj.mask)
    c_j = np.asarray(fj.voxel_coords(cj.xyz, 0.3))
    c_t = ft.voxel_coords(ct.xyz, 0.3)
    np.testing.assert_array_equal(c_t.numpy()[m], c_j[m])
    np.testing.assert_array_equal(ft.voxel_key(c_t).numpy()[m],
                                  np.asarray(fj.voxel_key(jnp.asarray(c_j)))[m])


def test_grid_max_z_matches_jax(clouds):
    cj, ct = clouds
    for cell in (0.25, 0.6):
        a, b = fj.grid_max_z(cj, cell), ft.grid_max_z(ct, cell)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))


@pytest.mark.parametrize("kw", [{}, {"strategy": "index"}, {"t0": 0.0, "t1": 0.1}])
def test_deskew_matches_jax(clouds, kw):
    cj, ct = clouds
    T0 = tt.from_rpy(0.1, 0.05, -0.3, t=(0.2, 0.1, 0.0), device="cpu")
    T1 = tt.from_rpy(0.0, 0.02, 0.2, t=(1.0, -0.5, 0.1), device="cpu")
    a = fj.deskew(cj, jnp.asarray(T0.numpy()), jnp.asarray(T1.numpy()), **kw)
    b = ft.deskew(ct, T0, T1, **kw)
    assert_cloud(a, b, exact=False)
    np.testing.assert_allclose(b.channels["normal"].numpy(), np.asarray(a.channels["normal"]), **TOL)


def test_deskew_lookup_matches_jax(clouds):
    cj, ct = clouds

    def lookup(t):
        return np.asarray(tt.from_rpy(0.0, 0.1 * t, 3.0 * t, t=(5.0 * t, 0.0, 0.0), device="cpu"))

    a = fj.deskew_lookup(cj, lookup, 8)
    b = ft.deskew_lookup(ct, lookup, 8)
    assert_cloud(a, b, exact=False)
    np.testing.assert_allclose(b.channels["normal"].numpy(), np.asarray(a.channels["normal"]), **TOL)
    with pytest.raises(ValueError, match="time"):
        ft.deskew_lookup(pt.from_numpy(np.zeros((3, 3), np.float32), device="cpu"), lookup)


def test_statistical_outlier_removal_matches_jax(clouds):
    """The same kept points. The global threshold is a float64 sum in the
    port and a float32 reduction in XLA: no point may lie within 8 ulps
    of either threshold (counted), so the masks must agree exactly."""
    cj, ct = clouds
    for k, std in ((10, 1.0), (10, 0.5)):
        a = fj.statistical_outlier_removal(cj, k, std)
        b = ft.statistical_outlier_removal(ct, k, std)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        assert 0.6 < b.mask.sum() / ct.mask.sum() < 1.0
        from fastdem_tpu_torch.cloud import search

        _, dist = search.knn(ct.xyz, ct.mask, k)
        mean_d = ft.sor_mean_distance(dist)
        thr = float(ft._global_threshold(mean_d, ct.mask, std))
        near = np.abs(mean_d.numpy()[ct.mask.numpy()] - thr) <= 8 * np.spacing(np.float32(thr))
        assert near.sum() == 0


@pytest.mark.parametrize("method", ["brute", "grid", "bucket"])
def test_radius_outlier_removal_matches_jax(clouds, method):
    cj, ct = clouds
    a = fj.radius_outlier_removal(cj, 0.3, 3, method=method)
    b = ft.radius_outlier_removal(ct, 0.3, 3, method=method)
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    assert 0 < b.mask.sum() < ct.mask.sum()


def test_depth_to_cloud_matches_jax():
    from fastdem_tpu.cloud import depth as dj
    from fastdem_tpu_torch.cloud import depth as dt

    rng = np.random.default_rng(2)
    depth = rng.integers(0, 4000, (48, 64)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.1] = 0
    rgb = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    for kw in (dict(stride=1), dict(stride=3, min_depth=0.5, max_depth=3.0)):
        a = dj.depth_to_cloud(depth, 52.0, 51.0, 31.7, 23.2, rgb=rgb, depth_scale=1e-3, **kw)
        b = dt.depth_to_cloud(depth, 52.0, 51.0, 31.7, 23.2, rgb=rgb, depth_scale=1e-3,
                              device="cpu", **kw)
        assert_cloud(a, b)
        assert b.valid_count == a.valid_count == int(b.mask.sum())
    f = np.where(rng.random((20, 30)) < 0.2, np.nan, rng.uniform(0.2, 5, (20, 30))).astype(np.float32)
    a = dj.depth_to_cloud(f, 30.0, 30.0, 15.0, 10.0)
    b = dt.depth_to_cloud(torch.tensor(f), 30.0, 30.0, 15.0, 10.0)
    assert b.xyz.device.type == "cpu"  # a tensor's own device
    assert_cloud(a, b)
    np.testing.assert_allclose(dt.camera_to_base_transform(t=(0.1, 0, 1.2)),
                               np.asarray(dj.camera_to_base_transform(t=(0.1, 0, 1.2))), **TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dt.depth_to_cloud(depth, 52.0, 51.0, 31.7, 23.2)
