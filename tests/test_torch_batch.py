"""The port's batch DEM (``mapping/batch.py``, ``rasterize_stats``) and the
``pcd2dem`` tool against the JAX package's, on the CPU.

Tolerances: count, min, max, touched, intensity and every mask exactly;
mean and variance bit for bit on the CPU (the same sums in point order;
the card's atomics are held to rtol 1e-5 in ``chip_smoke.py``); the
inpainted elevation within 2e-6 with the same NaN set; the tool's output
cloud with the same points in the same order, values within 2e-6.

One stated divergence: the colour layer. JAX takes the min-z point's
colour as a float minimum over packed colours, which are subnormal floats
for red < 128, and XLA's CPU code flushes subnormals to zero; the port
compares their int32 views, so it returns the colour itself. Colours are
compared where JAX's is a normal float, and the rest are checked to be
the min-z point's smallest packed colour.
"""

import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import pointcloud as pj
from fastdem_tpu.config.config import RasterMethod as RJ
from fastdem_tpu.grid.geometry import GridGeometry as GJ
from fastdem_tpu.mapping import batch as bj
from fastdem_tpu.mapping import rasterize as rj
from fastdem_tpu.utils.colors import pack_rgb as pack_j
from fastdem_tpu_torch.cloud import pointcloud as pt
from fastdem_tpu_torch.config import RasterMethod as RT
from fastdem_tpu_torch.grid.geometry import GridGeometry as GT
from fastdem_tpu_torch.mapping import batch as bt
from fastdem_tpu_torch.mapping import rasterize as rt
from fastdem_tpu_torch.utils.colors import pack_rgb as pack_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def site(rng, n_ground=4000, n_float=250, n_out=25, span=6.0):
    """A seeded terrain with ties in z (rounded heights, signed zeros),
    floating points 3-8 m above it, gross outliers, intensity and colour."""
    xy = rng.uniform(-span, span, (n_ground, 2))
    z = 0.3 * np.sin(0.5 * xy[:, 0]) * np.cos(0.4 * xy[:, 1]) + rng.normal(0, 0.03, n_ground)
    z[::9] = np.round(z[::9], 1)
    fl = rng.uniform(-span, span, (n_float, 2))
    fz = rng.uniform(3, 8, n_float)
    out = rng.normal(0, span * 3, (n_out, 3))
    xyz = np.concatenate([np.column_stack([xy, z]), np.column_stack([fl, fz]), out]).astype(np.float32)
    n = len(xyz)
    return xyz, rng.uniform(0, 100, n).astype(np.float32), rng.integers(0, 256, (n, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def clouds():
    xyz, inten, col = site(np.random.default_rng(7))
    return (pj.from_numpy(xyz, intensity=inten, color=col),
            pt.from_numpy(xyz, intensity=inten, color=col, device="cpu"), xyz)


def assert_color(ref, got, zmin_colors=None):
    ref, got = bits(ref).ravel(), bits(got).ravel()
    normal = ref >= 0x00800000  # red >= 128: a normal float in JAX too
    np.testing.assert_array_equal(got[normal], ref[normal])
    sub = ~normal & (ref != bits(np.float32(np.nan)))
    assert (ref[sub] == 0).all()  # flushed by XLA
    if zmin_colors is not None:
        np.testing.assert_array_equal(got[sub], zmin_colors[sub])


def test_rasterize_stats_matches_jax(clouds):
    cj, ct, xyz = clouds
    gj, gt = GJ.from_length(9.0, 8.0, 0.25), GT.from_length(9.0, 8.0, 0.25)
    pos = np.array([0.013, -0.021], np.float32)
    ref = rj.rasterize_stats(gj, jnp.asarray(pos), cj.xyz, cj.mask, cj.channels["intensity"],
                             pack_j(cj.channels["color"]))
    got = rt.rasterize_stats(gt, torch.tensor(pos), ct.xyz, ct.mask, ct.channels["intensity"],
                             pack_t(ct.channels["color"]))
    assert int(got.touched.sum()) > 900
    for name in ("count", "touched", "min_z", "max_z", "max_intensity", "mean", "variance"):
        np.testing.assert_array_equal(bits(getattr(got, name)), bits(getattr(ref, name)), name)
    # The colour: the smallest packed colour among each cell's min-z points.
    ids, inside = gt.cell_id_of(torch.tensor(pos), ct.xyz[:, :2], true_div=True)
    ids = np.where(inside.numpy() & ct.mask.numpy(), ids.numpy(), gt.num_cells)
    zmin = got.min_z.numpy().ravel()
    packed = bits(pack_t(ct.channels["color"]))
    want = np.full(gt.num_cells + 1, 0x7FFFFFFF, np.int64)
    at_min = (ids < gt.num_cells) & (xyz[:, 2] == zmin[np.minimum(ids, gt.num_cells - 1)])
    np.minimum.at(want, ids[at_min], packed[at_min])
    assert_color(ref.color, got.color, want[:-1])


@pytest.mark.parametrize("method", ["MAX", "MIN", "MEAN", "MINMAX"])
def test_from_pointcloud_matches_jax(clouds, method):
    cj, ct, xyz = clouds
    geom_j, pos_j = bj.bbox_geometry(np.asarray(cj.xyz), np.asarray(cj.mask), 0.3)
    geom_t, pos_t = bt.bbox_geometry(ct.xyz, ct.mask, 0.3)
    assert (geom_t.rows, geom_t.cols) == (geom_j.rows, geom_j.cols)
    np.testing.assert_array_equal(pos_t, pos_j)
    a = bj.from_pointcloud(cj, geom_j, pos_j, RJ[method])
    b = bt.from_pointcloud(ct, geom_t, pos_t, RT[method])
    assert sorted(b.layers) == sorted(a.layers)
    for name in a.layers:
        if name == "color":
            assert_color(a.layers[name], b.layers[name])
        else:
            np.testing.assert_array_equal(bits(b.layers[name]), bits(a.layers[name]), name)
    ga, sa = bj.from_pointcloud_auto(cj, 0.5, RJ[method])
    gb, sb = bt.from_pointcloud_auto(ct, 0.5, RT[method])
    assert gb.shape == ga.shape
    np.testing.assert_array_equal(bits(sb.layers["n_points"]), bits(sa.layers["n_points"]))


@pytest.mark.parametrize("threshold,bin_size", [(2.0, 0.3), (0.3, 0.1)])
def test_remove_floating_points_matches_jax(clouds, threshold, bin_size):
    cj, ct, xyz = clouds
    geom_j, pos_j = bj.bbox_geometry(np.asarray(cj.xyz), np.asarray(cj.mask), 0.3)
    geom_t, pos_t = bt.bbox_geometry(ct.xyz, ct.mask, 0.3)
    a = bj.remove_floating_points(cj, geom_j, pos_j, threshold, bin_size)
    b = bt.remove_floating_points(ct, geom_t, pos_t, threshold, bin_size)
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    kept = b.mask.numpy()
    assert kept[:4000].mean() > 0.6 and kept[4000:4250].mean() < 0.1


def test_floating_points_tie_goes_to_the_lowest_bin():
    """Two bins with the same count: the ground is the lower one."""
    pts = np.array([[0.05, 0.05, 0.0], [0.05, 0.05, 0.01], [0.05, 0.05, 1.0],
                    [0.05, 0.05, 1.01], [0.05, 0.05, 2.9]], np.float32)
    geom = GT.from_length(1.0, 1.0, 1.0)
    c = pt.from_numpy(pts, device="cpu")
    out = bt.remove_floating_points(c, geom, np.zeros(2, np.float32), 0.5, 0.5)
    # Ground bin [0, 0.5): ground_z 0.25, cutoff 0.75.
    assert out.mask.tolist() == [True, True, False, False, False]
    ref = bj.remove_floating_points(pj.from_numpy(pts), GJ.from_length(1.0, 1.0, 1.0),
                                    np.zeros(2, np.float32), 0.5, 0.5)
    assert np.asarray(ref.mask).tolist() == out.mask.tolist()


def test_build_dem_matches_jax(clouds):
    cj, ct, _ = clouds
    cfg_j = bj.DEMConfig(resolution=0.2)
    cfg_t = bt.DEMConfig(resolution=0.2)
    gj, sj = bj.build_dem(cj, cfg_j)
    gt, st = bt.build_dem(ct, cfg_t, device="cpu")
    assert gt.shape == gj.shape
    np.testing.assert_array_equal(st.position.numpy(), np.asarray(sj.position))
    for name in sj.layers:
        ref, got = np.asarray(sj.layers[name]), st.layers[name].numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), name)
        if name == "color":
            assert_color(ref, got)
        elif name == "elevation":
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6, equal_nan=True)
        else:
            np.testing.assert_array_equal(bits(got), bits(ref), name)
    elev = st.layers["elevation"].numpy()
    # Floating points survive only in cells without ground points.
    assert np.isfinite(elev).mean() > 0.8 and (elev > 1.5).mean() < 0.05
    # to_pointcloud: the same cells in the same order.
    pa, pb = bj.to_pointcloud(gj, sj), bt.to_pointcloud(gt, st)
    assert pb.capacity == pa.capacity and pb.frame_id == "map"
    np.testing.assert_allclose(pb.xyz.numpy(), np.asarray(pa.xyz), rtol=0, atol=2e-6)
    assert_bits(pa.channels["intensity"], pb.channels["intensity"])


def assert_bits(ref, got):
    np.testing.assert_array_equal(bits(got), bits(ref))


def test_build_dem_defaults_to_the_card(clouds):
    _, ct, _ = clouds
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bt.build_dem(ct)


def _jax_tool(argv):
    """The JAX package's tools/pcd2dem.py, run in this process."""
    tool = runpy.run_path(os.path.join(ROOT, "tools", "pcd2dem.py"), run_name="pcd2dem_jax")
    old = sys.argv
    sys.argv = ["pcd2dem.py"] + argv
    try:
        return tool["main"]()
    finally:
        sys.argv = old


def test_pcd2dem_tool_matches_jax(tmp_path, capsys):
    from fastdem_tpu.io import pcd as pcd_j
    from fastdem_tpu_torch.io import pcd as pcd_t
    from fastdem_tpu_torch.tools import pcd2dem

    xyz, inten, _ = site(np.random.default_rng(3), n_ground=3000, n_float=150)
    src = str(tmp_path / "in.pcd")
    pcd_j.save_pcd(src, pj.from_numpy(xyz, intensity=inten))
    out_j, out_t = str(tmp_path / "j.pcd"), str(tmp_path / "t.pcd")
    npz, png = str(tmp_path / "m.npz"), str(tmp_path / "m.png")
    assert _jax_tool([src, out_j, "0.25", "--platform", "cpu"]) == 0
    assert pcd2dem.main([src, out_t, "0.25", "--device", "cpu", "--npz", npz,
                         "--png", png]) == 0
    assert os.path.getsize(npz) > 0 and os.path.getsize(png) > 0
    a = pcd_j.load_pcd(out_j)
    b = pcd_t.load_pcd(out_t, device="cpu")
    assert b.capacity == a.capacity > 500
    np.testing.assert_allclose(b.xyz.numpy(), np.asarray(a.xyz), rtol=0, atol=2e-6)
    np.testing.assert_allclose(b.channels["intensity"].numpy(),
                               np.asarray(a.channels["intensity"]), rtol=0, atol=2e-6)
    # KITTI .bin input and the refusals.
    kitti = str(tmp_path / "in.bin")
    np.column_stack([xyz, inten]).astype(np.float32).tofile(kitti)
    assert pcd2dem.main([kitti, out_t, "0.5", "--device", "cpu", "--method", "mean"]) == 0
    assert pcd2dem.main([str(tmp_path / "missing.pcd"), out_t, "--device", "cpu"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pcd2dem.main([src, out_t])
