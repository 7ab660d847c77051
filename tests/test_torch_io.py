"""The port's IO (``fastdem_tpu_torch.io``) against the JAX package's, on
the CPU.

Map states are made by the JAX package (its grid API, with NaN holes,
internal estimator layers, a packed color layer and an off-origin
position) and carried into the port with ``interop.state_from_numpy``.
What each package writes for the same state must be the same bytes: npz
checkpoints, PNG renders (every colormap and normalisation), the HTML
viewer and the live viewer's frames. An npz written by one package loads
in the other and is written back byte-identical. PCD (ascii and binary,
every channel), KITTI ``.bin`` and TUM / KITTI trajectory files written by
one package read back in the other as equal arrays.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from fastdem_tpu.cloud import pointcloud as pc_j
from fastdem_tpu.grid import gridmap as gm_j
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.io import html_viewer as html_j
from fastdem_tpu.io import live_viewer as live_j
from fastdem_tpu.io import npz as npz_j
from fastdem_tpu.io import pcd as pcd_j
from fastdem_tpu.io import png as png_j
from fastdem_tpu_torch.cloud import pointcloud as pc_t
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.interop import state_from_numpy, state_to_numpy
from fastdem_tpu_torch.io import html_viewer as html_t
from fastdem_tpu_torch.io import live_viewer as live_t
from fastdem_tpu_torch.io import npz as npz_t
from fastdem_tpu_torch.io import pcd as pcd_t
from fastdem_tpu_torch.io import png as png_t
from fastdem_tpu_torch.utils import colors as colors_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


def jax_state(seed=0, length=(4.0, 6.0), res=0.2):
    """A JAX map state: every default layer with random heights and NaN
    holes, Kalman's internal P, a color layer and an off-origin position."""
    from fastdem_tpu.utils.colors import pack_rgb

    rng = np.random.default_rng(seed)
    geom = GeomJ.from_length(length[0], length[1], res)
    fills = gm_j.default_layer_fills()
    fills["_kalman_p"] = 0.0
    fills["color"] = np.nan
    state = gm_j.create(geom, fills, position=(1.3, -0.7))
    new = {}
    for name in state.layers:
        a = rng.normal(0.0, 0.5, geom.shape).astype(np.float32)
        a[rng.random(geom.shape) < 0.2] = np.nan
        new[name] = jnp.asarray(a)
    rgb = rng.integers(0, 256, geom.shape + (3,)).astype(np.uint8)
    col = np.asarray(pack_rgb(jnp.asarray(rgb)))
    col = np.where(np.isnan(np.asarray(new["elevation"])), np.nan, col).astype(np.float32)
    new["color"] = jnp.asarray(col)
    return geom, state.replace_layers(new)


def port_pair(geom_j, state_j):
    layers = {k: np.asarray(v) for k, v in state_j.layers.items()}
    state_t = state_from_numpy(layers, np.asarray(state_j.position), device="cpu")
    return GeomT(geom_j.rows, geom_j.cols, geom_j.resolution), state_t


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("names", [None, ["elevation", "_kalman_p", "color"]])
def test_npz_bytes_equal_jax(tmp_path, names):
    geom_j, state_j = jax_state()
    geom_t, state_t = port_pair(geom_j, state_j)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert npz_j.save_npz(pj, geom_j, state_j, frame_id="odom", layer_names=names)
    assert npz_t.save_npz(pt, geom_t, state_t, frame_id="odom", layer_names=names)
    assert read(pj) == read(pt)


def test_npz_crosses_between_packages(tmp_path):
    """JAX writes, the port loads and writes back the same bytes; and the
    reverse, from a port session's checkpoint."""
    geom_j, state_j = jax_state(seed=1)
    pj = str(tmp_path / "from_jax.npz")
    npz_j.save_npz(pj, geom_j, state_j, frame_id="map")
    geom_t, state_t, meta = npz_t.load_npz(pj, device="cpu")
    assert (geom_t.rows, geom_t.cols, geom_t.resolution) == (
        geom_j.rows, geom_j.cols, geom_j.resolution)
    assert meta["frame_id"] == "map"
    assert state_t.position.device.type == "cpu"
    back = str(tmp_path / "back.npz")
    npz_t.save_npz(back, geom_t, state_t, frame_id="map")
    assert read(back) == read(pj)

    geom_t2, state_t2 = port_pair(*jax_state(seed=2))
    pt = str(tmp_path / "from_port.npz")
    npz_t.save_npz(pt, geom_t2, state_t2)
    geom_j2, state_j2, _ = npz_j.load_npz(pt)
    back = str(tmp_path / "back2.npz")
    npz_j.save_npz(back, geom_j2, state_j2)
    assert read(back) == read(pt)
    layers, pos = state_to_numpy(state_t2)
    for k, v in layers.items():
        np.testing.assert_array_equal(np.asarray(state_j2.layers[k]).view(np.int32),
                                      v.view(np.int32))


@pytest.mark.parametrize("tamper", ["start_index", "future_version", "bad_shape"])
def test_npz_reference_files_load_as_in_jax(tmp_path, tamper):
    """Files the reference's own writer could produce: a rotated circular
    buffer loads world-aligned as in JAX; a newer metadata version and a
    layer of the wrong shape raise in both packages."""
    geom_j, state_j = jax_state(seed=6)
    path = str(tmp_path / "s.npz")
    npz_j.save_npz(path, geom_j, state_j)
    with np.load(path) as data:
        arrays = {n: data[n] for n in data.files if n != "meta"}
        meta = json.loads(bytes(data["meta"].item()).decode())
    if tamper == "start_index":
        meta["start_index"] = [3, 5]
        arrays = {n: np.roll(a, shift=(3, 5), axis=(0, 1)) for n, a in arrays.items()}
    elif tamper == "future_version":
        meta["version"] = 99
    else:
        arrays["elevation"] = arrays["elevation"][:-1]
    with open(path, "wb") as f:
        np.savez(f, **arrays, meta=np.bytes_(json.dumps(meta).encode()))
    if tamper != "start_index":
        for load in (npz_j.load_npz, lambda p: npz_t.load_npz(p, device="cpu")):
            with pytest.raises(ValueError, match="version" if "version" in tamper else "shape"):
                load(path)
        return
    _, sj, _ = npz_j.load_npz(path)
    _, st, _ = npz_t.load_npz(path, device="cpu")
    layers, _ = state_to_numpy(st)
    for k, v in sj.layers.items():
        np.testing.assert_array_equal(layers[k].view(np.int32), np.asarray(v).view(np.int32))
        np.testing.assert_array_equal(layers[k].view(np.int32),
                                      np.asarray(state_j.layers[k]).view(np.int32))
    geom_t, _ = port_pair(geom_j, state_j)
    assert not npz_t.save_npz(str(tmp_path / "no_dir" / "x.npz"), geom_t, st)


def test_npz_load_defaults_to_the_card(tmp_path):
    import torch

    geom_j, state_j = jax_state()
    p = str(tmp_path / "m.npz")
    npz_j.save_npz(p, geom_j, state_j)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        npz_t.load_npz(p)


PNG_CASES = {
    "default": {},
    "jet_minmax": dict(colormap="JET", normalize="MIN_MAX"),
    "gray_fixed": dict(colormap="GRAYSCALE", normalize="FIXED_RANGE", fixed_min=-0.5,
                       fixed_max=0.7),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
@pytest.mark.parametrize("layer", ["elevation", "elevation_max"])
def test_png_bytes_equal_jax(tmp_path, case, layer):
    geom_j, state_j = jax_state(seed=3)
    _, state_t = port_pair(geom_j, state_j)

    def config(mod):
        kw = dict(PNG_CASES[case])
        if "colormap" in kw:
            kw["colormap"] = mod.Colormap[kw["colormap"]]
        if "normalize" in kw:
            kw["normalize"] = mod.Normalize[kw["normalize"]]
        return mod.PngExportConfig(**kw)

    pj, pt = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert png_j.save_png(pj, state_j, layer, config(png_j))
    assert png_t.save_png(pt, state_t, layer, config(png_t))
    assert read(pj) == read(pt)
    assert not png_t.save_png(str(tmp_path / "x.png"), state_t, "no_such_layer")


@pytest.mark.parametrize("max_cells", [160_000, 100])
def test_html_viewer_equals_jax(tmp_path, max_cells):
    geom_j, state_j = jax_state(seed=4)
    geom_t, state_t = port_pair(geom_j, state_j)
    assert (html_j.encode_frame(geom_j, state_j, max_cells=max_cells)
            == html_t.encode_frame(geom_t, state_t, max_cells=max_cells))
    pj, pt = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    assert html_j.save_html(pj, geom_j, state_j, max_cells=max_cells, title="t")
    assert html_t.save_html(pt, geom_t, state_t, max_cells=max_cells, title="t")
    assert read(pj) == read(pt)
    pts = np.random.default_rng(0).normal(size=(50_000, 3)).astype(np.float32)
    assert html_j.encode_points(pts) == html_t.encode_points(pts)
    assert html_j.encode_points(pts[:0]) == html_t.encode_points(pts[:0])


def test_live_viewer_frames_equal_jax():
    """The frame each viewer publishes (surface and scan points) is the
    same JSON; the port's server hands it out over HTTP on localhost."""
    geom_j, state_j = jax_state(seed=5)
    geom_t, state_t = port_pair(geom_j, state_j)
    pts = np.random.default_rng(1).uniform(-2, 2, (300, 3)).astype(np.float32)
    vj, vt = live_j.LiveViewer(port=0), live_t.LiveViewer(port=0)
    assert vj.publish(geom_j, state_j, scan_xyz=pts) == 1
    assert vt.publish(geom_t, state_t, scan_xyz=pts) == 1
    assert vj._frame_json == vt._frame_json
    # The driver-sink adapter takes the driver's host payload.
    layers, pos = state_to_numpy(state_t)
    vt.sink(geom_t)({"layers": layers, "position": pos, "scan_xyz": pts})
    vj.sink(geom_j)({"layers": layers, "position": pos, "scan_xyz": pts})
    assert vj._frame_json == vt._frame_json
    vt.start()
    try:
        with urllib.request.urlopen(vt.url + "frame", timeout=10) as r:
            assert r.read() == vj._frame_json
        with urllib.request.urlopen(vt.url + "frame?seq=2", timeout=10) as r:
            assert json.loads(r.read()) == {"seq": 2}
        with urllib.request.urlopen(vt.url, timeout=10) as r:
            assert b"<html" in r.read().lower()
    finally:
        vt.stop()


def cloud_arrays(rng, n=500):
    return dict(
        xyz=rng.uniform(-5, 5, (n, 3)).astype(np.float32),
        intensity=rng.uniform(0, 255, n).astype(np.float32),
        color=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
    )


def assert_clouds_equal(a_xyz, a_ch, b_xyz, b_ch):
    np.testing.assert_array_equal(a_xyz, b_xyz)
    assert sorted(a_ch) == sorted(b_ch)
    for k in a_ch:
        np.testing.assert_array_equal(a_ch[k], b_ch[k], err_msg=k)


def host_cloud(cloud):
    """xyz and channels of a cloud of either package, valid points only."""
    if isinstance(cloud, pc_t.PointCloud):
        xyz, mask, ch = pc_t.host_arrays(cloud)
    else:
        xyz, mask = np.asarray(cloud.xyz), np.asarray(cloud.mask)
        ch = {k: np.asarray(v) for k, v in cloud.channels.items()}
    return xyz[mask], {k: v[mask] for k, v in ch.items()}


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("channels", [(), ("intensity",), ("intensity", "color", "normal")])
def test_pcd_round_trips_between_packages(tmp_path, binary, channels):
    rng = np.random.default_rng(7)
    arr = cloud_arrays(rng)
    ch = {k: arr[k] for k in channels}
    vp = (0.5, -1.0, 2.0, 1.0, 0.0, 0.0, 0.0)
    ct = pc_t.from_numpy(arr["xyz"], device="cpu", **ch)
    cj = pc_j.from_numpy(arr["xyz"], **ch)
    pt, pj = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert pcd_t.save_pcd(pt, ct, binary=binary, viewpoint=vp)
    assert pcd_j.save_pcd(pj, cj, binary=binary, viewpoint=vp, use_native=False)
    assert read(pt) == read(pj)
    got_j, meta_j = pcd_j.load_pcd(pt, return_meta=True, use_native=False)
    got_t, meta_t = pcd_t.load_pcd(pj, return_meta=True, device="cpu")
    np.testing.assert_array_equal(meta_t["viewpoint"], meta_j["viewpoint"])
    assert_clouds_equal(*host_cloud(got_j), *host_cloud(got_t))


def test_kitti_bin_and_trajectories_between_packages(tmp_path):
    rng = np.random.default_rng(8)
    xyz = rng.uniform(-20, 20, (1000, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, 1000).astype(np.float32)
    p = str(tmp_path / "000000.bin")
    assert pcd_t.save_kitti_bin(p, pc_t.from_numpy(xyz, intensity=inten, device="cpu"))
    got_j = pcd_j.load_kitti_bin(p, use_native=False)
    got_t = pcd_t.load_kitti_bin(p, device="cpu")
    assert_clouds_equal(*host_cloud(got_j), *host_cloud(got_t))

    K = 6
    poses = np.tile(np.eye(4), (K, 1, 1))
    for k in range(K):
        a = 0.3 * k
        poses[k, :3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        poses[k, :3, 3] = [k, -0.5 * k, 0.1]
    stamps = 1.5 + 0.1 * np.arange(K)
    tum, kitti = str(tmp_path / "t.txt"), str(tmp_path / "k.txt")
    assert pcd_t.save_trajectory_tum(tum, stamps, poses)
    assert pcd_t.save_trajectory_kitti(kitti, poses)
    for path in (tum, kitti):
        tj, pj = pcd_j.load_trajectory(path)
        tt, pt = pcd_t.load_trajectory(path)
        np.testing.assert_array_equal(pt, pj)
        if tj is None:
            assert tt is None
        else:
            np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(pcd_t.load_trajectory_kitti(kitti),
                                  pcd_j.load_trajectory_kitti(kitti))
    tj2 = str(tmp_path / "tj.txt")
    pcd_j.save_trajectory_tum(tj2, stamps, poses)
    assert read(tj2) == read(tum)


def test_color_packing_equals_jax():
    import torch
    from fastdem_tpu.utils import colors as colors_j

    rgb = np.random.default_rng(9).integers(0, 256, (40, 3)).astype(np.uint8)
    ref = np.asarray(colors_j.pack_rgb(jnp.asarray(rgb)))
    np.testing.assert_array_equal(colors_t.pack_rgb(rgb).view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(
        colors_t.pack_rgb(torch.tensor(rgb)).numpy().view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(colors_t.unpack_rgb(ref), rgb)
    np.testing.assert_array_equal(colors_t.unpack_rgb(torch.tensor(ref)).numpy(), rgb)
