"""The port's runtime (presets, node config, providers, bridge, wire codecs,
the mapping driver and the node tool) against the JAX package's, on the
CPU.

* Each preset dict equals ``yaml.safe_load`` of the JAX package's file,
  and ``NodeConfig.parse`` of it gives the JAX node config's fields (enums
  compared by value).
* ``TransformBuffer`` answers exactly as JAX's: interpolation, staleness,
  the latest-pose fallback, extrinsics.
* The bridge payloads and the wire messages (``map_to_pointcloud2``,
  ``map_to_gridmap_msg``, cloud <-> PointCloud2 and PCL records) are
  byte-identical to JAX's on the same state.
* ``MappingDriver`` sync and async on the same scans as JAX's driver: the
  port's two intakes agree bit for bit, and with JAX's map at the pipeline
  tolerance of ``test_torch_pipeline.py``; ``run_postprocess`` on the map
  JAX made, carried in with ``state_from_numpy``, agrees with JAX's at the
  tolerances of ``test_torch_postprocess.py``.

Async intake is waited on with ``drain()`` and timers with events, never
with sleeps.
"""

import dataclasses
import enum
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import yaml

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.cloud import pointcloud as pc_j
from fastdem_tpu.runtime import bridge as bridge_j
from fastdem_tpu.runtime import driver as driver_j
from fastdem_tpu.runtime import node_config as nc_j
from fastdem_tpu.runtime import providers as prov_j
from fastdem_tpu.runtime import wire as wire_j
from fastdem_tpu_torch import presets
from fastdem_tpu_torch.cloud import pointcloud as pc_t
from fastdem_tpu_torch.interop import state_from_numpy
from fastdem_tpu_torch.runtime import bridge as bridge_t
from fastdem_tpu_torch.runtime import driver as driver_t
from fastdem_tpu_torch.runtime import node_config as nc_t
from fastdem_tpu_torch.runtime import providers as prov_t
from fastdem_tpu_torch.runtime import wire as wire_t
from test_torch_io import jax_state, port_pair
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import assert_layers_agree
from test_torch_postprocess import assert_layer, layer_tol
from test_torch_replay import near_ties

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET_DIR = os.path.join(ROOT, "fastdem_tpu", "config", "presets")


# ---- presets and the node config ------------------------------------------

def test_presets_are_the_yaml_files():
    files = sorted(f[:-5] for f in os.listdir(PRESET_DIR) if f.endswith(".yaml"))
    assert presets.names() == files
    for name in files:
        with open(os.path.join(PRESET_DIR, name + ".yaml")) as f:
            assert presets.get(name) == yaml.safe_load(f), name
    # Callers get a copy: changing it leaves the preset as it was.
    p = presets.get("local_mapping")
    p["map"]["width"] = -1.0
    assert presets.get("local_mapping")["map"]["width"] == 15.0
    with pytest.raises(KeyError, match="unknown preset"):
        presets.get("nope")


def plain(obj):
    """A dataclass tree as dicts, enums by value."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("name", presets.names())
def test_node_config_equals_jax(name):
    path = os.path.join(PRESET_DIR, name + ".yaml")
    ref = plain(nc_j.NodeConfig.load(path))
    assert plain(nc_t.NodeConfig.from_preset(name)) == ref
    assert plain(nc_t.NodeConfig.load(path)) == ref
    assert isinstance(nc_t.NodeConfig.from_preset(name).pipeline, ft.Config)


def test_load_postprocess_equals_jax():
    from fastdem_tpu.config import config as cfg_j

    path = os.path.join(PRESET_DIR, "postprocess.yaml")
    ref = plain(cfg_j.load_postprocess(path))
    assert plain(ft.config.load_postprocess(path)) == ref
    assert plain(ft.config.parse_postprocess(presets.get("postprocess"))) == ref
    assert plain(ft.config.load_config(path)) == plain(cfg_j.load_config(path))


def test_node_config_validation_and_missing_yaml(monkeypatch, tmp_path):
    for root, match in (({"map": {"width": -1.0}}, "map geometry"),
                        ({"topics": {"input_scans": []}}, "input_scans"),
                        ({"topics": {"publish_rate": 0}}, "publish_rate"),
                        ({"tf": {"max_stale_time": -1}}, "max_stale_time")):
        with pytest.raises(ValueError, match=match):
            nc_t.NodeConfig.parse(root)
    with pytest.raises(ValueError, match="empty"):
        nc_t.NodeConfig.load("")
    path = tmp_path / "n.yaml"
    path.write_text("map: {width: 4.0}\n")
    assert nc_t.NodeConfig.load(str(path)).map.width == 4.0
    # Without PyYAML a YAML file is refused, naming the presets; a preset
    # still loads.
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="--preset"):
        nc_t.NodeConfig.load(str(path))
    with pytest.raises(ImportError, match="--preset"):
        ft.config.load_config(str(path))
    assert nc_t.NodeConfig.from_preset("global_mapping_node").map.width == 200.0


# ---- providers ---------------------------------------------------------------

def pose(k):
    a = 0.2 * k
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    T[:3, 3] = [0.5 * k, -0.3 * k, 0.01 * k]
    return T


@pytest.mark.parametrize("fallback", [False, True])
def test_transform_buffer_answers_equal_jax(fallback):
    bufs = [m.TransformBuffer("base", "odom", max_stale_time=0.05,
                              use_latest_fallback=fallback) for m in (prov_j, prov_t)]
    times = [10**9, 11 * 10**8, 13 * 10**8, 2 * 10**9]
    for b in bufs:
        assert b.get_pose_at(10**9) is None  # empty
        for k in (2, 0, 3, 1):  # out of order
            b.add_pose(times[k], pose(k))
        b.set_extrinsic("lidar", pose(5))
    queries = [0, 1, 10**9, 104 * 10**7, 105 * 10**7, 12 * 10**8, 13 * 10**8,
               1349 * 10**6, 1351 * 10**6, 2 * 10**9, 3 * 10**9, 5 * 10**8]
    for t in queries:
        a, b = (buf.get_pose_at(t) for buf in bufs)
        if a is None:
            assert b is None, t
        else:
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a, err_msg=str(t))
    for name in ("lidar", "camera", ""):
        a, b = (buf.get_extrinsic(name) for buf in bufs)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(bufs[1].latest()[1], bufs[0].latest()[1])
    a, b = (m.StaticOdometry("w", pose(1)).get_pose_at(7) for m in (prov_j, prov_t))
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(b, a)


# ---- bridge and wire ---------------------------------------------------------

def with_normals(seed):
    """``jax_state`` with unit normals and a slope layer where elevation is
    finite."""
    import jax.numpy as jnp

    geom, state = jax_state(seed=seed)
    rng = np.random.default_rng(seed + 100)
    n = rng.normal(size=geom.shape + (3,)) + [0, 0, 3]
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    nan = np.isnan(np.asarray(state.layers["elevation"]))
    new = {f"normal_{a}": jnp.asarray(np.where(nan, np.nan, n[..., i]).astype(np.float32))
           for i, a in enumerate("xyz")}
    new["slope"] = jnp.asarray(np.where(nan, np.nan, rng.uniform(0, 60, geom.shape))
                               .astype(np.float32))
    return geom, state.replace_layers(new)


def assert_same(a, b, what=""):
    """Equal structures, arrays equal as bytes (dtype included)."""
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif dataclasses.is_dataclass(a):
        assert_same(dataclasses.asdict(a), dataclasses.asdict(b), what)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("seed", [0, 1])
def test_bridge_outputs_equal_jax(seed):
    geom_j, state_j = with_normals(seed)
    geom_t, state_t = port_pair(geom_j, state_j)
    sub = (slice(2, 15), slice(5, 25))
    for submap in (None, sub):
        assert_same(bridge_j.to_structured_cloud(geom_j, state_j, submap=submap),
                    bridge_t.to_structured_cloud(geom_t, state_t, submap=submap))
    assert_same(bridge_j.to_grid_message(geom_j, state_j, "odom", 7),
                bridge_t.to_grid_message(geom_t, state_t, "odom", 7))
    for stride in (1, 3):
        assert_same(bridge_j.to_normal_markers(geom_j, state_j, stride=stride),
                    bridge_t.to_normal_markers(geom_t, state_t, stride=stride))
    assert_same(bridge_j.to_map_boundary(geom_j, state_j),
                bridge_t.to_map_boundary(geom_t, state_t))


@pytest.mark.parametrize("seed", [0, 1])
def test_map_messages_equal_jax(seed):
    geom_j, state_j = with_normals(seed)
    geom_t, state_t = port_pair(geom_j, state_j)
    for submap in (None, (slice(1, 9), slice(0, 30))):
        assert_same(wire_j.map_to_pointcloud2(geom_j, state_j, "map", 5, submap=submap),
                    wire_t.map_to_pointcloud2(geom_t, state_t, "map", 5, submap=submap))
    assert_same(wire_j.map_to_gridmap_msg(geom_j, state_j, "map", 9),
                wire_t.map_to_gridmap_msg(geom_t, state_t, "map", 9))


def clouds_both(seed, n=400, **which):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    chans = dict(intensity=rng.uniform(0, 200, n).astype(np.float32),
                 ring=rng.integers(0, 32, n).astype(np.int32),
                 time=rng.uniform(0, 0.1, n).astype(np.float32),
                 color=rng.integers(0, 256, (n, 3)).astype(np.uint8),
                 label=rng.integers(0, 9, n).astype(np.int32),
                 normal=rng.normal(size=(n, 3)).astype(np.float32))
    chans = {k: v for k, v in chans.items() if k in which.get("channels", chans)}
    mask = rng.random(n) > 0.1
    xyz_m = np.where(mask[:, None], xyz, np.nan).astype(np.float32)
    return (pc_j.from_numpy(xyz_m, frame_id="lidar", **chans),
            pc_t.from_numpy(xyz_m, frame_id="lidar", device="cpu", **chans))


def cloud_fields(cloud):
    if isinstance(cloud, pc_t.PointCloud):
        xyz, m, ch = pc_t.host_arrays(cloud)
    else:
        xyz, m = np.asarray(cloud.xyz), np.asarray(cloud.mask)
        ch = {k: np.asarray(v) for k, v in cloud.channels.items()}
    return {"xyz": xyz[m], **{k: v[m] for k, v in ch.items()}}


@pytest.mark.parametrize("channels", [(), ("intensity", "ring", "time", "color", "label",
                                           "normal")])
def test_cloud_codecs_equal_jax(channels):
    cj, ct = clouds_both(3, channels=channels)
    mj = wire_j.cloud_to_pointcloud2(cj, stamp_ns=11)
    mt = wire_t.cloud_to_pointcloud2(ct, stamp_ns=11)
    assert_same(mj, mt)
    assert_same(cloud_fields(wire_j.pointcloud2_to_cloud(mj)),
                cloud_fields(wire_t.pointcloud2_to_cloud(mj, device="cpu")))
    types = ["PointXYZ", "PointXYZI"] + (["PointXYZRGB", "PointXYZINormal"] if channels else [])
    for point_type in types:
        rj = wire_j.cloud_to_pcl(cj, point_type)
        rt = wire_t.cloud_to_pcl(ct, point_type)
        assert_same(rj, rt, point_type)
        assert_same(cloud_fields(wire_j.pcl_to_cloud(rj, "f")),
                    cloud_fields(wire_t.pcl_to_cloud(rj, "f", device="cpu")), point_type)


# ---- the mapping driver --------------------------------------------------------

N_SCANS = 6
N_POINTS = 3000


def driver_scans():
    """Sensor-frame scans, poses moving along x, timestamps 1 s apart."""
    rng = np.random.default_rng(12)
    out = []
    for k in range(N_SCANS):
        ang = rng.uniform(0, 2 * np.pi, N_POINTS)
        rad = rng.uniform(0.5, 3.5, N_POINTS)
        x, y = rad * np.cos(ang), rad * np.sin(ang)
        z = 0.2 * np.sin(0.7 * (x + 0.25 * k)) * np.cos(0.5 * y) - 1.0 + rng.normal(
            0, 0.02, N_POINTS)
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.25 * k
        out.append((np.column_stack([x, y, z]).astype(np.float32), T, (k + 1) * 10**9))
    return out


def make_driver(pkg, **kw):
    """A driver of either package on an 8x8 m map at 0.1 m (raycast on),
    providers from a TransformBuffer, timers off unless given."""
    fd = fj if pkg == "jax" else ft
    prov, drv = (prov_j, driver_j) if pkg == "jax" else (prov_t, driver_t)
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    pp = fd.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    calib = prov.StaticCalibration("base")
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    calib.set_extrinsic("lidar", T_bs)
    odom = prov.TransformBuffer("base", "map")
    for _, T, t in driver_scans():
        odom.add_pose(t, T)
    kw.setdefault("postprocess_rate", 0.0)
    kw.setdefault("viz_rate", 0.0)
    if pkg != "jax":
        kw["device"] = "cpu"
    return drv.MappingDriver(fd.GridGeometry.from_length(8.0, 8.0, 0.1), cfg,
                             postprocess_cfg=pp, calibration=calib, odometry=odom, **kw)


def feed(d, pkg):
    cloud = pc_j.from_numpy if pkg == "jax" else (
        lambda xyz, **kw: pc_t.from_numpy(xyz, device="cpu", **kw))
    for xyz, _, t in driver_scans():
        assert d.on_scan(cloud(xyz, frame_id="lidar", timestamp_ns=t))


@pytest.fixture(scope="module")
def jax_driver_run():
    """JAX's driver over the scans: its map and its post-processing."""
    with make_driver("jax") as d:
        feed(d, "jax")
        layers = {k: np.asarray(v) for k, v in d.mapper.state.layers.items()}
        position = np.asarray(d.mapper.state.position)
        pp = d.run_postprocess()
    return layers, position, pp


@pytest.fixture(scope="module")
def port_sync_state():
    with make_driver("port") as d:
        feed(d, "port")
        assert d.scan_count == N_SCANS
        return d.mapper.state


@pytest.mark.parametrize("burst", [1, 3, 8])
def test_async_driver_equals_sync_bitwise(port_sync_state, burst):
    with make_driver("port", async_intake=True, burst_batch=burst) as d:
        feed(d, "port")
        assert d.drain(timeout=120.0)
        assert (d.scan_count, d.dropped_scans, d.intake_errors) == (N_SCANS, 0, 0)
        for name, ref in port_sync_state.layers.items():
            np.testing.assert_array_equal(d.mapper.state.layers[name].numpy().view(np.int32),
                                          ref.numpy().view(np.int32), err_msg=name)


def test_mixed_scan_sizes_burst_equals_sync():
    """Scans of 3,000 and 30,000 points in the same bursts (the small ones
    with near-ties in z, see ``near_ties``): each integrates at its own
    capacity, which sets the rasterizer's z quantum, so how the arrivals
    group into bursts leaves the map as the sync intake's, bit for bit."""
    rng = np.random.default_rng(13)
    scans = [(np.concatenate([xyz] + [xyz + rng.normal(0, 0.01, xyz.shape).astype(np.float32)
                                      for _ in range(9)]) if k % 2 else near_ties(xyz), t)
             for k, (xyz, _, t) in enumerate(driver_scans())]
    assert [len(x) for x, _ in scans[:2]] == [N_POINTS, 10 * N_POINTS]
    states = []
    for kw in ({}, {"async_intake": True, "burst_batch": N_SCANS}):
        with make_driver("port", **kw) as d:
            for xyz, t in scans:
                assert d.on_scan(pc_t.from_numpy(xyz, frame_id="lidar", timestamp_ns=t,
                                                 device="cpu"))
            assert d.drain(timeout=120.0)
            assert (d.scan_count, d.dropped_scans, d.intake_errors) == (N_SCANS, 0, 0)
            states.append(d.mapper.state)
    for name, ref in states[0].layers.items():
        np.testing.assert_array_equal(states[1].layers[name].numpy().view(np.int32),
                                      ref.numpy().view(np.int32), err_msg=name)


def test_tick_takes_the_lock_between_the_scans_of_a_burst(port_sync_state):
    """A burst of 4 scans takes the driver's lock per scan and hands it to
    a waiting thread between scans: a thread that starts waiting for the
    lock during the burst's first scan gets it right after that scan, not
    after the burst; and the map is still the sync intake's, bit for bit.
    Synchronised by events and the lock's own waiter count, not sleeps."""
    in_scan, seen = threading.Event(), []

    with make_driver("port", async_intake=True, burst_batch=4) as d:
        integrate = d.mapper.integrate

        def first_scan_waits_for_a_reader(*args):
            ok = integrate(*args)
            if not in_scan.is_set():
                in_scan.set()
                with d._lock._cond:  # the reader is queued on the lock
                    assert d._lock._cond.wait_for(lambda: d._lock.waiting > 0, 60.0)
            return ok

        def tick():
            assert in_scan.wait(timeout=60.0)
            with d._lock:
                seen.append(d.scan_count)

        d.mapper.integrate = first_scan_waits_for_a_reader
        ticker = threading.Thread(target=tick)
        ticker.start()
        scans = driver_scans()
        with d._qcond:  # the burst's four scans queue before the worker wakes
            for xyz, _, t in scans[:4]:
                assert d.on_scan(pc_t.from_numpy(xyz, frame_id="lidar", timestamp_ns=t,
                                                 device="cpu"))
        for xyz, _, t in scans[4:]:
            assert d.on_scan(pc_t.from_numpy(xyz, frame_id="lidar", timestamp_ns=t,
                                             device="cpu"))
        assert d.drain(timeout=120.0)
        ticker.join(timeout=60.0)
        assert seen == [1]
        assert (d.scan_count, d.dropped_scans, d.intake_errors) == (N_SCANS, 0, 0)
        for name, ref in port_sync_state.layers.items():
            np.testing.assert_array_equal(d.mapper.state.layers[name].numpy().view(np.int32),
                                          ref.numpy().view(np.int32), err_msg=name)


def test_drivers_map_equals_jax(jax_driver_run, port_sync_state):
    layers, position, _ = jax_driver_run
    np.testing.assert_array_equal(position, port_sync_state.position.numpy())
    assert_layers_agree(layers, port_sync_state)
    assert torch.isfinite(port_sync_state.layers["elevation"]).sum() > 3000


def test_run_postprocess_equals_jax(jax_driver_run):
    """On the map JAX made: the chain and each service against JAX's."""
    layers, position, ref = jax_driver_run
    with make_driver("port") as d:
        d.mapper.state = state_from_numpy(layers, position, device="cpu")
        d._scan_count = N_SCANS
        got = d.run_postprocess()
        assert sorted(got) == sorted(ref)
        for name in ref:
            assert isinstance(got[name], np.ndarray)
            assert_layer(name, ref[name], got[name], layer_tol(name))
        assert np.isfinite(got["slope"]).sum() > 2000
        assert "slope" in d.run_feature_extraction()
        assert "upper_bound" in d.run_uncertainty_fusion()
        assert "elevation" in d.run_inpainting()


def test_snapshot_is_a_copy():
    """The post-processing snapshot clones its layers: an in-place change
    of the live map (the tensors the timers read and the next scan
    updates) after it leaves the snapshot as it was."""
    with make_driver("port") as d:
        feed(d, "port")
        snap = d.snapshot()
        assert sorted(snap.layers) == sorted(driver_t.SNAPSHOT_LAYERS)
        before = snap.layers["elevation"].clone()
        live = d.mapper.live_state().layers["elevation"]
        live.fill_(7.0)
        assert torch.equal(d.mapper.state.layers["elevation"], live)
        assert torch.equal(snap.layers["elevation"].nan_to_num(), before.nan_to_num())


def test_driver_async_with_timers_sinks_and_services(tmp_path):
    """Async bursts, the viz and post-processing timers, sinks and a
    service call mid-stream: the map is whole, each timer ticked, every
    published payload is host numpy without internal layers."""
    got = {k: [] for k in ("map", "postprocess", "pointcloud2", "gridmap_msg",
                           "global_submap")}
    ticked = {k: threading.Event() for k in got}

    def sink(topic):
        def cb(payload):
            got[topic].append(payload)
            ticked[topic].set()
        return cb

    with make_driver("port", async_intake=True, burst_batch=3, postprocess_rate=50.0,
                     viz_rate=50.0, global_rate=50.0, global_window=(2.0, 2.0),
                     artifact_dir=str(tmp_path)) as d:
        for topic in got:
            d.sinks[topic] = sink(topic)
        feed(d, "port")
        d.run_inpainting()
        assert d.drain(timeout=120.0)
        for topic, ev in ticked.items():
            assert ev.wait(timeout=60.0), topic
        assert (d.scan_count, d.dropped_scans, d.intake_errors) == (N_SCANS, 0, 0)
    for name in ("map", "postprocess", "viz", "global"):
        assert len(d.tick_ms[name if name != "map" else "viz"]) > 0
    payload = got["map"][-1]
    assert not any(k.startswith("_") for k in payload["layers"])
    assert all(isinstance(v, np.ndarray) for v in payload["layers"].values())
    # Bursts integrate scan by scan, so the last scan's points ride along.
    assert payload["scan_xyz"].dtype == np.float32 and payload["scan_xyz"].shape[1] == 3
    assert got["global_submap"][-1]["elevation"].shape == (20, 20)
    assert isinstance(got["pointcloud2"][-1], wire_t.PointCloud2)
    assert (tmp_path / "map_latest.npz").exists() and (tmp_path / "map_latest.html").exists()


def test_viz_payload_carries_the_last_scan():
    """With sync intake the viz payload holds the last scan's surviving
    points (world frame) beside the non-internal layers."""
    got = []
    ticked = threading.Event()

    def sink(payload):
        got.append(payload)
        ticked.set()

    with make_driver("port", viz_rate=50.0) as d:
        d.sinks["map"] = sink
        feed(d, "port")
        assert ticked.wait(timeout=60.0)
    payload = got[-1]
    assert payload["scan_count"] >= 1
    assert payload["scan_xyz"].dtype == np.float32 and payload["scan_xyz"].shape[1] == 3
    assert 1000 < payload["scan_xyz"].shape[0] <= N_POINTS
    assert not any(k.startswith("_") for k in payload["layers"])


def test_intake_error_is_counted():
    """A burst that raises is logged and counted; the worker goes on."""
    with make_driver("port", async_intake=True, burst_batch=1) as d:
        assert d.on_scan("not a cloud")
        feed(d, "port")
        assert d.drain(timeout=120.0)
        assert (d.intake_errors, d.scan_count) == (1, N_SCANS)


DEFAULT_DEVICE_ENTRY_POINTS = {
    "FastDEM": lambda g: ft.FastDEM(g, ft.Config()),
    "build_integrate": lambda g: ft.build_integrate(g, ft.Config()),
    "create_map_state": lambda g: ft.create_map_state(g, ft.Config()),
    "gridmap.create": lambda g: ft.gridmap.create(g, {"elevation": 0.0}),
    "state_from_numpy": lambda g: state_from_numpy(
        {"elevation": np.zeros(g.shape, np.float32)}, np.zeros(2, np.float32)),
    "MappingDriver": lambda g: driver_t.MappingDriver(g, ft.Config()),
    "NodeConfig.make_driver": lambda g: nc_t.NodeConfig.from_preset(
        "local_mapping").make_driver(),
}


@pytest.mark.parametrize("entry", sorted(DEFAULT_DEVICE_ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """Without a device argument the entry points run on the card; where
    there is none they raise, with no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_ENTRY_POINTS[entry](ft.GridGeometry.from_length(2.0, 2.0, 0.1))


def run_node(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "fastdem_tpu_torch.tools.fastdem_node", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("intake", ["sync", "async"])
def test_node_tool_on_the_cpu(tmp_path, intake):
    extra = ["--async-intake", "--burst", "2"] if intake == "async" else []
    r = run_node("--preset", "local_mapping", "--synthetic", "3", "--device", "cpu",
                 "--out", str(tmp_path), *extra)
    assert r.returncode == 0, r.stderr
    assert "integrated 3 scans" in r.stdout
    for name in ("map_final.npz", "elevation.png", "slope.png", "map_cloud.npy"):
        assert (tmp_path / name).stat().st_size > 0, name
    geom, state, _ = ft.io.load_npz(str(tmp_path / "map_final.npz"), device="cpu")
    assert torch.isfinite(state.layers["elevation"]).sum() > 10000


def test_node_tool_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run_node("--preset", "local_mapping", "--synthetic", "1", "--out", str(tmp_path))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
