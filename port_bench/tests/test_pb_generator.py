import numpy as np
import pytest
import torch

from port_bench.harness import bench, poses, scans


def _log(seed, n=2, **sensor):
    _, _, cfg, tr = bench.cell_inputs("local_vlp16.replay")
    cfg["scene"]["boxes"] = 80
    cfg["sensor"].update(sensor)
    tr["log_scans"] = n
    return cfg, scans.make_log(cfg, tr, seed, "cpu")


def test_same_seed_same_log_other_seed_other_log():
    _, a = _log(2**31 + 7)
    _, b = _log(2**31 + 7)
    _, c = _log(2**31 + 8)
    for x, y in zip(a.xyz, b.xyz):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.T_wb, b.T_wb)
    assert any(x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(a.xyz, c.xyz))


def test_vlp16_geometry():
    cfg, log = _log(3_000_000_001)
    s = cfg["sensor"]
    assert s["beams"] == 16 and s["azimuth_step_deg"] == 0.2
    rays = 16 * 1800
    for xyz in log.xyz:
        assert 0 < xyz.shape[0] < rays  # rays without a return are dropped
        r = np.linalg.norm(xyz.astype(np.float64), axis=1)
        assert r.max() <= s["max_range_m"] + 6 * s["range_noise_m"]
        el = np.degrees(np.arcsin(xyz[:, 2] / r))
        rings = np.round((el + 15.0) / 2.0)
        np.testing.assert_allclose(el, -15.0 + 2.0 * rings, atol=1e-3)
        assert set(np.unique(rings).astype(int)) <= set(range(16))
        assert len(np.unique(rings)) >= 8  # every beam below the horizon returns
        az = np.degrees(np.arctan2(xyz[:, 1], xyz[:, 0])) % 360.0
        steps = az / 0.2
        np.testing.assert_allclose(steps, np.round(steps), atol=5e-3)


def test_ground_beams_hit_the_terrain_near_the_sensor():
    cfg, log = _log(5)
    xyz = log.xyz[0].astype(np.float64)
    el = np.degrees(np.arcsin(xyz[:, 2] / np.linalg.norm(xyz, axis=1)))
    steep = xyz[np.abs(el + 15.0) < 0.01]
    # The -15 degree beam from 1 m up meets the ground at about 3.7 m.
    r = np.hypot(steep[:, 0], steep[:, 1])
    assert 2.5 < np.median(r) < 5.5


def test_scan_poses_are_the_odometry_buffers_interpolation():
    _, log = _log(9)
    for k in range(len(log)):
        np.testing.assert_array_equal(
            log.T_wb[k], poses.lookup(log.odom_ns, log.odom_T, int(log.stamps_ns[k])))


def test_scan_poses_match_the_ports_transform_buffer():
    from fastdem_tpu_torch.runtime.providers import TransformBuffer

    _, log = _log(9)
    buf = TransformBuffer(max_buffer=len(log.odom_ns) + 1)
    for t, T in zip(log.odom_ns, log.odom_T):
        buf.add_pose(int(t), T)
    for k in range(len(log)):
        np.testing.assert_array_equal(buf.get_pose_at(int(log.stamps_ns[k])), log.T_wb[k])


@pytest.mark.card
def test_generator_on_the_card_is_deterministic(card):
    _, _, cfg, tr = bench.cell_inputs("local_vlp16.replay")
    tr["log_scans"] = 8
    a = scans.make_log(cfg, tr, 2**33 + 1, card)
    b = scans.make_log(cfg, tr, 2**33 + 1, card)
    for x, y in zip(a.xyz, b.xyz):
        np.testing.assert_array_equal(x, y)
    assert torch.cuda.is_available()
