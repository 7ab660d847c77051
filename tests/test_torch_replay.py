"""Batched replay on the port (``build_integrate_sequence``,
``FastDEM.integrate_sequence``, ``tools/fastdem_replay``), on the CPU.

The port's sequence runs the per-scan step frame after frame, so its map
equals the step loop's (and the facade's ``integrate`` loop's) bit for bit
on every layer: padding frames, per-scan extrinsics, providers that drop
scans and the intensity / color channels included. Against the JAX
package's jitted sequence the map is held to the pipeline tolerance of
``test_torch_pipeline.py``: rtol 1e-5, atol 1e-6 on at least 99.9% of the
cells of every layer, ``n_points`` and the NaN set of ``elevation`` exact.

Scans hold 3000 points: padded to the 4096 bucket, their point-index width
(which sets the rasterizer's z quantum) is the unpadded one.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.mapping import pipeline as pipe_j
from fastdem_tpu_torch.mapping import pipeline as pipe_t
from fastdem_tpu_torch.runtime.providers import StaticCalibration, TransformBuffer
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import assert_layers_agree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3000


def scans(K, rng, n=N, step_x=0.3):
    """K sensor-frame scans over a wavy floor and poses moving along x."""
    ang = rng.uniform(0, 2 * np.pi, (K, n))
    rad = rng.uniform(0.5, 3.5, (K, n))
    x, y = rad * np.cos(ang), rad * np.sin(ang)
    z = 0.2 * np.sin(0.7 * x) * np.cos(0.5 * y) - 1.0 + rng.normal(0, 0.02, (K, n))
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = step_x * np.arange(K)
    poses[:, 1, 3] = -0.07 * np.arange(K)
    return xyz, poses


def config(raycast=True, mode=None):
    cfg = ft.Config()
    cfg.raycasting.enabled = raycast
    if mode is not None:
        cfg.mapping.mode = mode
    return cfg


@pytest.fixture(scope="module")
def geom():
    return ft.GridGeometry.from_length(8.0, 8.0, 0.1)


def assert_bitwise(a, b):
    assert list(a.layers) == list(b.layers)
    for name in a.layers:
        np.testing.assert_array_equal(
            a.layers[name].numpy().view(np.int32), b.layers[name].numpy().view(np.int32),
            err_msg=f"layer {name}",
        )
    np.testing.assert_array_equal(a.position.numpy(), b.position.numpy())


def step_loop(geom, cfg, xyz, mask, tbs, poses, intensity=None):
    step = ft.build_integrate(geom, cfg, has_intensity=intensity is not None, device="cpu")
    state = ft.create_map_state(geom, cfg, has_intensity=intensity is not None, device="cpu")
    for k in range(xyz.shape[0]):
        state, _ = step(
            state, torch.tensor(xyz[k]), torch.tensor(mask[k]),
            torch.tensor(tbs if tbs.ndim == 2 else tbs[k]), torch.tensor(poses[k]),
            None if intensity is None else torch.tensor(intensity[k]),
        )
    return state


def sequence(geom, cfg, xyz, mask, tbs, poses, intensity=None):
    seq = pipe_t.build_integrate_sequence(
        geom, cfg, has_intensity=intensity is not None, device="cpu"
    )
    state = ft.create_map_state(geom, cfg, has_intensity=intensity is not None, device="cpu")
    return seq(
        state, torch.tensor(xyz), torch.tensor(mask), torch.tensor(tbs), torch.tensor(poses),
        None if intensity is None else torch.tensor(intensity),
    )


@pytest.mark.parametrize("case", ["raycast", "no_raycast", "local_intensity",
                                  "per_scan_extrinsic", "sparse_frame"])
def test_sequence_equals_step_loop_bitwise(geom, case):
    rng = np.random.default_rng(3)
    K = 4
    xyz, poses = scans(K, rng)
    mask = np.ones((K, N), dtype=bool)
    tbs = np.eye(4, dtype=np.float32)
    tbs[2, 3] = 1.0
    intensity = None
    cfg = config(raycast=case != "no_raycast")
    if case == "local_intensity":
        cfg = config(mode=ft.MappingMode.LOCAL)
        intensity = rng.uniform(0, 100, (K, N)).astype(np.float32)
    if case == "per_scan_extrinsic":
        tbs = np.tile(tbs, (K, 1, 1))
        tbs[:, 2, 3] = np.linspace(0.5, 1.5, K)
        tbs[:, 0, 3] = np.linspace(0.0, 0.4, K)
    if case == "sparse_frame":
        mask[2, 500:] = False
    ref = step_loop(geom, cfg, xyz, mask, tbs, poses, intensity)
    got = sequence(geom, cfg, xyz, mask, tbs, poses, intensity)
    assert_bitwise(got, ref)
    assert torch.isfinite(got.layers["elevation"]).sum() > 1500


@pytest.mark.parametrize("raycast", [False, True])
def test_padding_frames_change_nothing(geom, raycast):
    """Empty frames at the last pose leave every layer as it was, in LOCAL
    mode (the move is a no-op) and on the per-frame layers (obstacle,
    raycasting)."""
    rng = np.random.default_rng(4)
    cfg = config(raycast=raycast, mode=ft.MappingMode.LOCAL)
    K, pad = 3, 3
    xyz, poses = scans(K, rng, step_x=0.75)
    mask = np.ones((K, N), dtype=bool)
    tbs = np.eye(4, dtype=np.float32)
    xyz_p = np.concatenate([xyz, np.repeat(xyz[-1:], pad, 0)])
    mask_p = np.concatenate([mask, np.zeros((pad, N), dtype=bool)])
    poses_p = np.concatenate([poses, np.repeat(poses[-1:], pad, 0)])
    assert_bitwise(sequence(geom, cfg, xyz_p, mask_p, tbs, poses_p),
                   sequence(geom, cfg, xyz, mask, tbs, poses))


def test_microbatch_is_not_ported(geom, caplog):
    """The reference's microbatch checks (the batched step itself:
    ``tests/test_torch_microbatch.py``): m >= 1; m * (cells + 1) within
    2^21; K a multiple of m at the call; and a configuration without a
    batched phase A (the sampled raycast) runs scan by scan with a
    warning, its map the loop's."""
    with pytest.raises(ValueError, match="microbatch"):
        pipe_t.build_integrate_sequence(geom, config(), microbatch=0, device="cpu")
    big = ft.GridGeometry.from_length(60.0, 60.0, 0.1)  # 360,000 cells
    with pytest.raises(ValueError, match="microbatch=8"):
        pipe_t.build_integrate_sequence(big, config(), microbatch=8, device="cpu")
    seq = pipe_t.build_integrate_sequence(geom, config(), microbatch=4, device="cpu")
    rng = np.random.default_rng(2)
    xyz, poses = scans(6, rng, n=500)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        seq(ft.create_map_state(geom, config(), device="cpu"), torch.tensor(xyz),
            torch.ones(6, 500, dtype=torch.bool), torch.eye(4), torch.tensor(poses))
    cfg = config()
    cfg.raycasting.method = "sampled"
    with caplog.at_level("WARNING", logger="fastdem_tpu_torch"):
        seq = pipe_t.build_integrate_sequence(geom, cfg, microbatch=2, device="cpu")
    assert any("scan by scan" in r.message for r in caplog.records)
    mask = np.ones((6, 500), dtype=bool)
    tbs = np.eye(4, dtype=np.float32)
    got = seq(ft.create_map_state(geom, cfg, device="cpu"), torch.tensor(xyz),
              torch.tensor(mask), torch.tensor(tbs), torch.tensor(poses))
    assert_bitwise(got, step_loop(geom, cfg, xyz, mask, tbs, poses))


def clouds_of(xyz, **kw):
    return [ft.cloud.from_numpy(xyz[k], device="cpu",
                                **{n: v[k] for n, v in kw.items()}) for k in range(len(xyz))]


@pytest.mark.parametrize("channels", [False, True])
def test_facade_sequence_equals_integrate_loop(geom, channels):
    """Seven scans in batches of 3 (a short last batch) equal seven
    ``integrate`` calls; with channels, intensity and color included."""
    rng = np.random.default_rng(5)
    K = 7
    xyz, poses = scans(K, rng)
    tbs = np.eye(4, dtype=np.float32)
    tbs[2, 3] = 1.0
    kw = {}
    if channels:
        kw = dict(intensity=rng.uniform(0, 100, (K, N)).astype(np.float32),
                  color=rng.integers(0, 256, (K, N, 3)).astype(np.uint8))
    clouds = clouds_of(xyz, **kw)
    m1 = ft.FastDEM(geom, config(), has_intensity=channels, has_color=channels, device="cpu")
    for k in range(K):
        assert m1.integrate(clouds[k], tbs, poses[k])
    m2 = ft.FastDEM(geom, config(), has_intensity=channels, has_color=channels, device="cpu")
    assert m2.integrate_sequence(clouds, tbs, poses, batch=3) == K
    assert_bitwise(m2.state, m1.state)
    if channels:
        assert torch.isfinite(m2.state.layers["intensity"]).sum() > 1000
        assert torch.isfinite(m2.state.layers["color"]).sum() > 1000


def near_ties(xyz):
    """The first half of a scan's points, each preceded by a copy 5 mm
    further out and 4 um higher: with a 12-bit point index the z quantum
    tells the pair apart, with 15 bits they tie and the copy (a lower index,
    another range, so another variance) carries the cell's variance."""
    half = xyz[: len(xyz) // 2]
    r = np.hypot(half[:, 0], half[:, 1])[:, None]
    copy = half + np.concatenate([0.005 * half[:, :2] / r, np.full((len(half), 1), 4e-6)], 1)
    return np.stack([copy, half], 1).reshape(-1, 3).astype(np.float32)


def test_facade_sequence_mixed_scan_sizes(geom):
    """Scans of 3,000 and 30,000 points in one call: each integrates at its
    own capacity, as ``integrate`` alone would (the capacity sets the
    rasterizer's z quantum), so the map is the loop's bit for bit and
    ``last_aux`` is the last scan's."""
    rng = np.random.default_rng(11)
    K = 4
    xyz, poses = scans(K, rng)
    big = scans(K, rng, n=10 * N)[0]
    clouds = [ft.cloud.from_numpy(big[k] if k % 2 else near_ties(xyz[k]), device="cpu")
              for k in range(K)]
    assert [c.capacity for c in clouds] == [N, 10 * N, N, 10 * N]
    tbs = np.eye(4, dtype=np.float32)
    tbs[2, 3] = 1.0
    m1 = ft.FastDEM(geom, config(), device="cpu")
    for k in range(K):
        assert m1.integrate(clouds[k], tbs, poses[k])
    m2 = ft.FastDEM(geom, config(), device="cpu")
    assert m2.integrate_sequence(clouds, tbs, poses, batch=3) == K
    assert_bitwise(m2.state, m1.state)
    assert m2.last_aux.world_xyz.shape == (10 * N, 3)


def test_facade_sequence_providers_and_drops(geom):
    """Providers answer per cloud; a scan without a pose, an empty cloud and
    a cloud of an uncalibrated frame are dropped, the rest equal the loop."""
    rng = np.random.default_rng(6)
    K = 5
    xyz, poses = scans(K, rng)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 0.9
    calib = StaticCalibration("base")
    calib.set_extrinsic("lidar", T_bs)
    odom = TransformBuffer("base", "map")
    times = [(k + 1) * 10**9 for k in range(K)]
    for k in range(K - 1):  # no pose near the last scan's time
        odom.add_pose(times[k], poses[k])
    clouds = [ft.cloud.from_numpy(xyz[k], frame_id="lidar", timestamp_ns=times[k],
                                  device="cpu") for k in range(K)]
    clouds.insert(2, ft.cloud.from_numpy(xyz[0][:0], frame_id="lidar", device="cpu"))
    clouds.insert(1, ft.cloud.from_numpy(xyz[0], frame_id="camera",
                                         timestamp_ns=times[0], device="cpu"))
    m = ft.FastDEM(geom, config(), device="cpu")
    assert m.integrate_sequence(clouds, batch=2) == 0  # no providers yet
    m.set_calibration_provider(calib).set_odometry_provider(odom)
    assert m.integrate_sequence(clouds, batch=2) == K - 1
    ref = ft.FastDEM(geom, config(), device="cpu")
    for k in range(K - 1):
        assert ref.integrate(ft.cloud.from_numpy(xyz[k], device="cpu"), T_bs, poses[k])
    assert_bitwise(m.state, ref.state)
    # A pose without an extrinsic is not explicit mode: providers answer.
    m2 = ft.FastDEM(geom, config(), device="cpu")
    m2.set_calibration_provider(calib).set_odometry_provider(odom)
    assert m2.integrate_sequence(clouds, None, poses, batch=2) == K - 1
    assert_bitwise(m2.state, ref.state)


def test_facade_sequence_checks_its_arguments(geom):
    xyz, poses = scans(2, np.random.default_rng(0))
    m = ft.FastDEM(geom, config(), device="cpu")
    clouds = clouds_of(xyz)
    with pytest.raises(ValueError, match="batch"):
        m.integrate_sequence(clouds, np.eye(4), poses, batch=0)
    with pytest.raises(ValueError, match="one pose per cloud"):
        m.integrate_sequence(clouds, np.eye(4), poses[:1])
    with pytest.raises(ValueError, match="one 4x4 or one per cloud"):
        m.integrate_sequence(clouds, np.tile(np.eye(4), (3, 1, 1)), poses)


def test_sequence_matches_jax(geom):
    """The port's sequence against the JAX package's jitted sequence on the
    same scans (LOCAL, raycast, a sparse frame)."""
    rng = np.random.default_rng(8)
    K = 4
    xyz, poses = scans(K, rng)
    mask = np.ones((K, N), dtype=bool)
    mask[1, 2000:] = False
    tbs = np.eye(4, dtype=np.float32)
    tbs[2, 3] = 1.0
    cfg_j = fj.Config()
    cfg_j.raycasting.enabled = True
    geom_j = fj.GridGeometry.from_length(8.0, 8.0, 0.1)
    seq_j = pipe_j.build_integrate_sequence(geom_j, cfg_j, donate=False)
    s_j = seq_j(pipe_j.create_map_state(geom_j, cfg_j), jnp.asarray(xyz), jnp.asarray(mask),
                jnp.asarray(tbs), jnp.asarray(poses))
    s_t = sequence(geom, config(), xyz, mask, tbs, poses)
    np.testing.assert_array_equal(np.asarray(s_j.position), s_t.position.numpy())
    assert_layers_agree(s_j.layers, s_t)
    assert torch.isfinite(s_t.layers["elevation"]).sum() > 1500


def test_facade_sequence_mixed_sizes_against_jax_loop(geom):
    """Mixed 3,000- and 30,000-point scans (near-ties in z) through the
    port's ``FastDEM.integrate_sequence`` and through a loop of JAX's
    ``FastDEM.integrate``: decision layers exact, float layers within rtol /
    atol 1e-5 on >= 99.9% of cells, NaN sets exact. JAX's own
    ``integrate_sequence`` pads the call to one bucket (another z quantum for
    the small scans), so the port's map must differ from it here."""
    rng = np.random.default_rng(11)
    K = 4
    xyz, poses = scans(K, rng)
    big = scans(K, rng, n=10 * N)[0]
    pts = [big[k] if k % 2 else near_ties(xyz[k]) for k in range(K)]
    tbs = np.eye(4, dtype=np.float32)
    tbs[2, 3] = 1.0
    m_t = ft.FastDEM(geom, config(), device="cpu")
    assert m_t.integrate_sequence([ft.cloud.from_numpy(p, device="cpu") for p in pts],
                                  tbs, poses, batch=3) == K
    cfg_j = fj.Config()
    cfg_j.raycasting.enabled = True
    geom_j = fj.GridGeometry.from_length(8.0, 8.0, 0.1)
    loop_j = fj.FastDEM(geom_j, cfg_j)
    for k in range(K):
        assert loop_j.integrate(fj.cloud.from_numpy(pts[k]), tbs, poses[k])
    seq_j = fj.FastDEM(geom_j, cfg_j)
    assert seq_j.integrate_sequence([fj.cloud.from_numpy(p) for p in pts], tbs, poses,
                                    batch=3) == K
    got = {k: v.numpy() for k, v in m_t.state.layers.items()}
    np.testing.assert_array_equal(np.asarray(loop_j.state.position), m_t.state.position.numpy())
    assert set(got) == set(loop_j.state.layers)
    decision = ("n_points", "obstacle")
    for name, ref in loop_j.state.layers.items():
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.isnan(got[name]), np.isnan(ref), err_msg=name)
        if name in decision:
            np.testing.assert_array_equal(got[name], ref, err_msg=name)
        else:
            close = np.isclose(got[name], ref, rtol=1e-5, atol=1e-5, equal_nan=True)
            assert close.mean() >= 0.999, f"{name}: {np.count_nonzero(~close)} cells differ"
    # The divergence from JAX's integrate_sequence, recorded as a share of
    # the mapped cells (it is the padded bucket's z quantum on the small
    # scans' near-ties).
    mapped = np.isfinite(got["elevation"])
    differ = np.zeros_like(mapped)
    for name, ref in seq_j.state.layers.items():
        a, b = got[name].view(np.int32), np.asarray(ref).view(np.int32)
        differ |= (a != b) & ~(np.isnan(got[name]) & np.isnan(np.asarray(ref)))
    share = differ[mapped].mean()
    print(f"port sequence vs JAX integrate_sequence: {share:.4%} of mapped cells differ")
    assert share > 0


def run_tool(module, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_replay_tool_on_the_cpu(tmp_path):
    out = tmp_path / "replay"
    r = run_tool("fastdem_tpu_torch.tools.fastdem_replay", "--preset", "local_mapping",
                 "--synthetic", "3", "--batch", "2", "--device", "cpu",
                 "--out", str(out), "--png")
    assert r.returncode == 0, r.stderr
    assert "scans/s" in r.stderr and "device=cpu" in r.stderr
    for name in ("map.npz", "elevation.png", "variance.png"):
        assert (out / name).stat().st_size > 0, name
    # Resumed from its own checkpoint, the map goes on.
    r = run_tool("fastdem_tpu_torch.tools.fastdem_replay", "--preset", "local_mapping",
                 "--synthetic", "2", "--device", "cpu", "--resume", str(out / "map.npz"))
    assert r.returncode == 0, r.stderr
    assert "resumed" in r.stderr


def test_replay_tool_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run_tool("fastdem_tpu_torch.tools.fastdem_replay", "--preset", "local_mapping",
                 "--synthetic", "1")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_cloud_helpers_match_jax():
    """compact, pad_to, bucket_capacity and has against JAX's; stage on a
    CPU cloud bound for the CPU hands the cloud back."""
    from fastdem_tpu.cloud import pointcloud as pc_j
    from fastdem_tpu_torch.cloud import pointcloud as pc_t

    rng = np.random.default_rng(10)
    xyz = rng.normal(size=(1000, 3)).astype(np.float32)
    xyz[rng.random(1000) < 0.25] = np.nan
    inten = rng.uniform(size=1000).astype(np.float32)
    cj = pc_j.from_numpy(xyz, intensity=inten, frame_id="f", timestamp_ns=5)
    ct = pc_t.from_numpy(xyz, intensity=inten, frame_id="f", timestamp_ns=5, device="cpu")
    for fn in (lambda pc, c: pc.compact(c), lambda pc, c: pc.pad_to(c, 1500)):
        a, b = fn(pc_j, cj), fn(pc_t, ct)
        assert (b.capacity, b.valid_count, b.frame_id, b.timestamp_ns) == (
            a.capacity, a.valid_count, a.frame_id, a.timestamp_ns)
        np.testing.assert_array_equal(b.xyz.numpy(), np.asarray(a.xyz))
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.channels["intensity"].numpy(),
                                      np.asarray(a.channels["intensity"]))
    with pytest.raises(ValueError, match="shrink"):
        pc_t.pad_to(ct, 10)
    assert pc_t.pad_to(ct, ct.capacity) is ct
    for n in (0, 1, 4095, 4096, 4097, 30000, 32768):
        assert pc_t.bucket_capacity(n) == pc_j.bucket_capacity(n)
    assert ct.has("intensity") and not ct.has("color")
