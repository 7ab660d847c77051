"""Tests of the port that need a CUDA card; they skip where there is none.

On a machine with a card and no JAX, run them without the suite's conftest
(which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

K1 against its plain twin bit for bit (at the reference test's shapes, at
edge shapes: folds of 1 and 10 rows, A = 1024, R off the segment sizes, a
tall field that the column pass walks in chunks; and with window tables of
any shift), K4 against its plain twin (bit for bit in both forms, NaN
propagated), the main path's K4 with its index math against its twin
(whole map and window, one and two reads), their launch counters, the
wrappers' input checks, small sessions (flagship,
windowed GLOBAL with Kalman and P^2) on the card against the same sessions
on the CPU, and the post-processing chain and the sampled raycast on the
card against the CPU; batched replay against the integrate loop bit for
bit, the node's driver with async intake against its sync intake,
``stage()``'s pinned copy, and ``integrate_sequence`` with the poses as a
list of CUDA tensors; the grid kNN and radius search against the brute
tile and the CPU, and ``build_dem`` on the card against the CPU.
"""

import numpy as np
import pytest
import torch

import fastdem_tpu_torch as fd
from fastdem_tpu_torch.ops import polar_field as k1
from fastdem_tpu_torch.ops import resample as k4
from fastdem_tpu_torch.postprocess import raycasting as raycast
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def polar_inputs(device, num_az, rbf, maxr, seed=0):
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    rng = np.random.default_rng(seed)
    A, R, dr = raycast.polar_dims(geom, num_az, rbf, maxr)
    tbl = rng.uniform(-2.0, 0.5, R * A).astype(np.float32)
    tbl[rng.random(R * A) < 0.97] = np.inf
    scat = torch.tensor(tbl, device=device).reshape(R, A)
    win = raycast.column_windows(geom, num_az, rbf, maxr, device)
    so = torch.tensor([0.07, -0.03, 1.2], device=device)
    return scat, win, so, dr, int(np.ceil(1.0 / rbf))


@pytest.mark.parametrize(
    "num_az,rbf,maxr,exact",
    [(2048, 0.25, 12.81, True), (1024, 0.5, 9.0, True), (2048, 0.25, 12.81, False)],
)
def test_k1_matches_plain_twin(cuda, num_az, rbf, maxr, exact):
    scat, win, so, dr, nfold = polar_inputs(cuda, num_az, rbf, maxr)
    before = k1.launches
    got = k1.polar_field_cuda(scat, win, so, dr, nfold, exact)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.polar_field_plain(scat, win, so, dr, nfold, exact)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# (R, A, range bin factor): nfold = 1 and 10; A = 1024; R = 517, not a
# multiple of the 64 row segments or of their odd length; a tall
# [4096, 1024] field, more rows than one block's shared memory holds.
K1_EDGES = [(515, 2048, 1.0), (515, 2048, 0.1), (515, 1024, 0.25), (517, 2048, 0.25),
            (4096, 1024, 0.25)]


@pytest.mark.parametrize("R,A,rbf", K1_EDGES)
def test_k1_edge_shapes_bitwise(cuda, R, A, rbf):
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    rng = np.random.default_rng(R + A)
    tbl = rng.uniform(-2.0, 0.5, (R, A)).astype(np.float32)
    tbl[rng.random((R, A)) < 0.97] = np.inf
    dr = geom.resolution * rbf
    lvl, shift = raycast._column_windows(geom, A, R, dr)
    win = k1.ColumnWindows.from_numpy(lvl, shift, cuda)
    scat = torch.tensor(tbl, device=cuda)
    so = torch.tensor([0.07, -0.03, 1.2], device=cuda)
    nfold = int(np.ceil(1.0 / rbf))
    got = k1.polar_field_cuda(scat, win, so, dr, nfold, True)
    ref = k1.polar_field_plain(scat, win, so, dr, nfold, True)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(ref).mean() > 0.5
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_k1_any_window_table_bitwise(cuda):
    """Window tables not from _column_windows: shifts up to and beyond
    2^lvl (one interval, or the reference's passes), windows of A bins and
    more, and no window."""
    rng = np.random.default_rng(11)
    R, A = 203, 1024
    lvl = rng.integers(0, 5, R).astype(np.int32)
    shift = rng.integers(0, 40, R).astype(np.int32)
    lvl[:3], shift[:3] = 0, 0
    lvl[3:6] = 9, 10, 11
    win = k1.ColumnWindows.from_numpy(lvl, shift, cuda)
    scat = torch.tensor(rng.uniform(-2.0, 0.5, (R, A)).astype(np.float32), device=cuda)
    scat[torch.rand((R, A), device=cuda) < 0.9] = float("inf")
    so = torch.tensor([0.07, -0.03, 1.2], device=cuda)
    for exact in (True, False):
        got = k1.polar_field_cuda(scat, win, so, 0.025, 3, exact)
        ref = k1.polar_field_plain(scat, win, so, 0.025, 3, exact)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      ref.cpu().numpy().view(np.int32))


def test_k1_rejects_bad_inputs(cuda):
    scat, win, so, dr, nfold = polar_inputs(cuda, 1024, 0.5, 9.0)
    with pytest.raises(ValueError):
        k1.polar_field_cuda(scat.double(), win, so, dr, nfold, True)
    with pytest.raises(ValueError, match="contiguous"):
        k1.polar_field_cuda(scat.t(), win, so, dr, nfold, True)
    with pytest.raises(ValueError, match="nfold"):
        k1.polar_field_cuda(scat, win, so, dr, k1.NFOLD_MAX + 1, True)
    with pytest.raises(ValueError, match="sensor_origin"):
        k1.polar_field_cuda(scat, win, so.cpu(), dr, nfold, True)


def session(device, impl, n_scans=4):
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    cfg.raycasting.polar_field_impl = impl
    m = fd.FastDEM(geom, cfg, device=device)
    rng = np.random.default_rng(3)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    for k in range(n_scans):
        n = 30000
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, 7.2, n)
        xyz = np.column_stack([rad * np.cos(ang), rad * np.sin(ang),
                               rng.normal(-1.0, 0.02, n)]).astype(np.float32)
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.11 * k
        assert m.integrate(fd.cloud.from_numpy(xyz, frame_id="lidar", device=device),
                           T_bs, T_wb)
    return m.state


def assert_states_agree(cpu, gpu):
    for name, ref in cpu.layers.items():
        ref = ref.numpy()
        got = gpu.layers[name].cpu().numpy()
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)
        assert close.mean() >= 0.999, name


@pytest.mark.parametrize("impl,launches", [("auto", 4), ("pallas", 4), ("xla", 0)])
def test_session_on_card_matches_cpu(cuda, impl, launches):
    before, before4 = k1.launches, k4.launches
    gpu = session(cuda, impl)
    torch.cuda.synchronize()
    assert k1.launches - before == launches
    assert k4.launches - before4 == 4
    assert_states_agree(session("cpu", "auto"), gpu)


@pytest.mark.parametrize("two_reads", [True, False])
@pytest.mark.parametrize("R,A,cells", [(515, 2048, 150), (962, 2048, 484)])
def test_k4_matches_plain_twin(cuda, two_reads, R, A, cells):
    rng = np.random.default_rng(1)
    field = rng.uniform(-2.0, 0.5, (R, A)).astype(np.float32)
    field[rng.random((R, A)) < 0.97] = np.inf
    field[rng.random((R, A)) < 0.01] = np.nan
    shape = (cells, cells)
    args = [
        torch.tensor(field, device=cuda),
        torch.tensor(rng.integers(0, A, shape).astype(np.int32), device=cuda),
        torch.tensor(rng.integers(0, A, shape).astype(np.int32), device=cuda)
        if two_reads else None,
        torch.tensor(rng.integers(0, R, shape).astype(np.int32), device=cuda),
        torch.tensor(rng.random(shape) < 0.9, device=cuda),
    ]
    before = k4.launches
    h, t = k4.resample_cuda(*args)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    h_ref, t_ref = k4.resample_plain(*args)
    np.testing.assert_array_equal(t.cpu().numpy(), t_ref.cpu().numpy())
    np.testing.assert_array_equal(h.cpu().numpy().view(np.int32),
                                  h_ref.cpu().numpy().view(np.int32))
    # NaN in the field reaches the cell (touched False, NaN out), as in the twin.
    assert t.sum() > 0 and torch.isnan(h[~t]).all()


def test_k4_rejects_bad_inputs(cuda):
    field = torch.zeros((8, 16), device=cuda)
    idx = torch.zeros((3, 4), dtype=torch.int32, device=cuda)
    ok = torch.ones((3, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k4.resample_cuda(field.t(), idx, None, idx, ok)
    with pytest.raises(ValueError, match="a0"):
        k4.resample_cuda(field, idx.long(), None, idx, ok)
    with pytest.raises(ValueError, match="in_range"):
        k4.resample_cuda(field, idx, None, idx, ok.cpu())


@pytest.mark.parametrize("two_reads", [False, True])
@pytest.mark.parametrize("windowed", [False, True])
def test_k4_lookup_matches_plain_twin(cuda, windowed, two_reads):
    """The main path's K4 (index math in the kernel) equals its twin,
    resample_indices + resample_plain on the card, bit for bit."""
    if windowed:
        geom, polar = fd.GridGeometry.from_length(200.0, 200.0, 0.1), (2048, 0.25, 24.0)
        pos, so = [0.0, 0.0], [-10.37, 5.21, 1.0]
    else:
        geom, polar = fd.GridGeometry.from_length(15.0, 15.0, 0.1), (2048, 0.25, 12.81)
        pos, so = [0.2, -0.1], [0.31, -0.17, 1.05]
    lk = raycast.polar_lookup(geom, *polar)
    rng = np.random.default_rng(5)
    field = rng.uniform(-2.0, 0.5, (lk.R, lk.A)).astype(np.float32)
    field[rng.random(field.shape) < 0.5] = np.inf
    field[rng.random(field.shape) < 0.01] = np.nan
    field = torch.tensor(field, device=cuda)
    pos, so = torch.tensor(pos, device=cuda), torch.tensor(so, device=cuda)
    window = None
    if windowed:
        sr, sc, _ = geom.index_of(pos, so[:2])
        r0 = torch.clamp(torch.clamp(sr, 0, geom.rows) - 242, 0, geom.rows - 484)
        c0 = torch.clamp(torch.clamp(sc, 0, geom.cols) - 242, 0, geom.cols - 484)
        window = (r0, c0, 484, 484)
    before = k4.launches
    h, t = k4.resample_lookup_cuda(field, lk, pos, so, window, two_reads)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    h_ref, t_ref = k4.resample_lookup_plain(field, lk, pos, so, window, two_reads)
    np.testing.assert_array_equal(t.cpu().numpy(), t_ref.cpu().numpy())
    np.testing.assert_array_equal(h.cpu().numpy().view(np.int32),
                                  h_ref.cpu().numpy().view(np.int32))
    assert t.float().mean() > 0.3


def test_k4_lookup_reads_strided_origins(cuda):
    """The sensor origin is a column of the sensor pose (stride 4): the
    kernel reads it through its stride."""
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    lk = raycast.polar_lookup(geom, 2048, 0.25, 12.81)
    field = torch.rand((lk.R, lk.A), device=cuda) - 2.0
    T = torch.eye(4, device=cuda)
    T[:3, 3] = torch.tensor([0.31, -0.17, 1.05])
    so = T[:3, 3]
    assert so.stride(0) == 4
    pos = torch.tensor([0.2, -0.1], device=cuda)
    got = k4.resample_lookup_cuda(field, lk, pos, so)
    ref = k4.resample_lookup_cuda(field, lk, pos, so.contiguous())
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def windowed_session(device, est, window_update, n_scans=4):
    geom = fd.GridGeometry.from_length(40.0, 40.0, 0.1)
    cfg = fd.Config()
    cfg.mapping.mode = fd.MappingMode.GLOBAL
    cfg.mapping.estimation_type = est
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = 6.0
    step = fd.build_integrate(geom, cfg, window_update=window_update, device=device)
    s = fd.create_map_state(geom, cfg, device=device)
    rng = np.random.default_rng(4)
    T_bs = torch.eye(4, device=device)
    T_bs[2, 3] = 1.0
    for k in range(n_scans):
        n = 30000
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, 5.8, n)
        xyz = np.column_stack([rad * np.cos(ang), rad * np.sin(ang),
                               rng.normal(-1.0, 0.02, n)]).astype(np.float32)
        T_wb = torch.eye(4, device=device)
        T_wb[0, 3] = -4.0 + 1.3 * k
        s, _ = step(s, torch.tensor(xyz, device=device),
                    torch.ones(n, dtype=torch.bool, device=device), T_bs, T_wb)
    return s


@pytest.mark.parametrize("est", ["KALMAN", "P2_QUANTILE"])
def test_windowed_session_on_card(cuda, est):
    est = getattr(fd.EstimationType, est)
    before, before4 = k1.launches, k4.launches
    win = windowed_session(cuda, est, None)
    torch.cuda.synchronize()
    assert (k1.launches - before, k4.launches - before4) == (4, 4)
    full = windowed_session(cuda, est, False)
    for name, ref in full.layers.items():
        np.testing.assert_array_equal(win.layers[name].cpu().numpy(), ref.cpu().numpy(),
                                      err_msg=name)
    assert_states_agree(windowed_session("cpu", est, None), win)


def postprocess_inputs(n, seed=6):
    rng = np.random.default_rng(seed)
    x = np.arange(n)[:, None] * 0.1
    elev = (0.3 * np.sin(x) * np.cos(0.7 * np.arange(n)[None, :] * 0.1)
            + rng.normal(0, 0.01, (n, n))).astype(np.float32)
    elev[rng.random((n, n)) < 0.1] = np.nan
    var = np.abs(rng.normal(0.01, 0.005, (n, n))).astype(np.float32)
    return elev, elev + var, elev - var


def test_postprocess_chain_on_card(cuda):
    """The chain and the median on the card equal the CPU's bit for bit:
    every transcendental runs in double and rounds to the same f32."""
    from fastdem_tpu_torch.postprocess import apply_postprocess_fn, smooth_median

    pp = fd.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    run = apply_postprocess_fn(fd.GridGeometry(96, 96, 0.1), pp)
    layers = postprocess_inputs(96)
    got = run(*(torch.tensor(a, device=cuda) for a in layers))
    ref = run(*(torch.tensor(a) for a in layers))
    got["smoothed"] = smooth_median(got["elevation"], 3, 5)
    ref["smoothed"] = smooth_median(ref["elevation"], 3, 5)
    assert got["slope"].device.type == "cuda"
    for name, r in ref.items():
        g, r = got[name].cpu().numpy(), r.numpy()
        # NaN payloads differ between the devices; NaN sets must not.
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
        fin = ~np.isnan(r)
        np.testing.assert_array_equal(g[fin].view(np.int32), r[fin].view(np.int32),
                                      err_msg=name)
    assert torch.isfinite(ref["slope"]).sum() > 5000


def test_sampled_raycast_on_card(cuda):
    """The sampled raycast on the card equals the CPU's; it launches neither
    K1 nor K4."""
    geom = fd.GridGeometry.from_length(12.0, 12.0, 0.1)
    rng = np.random.default_rng(8)
    n = 4000
    ang, rad = rng.uniform(0, 2 * np.pi, n), rng.uniform(0.3, 8.0, n)
    xyz = np.column_stack([rad * np.cos(ang), rad * np.sin(ang),
                           rng.normal(-1.0, 0.03, n)]).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    args = (np.zeros(2, np.float32), xyz, mask, np.array([0.3, -0.2, 0.8], np.float32))
    before = (k1.launches, k4.launches)
    h, t = raycast.ray_min_height_sampled(geom, *(torch.tensor(a, device=cuda) for a in args),
                                          num_samples=1200)
    torch.cuda.synchronize()
    assert (k1.launches, k4.launches) == before
    h_ref, t_ref = raycast.ray_min_height_sampled(geom, *(torch.tensor(a) for a in args),
                                                  num_samples=1200)
    np.testing.assert_array_equal(t.cpu().numpy(), t_ref.numpy())
    np.testing.assert_array_equal(h.cpu().numpy(), h_ref.numpy())
    assert t_ref.sum() > 10000


def replay_scans(K, seed=7, n=30000):
    rng = np.random.default_rng(seed)
    clouds, poses = [], []
    for k in range(K):
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, 7.2, n)
        xyz = np.column_stack([rad * np.cos(ang), rad * np.sin(ang),
                               rng.normal(-1.0, 0.02, n)]).astype(np.float32)
        clouds.append(xyz)
        T_wb = np.eye(4, dtype=np.float32)
        T_wb[0, 3] = 0.21 * k
        poses.append(T_wb)
    return clouds, np.stack(poses)


def flagship_on(device):
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    return fd.FastDEM(fd.GridGeometry.from_length(15.0, 15.0, 0.1), cfg, device=device)


def test_integrate_sequence_equals_loop_on_card(cuda):
    """Seven flagship scans in batches of 3 equal seven integrate calls, bit
    for bit on every layer, with one K1 and one K4 launch per scan."""
    xyz, poses = replay_scans(7)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    loop = flagship_on(cuda)
    for k in range(7):
        assert loop.integrate(fd.cloud.from_numpy(xyz[k], device=cuda), T_bs, poses[k])
    seq = flagship_on(cuda)
    torch.cuda.synchronize()
    before, before4 = k1.launches, k4.launches
    clouds = [fd.cloud.from_numpy(x, device=cuda) for x in xyz]
    assert seq.integrate_sequence(clouds, T_bs, poses, batch=3) == 7
    torch.cuda.synchronize()
    assert (k1.launches - before, k4.launches - before4) == (7, 7)
    for name, ref in loop.state.layers.items():
        np.testing.assert_array_equal(seq.state.layers[name].cpu().numpy().view(np.int32),
                                      ref.cpu().numpy().view(np.int32), err_msg=name)


def test_async_driver_on_card(cuda):
    """The node's driver with async intake on the card: the same map as the
    sync intake, bit for bit, nothing dropped, the snapshot post-processed on
    the card."""
    from fastdem_tpu_torch.runtime import MappingDriver, StaticCalibration, TransformBuffer

    xyz, poses = replay_scans(6, seed=8)
    calib = StaticCalibration("base")
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    calib.set_extrinsic("lidar", T_bs)
    odom = TransformBuffer("base", "map")
    for k in range(6):
        odom.add_pose((k + 1) * 10**9, poses[k])
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    states = []
    for kw in ({}, {"async_intake": True, "burst_batch": 4}):
        with MappingDriver(fd.GridGeometry.from_length(15.0, 15.0, 0.1), cfg,
                           calibration=calib, odometry=odom, postprocess_rate=0.0,
                           viz_rate=0.0, device=cuda, **kw) as d:
            for k in range(6):
                assert d.on_scan(fd.cloud.from_numpy(xyz[k], frame_id="lidar",
                                                     timestamp_ns=(k + 1) * 10**9,
                                                     device="cpu"))
            if kw:
                assert d.drain(timeout=120.0)
            assert (d.scan_count, d.dropped_scans, d.intake_errors) == (6, 0, 0)
            assert d.mapper.state.layers["elevation"].device.type == "cuda"
            out = d.run_postprocess()
            assert np.isfinite(out["elevation"]).sum() > 15000
            states.append({k: v.cpu().numpy() for k, v in d.mapper.state.layers.items()})
    for name, ref in states[0].items():
        np.testing.assert_array_equal(states[1][name].view(np.int32), ref.view(np.int32),
                                      err_msg=name)


def test_stage_keeps_its_pinned_source(cuda):
    """stage() copies a CPU cloud to the card through pinned memory without
    waiting; the staged cloud holds the pinned source and equals the cloud."""
    import gc

    from fastdem_tpu_torch.cloud import pointcloud as pc

    rng = np.random.default_rng(9)
    xyz = rng.normal(size=(50000, 3)).astype(np.float32)
    inten = rng.uniform(size=50000).astype(np.float32)
    host = pc.from_numpy(xyz, intensity=inten, frame_id="lidar", device="cpu")
    staged = pc.stage(host, cuda)
    del host
    gc.collect()
    assert staged.device.type == "cuda"
    src_xyz, src_mask, src_ch = staged.pinned_source
    assert src_xyz.is_pinned() and src_mask.is_pinned() and src_ch["intensity"].is_pinned()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(staged.xyz.cpu().numpy(), xyz)
    np.testing.assert_array_equal(staged.channels["intensity"].cpu().numpy(), inten)
    assert bool(staged.mask.all()) and staged.valid_count == 50000
    assert pc.stage(staged, cuda) is staged


def test_integrate_sequence_takes_cuda_tensor_lists(cuda):
    """Poses given as a list of CUDA tensors (and T_bs as one) map exactly
    as the numpy call."""
    xyz, poses = replay_scans(4)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    clouds = [fd.cloud.from_numpy(x, device=cuda) for x in xyz]
    ref = flagship_on(cuda)
    assert ref.integrate_sequence(clouds, T_bs, np.stack(poses)) == 4
    got = flagship_on(cuda)
    assert got.integrate_sequence(clouds, torch.as_tensor(T_bs, device=cuda),
                                  [torch.as_tensor(T, device=cuda) for T in poses]) == 4
    for name, r in ref.state.layers.items():
        assert torch.equal(got.state.layers[name].view(torch.int32), r.view(torch.int32)), name


def dem_site(n):
    from fastdem_tpu_torch.tools.common import synthetic_site

    return synthetic_site(n, size=30.0, seed=3)


def test_grid_knn_equals_brute_on_card(cuda):
    """The grid kNN with its certificate and fallback on the card: equal to
    the brute tile on the card, and to the grid on the CPU, bit for bit."""
    from fastdem_tpu_torch.cloud import search

    xyz, _, _ = dem_site(40000)
    mask = np.ones(len(xyz), bool)
    mask[::97] = False
    gi, gd = search.knn_grid(xyz, mask, 12, device=cuda)
    assert 0 < search.last_grid_stats["fallback"] < 0.2 * len(xyz)
    bi, bd = search.knn_brute(xyz, mask, 12, device=cuda)
    m = torch.as_tensor(mask, device=cuda)
    assert torch.equal(gd[m].view(torch.int32), bd[m].view(torch.int32))
    assert torch.equal(gi[m], bi[m])
    ci, cd = search.knn_grid(xyz, mask, 12, device="cpu")
    assert torch.equal(gd.cpu().view(torch.int32), cd.view(torch.int32))
    assert torch.equal(gi.cpu(), ci)
    ri, rd, rc = search.radius_search_grid(xyz, mask, 0.3, 16, device=cuda)
    ci, cd, cc = search.radius_search_grid(xyz, mask, 0.3, 16, device="cpu")
    assert torch.equal(rc.cpu(), cc) and torch.equal(rd.cpu().view(torch.int32),
                                                     cd.view(torch.int32))


def test_build_dem_on_card_matches_cpu(cuda):
    """build_dem on the card against the CPU: the same kept points, NaN
    sets and counts, min / max exact, the elevation within 2e-6 (the sums
    of mean / variance add in atomics' order on the card: rtol 1e-5)."""
    from fastdem_tpu_torch.cloud import filters
    from fastdem_tpu_torch.mapping import batch

    xyz, inten, col = dem_site(40000)
    out = {}
    for dev in ("cpu", cuda):
        c = fd.cloud.from_numpy(xyz, intensity=inten, color=col, device=dev)
        sor = filters.statistical_outlier_removal(c, 20, 1.0)
        out[str(dev)] = (sor.mask.cpu(), batch.build_dem(c, device=dev))
    (m_cpu, (g_cpu, s_cpu)), (m_gpu, (g_gpu, s_gpu)) = out["cpu"], out[str(cuda)]
    assert torch.equal(m_cpu, m_gpu) and g_cpu == g_gpu
    for name, ref in s_cpu.layers.items():
        got = s_gpu.layers[name].cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(ref)), name
        if name in ("elevation_min", "elevation_max", "n_points", "intensity", "color"):
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), name
        elif name == "elevation":
            assert float((got - ref).abs().nan_to_num().max()) <= 2e-6
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-9, equal_nan=True)
    assert float(torch.isfinite(s_gpu.layers["elevation"]).float().mean()) > 0.99
