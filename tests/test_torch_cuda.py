"""Tests of the port that need a CUDA card; they skip where there is none.

On a machine with a card and no JAX, run them without the suite's conftest
(which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

K1 against its plain twin bit for bit (at the reference test's shapes, at
edge shapes: folds of 1 and 10 rows, A = 1024, R off the segment sizes, a
tall field that the column pass walks in chunks; and with window tables of
any shift), K4 against its plain twin (bit for bit in both forms, NaN
propagated), the main path's K4 with its index math against its twin
(whole map and window, one and two reads), K1 and K4 over a batch of
frames in one launch against their one-frame launches and twins, their
launch counters, the
wrappers' input checks, small sessions (flagship,
windowed GLOBAL with Kalman and P^2) on the card against the same sessions
on the CPU, and the post-processing chain and the sampled raycast on the
card against the CPU; batched replay against the integrate loop bit for
bit, the node's driver with async intake against its sync intake,
and ``integrate_sequence`` with the poses as a list of CUDA tensors; the
grid kNN and radius search against the brute tile and the CPU, and
``build_dem`` on the card against the CPU; normals,
segmentation and registration on the card against the CPU, and the PRNG's
draws on the card equal to the CPU's; the block-sharded map on a 2x2 mesh
of one card against the unsharded step bit for bit (K1 once and K4 once
per block per scan), two gloo processes on the card against one process,
the sharded post-processing chain against the unsharded one, and a
program-cache bundle that a second process loads without building; the
packed, twophase and sort steps on the card against the CPU, and the
microbatch and fused replay steps against the step loop; the facade's
pinned staging ring against the blocking input path bit for bit (mixed
sizes, host arrays overwritten while the ring comes round), without a
synchronisation in steady state, and its counters; the facade's donating
step against the non-donating one over 40 scans of each preset's map.
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


@pytest.mark.parametrize("exact", [True, False])
def test_k1_batched_matches_single_and_plain(cuda, exact):
    """K = 5 fields [K, R, A] with their own sensor heights in one launch:
    each equal to the one-field launch and to the plain twin, bit for bit."""
    rng = np.random.default_rng(12)
    K = 5
    scat, win, _, dr, nfold = polar_inputs(cuda, 2048, 0.25, 12.81)
    R, A = scat.shape
    batch = torch.tensor(rng.uniform(-2.0, 0.5, (K, R, A)).astype(np.float32), device=cuda)
    batch[torch.rand((K, R, A), device=cuda) < 0.97] = float("inf")
    so = torch.tensor(rng.uniform(0.5, 1.5, (K, 3)).astype(np.float32), device=cuda)
    before = k1.launches
    got = k1.polar_field_cuda(batch, win, so, dr, nfold, exact)
    torch.cuda.synchronize()
    assert k1.launches == before + 1 and tuple(got.shape) == (K, R, A)
    ref = k1.polar_field_plain(batch, win, so, dr, nfold, exact)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  ref.cpu().numpy().view(np.int32))
    for k in range(K):
        one = k1.polar_field_cuda(batch[k].contiguous(), win, so[k].contiguous(), dr, nfold,
                                  exact)
        assert torch.equal(one.view(torch.int32), got[k].view(torch.int32))


@pytest.mark.parametrize("windowed", [False, True])
def test_k4_batched_matches_single_and_plain(cuda, windowed):
    """K = 4 frames (fields, positions, sensor origins and window offsets of
    their own) in one launch: each equal to the one-frame launch and to
    the plain twin, bit for bit."""
    rng = np.random.default_rng(13)
    K = 4
    if windowed:
        geom, polar, wr = fd.GridGeometry.from_length(200.0, 200.0, 0.1), (2048, 0.25, 24.0), 484
    else:
        geom, polar, wr = fd.GridGeometry.from_length(15.0, 15.0, 0.1), (2048, 0.25, 12.81), None
    lk = raycast.polar_lookup(geom, *polar)
    field = rng.uniform(-2.0, 0.5, (K, lk.R, lk.A)).astype(np.float32)
    field[rng.random(field.shape) < 0.5] = np.inf
    field = torch.tensor(field, device=cuda)
    pos = torch.tensor(rng.uniform(-0.3, 0.3, (K, 2)).astype(np.float32), device=cuda)
    so = torch.tensor(np.column_stack([rng.uniform(-20, 20, (K, 2)), np.ones(K)])
                      .astype(np.float32), device=cuda)
    window = None
    if windowed:
        r0 = torch.tensor(rng.integers(0, geom.rows - wr, K).astype(np.int32), device=cuda)
        c0 = torch.tensor(rng.integers(0, geom.cols - wr, K).astype(np.int32), device=cuda)
        window = (r0, c0, wr, wr)
    before = k4.launches
    h, t = k4.resample_lookup_cuda(field, lk, pos, so, window)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    h_ref, t_ref = k4.resample_lookup_plain(field, lk, pos, so, window)
    np.testing.assert_array_equal(t.cpu().numpy(), t_ref.cpu().numpy())
    np.testing.assert_array_equal(h.cpu().numpy().view(np.int32),
                                  h_ref.cpu().numpy().view(np.int32))
    for k in range(K):
        w = None if window is None else (r0[k], c0[k], wr, wr)
        h1, t1 = k4.resample_lookup_cuda(field[k].contiguous(), lk, pos[k].contiguous(),
                                         so[k].contiguous(), w)
        assert torch.equal(h1.view(torch.int32), h[k].view(torch.int32))
        assert torch.equal(t1, t[k])


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


@pytest.mark.parametrize("mode", ["packed", "twophase", "sort"])
def test_scatter_modes_on_card_match_cpu(cuda, mode):
    """Four flagship scans through build_integrate(scatter_mode=mode) on the
    card and on the CPU (sort with the raycast off)."""
    xyz, poses = replay_scans(4)
    cfg = fd.Config()
    cfg.raycasting.enabled = mode != "sort"
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    states = []
    for dev in (cuda, "cpu"):
        step = fd.build_integrate(geom, cfg, scatter_mode=mode, device=dev)
        s = fd.create_map_state(geom, cfg, device=dev)
        for k in range(4):
            s, _ = step(s, torch.tensor(xyz[k], device=dev), torch.ones(30000, dtype=torch.bool,
                        device=dev), torch.tensor(T_bs, device=dev),
                        torch.tensor(poses[k], device=dev))
        states.append(s)
    gpu, cpu = states
    assert_states_agree(cpu, gpu)
    for name in ("n_points", "elevation_min", "elevation_max"):
        np.testing.assert_array_equal(gpu.layers[name].cpu().numpy(), cpu.layers[name].numpy(),
                                      err_msg=name)


def test_microbatch_and_fused_on_card_equal_loop(cuda):
    """Eight flagship scans through microbatch 4 and fused (K = 8): every
    layer equal to the step loop on the card, K1 and K4 launched once per
    batch."""
    from fastdem_tpu_torch.mapping import pipeline as pl

    xyz, poses = replay_scans(8)
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    cfg.mapping.mode = fd.MappingMode.LOCAL
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    T_bs = torch.eye(4, device=cuda)
    T_bs[2, 3] = 1.0
    X = torch.tensor(np.stack(xyz), device=cuda)
    M = torch.ones((8, 30000), dtype=torch.bool, device=cuda)
    P = torch.tensor(poses, device=cuda)
    step = fd.build_integrate(geom, cfg, device=cuda)
    ref = fd.create_map_state(geom, cfg, device=cuda)
    for k in range(8):
        ref, _ = step(ref, X[k], M[k], T_bs, P[k])
    for fn, batches in ((pl.build_integrate_sequence(geom, cfg, microbatch=4, device=cuda), 2),
                        (pl.build_integrate_fused(geom, cfg, device=cuda), 1)):
        torch.cuda.synchronize()
        before, before4 = k1.launches, k4.launches
        got = fn(fd.create_map_state(geom, cfg, device=cuda), X, M, T_bs, P)
        torch.cuda.synchronize()
        assert (k1.launches - before, k4.launches - before4) == (batches, batches)
        for name, r in ref.layers.items():
            np.testing.assert_array_equal(got.layers[name].cpu().numpy().view(np.int32),
                                          r.cpu().numpy().view(np.int32), err_msg=name)


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


def test_cloud_library_on_card_matches_cpu(cuda):
    """Normals at 10K points, segment_ground and euclidean_cluster on the
    card against the CPU: normals within 1e-6 with the same zero set, the
    ground mask and the cluster labels exactly."""
    from fastdem_tpu_torch.cloud import normals, segmentation
    from fastdem_tpu_torch.tools.common import make_cloud_np

    xyz = make_cloud_np(10_000, np.random.default_rng(0))
    c_d = fd.cloud.from_numpy(xyz, device=cuda)
    c_h = fd.cloud.from_numpy(xyz, device="cpu")
    for method in ("brute", "grid"):
        n_d = normals.estimate_normals(c_d, k=10, method=method).channels["normal"].cpu()
        n_h = normals.estimate_normals(c_h, k=10, method=method).channels["normal"]
        assert torch.equal((n_d == 0).all(1), (n_h == 0).all(1))
        assert float((n_d - n_h).abs().max()) <= 1e-6
    assert torch.equal(segmentation.segment_ground(c_d).cpu(), segmentation.segment_ground(c_h))
    assert torch.equal(segmentation.euclidean_cluster(c_d, tolerance=0.3).cpu(),
                       segmentation.euclidean_cluster(c_h, tolerance=0.3))
    assert torch.equal(segmentation.segment_plane(c_d, 0.05).inliers.cpu(),
                       segmentation.segment_plane(c_h, 0.05).inliers)


@pytest.mark.parametrize("method", ["icp", "gicp"])
def test_align_on_card_matches_cpu(cuda, method):
    """ICP and GICP at 2K points on the card against the CPU, at the
    tolerances the CPU tests hold the port to JAX with."""
    from fastdem_tpu_torch.cloud import registration
    from fastdem_tpu_torch.tools.common import registration_pair

    src, tgt, T_true = registration_pair(2000, seed=1)
    r = {dev: registration.align(fd.cloud.from_numpy(src, device=dev),
                                 fd.cloud.from_numpy(tgt, device=dev), method=method,
                                 optimizer="lm")
         for dev in (cuda, "cpu")}
    a, b = r[cuda], r["cpu"]
    np.testing.assert_allclose(a.T, b.T, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.error, b.error, rtol=1e-4, atol=1e-7)
    assert a.converged == b.converged and abs(a.iterations - b.iterations) <= 1
    assert a.num_correspondences == b.num_correspondences
    assert np.linalg.norm(a.T[:3, 3] - T_true[:3, 3]) < 0.05


def test_prng_draws_on_card_equal_cpu(cuda):
    from fastdem_tpu_torch.utils import prng

    for seed in (0, 7, 2**31 - 1):
        key = prng.prng_key(seed)
        a = prng.randint(key, (1000, 3), 0, 2**20, device=cuda).cpu()
        b = prng.randint(key, (1000, 3), 0, 2**20, device="cpu")
        assert torch.equal(a, b)


def sharded_session(dev, shape=(2, 2), n_scans=4):
    from fastdem_tpu_torch.parallel import sharding as sh

    geom = fd.GridGeometry.from_length(40.0, 40.0, 0.1)
    cfg = fd.Config()
    cfg.mapping.mode = fd.MappingMode.GLOBAL
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = 6.0
    rng = np.random.default_rng(5)
    stream = []
    for k in range(n_scans):
        ang, rad = rng.uniform(0, 2 * np.pi, 8000), rng.uniform(0.5, 5.8, 8000)
        xyz = np.column_stack([rad * np.cos(ang), rad * np.sin(ang),
                               rng.normal(-1.0, 0.03, 8000)]).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3], pose[1, 3] = -3.0 + 2.1 * k, 1.0 - 0.9 * k
        stream.append((torch.tensor(xyz, device=dev), torch.tensor(pose, device=dev)))
    mask = torch.ones(8000, dtype=torch.bool, device=dev)
    T_bs = torch.eye(4, device=dev)
    step1 = fd.build_integrate(geom, cfg, device=dev)
    s1 = fd.create_map_state(geom, cfg, device=dev)
    mesh = sh.make_mesh(shape[0] * shape[1], shape=shape, devices=[dev])
    stepN, shard = sh.build_sharded_integrate(geom, cfg, mesh)
    sN = shard(fd.create_map_state(geom, cfg, device=dev))
    for xyz, pose in stream:
        s1, _ = step1(s1, xyz, mask, T_bs, pose)
    torch.cuda.synchronize()
    l1, l4 = k1.launches, k4.launches
    for xyz, pose in stream:
        sN, aux = stepN(sN, xyz, mask, T_bs, pose)
    torch.cuda.synchronize()
    launches = (k1.launches - l1, k4.launches - l4)
    return geom, s1, sh.gather_state(sN), stepN, launches, aux


def test_sharded_step_on_card_bitwise(cuda):
    geom, s1, got, step, (l1, l4), aux = sharded_session(cuda)
    assert step.formulation == "shardmap_windowed" and int(aux.oow_points) == 0
    assert (l1, l4) == (4, 16)  # K1 once per scan (shared), K4 once per block
    for name, a in s1.layers.items():
        assert torch.equal(a.view(torch.int32), got.layers[name].view(torch.int32)), name
    assert int(torch.isfinite(s1.layers["elevation"]).sum()) > 10000


def test_sharded_postprocess_on_card_bitwise(cuda):
    from fastdem_tpu_torch.parallel import sharding as sh
    from fastdem_tpu_torch.postprocess import apply_postprocess_fn

    geom, s1, _, _, _, _ = sharded_session(cuda, n_scans=2)
    pp = fd.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    names = ("elevation", "upper_bound", "lower_bound")
    ref = apply_postprocess_fn(geom, pp)(*(s1.layers[k] for k in names))
    mesh = sh.make_mesh(4, devices=[cuda])
    out = sh.gather_state(sh.sharded_postprocess(geom, pp, mesh, sh.shard_state(s1, mesh)))
    for name, a in ref.items():
        assert torch.equal(torch.isnan(a), torch.isnan(out.layers[name])), name
        assert torch.equal(a.view(torch.int32), out.layers[name].view(torch.int32)), name


def test_two_gloo_processes_on_one_card(cuda, tmp_path):
    import os
    import socket
    import subprocess
    import sys

    from fastdem_tpu_torch.io.npz import save_npz
    from fastdem_tpu_torch.tools.multihost_demo import synthetic_stream

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path / "mh.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fastdem_tpu_torch.tools.multihost_demo", "--pid", str(p),
         "--nproc", "2", "--coordinator", f"localhost:{port}", "--local-blocks", "2",
         "--scans", "4", "--points", "4096", "--out", out],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for p in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    geom = fd.GridGeometry.from_length(40.0, 40.0, 0.2)
    cfg = fd.Config()
    cfg.mapping.mode = fd.MappingMode.GLOBAL
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = 20.0
    xyz, T_bs, T_wb = synthetic_stream(4, 4096, 40.0)
    step = fd.build_integrate(geom, cfg, device=cuda)
    s = fd.create_map_state(geom, cfg, device=cuda)
    for k in range(4):
        s, _ = step(s, torch.tensor(xyz[k], device=cuda),
                    torch.ones(4096, dtype=torch.bool, device=cuda),
                    torch.tensor(T_bs, device=cuda), torch.tensor(T_wb[k], device=cuda))
    ref = str(tmp_path / "one.npz")
    assert save_npz(ref, geom, s)
    assert open(out, "rb").read() == open(ref, "rb").read()


def test_program_cache_bundle_on_card(cuda, tmp_path):
    """A process that warms an empty bundle builds K1 and K4 into it; a
    second process on the filled bundle builds nothing."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bundle = str(tmp_path / "bundle")
    code = (
        "import json, sys; from fastdem_tpu_torch.runtime import aotcache; "
        "from fastdem_tpu_torch.ops import cuda_build; import fastdem_tpu_torch as fd; "
        "geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1); cfg = fd.Config(); "
        "cfg.raycasting.enabled = True; "
        f"aotcache.warmup(geom, cfg, bundle_dir={bundle!r}, capacities=(4096,)); "
        "print(json.dumps(cuda_build.build_seconds))"
    )
    built = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True, timeout=600, env=dict(os.environ, PYTHONPATH=root))
        assert proc.returncode == 0, proc.stderr[-3000:]
        built.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert set(built[0]) == {"polar_field.cu", "resample.cu"} and built[1] == {}
    files = {e["file"].split("/")[0] for e in
             json.load(open(os.path.join(bundle, "manifest.json")))["libraries"]}
    assert files == {"cuda", "native"}


def graph_session(dev, cfg, geom, jit, n_scans=6, **kw):
    """``n_scans`` flagship-like scans through build_integrate(jit=jit) on
    ``dev``: (state, last aux, K1 launches, K4 launches, step)."""
    xyz, poses = replay_scans(n_scans, seed=9)
    step = fd.build_integrate(geom, cfg, jit=jit, device=dev, **kw)
    s = fd.create_map_state(geom, cfg, device=dev)
    T_bs = torch.eye(4, device=dev)
    T_bs[2, 3] = 1.0
    mask = torch.ones(30000, dtype=torch.bool, device=dev)
    mask[-500:] = False
    torch.cuda.synchronize()
    before, before4 = k1.launches, k4.launches
    for k in range(n_scans):
        s, aux = step(s, torch.tensor(xyz[k], device=dev), mask, T_bs,
                      torch.tensor(poses[k], device=dev))
    torch.cuda.synchronize()
    return s, aux, k1.launches - before, k4.launches - before4, step


def assert_bitwise_on_card(ref, got):
    assert list(ref.layers) == list(got.layers)
    for name, r in ref.layers.items():
        np.testing.assert_array_equal(got.layers[name].cpu().numpy().view(np.int32),
                                      r.cpu().numpy().view(np.int32), err_msg=name)
    np.testing.assert_array_equal(got.position.cpu().numpy(), ref.position.cpu().numpy())


GRAPH_PATHS = {
    "flagship kalman": (15.0, "LOCAL", "KALMAN", "polar", {}, 1),
    "flagship p2": (15.0, "LOCAL", "P2_QUANTILE", "polar", {}, 1),
    "global windowed": (40.0, "GLOBAL", "KALMAN", "polar", {}, 1),
    "packed": (15.0, "LOCAL", "KALMAN", "polar", {"scatter_mode": "packed"}, 1),
    "sampled": (15.0, "LOCAL", "KALMAN", "sampled", {}, 0),
}


@pytest.mark.parametrize("name", list(GRAPH_PATHS))
def test_graph_step_equals_eager_on_card(cuda, name):
    """build_integrate(jit=True) replays a CUDA graph per signature that
    equals the eager step (jit=False) bit for bit on every layer and on
    the aux; K1 and K4 count one launch per replay."""
    length, mode, est, method, kw, per_scan = GRAPH_PATHS[name]
    geom = fd.GridGeometry.from_length(length, length, 0.1)
    cfg = fd.Config()
    cfg.mapping.mode = getattr(fd.MappingMode, mode)
    cfg.mapping.estimation_type = getattr(fd.EstimationType, est)
    cfg.raycasting.enabled = True
    cfg.raycasting.method = method
    if mode == "GLOBAL":
        cfg.point_filter.range_max = 6.0
    ref, aux_e, e1, e4, _ = graph_session(cuda, cfg, geom, jit=False, **kw)
    got, aux_g, g1, g4, step = graph_session(cuda, cfg, geom, jit=True, **kw)
    assert_bitwise_on_card(ref, got)
    for f in ("min_z", "max_z", "min_z_var", "touched"):
        a, b = getattr(aux_e.obs, f), getattr(aux_g.obs, f)
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool else a.view(torch.int32),
                           b.view(torch.uint8) if b.dtype == torch.bool else b.view(torch.int32)), f
    assert (e1, e4) == (g1, g4) == (6 * per_scan, 6 * per_scan)
    (stats,) = step.stats()
    assert stats.replays == 6 and stats.pool_bytes > 0
    assert stats.launches_per_replay.get("fastdem_tpu_torch.ops.polar_field", 0) == per_scan


def test_facade_graphs_per_power_of_two_on_card(cuda):
    """Scans of eight sizes through the facade, in an order that turns
    between three powers of two: one graph each, sharing one pool, and
    the map equals the eager step's on the unpadded scans bit for bit."""
    xyz, poses = replay_scans(8, seed=13)
    sizes = (30000, 7000, 20000, 9000, 29000, 12000, 17000, 6500)
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    graph = fd.FastDEM(geom, fd.Config(), device=cuda)
    eager = fd.build_integrate(geom, fd.Config(), jit=False, device=cuda)
    state = fd.create_map_state(geom, fd.Config(), device=cuda)
    for k, n in enumerate(sizes):
        cloud = fd.cloud.from_numpy(xyz[k][:n], device=cuda)
        assert graph.integrate(cloud, T_bs, poses[k])
        state, _ = eager(state, cloud.xyz, cloud.mask, torch.as_tensor(T_bs, device=cuda),
                         torch.as_tensor(poses[k], device=cuda))
        assert graph.last_aux.world_xyz.shape == (n, 3)
    assert_bitwise_on_card(state, graph.state)
    caps = sorted(s.shape[0] for g in graph._map.step.graphs.values() for s in g.slots
                  if s.dim() == 2 and s.shape[1] == 3)
    assert caps == [8192, 16384, 32768]


def test_graph_replay_steps_equal_eager_on_card(cuda):
    """Microbatch 4 and fused (K = 8), captured whole, equal their eager
    form bit for bit; K1 and K4 once per batch through the replays."""
    from fastdem_tpu_torch.mapping import pipeline as pl

    xyz, poses = replay_scans(8)
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    T_bs = torch.eye(4, device=cuda)
    X = torch.tensor(np.stack(xyz), device=cuda)
    M = torch.ones((8, 30000), dtype=torch.bool, device=cuda)
    P = torch.tensor(poses, device=cuda)
    for build, batches in ((lambda jit: pl.build_integrate_sequence(
            geom, cfg, microbatch=4, jit=jit, device=cuda), 2),
            (lambda jit: pl.build_integrate_fused(geom, cfg, jit=jit, device=cuda), 1)):
        ref = build(False)(fd.create_map_state(geom, cfg, device=cuda), X, M, T_bs, P)
        fn = build(True)
        for _ in range(2):
            torch.cuda.synchronize()
            before, before4 = k1.launches, k4.launches
            got = fn(fd.create_map_state(geom, cfg, device=cuda), X, M, T_bs, P)
            torch.cuda.synchronize()
            assert (k1.launches - before, k4.launches - before4) == (batches, batches)
            assert_bitwise_on_card(ref, got)


def test_graph_chain_equals_eager_on_card(cuda):
    """The post-processing chain as a graph (donate=False) equals the eager
    chain bit for bit, NaN sets included, on two maps in turn; the outputs
    of the first call do not change under the second."""
    from fastdem_tpu_torch.postprocess import apply_postprocess_fn
    from fastdem_tpu_torch.utils import graphs

    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    pp = fd.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    eager = apply_postprocess_fn(geom, pp)
    fn = graphs.jit(eager, donate=False)
    rng = np.random.default_rng(5)
    maps = []
    for _ in range(2):
        e = rng.normal(0.0, 0.2, geom.shape).astype(np.float32)
        e[rng.random(geom.shape) < 0.3] = np.nan
        e = torch.tensor(e, device=cuda)
        maps.append((e, e + 0.1, e - 0.05))
    first = fn(*maps[0])
    kept = {k: v.clone() for k, v in first.items()}
    second = fn(*maps[1])
    for got, layers in ((kept, maps[0]), (second, maps[1])):
        ref = eager(*layers)
        for k, v in ref.items():
            assert torch.equal(got[k].view(torch.int32), v.view(torch.int32)), k
    for k, v in kept.items():
        assert torch.equal(first[k].view(torch.int32), v.view(torch.int32)), k
    assert len(fn.graphs) == 1 and fn.stats()[0].replays == 2


def test_capture_refuses_a_host_read_on_card(cuda):
    """A step that reads the device from the host raises on capture, naming
    the signature; a good step captures in the same process after it."""
    from fastdem_tpu_torch.utils import graphs

    def reads(x):
        return x * float(x.sum())

    def builds(x):
        return x + torch.tensor([1.0, 2.0], device=x.device)

    x = torch.arange(2.0, device=cuda)
    for bad in (reads, builds):
        with pytest.raises(RuntimeError, match=r"capture of .* failed for the signature "
                                               r"\(float32\[2\]\)"):
            graphs.jit(bad, donate=False)(x)
    good = graphs.jit(lambda x: x * 2.0, donate=False)
    assert torch.equal(good(x), x * 2.0) and torch.equal(good(x + 1.0), (x + 1.0) * 2.0)


def test_graph_block_step_equals_eager_on_card(cuda):
    """The step of one block (``spmd_blocks``), one graph per block, equals
    its eager form bit for bit on every block of a 2x2 map."""
    from fastdem_tpu_torch.parallel import sharding as sh

    xyz, poses = replay_scans(4, seed=10)
    geom = fd.GridGeometry.from_length(40.0, 40.0, 0.1)
    cfg = fd.Config()
    cfg.mapping.mode = fd.MappingMode.GLOBAL
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = 6.0
    mesh = sh.make_mesh(4, shape=(2, 2), devices=["cuda"])
    T_bs = torch.eye(4, device=cuda)
    mask = torch.ones(30000, dtype=torch.bool, device=cuda)
    out = {}
    for jit in (False, True):
        step = fd.build_integrate(geom, cfg, spmd_blocks=mesh.shape, jit=jit, device=cuda)
        sharded = sh.shard_state(fd.create_map_state(geom, cfg, device=cuda), mesh)
        blocks = {slot: sharded.block(slot) for slot in mesh.slots()}
        for k in range(4):
            for slot in mesh.slots():
                blocks[slot], _ = step(blocks[slot], torch.tensor(xyz[k], device=cuda), mask,
                                       T_bs, torch.tensor(poses[k], device=cuda), block=slot)
        out[jit] = blocks
        if jit:
            assert len(step.graphs) == 4
    for slot in mesh.slots():
        assert_bitwise_on_card(out[False][slot], out[True][slot])


def sharded_graph_run(dev, cfg, geom, jit, xyz, poses, T_bs, sequence=False):
    """The scans through the 2x2 sharded step (or as one sequence call):
    (gathered state, K1 launches, K4 launches, the step)."""
    from fastdem_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh(4, shape=(2, 2), devices=[dev])
    n = xyz[0].shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[-300:] = False
    build = sh.build_sharded_integrate_sequence if sequence else sh.build_sharded_integrate
    step, shard = build(geom, cfg, mesh, jit=jit)
    s = shard(fd.create_map_state(geom, cfg, device=dev))
    torch.cuda.synchronize()
    before, before4 = k1.launches, k4.launches
    if sequence:
        K = len(xyz)
        s = step(s, torch.tensor(np.stack(xyz), device=dev), mask.expand(K, -1), T_bs,
                 torch.tensor(np.stack(poses), device=dev))
    else:
        for k in range(len(xyz)):
            s, _ = step(s, torch.tensor(xyz[k], device=dev), mask, T_bs,
                        torch.tensor(poses[k], device=dev))
    torch.cuda.synchronize()
    return sh.gather_state(s), k1.launches - before, k4.launches - before4, step


@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
@pytest.mark.parametrize("sequence", [False, True])
def test_graph_sharded_step_equals_eager_on_card(cuda, mode, sequence):
    """The 2x2 sharded step on one card (the windowed GLOBAL map, and the
    LOCAL fallback whose move is a gather on the device) and its sequence,
    each one graph per scan (per call for the sequence), equal their eager
    form and the unsharded step bit for bit; K1 counts once per scan and
    K4 once per block per scan through the replays."""
    xyz, poses = replay_scans(6, seed=21)
    geom = fd.GridGeometry.from_length(40.0 if mode == "GLOBAL" else 15.0, 40.0 if
                                       mode == "GLOBAL" else 15.0, 0.1)
    cfg = fd.Config()
    cfg.mapping.mode = getattr(fd.MappingMode, mode)
    cfg.raycasting.enabled = True
    if mode == "GLOBAL":
        cfg.point_filter.range_max = 6.0
    T_bs = torch.eye(4, device=cuda)
    T_bs[2, 3] = 1.0
    ref, e1, e4, _ = sharded_graph_run(cuda, cfg, geom, False, xyz, poses, T_bs, sequence)
    got, g1, g4, step = sharded_graph_run(cuda, cfg, geom, True, xyz, poses, T_bs, sequence)
    assert step.compiled == "whole"
    assert_bitwise_on_card(ref, got)
    assert (e1, e4) == (g1, g4) == (6, 24)
    one = fd.build_integrate(geom, cfg, device=cuda)
    s1 = fd.create_map_state(geom, cfg, device=cuda)
    mask = torch.ones(30000, dtype=torch.bool, device=cuda)
    mask[-300:] = False
    for k in range(6):
        s1, _ = one(s1, torch.tensor(xyz[k], device=cuda), mask, T_bs,
                    torch.tensor(poses[k], device=cuda))
    assert_bitwise_on_card(s1, got)
    if mode == "LOCAL":
        assert float(got.position[0]) > 0.9  # the moves crossed block edges
    (graph_step,) = step.per_device.values()
    assert [st.replays for st in graph_step.stats()] == [1 if sequence else 6]


@pytest.mark.parametrize("method,optimizer", [("icp", "gn"), ("icp", "lm"), ("gicp", "lm"),
                                              ("vgicp", "lm")])
def test_fused_align_equals_host_on_card(cuda, monkeypatch, method, optimizer):
    """The fused driver (blocks of 1, 4 and 64 passes, each call capturing
    its own graph after an eager first block) gives the host loop's result
    bit for bit on the card, with one host read per block and fewer masked
    passes than a block."""
    from fastdem_tpu_torch.cloud import registration as reg
    from fastdem_tpu_torch.tools.common import registration_pair

    src, tgt, _ = registration_pair(3000, seed=2)
    s_c, t_c = (fd.cloud.from_numpy(a, device=cuda) for a in (src, tgt))
    kw = dict(method=method, optimizer=optimizer, voxel_size=1.0)
    reg.host_reads = reg.passes_run = reg.passes_used = 0
    host = reg.align(s_c, t_c, driver="host", **kw)
    passes = reg.passes_used
    for block in (1, 4, 64):
        monkeypatch.setattr(reg, "_FUSED_BLOCK", block)
        for _ in range(2):
            reg.host_reads = reg.passes_run = reg.passes_used = 0
            got = reg.align(s_c, t_c, driver="fused", **kw)
            assert np.array_equal(got.T.view(np.int32), host.T.view(np.int32)), block
            assert (got.error, got.iterations, got.converged, got.num_correspondences) == (
                host.error, host.iterations, host.converged, host.num_correspondences)
            assert reg.passes_used == passes and reg.host_reads == -(-passes // block)
            assert reg.passes_run - passes < block


def per_sweep_propagate(labels, cand, max_sweeps):
    """The propagation as a plain loop that reads the ``changed`` flag after
    every sweep (the reference of ``tests/test_torch_segmentation.py``)."""
    from fastdem_tpu_torch.cloud import segmentation as segm

    n = labels.shape[0]
    tail = torch.tensor([n], device=labels.device)
    for _ in range(max_sweeps):
        lab_ext = torch.cat([labels, tail])
        new = torch.minimum(labels, lab_ext[cand].amin(dim=1))
        new = torch.minimum(new, lab_ext[new.clamp_max(n - 1)])
        changed = bool((new != labels).any())
        segm.sweeps += 1
        labels = new
        if not changed:
            break
    return labels


def test_cluster_blocks_equal_per_sweep_on_card(cuda, monkeypatch):
    """Blocks of sweeps give the per-sweep loop's labels on the card, one
    host read per block, and the CPU's labels."""
    from fastdem_tpu_torch.cloud import segmentation as segm
    from fastdem_tpu_torch.tools.common import make_cloud_np

    xyz = make_cloud_np(20000, np.random.default_rng(4), spread=20.0)
    c_d = fd.cloud.from_numpy(xyz, device=cuda)
    segm.host_reads = segm.sweeps = 0
    with monkeypatch.context() as m:
        m.setattr(segm, "_propagate", per_sweep_propagate)
        ref = segm.euclidean_cluster(c_d, tolerance=0.5)
    need = segm.sweeps
    for per_read in (4, 16):
        monkeypatch.setattr(segm, "_SWEEPS_PER_READ", per_read)
        segm.host_reads = segm.sweeps = 0
        got = segm.euclidean_cluster(c_d, tolerance=0.5)
        assert torch.equal(got, ref) and segm.sweeps == need
        assert segm.host_reads == -(-need // per_read)
    assert torch.equal(ref.cpu(), segm.euclidean_cluster(fd.cloud.from_numpy(xyz, device="cpu"),
                                                         tolerance=0.5))


def test_device_profile_sees_every_launch_on_card(cuda):
    """Padded windows of short launches record every launch: 20 windows of
    50 adds each give 50 device events per window."""
    from fastdem_tpu_torch.utils import profiling

    x = torch.zeros(22500, device=cuda)
    for _ in range(20):
        ms, events, by_name, _ = profiling.device_profile(lambda: x.add_(1.0), 50)
        assert events == 1.0 and ms > 0.0 and len(by_name) == 1
    assert float(x[0]) == 20 * 50


def test_spans_share_the_device_trace_clock_on_card(cuda, tmp_path):
    """Under a CUDA-only profiler window, as the benchmark records it, a span
    around a 5 ms sleep and a launch brackets the kernel's start in kineto's
    trace once exported to the wall clock; the step's ``step.device`` span
    resolves for every scan, in the scan's id."""
    import json
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fastdem_tpu_torch.utils import tracing

    x = torch.zeros(1 << 20, device=cuda)
    x.add_(1.0)
    torch.cuda.synchronize()
    tracing.reset()
    name = tracing.name_id("test.bracket")
    wall0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        h = tracing.begin(name)
        time.sleep(0.005)
        x.add_(1.0)
        torch.cuda.synchronize()
        tracing.end(h)
        time.sleep(0.02)
    wall1 = time.time_ns()
    # This window's kernels: kineto's wall clock against the host's reads.
    kernels = [e.start_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
               and wall0 <= e.start_ns() <= wall1]
    assert len(kernels) == 1
    path = tmp_path / "spans.json"
    tracing.export_chrome(str(path))
    ev = next(e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") == "test.bracket" and e["ph"] == "X")
    start, stop = ev["ts"] * 1e3, (ev["ts"] + ev["dur"]) * 1e3
    assert start + 4e6 <= kernels[0] <= stop

    cfg = fd.Config()
    cfg.raycasting.enabled = False
    mapper = fd.FastDEM(fd.GridGeometry.from_length(15.0, 15.0, 0.1), cfg, device=cuda)
    xyz, poses = replay_scans(5)
    T_bs = np.eye(4, dtype=np.float32)
    tracing.reset()
    for k in range(5):
        assert mapper.integrate(fd.cloud.from_numpy(xyz[k], frame_id="lidar", device="cpu"),
                                T_bs, poses[k])
    tab = tracing.table()
    # This thread's scans (other threads of the process may be recording).
    fi = np.flatnonzero(tab.name == tab.id_of("facade.integrate"))
    fi = fi[tab.thread[fi] == tab.thread[fi[-1]]]
    scans = set(tab.scan[fi].tolist())
    dev = np.flatnonzero(tab.name == tab.id_of("step.device"))
    dev = dev[np.isin(tab.scan[dev], list(scans))]
    assert len(scans) == len(dev) == 5
    assert set(tab.scan[dev].tolist()) == scans
    assert (tab.end[dev] >= tab.start[dev]).all(), tab.durations_ms(dev)


def test_device_span_since_holds_only_the_work_between(cuda):
    """A device span from ``device_start``'s event holds the work enqueued
    between the two events alone; one opened at the host's enqueue holds
    the device work queued ahead of it too (two ~30 ms sleeps)."""
    from fastdem_tpu_torch.device import resolve_device
    from fastdem_tpu_torch.utils import tracing

    cuda = resolve_device(cuda)  # with its index, as the program's callers pass it
    x = torch.zeros(16, device=cuda)
    tracing.device_span(tracing.name_id("test.warm"), cuda)  # the device's clock
    torch.cuda.synchronize()
    tracing.reset()
    between, queued = tracing.name_id("test.between"), tracing.name_id("test.queued")
    torch.cuda._sleep(50_000_000)
    since = tracing.device_start(cuda)
    x.add_(1.0)
    tracing.device_span(between, cuda, since)
    torch.cuda._sleep(50_000_000)
    x.add_(1.0)
    tracing.device_span(queued, cuda)
    torch.cuda.synchronize()
    tab = tracing.table()
    (b,), (q,) = (np.flatnonzero(tab.name == tab.id_of(n))
                  for n in ("test.between", "test.queued"))
    b_ms, q_ms = tab.durations_ms(np.array([b, q]))
    assert 0.0 <= b_ms < 5.0 and q_ms > 25.0, (b_ms, q_ms)
    # The first span starts on the device, after the first sleep; the
    # second at the host's enqueue, before it.
    assert tab.start[b] > tab.start[q] + 15_000_000


def blocking_loop(mapper, clouds, T_bs, poses):
    """The facade's input path before its staging ring, written out: each
    cloud copied to the card from pageable memory, padded there to the
    next power of two, the transforms copied one by one, then the step."""
    from fastdem_tpu_torch.cloud import pointcloud as pc

    dev = mapper.device
    for c, T_wb in zip(clouds, poses):
        g = c.to(dev)
        g = pc.pad_to(g, pc.ladder_capacity(g.capacity, base=1))
        mapper.state, _ = mapper._map.step(
            mapper.state, g.xyz, g.mask,
            torch.as_tensor(np.asarray(T_bs, dtype=np.float32), device=dev),
            torch.as_tensor(T_wb, dtype=torch.float32, device=dev),
            g.channels.get("intensity") if mapper.has_intensity else None, None)
    torch.cuda.synchronize()


def staging_pair(cuda, has_intensity=False):
    geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
    cfg = fd.Config()
    cfg.raycasting.enabled = True
    return [fd.FastDEM(geom, cfg, has_intensity=has_intensity, device=cuda) for _ in range(2)]


def test_staged_facade_equals_blocking_path_on_card(cuda):
    """64 scans of six sizes with intensity through the facade's pinned
    ring (host clouds, and every fifth one already on the card, with its
    pose as a CUDA tensor) map as the blocking path, bit for bit."""
    xyz, poses = replay_scans(64, seed=21)
    rng = np.random.default_rng(21)
    sizes = (30000, 17000, 9000, 16384, 24000, 4096)
    T_bs = np.eye(4)
    T_bs[2, 3] = 1.0
    clouds = []
    for k in range(64):
        n = sizes[k % len(sizes)]
        clouds.append(fd.cloud.from_numpy(
            xyz[k][:n], frame_id="lidar", device="cpu",
            intensity=rng.uniform(0, 255, n).astype(np.float32)))
    staged, ref = staging_pair(cuda, has_intensity=True)
    for k, c in enumerate(clouds):
        if k % 5 == 4:
            assert staged.integrate(c.to(cuda), T_bs, torch.tensor(poses[k], device=cuda))
        else:
            assert staged.integrate(c, T_bs, poses[k])
    torch.cuda.synchronize()
    blocking_loop(ref, clouds, T_bs, poses)
    assert_bitwise_on_card(ref.state, staged.state)


def test_staged_inputs_survive_overwrites_on_card(cuda):
    """Three times as many scans as the ring has buffers, queued behind a
    long kernel so the ring comes round while its copies wait, each scan's
    host arrays overwritten right after its call without a
    synchronisation: the map equals the blocking path's bit for bit."""
    from fastdem_tpu_torch.mapping import staging

    K = 3 * staging.DEPTH
    xyz, poses = replay_scans(K, seed=23)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    staged, ref = staging_pair(cuda)
    cloud = fd.cloud.from_numpy(xyz[0], frame_id="lidar", device="cpu")
    pose = poses[0].copy()
    assert staged.integrate(cloud, T_bs, pose)  # the capture, outside the race
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    for k in range(1, K):
        cloud.xyz.copy_(torch.from_numpy(xyz[k]))
        pose[:] = poses[k]
        assert staged.integrate(cloud, T_bs, pose)
        cloud.xyz.fill_(float("nan"))
        pose[:] = 7.0
    torch.cuda.synchronize()
    blocking_loop(ref, [fd.cloud.from_numpy(x, device="cpu") for x in xyz], T_bs, poses)
    assert_bitwise_on_card(ref.state, staged.state)


def test_staged_steady_state_never_synchronizes_on_card(cuda):
    """After one synchronisation, fewer scans than the ring has buffers and
    off the 64-scan check run under ``set_sync_debug_mode("error")``."""
    from fastdem_tpu_torch.mapping import staging

    xyz, poses = replay_scans(3 + staging.DEPTH, seed=25)
    T_bs = np.eye(4, dtype=np.float32)
    clouds = [fd.cloud.from_numpy(x, frame_id="lidar", device="cpu") for x in xyz]
    mapper, _ = staging_pair(cuda)
    for k in range(3):
        assert mapper.integrate(clouds[k], T_bs, poses[k])
    torch.cuda.synchronize()
    assert mapper._scan_counter % 64 + staging.DEPTH - 1 < 64
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(3, 2 + staging.DEPTH):
            assert mapper.integrate(clouds[k], T_bs, poses[k])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_staging_counters_on_card(cuda):
    """``facade.staged`` counts every scan through the ring (a cloud on the
    card too: its transforms); with the card held by a long kernel, the
    scan that comes round to a buffer still in flight counts in
    ``facade.stage_waits``, with a ``facade.stage_wait`` span inside
    ``facade.prep``."""
    from fastdem_tpu_torch.mapping import staging
    from fastdem_tpu_torch.utils import tracing

    n = staging.DEPTH + 1
    xyz, poses = replay_scans(n + 3, seed=27)
    T_bs = np.eye(4, dtype=np.float32)
    clouds = [fd.cloud.from_numpy(x, frame_id="lidar", device="cpu") for x in xyz]
    mapper, _ = staging_pair(cuda)
    for k in range(2):
        assert mapper.integrate(clouds[k], T_bs, poses[k])
    torch.cuda.synchronize()
    tracing.reset()
    torch.cuda._sleep(400_000_000)
    for k in range(2, 2 + n):
        assert mapper.integrate(clouds[k], T_bs, poses[k])
    got = tracing.counters()
    assert (got.get("facade.staged"), got.get("facade.stage_waits")) == (n, 1)
    torch.cuda.synchronize()
    assert mapper.integrate(clouds[-1].to(cuda), T_bs, poses[-1])
    got = tracing.counters()
    assert (got.get("facade.staged"), got.get("facade.stage_waits")) == (n + 1, 1)
    tab = tracing.table()
    rows = np.flatnonzero(tab.name == tab.id_of("facade.stage_wait"))
    assert len(rows) == 1
    assert (tab.parent_name_ids(rows) == tab.id_of("facade.prep")).all()
    assert (tab.durations_ms(rows) > 0).all()


@pytest.mark.parametrize("preset", ["local_mapping", "global_mapping_node"])
def test_donating_facade_equals_non_donating_on_card(cuda, preset):
    """The facade's donating step against the same facade over a step that
    copies the map into its graph and clones it out (``donate=False``): 40
    scans of a VLP-16-sized cloud into each preset's map (LOCAL 150^2 with
    K1 / K4, GLOBAL 2000^2 with its window) give the same map bit for bit,
    every call after the first passes the graph's own slots back, a
    steady-state call clones none of the map's tensors, only the aux, and
    the GLOBAL graph copies no donated output into its slot (the window is
    written into the slots in place), where LOCAL's move makes new layers
    that the graph copies, each into its slot."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from fastdem_tpu_torch import presets
    from fastdem_tpu_torch.mapping import pipeline as pl
    from fastdem_tpu_torch.runtime.node_config import NodeConfig
    from fastdem_tpu_torch.utils import tracing

    class Copying(fd.FastDEM):
        def _build_step(self):
            return pl.build_integrate(self.geom, self.cfg, self.has_intensity, self.has_color,
                                      window_margin=self._window_margin, jit=True,
                                      donate=False, device=self.device)

    class Clones(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ptrs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.clone.default:
                self.ptrs.append(args[0].data_ptr())
            return func(*args, **(kwargs or {}))

    nc = NodeConfig.parse(presets.get(preset))
    geom = fd.GridGeometry.from_length(nc.map.width, nc.map.height, nc.map.resolution)
    donating = fd.FastDEM(geom, nc.pipeline, device=cuda)
    copying = Copying(geom, NodeConfig.parse(presets.get(preset)).pipeline, device=cuda)
    xyz, poses = replay_scans(40, seed=29, n=18000)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    clouds = [fd.cloud.from_numpy(x, frame_id="lidar", device="cpu") for x in xyz]
    before = tracing.counters()
    for k in range(39):
        for mapper in (donating, copying):
            assert mapper.integrate(clouds[k], T_bs, poses[k])
    (graph,) = donating._map.step.graphs.values()
    want = 0 if preset == "global_mapping_node" else graph.donated
    assert graph.stats.slot_copies_per_replay == want
    slots = {s.data_ptr() for s in graph.slots[: graph.donated]}
    with Clones() as clones:
        assert donating.integrate(clouds[39], T_bs, poses[39])
    assert copying.integrate(clouds[39], T_bs, poses[39])
    torch.cuda.synchronize()
    assert len(clones.ptrs) == len(graph.outs) - graph.donated
    assert not slots & set(clones.ptrs)
    assert donating._map.step.holds(donating.live_state())
    after = tracing.counters()
    assert [after.get(c, 0) - before.get(c, 0)
            for c in ("step.state_in_place", "step.state_copied_in")] == [39, 1]
    assert_bitwise_on_card(copying.live_state(), donating.live_state())
