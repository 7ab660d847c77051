"""Tests of the port that need a CUDA card; they skip where there is none.

On a machine with a card and no JAX, run them without the suite's conftest
(which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

K1 against its plain twin (identical finite sets, heights within 4e-6),
its launch counter, the wrapper's input checks, and a small session on the
card against the same session on the CPU.
"""

import numpy as np
import pytest
import torch

import fastdem_tpu_torch as fd
from fastdem_tpu_torch.ops import polar_field as k1
from fastdem_tpu_torch.postprocess import raycasting as raycast


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
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=4e-6)


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


@pytest.mark.parametrize("impl,launches", [("auto", 4), ("pallas", 4), ("xla", 0)])
def test_session_on_card_matches_cpu(cuda, impl, launches):
    before = k1.launches
    gpu = session(cuda, impl)
    torch.cuda.synchronize()
    assert k1.launches - before == launches
    cpu = session("cpu", "auto")
    for name, ref in cpu.layers.items():
        ref = ref.numpy()
        got = gpu.layers[name].cpu().numpy()
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)
        assert close.mean() >= 0.999, name
