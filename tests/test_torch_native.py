"""The port's native scan IO (``fastdem_tpu_torch.native``: the reference's
C++ sources, copied, built with g++ and bound through ctypes), on the CPU.

The seven cases of ``tests/test_native_stream.py`` on the port (the stream
against direct loads, truncation, parse failures, non-finite points, the
Python fallback, the replay tool's ``--prefetch`` and its resume equal to
one run), plus: the native and the Python parsers and writers give the
same bits, the library is built from the port's own copy, and
``--prefetch`` refuses to run without the library. They skip only where
``g++`` is absent.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from fastdem_tpu_torch import native
from fastdem_tpu_torch.cloud.pointcloud import from_numpy
from fastdem_tpu_torch.io import pcd as pcd_io
from fastdem_tpu_torch.io.npz import load_npz
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the library")


def cloud(xyz, **ch):
    return from_numpy(xyz, device="cpu", **ch)


def _write_scans(tmp_path, n_files, n_pts, rng, fmt="pcd"):
    paths, truths = [], []
    for i in range(n_files):
        xyz = rng.uniform(-5, 5, (n_pts + i, 3)).astype(np.float32)
        inten = rng.uniform(0, 100, (n_pts + i,)).astype(np.float32)
        p = tmp_path / f"{i:06d}.{fmt}"
        save = pcd_io.save_pcd if fmt == "pcd" else pcd_io.save_kitti_bin
        assert save(str(p), cloud(xyz, intensity=inten))
        paths.append(str(p))
        truths.append((xyz, inten))
    return paths, truths


def test_library_builds_from_the_port_copy():
    assert native.available(), native.build_error
    assert native._LIB.startswith(os.path.join(ROOT, "fastdem_tpu_torch") + os.sep)
    for name in ("pcdio.cpp", "scanstream.cpp"):
        code = []
        for pkg in ("fastdem_tpu_torch", "fastdem_tpu"):
            with open(os.path.join(ROOT, pkg, "native", "src", name)) as f:
                code.append([ln for ln in f if not ln.lstrip().startswith("//")])
        assert code[0] == code[1], f"{name}'s code is no longer the reference's"


@pytest.mark.parametrize("fmt", ["pcd", "bin"])
def test_stream_matches_direct_loads(tmp_path, rng, fmt):
    paths, truths = _write_scans(tmp_path, 6, 500, rng, fmt)
    cap = 1024
    with native.ScanStream(paths, cap, threads=3, ring=4, with_intensity=True) as s:
        assert s._handle
        out = list(s)
    assert len(out) == 6
    for (xyz, mask, inten), (txyz, tinten) in zip(out, truths):
        n = len(txyz)
        assert xyz.shape == (cap, 3) and mask.shape == (cap,)
        assert mask[:n].all() and not mask[n:].any()
        np.testing.assert_array_equal(xyz[:n], txyz)
        np.testing.assert_array_equal(xyz[n:], 1e9)
        np.testing.assert_allclose(inten[:n], tinten, rtol=1e-6)


def test_stream_truncates_to_capacity(tmp_path, rng):
    paths, truths = _write_scans(tmp_path, 1, 300, rng)
    with native.ScanStream(paths, 100, threads=1) as s:
        xyz, mask, _ = next(s)
    assert mask.sum() == 100
    np.testing.assert_array_equal(xyz[:100], truths[0][0][:100])


def test_stream_parse_failure_yields_empty_frame(tmp_path, rng):
    paths, _ = _write_scans(tmp_path, 2, 200, rng)
    bad = tmp_path / "000001a.pcd"
    bad.write_text("not a pcd header\n")
    with native.ScanStream([paths[0], str(bad), paths[1]], 512, threads=2) as s:
        frames = list(s)
    assert [f[1].sum() for f in frames] == [200, 0, 201]
    assert s.errors == 1


ASCII_NAN = ("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
             "WIDTH 3\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 3\nDATA ascii\n"
             "0 0 1\nnan 0 0\n1 1 1\n")


def test_stream_nonfinite_points_masked(tmp_path):
    p = tmp_path / "nan.pcd"
    p.write_text(ASCII_NAN)
    with native.ScanStream([str(p)], 8, threads=1) as s:
        got, mask, _ = next(s)
    assert mask.sum() == 2 and not mask[1]
    np.testing.assert_array_equal(got[1], 1e9)
    np.testing.assert_array_equal(got[0], [0.0, 0.0, 1.0])


def test_python_fallback_equivalent(tmp_path, rng, monkeypatch, caplog):
    """Without the library: the same frames (truncation window, non-finite
    points masked in place), parsed in Python, with a warning."""
    paths, _ = _write_scans(tmp_path, 3, 128, rng)
    big = tmp_path / "zzbig.pcd"
    rows = ["0 0 1"] * 300
    rows[5] = "nan 0 0"
    big.write_text("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                   "WIDTH 300\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 300\n"
                   "DATA ascii\n" + "\n".join(rows) + "\n")
    paths = paths + [str(big)]
    cap = 256
    with native.ScanStream(paths, cap, threads=2, with_intensity=True) as s_native:
        out_native = list(s_native)
    monkeypatch.setattr(native, "_get", lambda: None)
    with caplog.at_level("WARNING", logger="fastdem_tpu_torch.native"):
        with native.ScanStream(paths, cap, threads=2, with_intensity=True) as s_py:
            out_py = list(s_py)
    assert s_py._handle is None
    assert "parsing in Python" in caplog.text
    for (xa, ma, ia), (xb, mb, ib) in zip(out_native, out_py):
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_allclose(ia, ib, rtol=1e-6)
    assert out_native[-1][1].sum() == cap - 1


def test_native_and_python_parsers_agree_bitwise(tmp_path, rng):
    """Binary PCD (all channels), ascii PCD and KITTI .bin: the C++ and the
    numpy parsers give the same bits; the C++ and numpy binary writers
    write the same points."""
    n = 700
    xyz = rng.normal(0, 20, (n, 3)).astype(np.float32)
    xyz[3] = np.nan
    inten = rng.uniform(0, 255, n).astype(np.float32)
    color = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    c = cloud(xyz, intensity=inten, color=color, normal=normal)
    vp = (1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0)
    files = {}
    for name, kw in (("native.pcd", dict(use_native=True)), ("numpy.pcd", dict(use_native=False)),
                     ("ascii.pcd", dict(binary=False))):
        assert pcd_io.save_pcd(str(tmp_path / name), c, viewpoint=vp, **kw)
        files[name] = str(tmp_path / name)
    bin_path = str(tmp_path / "scan.bin")
    assert pcd_io.save_kitti_bin(bin_path, c)
    for path in list(files.values()) + [bin_path]:
        load = pcd_io.load_kitti_bin if path.endswith(".bin") else pcd_io.load_pcd
        a, b = load(path, use_native=True, device="cpu"), load(path, use_native=False, device="cpu")
        np.testing.assert_array_equal(a.xyz.numpy().view(np.int32), b.xyz.numpy().view(np.int32))
        np.testing.assert_array_equal(a.mask.numpy(), b.mask.numpy())
        assert set(a.channels) == set(b.channels), path
        for k in a.channels:
            np.testing.assert_array_equal(a.channels[k].numpy(), b.channels[k].numpy(), err_msg=k)
        assert a.mask.sum() == n - 1
    _, meta = pcd_io.load_pcd(files["native.pcd"], return_meta=True, device="cpu")
    np.testing.assert_array_equal(meta["viewpoint"], vp)
    a = pcd_io.load_pcd(files["native.pcd"], use_native=False, device="cpu")
    b = pcd_io.load_pcd(files["numpy.pcd"], use_native=False, device="cpu")
    np.testing.assert_array_equal(a.xyz.numpy(), b.xyz.numpy())


def run_replay(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "fastdem_tpu_torch.tools.fastdem_replay",
                           "--preset", "local_mapping", "--device", "cpu", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def kitti_poses(path, k, step):
    T = np.eye(4)
    lines = []
    for i in range(k):
        T[0, 3] = step * i
        lines.append(" ".join(f"{v:.6f}" for v in T[:3].reshape(-1)))
    path.write_text("\n".join(lines) + "\n")
    return path


def assert_maps_equal(a, b):
    _, sa, _ = load_npz(str(a), device="cpu")
    _, sb, _ = load_npz(str(b), device="cpu")
    assert set(sa.layers) == set(sb.layers)
    for name in sb.layers:
        np.testing.assert_array_equal(sa.layers[name].numpy().view(np.int32),
                                      sb.layers[name].numpy().view(np.int32), err_msg=name)


def test_replay_cli_prefetch(tmp_path, rng):
    """--prefetch streams the scans through the native loader; the map is
    the plain replay's bit for bit (300-400-point scans padded to 512 keep
    their point-index width)."""
    scans = tmp_path / "scans"
    scans.mkdir()
    _write_scans(scans, 5, 400, rng)
    traj = kitti_poses(tmp_path / "poses.txt", 5, 0.5)
    common = ["--scans", str(scans), "--trajectory", str(traj), "--batch", "2"]
    r = run_replay(*common, "--prefetch", "2", "--capacity", "512", "--out",
                   str(tmp_path / "pf"))
    assert r.returncode == 0, r.stderr
    assert "5 scans" in r.stderr and "native=True" in r.stderr
    r = run_replay(*common, "--out", str(tmp_path / "plain"))
    assert r.returncode == 0, r.stderr
    assert_maps_equal(tmp_path / "pf" / "map.npz", tmp_path / "plain" / "map.npz")


def test_replay_cli_resume_matches_single_run(tmp_path, rng):
    """Mapping 6 scans in one run == mapping 3, checkpointing to npz and
    resuming with the other 3; also through --prefetch, whose warm-up must
    leave a resumed map where it was."""
    scans = tmp_path / "scans"
    scans.mkdir()
    paths, _ = _write_scans(scans, 6, 300, rng)
    halves = []
    for name, part in (("a", paths[:3]), ("b", paths[3:])):
        d = tmp_path / f"scans_{name}"
        d.mkdir()
        for p in part:
            shutil.copy(p, d / os.path.basename(p))
        halves.append(d)
    traj_all = kitti_poses(tmp_path / "poses_all.txt", 6, 0.3)
    lines = traj_all.read_text().splitlines()
    (tmp_path / "poses_a.txt").write_text("\n".join(lines[:3]) + "\n")
    (tmp_path / "poses_b.txt").write_text("\n".join(lines[3:]) + "\n")

    def run(scan_dir, traj, out, *extra):
        r = run_replay("--scans", str(scan_dir), "--trajectory", str(traj), "--batch", "2",
                       "--out", str(out), *extra)
        assert r.returncode == 0, r.stderr

    run(halves[0], tmp_path / "poses_a.txt", tmp_path / "out_a")
    ckpt = str(tmp_path / "out_a" / "map.npz")
    run(halves[1], tmp_path / "poses_b.txt", tmp_path / "out_b", "--resume", ckpt)
    run(scans, traj_all, tmp_path / "out_full")
    assert_maps_equal(tmp_path / "out_b" / "map.npz", tmp_path / "out_full" / "map.npz")
    run(halves[1], tmp_path / "poses_b.txt", tmp_path / "out_b_pf", "--resume", ckpt,
        "--prefetch", "2", "--capacity", "512")
    assert_maps_equal(tmp_path / "out_b_pf" / "map.npz", tmp_path / "out_full" / "map.npz")


def test_prefetch_refuses_without_the_library(tmp_path, monkeypatch):
    from fastdem_tpu_torch.tools import fastdem_replay

    scans = tmp_path / "scans"
    scans.mkdir()
    monkeypatch.setattr(native, "_get", lambda: None)
    with pytest.raises(SystemExit, match="native scan IO library"):
        fastdem_replay.main(["--preset", "local_mapping", "--device", "cpu", "--scans",
                             str(scans), "--prefetch", "2"])
    with pytest.raises(SystemExit, match="requires --scans"):
        fastdem_replay.main(["--preset", "local_mapping", "--device", "cpu", "--synthetic",
                             "2", "--prefetch", "2"])
