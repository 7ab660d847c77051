"""The port's multi-process runtime (``parallel/distributed.py``), sharded
checkpoints (``io/sharded_ckpt.py``) and the multi-process worker
(``tools/multihost_demo.py``), on the CPU with gloo.

(a) Two processes x 4 blocks through the worker, per scan and batched
    (the reference's ``TestMultiProcess``: 4 scans of 4,096 points on the
    40 m / 0.2 m GLOBAL map): the npz rank 0 assembles through
    ``save_sharded_npz`` has the bytes of ``save_npz`` of a one-process
    unsharded run, and its elevation agrees with JAX's single-process run
    at the reference test's rtol 1e-5 / atol 1e-6. LOCAL mode (the move's
    strips exchanged between the processes) and the post-processing chain
    (halos exchanged) likewise, byte for byte.
(b) ``save_sharded_npz``: the bytes of ``save_npz``, also in small column
    blocks with a ragged tail; a map that would need ZIP64 is refused
    with no file left; a write that fails on rank 0 (a bad path, or an
    error partway through the zip) fails on both processes, in time.
(c) Sharded checkpoints: restored onto other mesh shapes and unsharded,
    bit for bit; a resumed session equals the uninterrupted one for Kalman
    and P^2 (the reference's ``tests/test_resume.py``).
(d) The scaling report, strong and weak.
"""

import os
import socket
import subprocess
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.mapping import pipeline as pl_j
from fastdem_tpu_torch.io.npz import load_npz, save_npz
from fastdem_tpu_torch.io.sharded_ckpt import load_sharded, save_sharded
from fastdem_tpu_torch.mapping.pipeline import build_integrate, create_map_state
from fastdem_tpu_torch.parallel import sharding as sh
from fastdem_tpu_torch.parallel.distributed import save_sharded_npz, scaling_report
from fastdem_tpu_torch.tools.multihost_demo import LOCAL_STEP, synthetic_stream
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two(command):
    """``command(pid, port)`` in two processes on one free coordinator
    port; returns [(exit code, output)], each waited for with a timeout."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen(
            command(pid, port),
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_workers(tmp_path, *extra, expect_ok=True):
    """Two worker processes on one coordinator; both must exit 0 (or,
    with ``expect_ok`` False, both non-zero)."""
    results = run_two(lambda pid, port: [
        sys.executable, "-m", "fastdem_tpu_torch.tools.multihost_demo",
        "--pid", str(pid), "--nproc", "2", "--coordinator", f"localhost:{port}",
        "--device", "cpu", "--scans", "4", "--points", "4096", *extra,
    ])
    for rc, out in results:
        assert (rc == 0) == expect_ok, out[-3000:]
    return [out for _, out in results]


def demo_config(pkg, mode="GLOBAL"):
    cfg = pkg.Config()
    cfg.mapping.mode = getattr(pkg.MappingMode, mode)
    cfg.raycasting.enabled = True
    cfg.point_filter.range_max = 20.0
    return cfg


def one_process_run(mode="GLOBAL"):
    """The worker's stream through the port's unsharded step."""
    geom = ft.GridGeometry.from_length(40.0, 40.0, 0.2)
    cfg = demo_config(ft, mode)
    step_xy = LOCAL_STEP if mode == "LOCAL" else (0.0, 0.0)
    xyz, T_bs, T_wb = synthetic_stream(4, 4096, 40.0, step_xy)
    step = build_integrate(geom, cfg, device="cpu")
    s = create_map_state(geom, cfg, device="cpu")
    mask = torch.ones(4096, dtype=torch.bool)
    for k in range(4):
        s, _ = step(s, torch.tensor(xyz[k]), mask, torch.tensor(T_bs), torch.tensor(T_wb[k]))
    return geom, s


def read(path):
    with open(path, "rb") as f:
        return f.read()


# ---- (a) two processes ------------------------------------------------------------


@pytest.mark.parametrize("batched", [0, 1])
def test_two_process_matches_single(tmp_path, batched):
    out = str(tmp_path / "mh.npz")
    logs = run_workers(tmp_path, "--batched", str(batched), "--out", out)
    assert "blocks [(0, 0), (0, 1), (1, 0), (1, 1)]" in logs[0]
    assert "blocks [(2, 0), (2, 1), (3, 0), (3, 1)]" in logs[1]
    geom, s1 = one_process_run()
    ref = str(tmp_path / "one.npz")
    assert save_npz(ref, geom, s1)
    assert read(out) == read(ref)

    # JAX's single-process run of the same stream (tests/test_sharding.py).
    geom_j = fj.GridGeometry.from_length(40.0, 40.0, 0.2)
    step = pl_j.build_integrate(geom_j, demo_config(fj), donate=False)
    sj = pl_j.create_map_state(geom_j, demo_config(fj))
    xyz, T_bs, T_wb = synthetic_stream(4, 4096, 40.0)
    for k in range(4):
        sj, _ = step(sj, jnp.asarray(xyz[k]), jnp.ones(4096, bool), jnp.asarray(T_bs),
                     jnp.asarray(T_wb[k]))
    _, got, _ = load_npz(out, device="cpu")
    np.testing.assert_allclose(got.layers["elevation"].numpy(),
                               np.asarray(sj.layers["elevation"]), rtol=1e-5, atol=1e-6)
    assert int(torch.isfinite(got.layers["elevation"]).sum()) > 5000


def test_two_process_local_move_and_postprocess(tmp_path):
    """LOCAL mode across two processes (each move's strips cross between
    them through gloo) and the post-processing chain with its halos
    exchanged: the bytes of the one-process run's."""
    from fastdem_tpu_torch.postprocess import apply_postprocess_fn, smooth_median

    out, pp_out = str(tmp_path / "mh.npz"), str(tmp_path / "pp.npz")
    run_workers(tmp_path, "--mode", "local", "--out", out, "--pp-out", pp_out)
    geom, s1 = one_process_run("LOCAL")
    assert float(s1.position[0]) > 2.0
    ref = str(tmp_path / "one.npz")
    assert save_npz(ref, geom, s1)
    assert read(out) == read(ref)

    pp = ft.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    chain = apply_postprocess_fn(geom, pp)(
        *(s1.layers[k] for k in ("elevation", "upper_bound", "lower_bound"))
    )
    chain["elevation_smoothed"] = smooth_median(chain["elevation"], 3, 5)
    ref_pp = str(tmp_path / "one_pp.npz")
    assert save_npz(ref_pp, geom, ft.GridMapState(layers=chain, position=s1.position))
    assert read(pp_out) == read(ref_pp)


# ---- (b) the sharded npz ------------------------------------------------------------


def random_state(geom, seed=11):
    rng = np.random.default_rng(seed)
    state = create_map_state(geom, demo_config(ft), device="cpu")
    return state.replace_layer(
        "elevation", torch.tensor(rng.normal(size=geom.shape).astype(np.float32))
    )


@pytest.mark.parametrize("col_block", [0, 5])
def test_sharded_npz_bytes_equal_save_npz(tmp_path, col_block):
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.5)  # 32x32
    state = random_state(geom)
    sharded = sh.shard_state(state, sh.make_mesh(8, devices=["cpu"]))
    p_stream, p_host = str(tmp_path / "stream.npz"), str(tmp_path / "host.npz")
    # col_block 5: 7 blocks of columns, the last ragged.
    assert save_sharded_npz(p_stream, geom, sharded, col_block=col_block)
    assert save_npz(p_host, geom, state)
    assert read(p_stream) == read(p_host)
    # A whole map streams the same bytes.
    p_whole = str(tmp_path / "whole.npz")
    assert save_sharded_npz(p_whole, geom, state, col_block=col_block)
    assert read(p_whole) == read(p_host)
    geom2, state2, _ = load_npz(p_stream, device="cpu")
    assert geom2 == geom
    np.testing.assert_array_equal(state2.layers["elevation"].numpy(),
                                  state.layers["elevation"].numpy())


def test_sharded_npz_refuses_zip64_and_leaves_no_file(tmp_path, monkeypatch):
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.5)
    sharded = sh.shard_state(random_state(geom), sh.make_mesh(8, devices=["cpu"]))
    # A 32x32 f32 member is 4,224 bytes: over a 4,000-byte limit it would
    # need ZIP64, which the reference's reader does not take.
    monkeypatch.setattr(zipfile, "ZIP64_LIMIT", 4000)
    path = str(tmp_path / "big.npz")
    assert save_sharded_npz(path, geom, sharded) is False
    assert not os.path.exists(path)
    assert save_npz(str(tmp_path / "host.npz"), geom, random_state(geom)) is False
    # The whole archive past the limit (members each under it) is refused too.
    monkeypatch.setattr(zipfile, "ZIP64_LIMIT", 20000)
    assert save_sharded_npz(path, geom, sharded) is False
    assert not os.path.exists(path)


def test_two_process_unwritable_out_fails_both(tmp_path):
    """Rank 0 cannot open --out: neither process reports success, and
    neither waits on a column block nobody receives."""
    out = str(tmp_path / "missing_dir" / "mh.npz")
    logs = run_workers(tmp_path, "--scans", "1", "--out", out, expect_ok=False)
    assert f"wrote {out}: False" in logs[0]
    assert not os.path.exists(out)


MID_WRITE_FAILURE = """
import sys, zipfile
import numpy as np, torch
torch.set_num_threads(2)
import fastdem_tpu_torch as ft
from fastdem_tpu_torch.mapping.pipeline import create_map_state
from fastdem_tpu_torch.parallel import sharding as sh
from fastdem_tpu_torch.parallel.distributed import (
    init_distributed, make_global_mesh, save_sharded_npz, shutdown)

pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_distributed(f"localhost:{port}", 2, pid)
geom = ft.GridGeometry.from_length(16.0, 16.0, 0.5)
state = create_map_state(geom, ft.Config(), device="cpu")
rng = np.random.default_rng(11)
state = state.replace_layer(
    "elevation", torch.tensor(rng.normal(size=geom.shape).astype(np.float32)))
sharded = sh.shard_state(state, make_global_mesh(n=8, devices=["cpu"]))
if pid == 0:
    # The disk fills partway through the zip: the third chunk written fails.
    real, calls = zipfile._ZipWriteFile.write, [0]
    def write(self, data):
        calls[0] += 1
        if calls[0] == 3:
            raise OSError(28, "No space left on device")
        return real(self, data)
    zipfile._ZipWriteFile.write = write
ok = save_sharded_npz(path, geom, sharded, col_block=5)
print(f"saved {ok}", flush=True)
shutdown()
sys.exit(0 if ok else 1)
"""


def test_two_process_write_failing_midway_fails_both(tmp_path):
    path = str(tmp_path / "mh.npz")
    results = run_two(lambda pid, port: [
        sys.executable, "-c", MID_WRITE_FAILURE, str(pid), str(port), path,
    ])
    for rc, out in results:
        assert rc == 1 and "saved False" in out, out[-3000:]
    assert not os.path.exists(path)


# ---- (c) sharded checkpoints ----------------------------------------------------------


@pytest.mark.parametrize("new_shape", [(2, 4), (1, 8)])
def test_restore_onto_another_mesh_shape(tmp_path, new_shape):
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.5)
    state = random_state(geom)
    mesh_a = sh.make_mesh(8, devices=["cpu"])
    assert mesh_a.shape == (4, 2)
    path = str(tmp_path / "ckpt")
    save_sharded(path, geom, sh.shard_state(state, mesh_a))
    mesh_b = sh.make_mesh(8, shape=new_shape, devices=["cpu"])
    geom2, got, meta = load_sharded(path, mesh_b)
    assert geom2 == geom and meta["mesh"] == [4, 2] and got.mesh.shape == new_shape
    assert tuple(got.blocks[(0, 0)]["elevation"].shape) == (32 // new_shape[0],
                                                            32 // new_shape[1])
    full = sh.gather_state(got)
    for name, v in state.layers.items():
        np.testing.assert_array_equal(full.layers[name].numpy().view(np.int32),
                                      v.numpy().view(np.int32), err_msg=name)
    # The restored state feeds a step built on the new mesh.
    step, _ = sh.build_sharded_integrate(geom2, demo_config(ft), mesh_b)
    xyz = np.random.default_rng(1).uniform(-6, 6, (512, 3)).astype(np.float32)
    xyz[:, 2] = -1.0
    out, _ = step(got, torch.tensor(xyz), torch.ones(512, dtype=torch.bool), torch.eye(4),
                  torch.eye(4))
    assert sum(int(torch.isfinite(b["elevation"]).sum()) for b in out.blocks.values()) > 0


def test_unsharded_restore(tmp_path):
    geom = ft.GridGeometry.from_length(4.0, 4.0, 0.5)
    state = random_state(geom)
    path = str(tmp_path / "c2")
    save_sharded(path, geom, sh.shard_state(state, sh.make_mesh(4, devices=["cpu"])))
    geom2, state2, _ = load_sharded(path, device="cpu")
    assert geom2 == geom and set(state2.layers) == set(state.layers)
    for name, v in state.layers.items():
        np.testing.assert_array_equal(state2.layers[name].numpy().view(np.int32),
                                      v.numpy().view(np.int32), err_msg=name)
    np.testing.assert_array_equal(state2.position.numpy(), state.position.numpy())


def resume_scan(seed, n=4000):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
        0.2 * np.sin(rng.uniform(-4, 4, n)) + rng.normal(0, 0.02, n),
    ]).astype(np.float32)


@pytest.mark.parametrize("est", ["KALMAN", "P2_QUANTILE"])
def test_resume_matches_uninterrupted(tmp_path, est):
    """tests/test_resume.py on a sharded GLOBAL map: 6 scans uninterrupted
    against 3 scans, a sharded checkpoint, a restore onto another mesh
    shape and 3 more scans."""
    geom = ft.GridGeometry.from_length(10.0, 10.0, 0.2)  # 50x50
    cfg = ft.Config()
    cfg.mapping.mode = ft.MappingMode.GLOBAL
    cfg.mapping.estimation_type = getattr(ft.EstimationType, est)
    cfg.raycasting.enabled = True
    I4 = torch.eye(4)
    mask = torch.ones(4000, dtype=torch.bool)
    mesh_a = sh.make_mesh(10, shape=(5, 2), devices=["cpu"])
    mesh_b = sh.make_mesh(5, shape=(1, 5), devices=["cpu"])
    step_a, shard = sh.build_sharded_integrate(geom, cfg, mesh_a)
    step_b, _ = sh.build_sharded_integrate(geom, cfg, mesh_b)

    s1 = shard(create_map_state(geom, cfg, device="cpu"))
    for i in range(6):
        s1, _ = step_a(s1, torch.tensor(resume_scan(i)), mask, I4, I4)

    s2 = shard(create_map_state(geom, cfg, device="cpu"))
    for i in range(3):
        s2, _ = step_a(s2, torch.tensor(resume_scan(i)), mask, I4, I4)
    path = str(tmp_path / "ckpt")
    save_sharded(path, geom, s2)
    _, s3, _ = load_sharded(path, mesh_b)
    assert set(s3.layer_names) == set(s2.layer_names)
    for i in range(3, 6):
        s3, _ = step_b(s3, torch.tensor(resume_scan(i)), mask, I4, I4)

    a, b = sh.gather_state(s1), sh.gather_state(s3)
    for name in a.layers:
        np.testing.assert_array_equal(a.layers[name].numpy().view(np.int32),
                                      b.layers[name].numpy().view(np.int32),
                                      err_msg=f"layer {name} diverged after resume")
    assert int(torch.isfinite(a.layers["elevation"]).sum()) > 1000


# ---- (d) scaling ---------------------------------------------------------------


def test_scaling_report_strong():
    geom = ft.GridGeometry.from_length(12.8, 12.8, 0.2)
    cfg = ft.Config()
    cfg.mapping.mode = ft.MappingMode.GLOBAL
    rep = scaling_report(geom, cfg, scans=3, points=2048,
                         mesh=sh.make_mesh(8, devices=["cpu"]), device="cpu")
    assert rep["devices"] == 8 and rep["cards"] == 0 and rep["mode"] == "strong"
    assert rep["ms_single"] > 0 and rep["ms_sharded"] > 0
    assert abs(rep["efficiency"] - rep["speedup"] / 8) < 1e-12


def test_scaling_report_weak_mode():
    geom = ft.GridGeometry.from_length(6.4, 6.4, 0.2)  # 32x32 per block
    cfg = ft.Config()
    cfg.mapping.mode = ft.MappingMode.GLOBAL
    rep = scaling_report(geom, cfg, scans=2, points=1024, mode="weak",
                         mesh=sh.make_mesh(8, devices=["cpu"]), device="cpu")
    assert rep["mode"] == "weak" and rep["devices"] == 8
    assert rep["map_shape_sharded"] == (32 * 4, 32 * 2)  # 4x2 mesh
    assert rep["efficiency"] > 0
    assert abs(rep["speedup"] - rep["efficiency"] * 8) < 1e-9
    with pytest.raises(ValueError, match="scaling mode"):
        scaling_report(geom, cfg, mode="diagonal", device="cpu")
