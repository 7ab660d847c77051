"""Program-cache bundles of the port (``runtime/aotcache.py``) and its
timing / profiling utilities (``utils/benchtime.py``, ``utils/profiling.py``).

The reference's three ``tests/test_aotcache.py`` cases on the port, on the
CPU: ``warmup`` fills a bundle (here the g++-built native scan IO; nvcc's
kernels are built only on a card) and its manifest; ``enable`` warns when
the toolchain moved; the fingerprint follows the config, the geometry and
the capacities. Then: after ``enable`` the kernels' library paths lie in
the bundle (no nvcc needed); the canary is "unavailable" without nvcc; the
``aot_warmup`` tool and ``fastdem_replay --program-cache``. Last, the
utilities against the reference's (``TestProfiling`` in
``tests/test_sharding.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastdem_tpu_torch as ft
from fastdem_tpu_torch import native
from fastdem_tpu_torch.ops import cuda_build
from fastdem_tpu_torch.ops import polar_field as k1
from fastdem_tpu_torch.ops import resample as k4
from fastdem_tpu_torch.runtime import aotcache
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fresh_builds(monkeypatch):
    """Undo enable() after the test: the build directories, the bundle and
    the native library's loaded state go back to what they were."""
    for mod, names in ((cuda_build, ("BUILD_DIR",)),
                       (native, ("_BUILD_DIR", "_LIB", "_lib", "_tried", "build_error",
                                  "build_seconds")),
                       (aotcache, ("active",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_seconds", None)
    return monkeypatch


@pytest.fixture()
def geom():
    return ft.GridGeometry.from_length(6.0, 6.0, 0.1)


def test_warmup_populates_bundle_and_manifest(tmp_path, geom, fresh_builds):
    bundle = str(tmp_path / "bundle")
    cfg = ft.Config()
    cfg.raycasting.enabled = True
    manifest = aotcache.warmup(
        geom, cfg, ft.PostProcessConfig(), bundle_dir=bundle,
        capacities=(4096,), replay_batches=(2,), device="cpu",
    )
    assert os.path.exists(os.path.join(bundle, aotcache.MANIFEST))
    progs = {p["program"] for p in manifest["programs"]}
    assert progs == {"integrate", "integrate_sequence", "postprocess", "native_io"}
    assert manifest["warmup_seconds"] > 0
    assert manifest["toolchain"]["torch"] == torch.__version__
    # The native library was built into the bundle, not the package.
    assert native._LIB == os.path.join(bundle, "native", "libfastdem_io.so")
    assert os.path.exists(native._LIB)
    assert native.build_seconds > 0  # this process ran g++
    assert {e["file"] for e in manifest["libraries"]} == {"native/libfastdem_io.so"}
    health = aotcache.verify(bundle)
    assert health["fingerprint"] == manifest["fingerprint"]
    assert health["toolchain_drift"] == {}
    assert health["entries"] == 1 and health["libraries"] == manifest["libraries"]
    # A second process would find the library: enabling the filled bundle
    # builds nothing.
    assert aotcache.enable(bundle)["fingerprint"] == manifest["fingerprint"]


def test_enable_warns_on_toolchain_drift(tmp_path, fresh_builds, caplog):
    bundle = str(tmp_path / "bundle")
    os.makedirs(bundle)
    manifest = {
        "fingerprint": "abc",
        "toolchain": {"torch": "0.0.1", "platform": "tpu", "device_kind": "v99"},
    }
    with open(os.path.join(bundle, aotcache.MANIFEST), "w") as f:
        json.dump(manifest, f)
    with caplog.at_level("WARNING", logger="fastdem_tpu_torch.aotcache"):
        out = aotcache.enable(bundle)
    assert out["fingerprint"] == "abc"
    assert any("was built with torch=0.0.1" in r.message for r in caplog.records)
    health = aotcache.verify(bundle)
    assert set(health["toolchain_drift"]) >= {"torch", "platform"}


def test_fingerprint_sensitivity(geom):
    cfg = ft.Config()
    fp1 = aotcache.fingerprint(geom, cfg, None, (4096,))
    assert fp1 == aotcache.fingerprint(geom, cfg, None, (4096,))
    cfg2 = ft.Config()
    cfg2.mapping.kalman.process_noise = cfg2.mapping.kalman.process_noise + 1e-3
    assert fp1 != aotcache.fingerprint(geom, cfg2, None, (4096,))
    assert fp1 != aotcache.fingerprint(geom, cfg, None, (8192,))
    geom2 = ft.GridGeometry.from_length(8.0, 6.0, 0.1)
    assert fp1 != aotcache.fingerprint(geom2, cfg, None, (4096,))
    assert fp1 != aotcache.fingerprint(geom, cfg, ft.PostProcessConfig(), (4096,))


def test_enable_points_the_kernel_builds_at_the_bundle(tmp_path, fresh_builds):
    bundle = str(tmp_path / "bundle")
    aotcache.enable(bundle)
    for src in (k1.SOURCE, k4.SOURCE):
        path = cuda_build.library_path(src)
        assert str(path).startswith(os.path.join(bundle, "cuda") + os.sep)
        assert path.name.startswith(src.stem + "_") and path.suffix == ".so"
    assert aotcache.active == os.path.abspath(bundle)


def test_canary_without_nvcc(tmp_path):
    if aotcache._nvcc() is not None:
        pytest.skip("nvcc is present")
    out = aotcache.verify(str(tmp_path), canary=True)
    assert out["canary"] == "unavailable" and out["canary_match"] is None
    assert out["entries"] == 0


def test_tools_build_and_use_a_bundle(tmp_path):
    """aot_warmup fills a bundle for a preset; --verify reports it; the
    replay tool with --program-cache and --prefetch loads the native IO
    from the bundle."""
    bundle = str(tmp_path / "bundle")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def tool(*args):
        proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        return proc.stdout, proc.stderr

    out = json.loads(tool("fastdem_tpu_torch.tools.aot_warmup", "--preset", "local_mapping",
                          "--bundle", bundle, "--capacities", "4096", "--device", "cpu")[0])
    assert {"native/libfastdem_io.so"} == {e["file"] for e in out["libraries"]}
    health = json.loads(tool("fastdem_tpu_torch.tools.aot_warmup", "--verify", bundle)[0])
    assert health["fingerprint"] == out["fingerprint"] and health["entries"] == 1
    before = os.path.getmtime(os.path.join(bundle, "native", "libfastdem_io.so"))

    scans = tmp_path / "scans"
    scans.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        xyzi = np.column_stack([rng.uniform(-5, 5, (2000, 2)), rng.normal(-1, 0.02, 2000),
                                rng.random(2000)]).astype(np.float32)
        xyzi.tofile(scans / f"{i:06d}.bin")
    log = tool("fastdem_tpu_torch.tools.fastdem_replay", "--preset", "local_mapping",
               "--scans", str(scans), "--prefetch", "1", "--capacity", "2048",
               "--device", "cpu", "--program-cache", bundle)
    assert "ms/scan" in "".join(log)
    assert os.path.getmtime(os.path.join(bundle, "native", "libfastdem_io.so")) == before


# ---- utils -----------------------------------------------------------------


def test_stats_match_the_reference():
    from fastdem_tpu.utils import benchtime as bt_j
    from fastdem_tpu.utils import profiling as prof_j
    from fastdem_tpu_torch.utils import benchtime, profiling

    samples = [1.0, 1.1, 0.9, 1.05, 50.0]
    s = profiling.compute_stats(samples)
    assert s.n_outliers == 1 and 0.9 <= s.mean <= 1.2
    assert dataclasses.asdict(s) == dataclasses.asdict(prof_j.compute_stats(samples))
    assert "ms +/-" in str(s)
    rng = np.random.default_rng(3)
    pool = list(rng.lognormal(0.0, 0.5, 41)) + [30.0, 40.0]
    assert benchtime.summarize(pool) == bt_j.summarize(pool)
    assert benchtime.median(pool) == bt_j.median(pool)
    with pytest.raises(ValueError):
        benchtime.summarize([])


def test_two_length_diff_interleaves_the_legs():
    from fastdem_tpu_torch.utils import benchtime

    calls = []
    ms, per_pair, med_k = benchtime.two_length_diff_ms(
        lambda: calls.append("k"), lambda: calls.append("2k"), K=4, pairs=5
    )
    assert calls == ["k", "2k"] * 5
    assert len(per_pair) == 5 and ms >= 1e-4 and med_k >= 0.0


def test_benchmark_helper_and_platform(tmp_path):
    from fastdem_tpu_torch.utils.profiling import benchmark, platform_info, trace

    x = torch.zeros((64, 64))
    st = benchmark(lambda: x + 1, warmup=1, reps=5)
    assert st.mean >= 0 and st.n_samples + st.n_outliers == 5
    info = platform_info()
    assert "device" in info and info["torch"] == torch.__version__
    with trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert os.listdir(tmp_path / "trace")
    assert any("matmul" in e.key or "mm" in e.key for e in prof.key_averages())
