"""Program-cache bundles: a node that starts without building anything
(port of ``fastdem_tpu/runtime/aotcache.py``).

In the reference the first-run cost is XLA compiling each program, and a
bundle is a directory of JAX's persistent compilation cache. In the port
the first-run cost is building native code: nvcc builds the kernels K1 and
K4 (``ops/cuda_build.py``) and g++ builds the scan-IO library
(``native/``). So here a *bundle* is a directory holding those built
libraries (``cuda/`` and ``native/``) plus ``manifest.json``, which records

  * ``fingerprint(geom, cfg, pp_cfg, capacities)``: a hash of everything
    that shapes what the node runs (the reference's rules);
  * the toolchain: torch, ``torch.version.cuda``, ``nvcc --version``, the
    device's name and compute capability, and the NVIDIA driver version.

``enable(bundle_dir)``, called before the first scan, points both builds
at the bundle: libraries found there are loaded as they are, missing ones
are built into it (a pid-named temporary file, then an atomic rename, so
two processes filling one bundle never see a partial library). It warns
when the toolchain moved since the bundle was built. ``warmup`` fills a
bundle by driving the real code paths; ``verify`` reports a bundle's
health, optionally with a canary rebuild.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import tempfile
import time
from dataclasses import asdict, is_dataclass
from typing import Optional, Sequence

log = logging.getLogger("fastdem_tpu_torch.aotcache")

MANIFEST = "manifest.json"
# The bundle enabled in this process (None: the packages' own build dirs).
active: Optional[str] = None

# The canary: one fixed small kernel, rebuilt with `nvcc -cubin` by
# verify(canary=True). A different cubin for the same source means the
# compiler moved, even where its version string did not.
_CANARY_SOURCE = r"""
extern "C" __global__ void fastdem_canary(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = tanhf(x[i]) * x[i] + 1.0f;
}
"""


def _canonical(obj):
    """Config / geometry -> a stable JSON-able structure."""
    if is_dataclass(obj) and not isinstance(obj, type):
        return {k: _canonical(v) for k, v in asdict(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if hasattr(obj, "value"):  # enums
        return obj.value
    if isinstance(obj, float):
        return round(obj, 12)
    return obj


def fingerprint(geom, cfg, pp_cfg=None, capacities: Sequence[int] = ()) -> str:
    """Stable hash of everything that shapes what the node runs."""
    payload = {
        "geometry": {"shape": list(geom.shape), "resolution": geom.resolution},
        "config": _canonical(cfg),
        "postprocess": _canonical(pp_cfg) if pp_cfg is not None else None,
        "capacities": sorted(int(c) for c in capacities),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _nvcc() -> Optional[str]:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    return path if path and os.path.exists(path) else None


def _run(cmd) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _toolchain() -> dict:
    """What the bundle's libraries were built with and for."""
    import torch

    nvcc = _nvcc()
    nvcc_version = _run([nvcc, "--version"]) if nvcc else None
    out = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc_version.splitlines()[-1] if nvcc_version else None,
        "platform": "cuda" if torch.cuda.is_available() else "cpu",
        "device_kind": None,
        "capability": None,
        "driver": None,
    }
    if torch.cuda.is_available():
        out["device_kind"] = torch.cuda.get_device_name(0)
        out["capability"] = "sm_%d%d" % torch.cuda.get_device_capability(0)
        drv = _run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"])
        out["driver"] = drv.splitlines()[0] if drv else None
    return out


def _canary_fingerprint() -> str:
    """The hash of the canary's cubin, or "unavailable" without nvcc."""
    nvcc = _nvcc()
    if nvcc is None:
        return "unavailable"
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "canary.cu")
        cubin = os.path.join(d, "canary.cubin")
        with open(src, "w") as f:
            f.write(_CANARY_SOURCE)
        from fastdem_tpu_torch.ops.cuda_build import NVCC_FLAGS

        arch = [NVCC_FLAGS[0], NVCC_FLAGS[1]]
        if _run([nvcc, *arch, "-O3", "-cubin", "-o", cubin, src]) is None:
            return "unavailable"
        with open(cubin, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:16]


def _drift(manifest: dict) -> dict:
    drift = {}
    for key, cur in _toolchain().items():
        built = manifest.get("toolchain", {}).get(key)
        if built is not None and built != cur:
            drift[key] = {"built": built, "current": cur}
    return drift


def read_manifest(bundle_dir: str) -> Optional[dict]:
    path = os.path.join(bundle_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def enable(bundle_dir: str, create: bool = True) -> Optional[dict]:
    """Build into and load from ``bundle_dir`` in this process. Call before
    the first scan. Returns the bundle's manifest (None if it has none)
    after warning about toolchain drift: a library built with another
    toolchain is not an error (the build is keyed by its source and flags),
    but it may not load or may be slower."""
    global active
    from fastdem_tpu_torch import native
    from fastdem_tpu_torch.ops import cuda_build

    bundle_dir = os.path.abspath(bundle_dir)
    if create:
        os.makedirs(bundle_dir, exist_ok=True)
    cuda_build.set_build_dir(os.path.join(bundle_dir, "cuda"))
    native.set_build_dir(os.path.join(bundle_dir, "native"))
    active = bundle_dir
    manifest = read_manifest(bundle_dir)
    if manifest is not None:
        for key, d in _drift(manifest).items():
            log.warning(
                "program-cache bundle %s was built with %s=%s but this process "
                "has %s: its libraries may need a rebuild",
                bundle_dir, key, d["built"], d["current"],
            )
    return manifest


def _libraries(bundle_dir: str) -> list:
    out = []
    for sub in ("cuda", "native"):
        d = os.path.join(bundle_dir, sub)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".so"):
                with open(os.path.join(d, name), "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()[:16]
                out.append({"file": f"{sub}/{name}", "sha256": digest})
    return out


def verify(bundle_dir: str, canary: bool = False) -> dict:
    """A bundle's health: its libraries, its fingerprint, the toolchain
    drift; with ``canary`` the canary rebuild against the recorded hash
    (``canary_match`` None when either side is unavailable)."""
    manifest = read_manifest(bundle_dir) or {}
    libs = _libraries(bundle_dir) if os.path.isdir(bundle_dir) else []
    out = {
        "bundle": bundle_dir,
        "entries": len(libs),
        "libraries": libs,
        "fingerprint": manifest.get("fingerprint"),
        "toolchain_drift": _drift(manifest),
    }
    if canary:
        cur = _canary_fingerprint()
        built = manifest.get("canary")
        out["canary"] = cur
        if cur == "unavailable" or built in (None, "unavailable"):
            out["canary_match"] = None
        else:
            out["canary_match"] = cur == built
            if not out["canary_match"]:
                log.warning(
                    "the compiler moved since the bundle was built (canary %s -> %s)",
                    built, cur,
                )
    return out


def warmup(
    geom,
    cfg,
    pp_cfg=None,
    bundle_dir: Optional[str] = None,
    capacities: Sequence[int] = (32768,),
    replay_batches: Sequence[int] = (),
    canary: bool = False,
    progress=None,
    *,
    device="cuda",
) -> dict:
    """Fill the active (or given) bundle by driving the real code paths:
    ``FastDEM.integrate`` per capacity bucket (on a card with the raycast
    on, K1 and K4 are built first, in parallel), ``integrate_sequence`` per
    replay batch, the post-processing chain, and the native scan IO. Returns the manifest,
    also written to the bundle."""
    import numpy as np
    import torch

    from fastdem_tpu_torch import native
    from fastdem_tpu_torch.cloud.pointcloud import from_numpy
    from fastdem_tpu_torch.config import PostProcessConfig
    from fastdem_tpu_torch.mapping.pipeline import FastDEM
    from fastdem_tpu_torch.postprocess import apply_postprocess_fn

    if bundle_dir is not None:
        enable(bundle_dir)
    if active is None:
        raise RuntimeError("warmup needs a bundle: pass bundle_dir or call enable() first")
    t0 = time.perf_counter()
    say = progress or (lambda msg: log.info("%s", msg))

    done = []
    mapper = FastDEM(geom, cfg, device=device)
    if mapper.device.type == "cuda" and cfg.raycasting.enabled:
        # Both kernels at once (one nvcc each, in parallel), before the
        # first scan would build them one after the other.
        from fastdem_tpu_torch.ops import cuda_build
        from fastdem_tpu_torch.ops import polar_field as k1
        from fastdem_tpu_torch.ops import resample as k4

        say("building K1 and K4 ...")
        cuda_build.build(k1.SOURCE, k4.SOURCE)
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    rng = np.random.default_rng(0)
    for cap in capacities:
        n = int(cap)
        say(f"integrate @ capacity {n} ...")
        xyz = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
        xyz[:, 2] = -1.0
        mapper.integrate(
            from_numpy(xyz, frame_id="lidar", device=device), T_bs, np.eye(4, dtype=np.float32)
        )
        done.append({"program": "integrate", "capacity": n})
        for b in replay_batches:
            say(f"integrate_sequence @ capacity {n} batch {b} ...")
            clouds = [from_numpy(xyz, frame_id="lidar", device=device) for _ in range(int(b))]
            poses = np.tile(np.eye(4, dtype=np.float32), (int(b), 1, 1))
            mapper.integrate_sequence(clouds, T_bs, poses, batch=int(b))
            done.append({"program": "integrate_sequence", "capacity": n, "batch": int(b)})
        mapper.reset()
    pp = pp_cfg or PostProcessConfig()
    say("postprocess chain ...")
    e = mapper.state.layers["elevation"]
    apply_postprocess_fn(geom, pp)(e, e + 0.1, e - 0.1)
    done.append({"program": "postprocess"})
    say("native scan IO ...")
    if native.available():
        done.append({"program": "native_io"})
    else:
        log.warning("native scan IO could not be built into the bundle: %s", native.build_error)
    if mapper.device.type == "cuda":
        torch.cuda.synchronize(mapper.device)

    manifest = {
        "fingerprint": fingerprint(geom, cfg, pp, capacities),
        "toolchain": _toolchain(),
        "capacities": [int(c) for c in capacities],
        "replay_batches": [int(b) for b in replay_batches],
        "programs": done,
        "libraries": _libraries(active),
        "warmup_seconds": round(time.perf_counter() - t0, 3),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if canary:
        say("canary build ...")
        manifest["canary"] = _canary_fingerprint()
    tmp = os.path.join(active, f"{MANIFEST}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    os.replace(tmp, os.path.join(active, MANIFEST))
    return manifest

