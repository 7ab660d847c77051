"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into ``csrc/_build/<stem>_<hash>.so`` (or the directory ``set_build_dir``
names: a program-cache bundle, ``runtime.aotcache``), keyed by a hash of
the source and the flags, then loaded with ctypes. ``build`` starts one nvcc per missing
library, all at once, and waits for them; a failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Per source file name: nvcc's output (registers, spills) and the wall
# seconds of the build this process made. Sources found already built have
# no entry.
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def set_build_dir(path) -> None:
    """Build into and load from ``path`` from now on. Libraries already
    loaded stay loaded from where they were."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc) to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build(*sources: Path) -> None:
    """Compile every source whose library is missing, in parallel."""
    jobs = []
    for src in sources:
        so = library_path(src)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp.so"
        log = open(BUILD_DIR / f"{so.stem}.{os.getpid()}.log", "w+")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, so, tmp, log, proc, time.perf_counter()))
    failures = []
    while jobs:
        for job in list(jobs):
            src, so, tmp, log, proc, t0 = job
            if proc.poll() is None:
                continue
            jobs.remove(job)
            build_seconds[src.name] = time.perf_counter() - t0
            log.seek(0)
            out = log.read()
            log.close()
            os.unlink(log.name)
            if proc.returncode != 0:
                failures.append(
                    f"nvcc failed to build {src.name} (exit {proc.returncode}):\n{out}"
                )
                continue
            build_logs[src.name] = out
            os.replace(tmp, so)
        if jobs:
            time.sleep(0.02)
    if failures:
        raise RuntimeError("\n".join(failures))


def load(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))
