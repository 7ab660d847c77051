"""Profiling and benchmark statistics (port of
``fastdem_tpu/utils/profiling.py``).

``compute_stats`` is the reference benchmark harness's Stats (mean,
stddev, median and a 95% CI after IQR outlier removal); ``benchmark``
times a callable with the card synchronised around each rep;
``platform_info`` names the device and its power limit; ``trace`` records a
``torch.profiler`` trace of a block; ``device_profile`` sums the device
events of a callable's calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import platform
import subprocess
import time
from typing import Callable, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Stats:
    mean: float
    stddev: float
    median: float
    ci95_lo: float
    ci95_hi: float
    n_samples: int
    n_outliers: int

    def __str__(self):
        return (
            f"{self.mean:.3f} ms +/- {self.stddev:.3f} "
            f"(median {self.median:.3f}, CI95 [{self.ci95_lo:.3f}, "
            f"{self.ci95_hi:.3f}], n={self.n_samples}, "
            f"dropped {self.n_outliers} outliers)"
        )


def compute_stats(samples_ms: List[float], iqr_filter: bool = True) -> Stats:
    """IQR-filtered summary statistics: drop samples outside
    [Q1 - 1.5 IQR, Q3 + 1.5 IQR] (with 4 samples or more), then mean,
    stddev (ddof 1), median and a normal-approximation 95% CI."""
    x = np.asarray(samples_ms, dtype=np.float64)
    n_out = 0
    if iqr_filter and x.size >= 4:
        q1, q3 = np.percentile(x, [25, 75])
        iqr = q3 - q1
        keep = (x >= q1 - 1.5 * iqr) & (x <= q3 + 1.5 * iqr)
        n_out = int((~keep).sum())
        x = x[keep]
    mean = float(np.mean(x))
    std = float(np.std(x, ddof=1)) if x.size > 1 else 0.0
    half = 1.96 * std / np.sqrt(max(x.size, 1))
    return Stats(
        mean=mean,
        stddev=std,
        median=float(np.median(x)),
        ci95_lo=mean - half,
        ci95_hi=mean + half,
        n_samples=int(x.size),
        n_outliers=n_out,
    )


def _sync(_out=None) -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(
    fn: Callable[[], object],
    warmup: int = 2,
    reps: int = 20,
    sync: Optional[Callable[[object], None]] = None,
) -> Stats:
    """Time ``fn()`` ``reps`` times (ms, host clock) after ``warmup`` calls.
    ``sync(out)`` runs after every call (default: synchronise the card when
    CUDA is in use), and the card is synchronised before each rep, so a
    rep times exactly its own work."""
    sync = sync or _sync
    for _ in range(warmup):
        sync(fn())
    samples = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        sync(fn())
        samples.append((time.perf_counter() - t0) * 1e3)
    return compute_stats(samples)


# Idle seconds at each end of a ``device_profile`` window.
PROFILE_PAD_S = 0.02


def profile_window(fn: Callable[[], object], reps: int, pad_s: Optional[float] = None):
    """``torch.profiler`` (CPU and CUDA) over ``reps`` calls of ``fn``, the
    card synchronised before the window and after the calls, the window
    idle for ``pad_s`` seconds (default ``PROFILE_PAD_S``) before the first
    call and after the last.
    Returns ``(profiler, device events by name)``: each CUDA event's count
    and total device time in microseconds.

    Kineto drops a device event that it places outside the window. On the
    H100 unpadded windows of 50 short launches lost all their events about
    once in 11 s (13 of 1,807 windows, one more lost some); padded by 20
    ms, none of 1,807 did (``tools/profiler_windows.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad_s = PROFILE_PAD_S if pad_s is None else pad_s
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        _sync()
        time.sleep(pad_s)
    events = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "device_time", None)
            n, us = events.get(e.name, (0, 0.0))
            events[e.name] = (n + 1, us + (e.cuda_time if t is None else t))
    return prof, events


def device_profile(fn: Callable[[], object], reps: int, attempts: int = 1):
    """(device ms, device events, {name: (events, device ms)}) per call of
    ``fn``: the count and the summed time of the CUDA events (kernels,
    copies, fills) of ``reps`` calls in one ``profile_window``, / reps, and
    the profiler. A window that records no device time is measured again,
    up to ``attempts`` windows in all: give ``attempts`` > 1 only for an
    ``fn`` that may run again. Raises when no window recorded any."""
    for _ in range(attempts):
        prof, events = profile_window(fn, reps)
        total = sum(us for _, us in events.values())
        if total > 0.0:
            count = sum(n for n, _ in events.values())
            by_name = {k: (n / reps, us / reps / 1000.0) for k, (n, us) in events.items()}
            return total / reps / 1000.0, count / reps, by_name, prof
    raise RuntimeError(f"the profiler recorded no device time in {attempts} window(s)")


def platform_info() -> dict:
    """The device (the card's name and power limit from ``torch.cuda`` and,
    where present, ``nvidia-smi``), torch, Python and the machine."""
    info = {
        "device": "cpu",
        "backend": "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "machine": platform.machine(),
    }
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        info.update(
            device=torch.cuda.get_device_name(0),
            backend="cuda",
            device_count=torch.cuda.device_count(),
            capability="sm_%d%d" % (props.major, props.minor),
            memory_bytes=int(props.total_memory),
        )
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30,
            )
            if smi.returncode == 0 and smi.stdout.strip():
                info["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError):
            pass
    return info


@contextlib.contextmanager
def trace(log_dir: str = "fastdem_trace"):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where present) of
    the block into ``log_dir`` (a Chrome trace, viewable in Perfetto).
    Yields the profiler, whose ``key_averages()`` summarise the ops."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _sync()
