"""K1, the polar ray field's dense tail: CUDA kernel wrapper and plain twin.

Replaces the Pallas TPU kernel ``fastdem_tpu/ops/pallas_polar.py::_kernel``.
From the scattered min-slope table [R, A] it computes, in order:

  1. a suffix min along the range rows;
  2. h = z0 + slope * (r * dr) where the slope is finite, else +inf;
  3. the in-cell fold: the min over rows r-nfold+1 .. r (row 0 stands in
     above the top edge);
  4. per-row circular azimuth roll-min doublings for k < lvl[r];
  5. with ``exact_window``, one more roll-min at each set bit of shift[r].

``polar_field`` launches the kernel (``csrc/polar_field.cu``) for a CUDA
tensor and runs ``polar_field_plain`` -- the same steps as plain PyTorch
ops, mirroring the reference's XLA formulation -- for a CPU tensor. The
kernel is built with nvcc from the repository's source at first use
(``ops/cuda_build.py``); a build or launch failure raises. ``launches``
counts kernel launches; inside a CUDA graph of a step
(``utils/graphs.py``) each replay adds the launches its capture made. The
kernel's host code (``cudaFuncSetAttribute``, the launch,
``cudaGetLastError``) is legal inside a capture, and the launch into the
capturing stream is recorded in the graph.

A batch of K fields (``scat`` [K, R, A] with ``sensor_origin`` [K, 3], the
scan-batched replay step) is one launch; each field equals the one-field
call's bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np
import torch

from fastdem_tpu_torch.numerics import fma_f32
from fastdem_tpu_torch.ops import cuda_build
from fastdem_tpu_torch.utils import graphs

# Kernel launches since import (or since the caller last reset it).
launches = 0
# Kept true through the replays of the CUDA graphs of a step.
graphs.count_launches(sys.modules[__name__])
# Compile-time bound of the in-cell fold width in the kernel (nfold =
# ceil(1 / range_bin_factor) <= 10 for every validated config).
NFOLD_MAX = 10

SOURCE = cuda_build.CSRC / "polar_field.cu"

_lib = None


@dataclasses.dataclass(frozen=True)
class ColumnWindows:
    """Per-range-row azimuth windows of one polar geometry, on the device:
    w(r) = 2^lvl[r] + shift[r] bins (see raycasting._column_windows)."""

    lvl: torch.Tensor  # int32[R]
    shift: torch.Tensor  # int32[R]
    max_lvl: int
    max_shift: int

    @staticmethod
    def from_numpy(lvl: np.ndarray, shift: np.ndarray, device) -> "ColumnWindows":
        return ColumnWindows(
            lvl=torch.as_tensor(lvl.astype(np.int32), device=device),
            shift=torch.as_tensor(shift.astype(np.int32), device=device),
            max_lvl=int(np.max(lvl)),
            max_shift=int(np.max(shift)),
        )


def library():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load(SOURCE)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fastdem_polar_field.argtypes = [vp, vp, vp, vp, ci, ci, cf, ci, ci, ci, ci, vp, vp]
    lib.fastdem_polar_field.restype = ci
    lib.fastdem_polar_field_nfold_max.argtypes = []
    lib.fastdem_polar_field_nfold_max.restype = ci
    lib.fastdem_cuda_error_string.argtypes = [ci]
    lib.fastdem_cuda_error_string.restype = ctypes.c_char_p
    if lib.fastdem_polar_field_nfold_max() != NFOLD_MAX:
        raise RuntimeError("K1 library and wrapper disagree on NFOLD_MAX")
    _lib = lib
    return lib


def _check_inputs(scat, windows, sensor_origin, nfold):
    if scat.dtype != torch.float32 or scat.dim() not in (2, 3):
        raise ValueError(
            f"scat must be f32[R, A] or f32[K, R, A], got {scat.dtype} {tuple(scat.shape)}"
        )
    if not scat.is_contiguous():
        raise ValueError("scat must be contiguous")
    R = scat.shape[-2]
    for name, t in (("lvl", windows.lvl), ("shift", windows.shift)):
        if t.dtype != torch.int32 or tuple(t.shape) != (R,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32[{R}]")
        if t.device != scat.device:
            raise ValueError(f"{name} is on {t.device}, scat on {scat.device}")
    if (
        sensor_origin.dtype != torch.float32
        or tuple(sensor_origin.shape) != tuple(scat.shape[:-2]) + (3,)
        or sensor_origin.device != scat.device
    ):
        raise ValueError(
            "sensor_origin must be f32[3] (f32[K, 3] for K fields) on the field's device"
        )
    if not 1 <= nfold <= NFOLD_MAX:
        raise ValueError(f"nfold {nfold} outside the kernel's range 1..{NFOLD_MAX}")


def polar_field_cuda(
    scat: torch.Tensor,
    windows: ColumnWindows,
    sensor_origin: torch.Tensor,
    dr: float,
    nfold: int,
    exact_window: bool,
) -> torch.Tensor:
    """Launch K1 on the current stream. ``scat`` f32[R, A] (or [K, R, A])
    on a CUDA device."""
    global launches
    if scat.device.type != "cuda":
        raise ValueError(f"K1 needs a CUDA tensor, got one on {scat.device}")
    _check_inputs(scat, windows, sensor_origin, nfold)
    lib = library()
    R, A = scat.shape[-2:]
    frames = scat[..., 0, 0].numel()
    out = torch.empty_like(scat)
    # The sensor heights: the kernel reads frame k's z0 at k * stride.
    z0 = sensor_origin[..., 2:3]
    stream = torch.cuda.current_stream(scat.device).cuda_stream
    err = lib.fastdem_polar_field(
        ctypes.c_void_p(scat.data_ptr()),
        ctypes.c_void_p(windows.lvl.data_ptr()),
        ctypes.c_void_p(windows.shift.data_ptr()),
        ctypes.c_void_p(z0.data_ptr()),
        ctypes.c_int(sensor_origin.stride(0) if scat.dim() == 3 else 0),
        ctypes.c_int(frames),
        ctypes.c_float(dr),
        ctypes.c_int(R),
        ctypes.c_int(A),
        ctypes.c_int(nfold),
        ctypes.c_int(1 if exact_window else 0),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"K1 launch failed: cudaError {err} "
            f"({lib.fastdem_cuda_error_string(err).decode()})"
        )
    launches += 1
    return out


def polar_field_plain(
    scat: torch.Tensor,
    windows: ColumnWindows,
    sensor_origin: torch.Tensor,
    dr: float,
    nfold: int,
    exact_window: bool,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (the reference's XLA formulation); a
    batch [K, R, A] field by field."""
    if scat.dim() == 3:
        return torch.stack([
            polar_field_plain(s, windows, o, dr, nfold, exact_window)
            for s, o in zip(scat, sensor_origin)
        ])
    R, A = scat.shape
    ms = torch.flip(torch.cummin(torch.flip(scat, [0]), dim=0).values, [0])
    d_r = torch.arange(R, dtype=torch.float32, device=scat.device)[:, None] * dr
    # The reference's compiler contracts z0 + ms * d_r into one FMA.
    h = torch.where(
        torch.isfinite(ms), fma_f32(ms, d_r, sensor_origin[2]), float("inf")
    )

    def shift_down(a, k):
        return torch.cat([a[:1].expand(k, -1), a[:-k]], dim=0) if k > 0 else a

    p = 1
    acc = h
    while 2 * p <= nfold:
        acc = torch.minimum(acc, shift_down(acc, p))
        p *= 2
    if nfold - p > 0:
        acc = torch.minimum(acc, shift_down(acc, nfold - p))
    h = acc

    for k in range(windows.max_lvl):
        rowmask = (windows.lvl > k)[:, None]
        h = torch.where(rowmask, torch.minimum(h, torch.roll(h, -(1 << k), 1)), h)
    if exact_window:
        for b in range(max(0, windows.max_shift).bit_length()):
            rowmask = (((windows.shift >> b) & 1) == 1)[:, None]
            h = torch.where(
                rowmask, torch.minimum(h, torch.roll(h, -(1 << b), 1)), h
            )
    return h


def polar_field(
    scat: torch.Tensor,
    windows: ColumnWindows,
    sensor_origin: torch.Tensor,
    dr: float,
    nfold: int,
    exact_window: bool,
) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain twin for a CPU tensor."""
    if scat.device.type == "cuda":
        return polar_field_cuda(scat, windows, sensor_origin, dr, nfold, exact_window)
    if scat.device.type == "cpu":
        return polar_field_plain(scat, windows, sensor_origin, dr, nfold, exact_window)
    raise ValueError(f"no polar field implementation for device {scat.device}")
