"""K4, the per-cell lookup of the polar ray field: CUDA kernel wrappers and
plain twins.

Replaces the Pallas TPU kernel
``fastdem_tpu/ops/pallas_resample.py::_resample_kernel``
(``out = min(field[a0, r], field[a1, r])``) and fuses the epilogue the
reference runs after it. The field is f32[R, A] (the port's layout, the
transpose of the TPU kernel's [A, R]); per cell (all [h, w], the whole map
or a window) it returns

  ray_min f32[h, w]: the field's min over the cell's one or two reads,
                     NaN where the cell is not touched;
  touched bool[h, w] = isfinite(min) & in_range.

``resample_lookup`` is the wrapper: the kernel also computes each cell's
lookup indices (``lookup_indices``, the reference's ``resample_indices``)
from the map position, the sensor origin and the window offsets, all read
on the device. Its twin, ``resample_lookup_plain``, is ``lookup_indices``
followed by ``resample_plain`` (the lookup of given indices: int32 ``a0``,
optional ``a1``, ``r_idx`` and bool ``in_range``).

It launches the kernel (``csrc/resample.cu``) for a CUDA tensor and runs
the plain twin for a CPU tensor; a build or launch failure raises.
``launches`` counts kernel launches; inside a CUDA graph of a step
(``utils/graphs.py``) each replay adds the launches its capture made. The
kernel's host code (the launch, ``cudaGetLastError``) is legal inside a
capture, and the launch into the capturing stream is recorded in the
graph.

A batch of K frames (the scan-batched replay step) is one launch: field
[K, R, A], position [K, 2], sensor_origin [K, 3], window offsets int32[K],
outputs [K, h, w]; each frame equals the one-frame call's bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.grid.geometry import GridGeometry, floor_i32, to_i32
from fastdem_tpu_torch.numerics import fma_f32, recip_f32, sqrt_f32
from fastdem_tpu_torch.ops import cuda_build
from fastdem_tpu_torch.utils import graphs

# Kernel launches since import (or since the caller last reset it).
launches = 0
# Kept true through the replays of the CUDA graphs of a step.
graphs.count_launches(sys.modules[__name__])

SOURCE = cuda_build.CSRC / "resample.cu"
# Azimuth half-width factor of a cell's angular footprint; the lookup and
# raycasting._column_windows must use the same value (the exact-window fold
# relies on it).
AZ_HALF_WIDTH = 0.5
_PI = math.pi
_INF = float("inf")

_lib = None


class _LookupParams(ctypes.Structure):
    """``FastdemLookup`` of csrc/resample.cu."""

    _fields_ = [(k, ctypes.c_int) for k in ("R", "A", "wr", "wc", "two_reads")] + [
        (k, ctypes.c_float)
        for k in ("half_x", "half_y", "res", "half_res", "inv_dr", "dr", "az_half",
                  "d_min", "inv_bin", "pi", "inv_2pi", "a_f", "r_max")
    ]


@dataclasses.dataclass(frozen=True)
class PolarLookup:
    """The static part of one polar geometry's per-cell lookup: the map's
    geometry and a field [R, A] of range bin ``dr``
    (raycasting.polar_lookup builds it)."""

    geom: GridGeometry
    A: int
    R: int
    dr: float

    @functools.cached_property
    def consts(self) -> dict:
        """The lookup's constants, computed once: each the f32 value that the
        twin's ops compute with (a Python float operand of an f32 op is
        rounded to f32 first). The kernel and ``lookup_indices`` both read
        them."""
        f32 = np.float32
        rows, cols, res = self.geom.rows, self.geom.cols, self.geom.resolution
        return {
            k: float(v)
            for k, v in (
                ("half_x", f32(0.5 * rows * res)),
                ("half_y", f32(0.5 * cols * res)),
                ("res", f32(res)),
                ("half_res", f32(res * 0.5)),
                ("inv_dr", recip_f32(self.dr)),
                ("dr", f32(self.dr)),
                ("az_half", f32(res * AZ_HALF_WIDTH)),
                ("d_min", f32(1e-6)),
                ("inv_bin", recip_f32(2 * _PI / self.A)),
                ("pi", f32(_PI)),
                ("inv_2pi", recip_f32(2 * _PI)),
                ("a_f", f32(self.A)),
                ("r_max", f32((self.R - 1) * self.dr)),
            )
        }

    def params(self, wr: int, wc: int, two_reads: bool) -> _LookupParams:
        """The kernel's arguments for a wr x wc block of cells."""
        return _LookupParams(R=self.R, A=self.A, wr=wr, wc=wc, two_reads=int(two_reads),
                             **self.consts)


def library():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fastdem_resample_lookup.argtypes = [
        vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, ctypes.POINTER(_LookupParams), vp, vp, vp,
    ]
    lib.fastdem_resample_lookup.restype = ci
    lib.fastdem_cuda_error_string.argtypes = [ci]
    lib.fastdem_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def resample_plain(
    field: torch.Tensor,
    a0: torch.Tensor,
    a1: Optional[torch.Tensor],
    r_idx: torch.Tensor,
    in_range: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lookup of given indices in plain PyTorch: the twin's second
    half (``resample_lookup_plain``)."""
    A = field.shape[1]
    flat = field.reshape(-1)
    base = r_idx.long() * A
    h = flat[base + a0.long()]
    if a1 is not None:
        h = torch.minimum(h, flat[base + a1.long()])
    touched = torch.isfinite(h) & in_range
    return torch.where(touched, h, float("nan")), touched


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hypot as the reference computes it: max * sqrt(fma(q, q, 1)) with
    q = min / max."""
    x, y = torch.abs(x), torch.abs(y)
    idx_inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    q = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    out = torch.where(hi == 0, hi, hi * sqrt_f32(fma_f32(q, q, 1.0)))
    return torch.where(idx_inf, _INF, out)


def lookup_indices(
    lk: PolarLookup,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    window: Optional[Tuple] = None,
):
    """Per-cell (a0, a1, r_idx, in_range) lookups into the smeared field, as
    the reference's ``resample_indices`` computes them. Cells beyond the
    field's range bound report in_range=False.

    ``window``: optional (r0, c0, wr, wc) -- only the wr x wc cells whose
    top-left cell is (r0, c0); r0 / c0 are int32 device scalars, so the
    window never costs a host sync.
    """
    geom, A, R, c = lk.geom, lk.A, lk.R, lk.consts
    dev = position.device
    if window is not None:
        r0, c0, wr, wc = window
        rr = r0 + torch.arange(wr, dtype=torch.int32, device=dev)
        cc = c0 + torch.arange(wc, dtype=torch.int32, device=dev)
    else:
        wr, wc = geom.shape
        rr = torch.arange(wr, dtype=torch.int32, device=dev)
        cc = torch.arange(wc, dtype=torch.int32, device=dev)
    # Cell centres o - (i + 0.5) * res, which the reference's compiler
    # contracts into one fused multiply-add inside its compiled step.
    ox, oy = geom.origin(position)
    res = torch.full((), c["res"], dtype=torch.float32, device=dev)
    cx = fma_f32(-(rr.to(torch.float32) + 0.5), res, ox)[:, None].expand(wr, wc)
    cy = fma_f32(-(cc.to(torch.float32) + 0.5), res, oy)[None, :].expand(wr, wc)
    ddx = cx - sensor_origin[0]
    ddy = cy - sensor_origin[1]
    dist = _hypot(ddx, ddy)
    cell_az = torch.atan2(ddy, ddx)
    # Far-edge range: for downward rays the in-cell minimum sits there.
    r_idx = torch.clamp(to_i32((dist + c["half_res"]) * c["inv_dr"]), 0, R - 1)
    d_cell = r_idx.to(torch.float32) * c["dr"]
    half_w = torch.atan2(
        torch.full_like(d_cell, c["az_half"]), torch.clamp_min(d_cell, c["d_min"])
    )
    w_bins = torch.clamp(to_i32(torch.ceil(half_w * c["inv_bin"] * 2.0)) + 1, 1, A // 2)
    lvl_cell = floor_i32(torch.log2(torch.clamp_min(w_bins, 1).to(torch.float32)))
    w_pow = torch.bitwise_left_shift(torch.ones_like(lvl_cell), lvl_cell)
    a_center = torch.clamp(
        floor_i32((cell_az + c["pi"]) * c["inv_2pi"] * c["a_f"]), 0, A - 1
    )
    a0 = torch.remainder(a_center - w_bins // 2, A)
    a1 = torch.remainder(a0 + w_bins - w_pow, A)
    in_range = (dist + c["half_res"]) <= c["r_max"]
    return a0, a1, r_idx, in_range


def resample_lookup_plain(
    field: torch.Tensor,
    lk: PolarLookup,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    window: Optional[Tuple] = None,
    two_reads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the main path's K4: ``lookup_indices``
    followed by ``resample_plain``; a batch frame by frame."""
    if field.dim() == 3:
        outs = [
            resample_lookup_plain(
                field[k], lk, position[k], sensor_origin[k],
                None if window is None else (window[0][k], window[1][k], *window[2:]),
                two_reads,
            )
            for k in range(field.shape[0])
        ]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    a0, a1, r_idx, in_range = lookup_indices(lk, position, sensor_origin, window)
    return resample_plain(field, a0, a1 if two_reads else None, r_idx, in_range)


def _check_lookup_inputs(field, lk, position, sensor_origin, window):
    lead = tuple(field.shape[:-2])
    if field.dtype != torch.float32 or field.dim() not in (2, 3) or (
        tuple(field.shape[-2:]) != (lk.R, lk.A)
    ):
        raise ValueError(
            f"field must be f32[{lk.R}, {lk.A}] or f32[K, {lk.R}, {lk.A}], "
            f"got {field.dtype} {tuple(field.shape)}"
        )
    if not field.is_contiguous():
        raise ValueError("field must be contiguous")
    for name, t, n in (("position", position, 2), ("sensor_origin", sensor_origin, 3)):
        if t.dtype != torch.float32 or tuple(t.shape) != lead + (n,) or (
            t.device != field.device
        ):
            raise ValueError(f"{name} must be f32[{n}] (f32[K, {n}] for K frames) "
                             "on the field's device")
    if window is None:
        return
    r0, c0, wr, wc = window
    for name, t in (("r0", r0), ("c0", c0)):
        if (
            not isinstance(t, torch.Tensor)
            or t.dtype != torch.int32
            or (tuple(t.shape) != lead if lead else t.numel() != 1)
            or t.device != field.device
        ):
            raise ValueError(f"window offset {name} must be an int32 scalar (int32[K] for "
                             "K frames) on the field's device")
    for name, n, most in (("wr", wr, lk.geom.rows), ("wc", wc, lk.geom.cols)):
        if not isinstance(n, int) or not 1 <= n <= most:
            raise ValueError(f"window extent {name}={n!r} outside 1..{most}")


def resample_lookup_cuda(
    field: torch.Tensor,
    lk: PolarLookup,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    window: Optional[Tuple] = None,
    two_reads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the main path's K4 on the current stream (one launch for a
    batch of frames); every tensor on one CUDA device."""
    global launches
    if field.device.type != "cuda":
        raise ValueError(f"K4 needs a CUDA tensor, got one on {field.device}")
    _check_lookup_inputs(field, lk, position, sensor_origin, window)
    lib = library()
    if window is None:
        r0 = c0 = None
        wr, wc = lk.geom.shape
    else:
        r0, c0, wr, wc = window
        r0, c0 = r0.contiguous(), c0.contiguous()
    params = lk.params(wr, wc, two_reads)
    lead = tuple(field.shape[:-2])
    batched = bool(lead)
    ray_min = torch.empty(lead + (wr, wc), dtype=torch.float32, device=field.device)
    touched = torch.empty(lead + (wr, wc), dtype=torch.bool, device=field.device)
    stream = torch.cuda.current_stream(field.device).cuda_stream
    err = lib.fastdem_resample_lookup(
        ctypes.c_void_p(field.data_ptr()),
        ctypes.c_void_p(position.data_ptr()),
        ctypes.c_void_p(sensor_origin.data_ptr()),
        ctypes.c_int(position.stride(-1)),
        ctypes.c_int(sensor_origin.stride(-1)),
        ctypes.c_int(position.stride(0) if batched else 0),
        ctypes.c_int(sensor_origin.stride(0) if batched else 0),
        ctypes.c_int(lead[0] if batched else 1),
        ctypes.c_void_p(r0.data_ptr() if r0 is not None else None),
        ctypes.c_void_p(c0.data_ptr() if c0 is not None else None),
        ctypes.byref(params),
        ctypes.c_void_p(ray_min.data_ptr()),
        ctypes.c_void_p(touched.data_ptr()),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"K4 launch failed: cudaError {err} "
            f"({lib.fastdem_cuda_error_string(err).decode()})"
        )
    launches += 1
    return ray_min, touched


def resample_lookup(
    field: torch.Tensor,
    lk: PolarLookup,
    position: torch.Tensor,
    sensor_origin: torch.Tensor,
    window: Optional[Tuple] = None,
    two_reads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The main path's K4 for a CUDA tensor, its plain twin for a CPU
    tensor."""
    if field.device.type == "cuda":
        return resample_lookup_cuda(field, lk, position, sensor_origin, window, two_reads)
    if field.device.type == "cpu":
        return resample_lookup_plain(field, lk, position, sensor_origin, window, two_reads)
    raise ValueError(f"no resample implementation for device {field.device}")
