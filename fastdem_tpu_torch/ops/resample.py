"""K4, the per-cell lookup of the polar ray field: CUDA kernel wrapper and
plain twin.

Replaces the Pallas TPU kernel
``fastdem_tpu/ops/pallas_resample.py::_resample_kernel``
(``out = min(field[a0, r], field[a1, r])``) and fuses the epilogue the
reference runs after it. From the smeared field f32[R, A] (the port's
layout, the transpose of the TPU kernel's [A, R]) and per-cell int32
``a0``, optional ``a1`` and ``r_idx`` and bool ``in_range`` (all [h, w],
the whole map or a window) it returns

  ray_min f32[h, w]: the field's min over the cell's one or two reads,
                     NaN where the cell is not touched;
  touched bool[h, w] = isfinite(min) & in_range.

``resample`` launches the kernel (``csrc/resample.cu``) for a CUDA tensor
and runs ``resample_plain`` for a CPU tensor; a build or launch failure
raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from fastdem_tpu_torch.ops import cuda_build

# Kernel launches since import (or since the caller last reset it).
launches = 0

SOURCE = cuda_build.CSRC / "resample.cu"

_lib = None


def library():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fastdem_resample.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp, vp, vp]
    lib.fastdem_resample.restype = ci
    lib.fastdem_cuda_error_string.argtypes = [ci]
    lib.fastdem_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_inputs(field, a0, a1, r_idx, in_range):
    if field.dtype != torch.float32 or field.dim() != 2 or not field.is_contiguous():
        raise ValueError(
            f"field must be contiguous f32[R, A], got {field.dtype} {tuple(field.shape)}"
        )
    shape = tuple(a0.shape)
    named = [("a0", a0, torch.int32), ("r_idx", r_idx, torch.int32),
             ("in_range", in_range, torch.bool)]
    if a1 is not None:
        named.append(("a1", a1, torch.int32))
    for name, t, dtype in named:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype}{list(shape)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != field.device:
            raise ValueError(f"{name} is on {t.device}, the field on {field.device}")


def resample_cuda(
    field: torch.Tensor,
    a0: torch.Tensor,
    a1: Optional[torch.Tensor],
    r_idx: torch.Tensor,
    in_range: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on the current stream; every tensor on one CUDA device."""
    global launches
    if field.device.type != "cuda":
        raise ValueError(f"K4 needs a CUDA tensor, got one on {field.device}")
    _check_inputs(field, a0, a1, r_idx, in_range)
    lib = library()
    a0, r_idx, in_range = a0.contiguous(), r_idx.contiguous(), in_range.contiguous()
    a1 = a1.contiguous() if a1 is not None else None
    ray_min = torch.empty(a0.shape, dtype=torch.float32, device=field.device)
    touched = torch.empty(a0.shape, dtype=torch.bool, device=field.device)
    stream = torch.cuda.current_stream(field.device).cuda_stream
    err = lib.fastdem_resample(
        ctypes.c_void_p(field.data_ptr()),
        ctypes.c_void_p(a0.data_ptr()),
        ctypes.c_void_p(a1.data_ptr() if a1 is not None else None),
        ctypes.c_void_p(r_idx.data_ptr()),
        ctypes.c_void_p(in_range.data_ptr()),
        ctypes.c_int(field.shape[1]),
        ctypes.c_int(a0.numel()),
        ctypes.c_void_p(ray_min.data_ptr()),
        ctypes.c_void_p(touched.data_ptr()),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"K4 launch failed: cudaError {err} "
            f"({lib.fastdem_cuda_error_string(err).decode()})"
        )
    if a0.numel():
        launches += 1
    return ray_min, touched


def resample_plain(
    field: torch.Tensor,
    a0: torch.Tensor,
    a1: Optional[torch.Tensor],
    r_idx: torch.Tensor,
    in_range: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4."""
    A = field.shape[1]
    flat = field.reshape(-1)
    base = r_idx.long() * A
    h = flat[base + a0.long()]
    if a1 is not None:
        h = torch.minimum(h, flat[base + a1.long()])
    touched = torch.isfinite(h) & in_range
    return torch.where(touched, h, float("nan")), touched


def resample(
    field: torch.Tensor,
    a0: torch.Tensor,
    a1: Optional[torch.Tensor],
    r_idx: torch.Tensor,
    in_range: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 for a CUDA tensor, the plain twin for a CPU tensor."""
    if field.device.type == "cuda":
        return resample_cuda(field, a0, a1, r_idx, in_range)
    if field.device.type == "cpu":
        return resample_plain(field, a0, a1, r_idx, in_range)
    raise ValueError(f"no resample implementation for device {field.device}")
