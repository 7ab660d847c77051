"""Float32 arithmetic that gives the same bits on the CPU and on CUDA.

The reference's compiler rewrites ``x / c`` for a constant c as a
multiplication by the float32 reciprocal, contracts some ``a * b + c`` into
fused multiply-adds, and rounds ``sqrt`` correctly. PyTorch's CPU float32
``sqrt`` is not always correctly rounded, PyTorch on CUDA divides by a
Python scalar through its reciprocal, and two separate ops never fuse. The
helpers below pin one rounding on every device; the port uses them where a
last-bit difference can move a point or a ray across a bin boundary.

Outside a compiled step (the reference's eager paths: the filters, the
batch DEM) ``x / c`` is a true division, which ``div_f32`` gives on every
device, and a sum along a short axis adds its terms left to right
(``sum_seq``).
"""

from __future__ import annotations

import numpy as np
import torch


def recip_f32(c: float) -> float:
    """The float32 reciprocal of the float32 constant ``c``, as a Python
    float: ``x * recip_f32(c)`` is the reference's ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, which is
    exact for sqrt: 53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c with one rounding to float32 (the product is exact in
    float64; the sum rounds in float64, then to float32). ``b`` and ``c``
    may be Python floats holding float32 values."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def sum_sq(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum of squares along ``dim``, accumulated as the reference's compiled
    reductions do: v0 * v0, then one FMA per further term (for xyz:
    fma(z, z, fma(y, y, x * x)))."""
    acc = v.select(dim, 0) * v.select(dim, 0)
    for i in range(1, v.shape[dim]):
        acc = fma_f32(v.select(dim, i), v.select(dim, i), acc)
    return acc


def div_f32(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with one float32 rounding on every device. ``c`` goes in as a
    0-dim tensor on x's device: CUDA divides by a Python scalar through its
    reciprocal, but divides tensors exactly. ``torch.full`` makes it on the
    device, so the division holds no host-to-device copy."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


