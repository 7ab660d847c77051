"""Float32 arithmetic that gives the same bits on the CPU and on CUDA.

The reference's compiler rewrites ``x / c`` for a constant c as a
multiplication by the float32 reciprocal, contracts some ``a * b + c`` into
fused multiply-adds, and rounds ``sqrt`` correctly. PyTorch's CPU float32
``sqrt`` is not always correctly rounded, PyTorch on CUDA divides by a
Python scalar through its reciprocal, and two separate ops never fuse. The
helpers below pin one rounding on every device; the port uses them where a
last-bit difference can move a point or a ray across a bin boundary.
"""

from __future__ import annotations

import torch


def recip_f32(c: float) -> float:
    """The float32 reciprocal of the float32 constant ``c``, as a Python
    float: ``x * recip_f32(c)`` is the reference's ``x / c``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(c, dtype=torch.float32))


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


def sum_sq3(v: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 of f32[..., 3], accumulated as the reference does:
    fma(z, z, fma(y, y, x * x))."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return fma_f32(z, z, fma_f32(y, y, x * x))
