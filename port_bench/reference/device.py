"""Device selection: every entry point of the port names its device.

A request for CUDA on a machine without it raises; the port never carries
on on the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, checked to exist.
    A CUDA device gets its index (the current one when none is named), so
    it compares equal to the device of the tensors made on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but CUDA is not available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

