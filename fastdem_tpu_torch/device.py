"""Device selection: every entry point of the port names its device.

A request for CUDA on a machine without it raises; the port never carries
on on the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, checked to exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but CUDA is not available"
        )
    return dev

