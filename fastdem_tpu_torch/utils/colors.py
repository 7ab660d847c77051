"""Packed-float RGB helpers (port of ``fastdem_tpu/utils/colors.py``).

A color layer packs an RGB triple into the bit pattern of a float32:
value = bitcast(r << 16 | g << 8 | b). Both helpers take a torch tensor (and
answer on its device) or a numpy array (and answer in numpy), so the
device step and the host-side IO share one definition.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_rgb(rgb):
    """u8[..., 3] -> f32[...] bit-packed color value."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.to(torch.int32)
        bits = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
        return bits.contiguous().view(torch.float32)
    rgb = np.asarray(rgb).astype(np.uint32)
    bits = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    return np.ascontiguousarray(bits).view(np.float32)


def unpack_rgb(value):
    """f32[...] -> u8[..., 3]."""
    if isinstance(value, torch.Tensor):
        bits = value.to(torch.float32).contiguous().view(torch.int32)
        out = torch.stack([(bits >> 16) & 0xFF, (bits >> 8) & 0xFF, bits & 0xFF], dim=-1)
        return out.to(torch.uint8)
    bits = np.ascontiguousarray(np.asarray(value, dtype=np.float32)).view(np.uint32)
    out = np.stack([(bits >> 16) & 0xFF, (bits >> 8) & 0xFF, bits & 0xFF], axis=-1)
    return out.astype(np.uint8)
