"""Colormapped RGBA PNG export of map layers (port of
``fastdem_tpu/io/png.py``).

The reference exporter's normalisation modes (MIN_MAX, PERCENTILE_1_99,
FIXED_RANGE) and colormaps (8-anchor viridis, jet, grayscale), NaN ->
alpha 0, with a dependency-free PNG encoder (zlib + struct). Numpy on the
host: the layer is read from its device once (``interop.host_state``).
"""

from __future__ import annotations

import enum
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from fastdem_tpu_torch.interop import host_state


class Normalize(enum.Enum):
    MIN_MAX = "min_max"
    PERCENTILE_1_99 = "percentile_1_99"
    FIXED_RANGE = "fixed_range"


class Colormap(enum.Enum):
    VIRIDIS = "viridis"
    JET = "jet"
    GRAYSCALE = "grayscale"


@dataclass
class PngExportConfig:
    # Defaults are the reference's PngExportConfig's.
    normalize: Normalize = Normalize.PERCENTILE_1_99
    colormap: Colormap = Colormap.VIRIDIS
    fixed_min: float = -2.0
    fixed_max: float = 2.0


# 8-anchor viridis LUT (the reference's)
_VIRIDIS = np.array(
    [
        [0.267, 0.005, 0.329],
        [0.283, 0.141, 0.458],
        [0.254, 0.265, 0.530],
        [0.207, 0.372, 0.553],
        [0.164, 0.471, 0.558],
        [0.128, 0.567, 0.551],
        [0.267, 0.679, 0.481],
        [0.993, 0.906, 0.144],
    ],
    dtype=np.float32,
)


def _compute_range(values: np.ndarray, cfg: PngExportConfig):
    if cfg.normalize == Normalize.FIXED_RANGE:
        return cfg.fixed_min, cfg.fixed_max
    finite = values[np.isfinite(values)]
    if finite.size == 0:
        return 0.0, 1.0
    if cfg.normalize == Normalize.MIN_MAX:
        return float(finite.min()), float(finite.max())
    # PERCENTILE_1_99 via partial selection: indices floor(n*0.01) and
    # min(floor(n*0.99), n-1), as the reference.
    n = finite.size
    i1 = int(n * 0.01)
    i99 = min(int(n * 0.99), n - 1)
    part = np.partition(finite, [i1, i99])
    return float(part[i1]), float(part[i99])


def _apply_colormap(t: np.ndarray, cmap: Colormap) -> np.ndarray:
    """t in [0,1] -> u8 rgb [..., 3]."""
    t = np.clip(t, 0.0, 1.0)
    if cmap == Colormap.GRAYSCALE:
        g = (t * 255 + 0.5).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    if cmap == Colormap.JET:
        r = np.zeros_like(t)
        g = np.zeros_like(t)
        b = np.zeros_like(t)
        m1, m2, m3 = t < 0.25, (t >= 0.25) & (t < 0.5), (t >= 0.5) & (t < 0.75)
        m4 = t >= 0.75
        g = np.where(m1, 4 * t, g)
        b = np.where(m1, 1.0, b)
        g = np.where(m2, 1.0, g)
        b = np.where(m2, 1 - 4 * (t - 0.25), b)
        r = np.where(m3, 4 * (t - 0.5), r)
        g = np.where(m3, 1.0, g)
        r = np.where(m4, 1.0, r)
        g = np.where(m4, 1 - 4 * (t - 0.75), g)
        return (np.stack([r, g, b], axis=-1) * 255 + 0.5).astype(np.uint8)
    # viridis: linear interpolation between the 8 anchors.
    idx = t * 7.0
    i0 = np.clip(idx.astype(np.int32), 0, 7)
    i1 = np.minimum(i0 + 1, 7)
    frac = (idx - i0)[..., None]
    rgb = _VIRIDIS[i0] * (1 - frac) + _VIRIDIS[i1] * frac
    return (rgb * 255 + 0.5).astype(np.uint8)


def encode_png(rgba: np.ndarray) -> bytes:
    """Minimal RGBA8 PNG encoder."""
    h, w, c = rgba.shape
    assert c == 4 and rgba.dtype == np.uint8
    raw = b"".join(
        b"\x00" + rgba[row].tobytes() for row in range(h)
    )
    compressed = zlib.compress(raw, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )


def layer_to_rgba(
    layer: np.ndarray, cfg: PngExportConfig | None = None
) -> np.ndarray:
    cfg = cfg or PngExportConfig()
    vmin, vmax = _compute_range(layer, cfg)
    rng = vmax - vmin
    if rng < 1e-6:
        rng = 1.0
    t = (layer - vmin) / rng
    finite = np.isfinite(layer)
    rgb = _apply_colormap(np.where(finite, t, 0.0), cfg.colormap)
    # NaN pixels carry rgb=0 under alpha=0, like the reference, so decoded
    # RGBA is pixel-identical to the reference renderer's.
    rgb = np.where(finite[..., None], rgb, 0).astype(np.uint8)
    alpha = np.where(finite, 255, 0).astype(np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def save_png(
    path: str, state, layer_name: str, cfg: PngExportConfig | None = None
) -> bool:
    if layer_name not in state.layers:
        import logging

        logging.getLogger("fastdem_tpu_torch.io").error(
            "[png_io] Layer '%s' does not exist", layer_name
        )
        return False
    layer = host_state(state, [layer_name])[0][layer_name]
    rgba = layer_to_rgba(layer, cfg)
    try:
        with open(path, "wb") as f:
            f.write(encode_png(rgba))
    except OSError:
        return False
    return True
