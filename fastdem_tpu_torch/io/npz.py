"""Lossless map checkpoints as reference-compatible .npz archives (port of
``fastdem_tpu/io/npz.py``).

The reference's schema: an uncompressed zip of one Fortran-order float32
``<layer>.npy`` per layer plus ``meta.npy``, a ``|S`` scalar holding JSON
metadata {version, resolution, position, frame_id, size, start_index}.
Members are sorted, STORE mode, fixed timestamps and no ZIP64, so the
same map gives the same bytes from either package, and files written by
one load in the other (and in plain ``numpy.load``). Every internal
estimator layer round-trips, so save / load is a complete checkpoint of a
mapping session. Layouts are world-aligned: ``start_index`` is written as
[0, 0], and a nonzero one read from a reference file is unrolled.
"""

from __future__ import annotations

import io as _io
import json
import logging
import zipfile
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.interop import host_state, state_from_numpy

METADATA_VERSION = 1

log = logging.getLogger("fastdem_tpu_torch.io")


def zip_member_info(name: str) -> zipfile.ZipInfo:
    """Deterministic STORE-mode member header (fixed mtime): byte-identical
    output for identical maps."""
    zi = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
    zi.compress_type = zipfile.ZIP_STORED
    zi.external_attr = 0o600 << 16
    return zi


def save_npz(
    path: str,
    geom: GridGeometry,
    state,
    layer_names: Optional[Iterable[str]] = None,
    frame_id: str = "map",
) -> bool:
    """Write the map (every layer, or ``layer_names``) to ``path``; False
    on an IO error."""
    names = sorted(layer_names) if layer_names is not None else sorted(state.layers)
    for name in names:
        if name not in state.layers:
            log.warning("[npz_io] Layer '%s' does not exist, skipping", name)
    layers, position = host_state(state, names)
    pos = np.asarray(position, dtype=np.float64)
    meta = {
        "version": METADATA_VERSION,
        "resolution": geom.resolution,
        "position": [float(pos[0]), float(pos[1])],
        "frame_id": frame_id,
        "size": [geom.rows, geom.cols],
        "start_index": [0, 0],
    }
    arrays: Dict[str, np.ndarray] = {
        name: np.asfortranarray(np.asarray(layers[name], dtype=np.float32))
        for name in names
        if name in layers
    }
    meta_bytes = np.bytes_(json.dumps(meta).encode())
    try:
        # Members are materialised first and written with writestr, so the
        # local headers carry real 32-bit sizes (the reference's ZIP parser
        # rejects numpy.savez's ZIP64 streaming headers).
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=False) as zf:
            for name, arr in {**arrays, "meta": np.array(meta_bytes)}.items():
                buf = _io.BytesIO()
                np.lib.format.write_array(buf, np.asanyarray(arr), allow_pickle=False)
                zf.writestr(zip_member_info(name + ".npy"), buf.getvalue())
    except (OSError, zipfile.LargeZipFile):
        # A >= 4 GiB member would need ZIP64: fail soft like other IO errors.
        return False
    return True


def load_npz(path: str, *, device="cuda") -> Tuple[GridGeometry, object, Dict]:
    """(geom, GridMapState on ``device``, metadata dict). Raises ValueError
    on schema violations (missing meta, a newer metadata version, a layer
    of the wrong shape)."""
    with np.load(path, allow_pickle=False) as data:
        if "meta" not in data:
            raise ValueError(f"{path}: missing meta.npy")
        meta_raw = data["meta"]
        meta = json.loads(
            bytes(meta_raw.item() if meta_raw.shape == () else meta_raw.tobytes()).decode()
        )
        version = int(meta.get("version", -1))
        if version > METADATA_VERSION:
            raise ValueError(
                f"{path}: unsupported metadata version {version} "
                f"(supported <= {METADATA_VERSION})"
            )
        rows, cols = (int(v) for v in meta["size"])
        start = tuple(int(v) for v in meta.get("start_index", (0, 0)))
        geom = GridGeometry(rows=rows, cols=cols, resolution=float(meta["resolution"]))
        layers: Dict[str, np.ndarray] = {}
        for name in data.files:
            if name == "meta":
                continue
            arr = np.asarray(data[name], dtype=np.float32)
            if arr.shape != (rows, cols):
                raise ValueError(
                    f"{path}: layer '{name}' shape {arr.shape} != map size "
                    f"({rows}, {cols})"
                )
            if start != (0, 0):
                # Unroll the reference's circular buffer to world-aligned.
                arr = np.roll(arr, shift=(-start[0], -start[1]), axis=(0, 1))
            layers[name] = np.ascontiguousarray(arr)
    state = state_from_numpy(
        layers, np.asarray(meta["position"], dtype=np.float32), device=device
    )
    return geom, state, meta
