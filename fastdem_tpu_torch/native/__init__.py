"""Native (C++) scan IO of the port, loaded through ctypes.

``src/pcdio.cpp`` (PCD and KITTI ``.bin`` parsing, binary PCD writing) and
``src/scanstream.cpp`` (a worker pool that parses scan files ahead of the
consumer, in file order, padded to a fixed capacity) are the reference
package's sources, copied (the code unchanged; two comments cite the C++
reference's headers by their place in its tree). On first use they are
compiled with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into
``fastdem_tpu_torch/native/_build/libfastdem_io.so`` (or the directory
``set_build_dir`` names; rebuilt when a source is newer) and bound through
their plain-C ABI.

Without a toolchain the library is unavailable: ``available()`` says so,
the loaders return None, and ``ScanStream`` parses in Python; each of these
fallbacks logs a warning. Callers that must not fall back (the replay
tool's ``--prefetch``) check ``available()`` and raise.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

log = logging.getLogger("fastdem_tpu_torch.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_HERE, "src", "pcdio.cpp"),
    os.path.join(_HERE, "src", "scanstream.cpp"),
]
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB = os.path.join(_BUILD_DIR, "libfastdem_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# Why the library is unavailable (None while it is, or before a try).
build_error: Optional[str] = None
# Wall seconds of the g++ build this process made (None: found built, or
# not tried).
build_seconds: Optional[float] = None


class _CloudBuffers(ctypes.Structure):
    _fields_ = [
        ("xyz", ctypes.POINTER(ctypes.c_float)),
        ("intensity", ctypes.POINTER(ctypes.c_float)),
        ("rgb", ctypes.POINTER(ctypes.c_uint8)),
        ("time", ctypes.POINTER(ctypes.c_float)),
        ("ring", ctypes.POINTER(ctypes.c_int32)),
        ("normal", ctypes.POINTER(ctypes.c_float)),
        ("n", ctypes.c_int64),
        ("error", ctypes.c_int32),
        ("viewpoint", ctypes.c_float * 7),
    ]


def set_build_dir(path: str) -> None:
    """Build into and load from ``path`` from now on (a program-cache
    bundle, ``runtime.aotcache``). A library already loaded stays loaded:
    the call then only warns."""
    global _BUILD_DIR, _LIB
    _BUILD_DIR = os.path.abspath(path)
    _LIB = os.path.join(_BUILD_DIR, "libfastdem_io.so")
    if _tried:
        log.warning("native scan IO is already loaded; %s takes effect in a new process", path)


def _build() -> Optional[str]:
    global build_error, build_seconds
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        src_mtime = max(os.path.getmtime(s) for s in _SRCS)
        if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= src_mtime:
            return _LIB
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *_SRCS, "-o", tmp, "-pthread"]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, _LIB)  # atomic: a concurrent build never sees a partial file
        return _LIB
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None)
        build_error = f"{e}" + (f": {detail.decode(errors='replace')[-400:]}" if detail else "")
        log.warning("native scan IO unavailable (%s); parsing scans in Python", build_error)
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.fastdem_load_pcd.argtypes = [ctypes.c_char_p, ctypes.POINTER(_CloudBuffers)]
        lib.fastdem_load_kitti.argtypes = [ctypes.c_char_p, ctypes.POINTER(_CloudBuffers)]
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.fastdem_save_pcd.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, fptr, fptr, ctypes.POINTER(ctypes.c_uint8),
            fptr, fptr,
        ]
        lib.fastdem_save_pcd.restype = ctypes.c_int32
        lib.fastdem_free_cloud.argtypes = [ctypes.POINTER(_CloudBuffers)]
        lib.fastdem_stream_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.fastdem_stream_open.restype = ctypes.c_void_p
        lib.fastdem_stream_next.argtypes = [
            ctypes.c_void_p, fptr, ctypes.POINTER(ctypes.c_uint8), fptr,
        ]
        lib.fastdem_stream_next.restype = ctypes.c_int64
        lib.fastdem_stream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (builds it on the
    first call)."""
    return _get() is not None


def _copy_out(buf: _CloudBuffers):
    n = buf.n
    out = {}
    xyz = np.ctypeslib.as_array(buf.xyz, shape=(n, 3)).copy()
    if buf.intensity:
        out["intensity"] = np.ctypeslib.as_array(buf.intensity, shape=(n,)).copy()
    if buf.rgb:
        out["color"] = np.ctypeslib.as_array(buf.rgb, shape=(n, 3)).copy()
    if buf.time:
        out["time"] = np.ctypeslib.as_array(buf.time, shape=(n,)).copy()
    if buf.ring:
        out["ring"] = np.ctypeslib.as_array(buf.ring, shape=(n,)).copy()
    if buf.normal:
        out["normal"] = np.ctypeslib.as_array(buf.normal, shape=(n, 3)).copy()
    return xyz, out


def load_pcd(path: str):
    """Returns (xyz f32[N, 3], channels dict, viewpoint f64[7]), or None
    when the library is unavailable or the file does not parse."""
    lib = _get()
    if lib is None:
        return None
    buf = _CloudBuffers()
    lib.fastdem_load_pcd(path.encode(), ctypes.byref(buf))
    if buf.error != 0 or buf.n < 0:
        lib.fastdem_free_cloud(ctypes.byref(buf))
        return None
    try:
        vp = np.asarray(list(buf.viewpoint), dtype=np.float64)
        if buf.n == 0:
            return np.zeros((0, 3), np.float32), {}, vp
        xyz, out = _copy_out(buf)
        return xyz, out, vp
    finally:
        lib.fastdem_free_cloud(ctypes.byref(buf))


def load_kitti(path: str):
    """Returns (xyz f32[N, 3], {"intensity": f32[N]}), or None."""
    lib = _get()
    if lib is None:
        return None
    buf = _CloudBuffers()
    lib.fastdem_load_kitti(path.encode(), ctypes.byref(buf))
    if buf.error != 0:
        lib.fastdem_free_cloud(ctypes.byref(buf))
        return None
    try:
        return _copy_out(buf)
    finally:
        lib.fastdem_free_cloud(ctypes.byref(buf))


def save_pcd(path: str, xyz: np.ndarray, intensity=None, rgb=None, normal=None,
             viewpoint=None) -> bool:
    """Binary PCD writer; False when the library is unavailable or the
    write fails."""
    lib = _get()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    # Keep the temporaries alive through the call.
    arrays = [
        None if a is None else np.ascontiguousarray(a, dtype=dt)
        for a, dt in ((intensity, np.float32), (rgb, np.uint8), (normal, np.float32),
                      (viewpoint, np.float32))
    ]
    fptr = ctypes.POINTER(ctypes.c_float)
    bptr = ctypes.POINTER(ctypes.c_uint8)
    ptrs = [
        a.ctypes.data_as(p) if a is not None else p()
        for a, p in zip(arrays, (fptr, bptr, fptr, fptr))
    ]
    rc = lib.fastdem_save_pcd(path.encode(), xyz.shape[0], xyz.ctypes.data_as(fptr), *ptrs)
    return rc == 0


class ScanStream:
    """Prefetching scan loader: a native worker pool parses .pcd / .bin files
    ahead of the consumer and yields (xyz f32[cap, 3], mask bool[cap],
    intensity f32[cap] | None) IN FILE ORDER, padded to a fixed capacity
    (the point-cloud padding convention: invalid rows masked and at 1e9).
    A file with more points keeps its first ``capacity`` points.

    Without the library it parses sequentially in Python (same interface,
    truncation and padding) and warns. A file that fails to parse yields an
    all-masked frame and is counted in ``errors``.
    """

    def __init__(self, paths, capacity: int, threads: int = 4, ring: int = 8,
                 with_intensity: bool = False):
        self.paths = [str(p) for p in paths]
        self.capacity = int(capacity)
        self.with_intensity = with_intensity
        self.errors = 0
        self._i = 0
        self._handle = None
        self._lib = _get()
        if self._lib is None:
            log.warning("[ScanStream] native library unavailable; parsing in Python")
        elif self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._paths_keepalive = arr
            self._handle = self._lib.fastdem_stream_open(
                arr, len(self.paths), self.capacity, threads, ring)

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self.paths):
            raise StopIteration
        self._i += 1
        cap = self.capacity
        if self._handle:
            xyz = np.empty((cap, 3), np.float32)
            mask = np.empty(cap, np.uint8)
            inten = np.empty(cap, np.float32) if self.with_intensity else None
            fptr = ctypes.POINTER(ctypes.c_float)
            n = self._lib.fastdem_stream_next(
                self._handle, xyz.ctypes.data_as(fptr),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                inten.ctypes.data_as(fptr) if inten is not None else fptr(),
            )
            if n == -1:
                raise StopIteration
            if n == -2:
                self.errors += 1
                log.warning("[ScanStream] failed to parse '%s'; empty frame",
                            self.paths[self._i - 1])
            return xyz, mask.astype(bool), inten
        # Python parsing: the same window (the first `cap` points in file
        # order), non-finite points masked in place.
        path = self.paths[self._i - 1]
        xyz = np.full((cap, 3), 1e9, np.float32)
        mask = np.zeros(cap, bool)
        inten = np.zeros(cap, np.float32) if self.with_intensity else None
        try:
            from fastdem_tpu_torch.io import pcd as pcd_io

            cloud = (pcd_io.load_kitti_bin(path, use_native=False, device="cpu")
                     if path.endswith(".bin")
                     else pcd_io.load_pcd(path, use_native=False, device="cpu"))
            n = min(cloud.capacity, cap)
            xyz[:n] = cloud.xyz[:n].numpy()
            mask[:n] = cloud.mask[:n].numpy()
            if inten is not None and cloud.has("intensity"):
                inten[:n] = cloud.channels["intensity"][:n].numpy()
        except (OSError, ValueError) as e:
            self.errors += 1
            log.warning("[ScanStream] failed to parse '%s': %s", path, e)
        return xyz, mask, inten

    def close(self):
        if self._handle and self._lib is not None:
            self._lib.fastdem_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
