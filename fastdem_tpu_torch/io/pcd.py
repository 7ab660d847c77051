"""PCD file IO (ascii + binary), KITTI .bin and trajectory formats (port of
``fastdem_tpu/io/pcd.py``, its pure-numpy reader and writer).

PCD v0.7 load / save with x/y/z plus intensity / rgb / normal / time /
ring / label channels, KITTI velodyne ``.bin`` (x, y, z, intensity
float32), and TUM / KITTI trajectory files. Host-side: a loaded cloud is
built on ``device`` (the card unless the caller names the CPU), and a
saved cloud is read from its device once.

With ``use_native`` (the default) binary and ascii PCD and KITTI files are
parsed, and binary PCD written, by the port's C++ library
(``fastdem_tpu_torch.native``); where it cannot be built, or does not parse
a file, the numpy reader and writer below run (the library warns when it is
unavailable). Both give the same bits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from fastdem_tpu_torch.cloud.pointcloud import PointCloud, from_numpy, host_arrays

_FIELD_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


DEFAULT_VIEWPOINT = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)  # tx ty tz qw qx qy qz


def load_pcd(
    path: str,
    capacity: Optional[int] = None,
    use_native: bool = True,
    return_meta: bool = False,
    *,
    device="cuda",
):
    """Load a PCD v0.7 file (ascii or binary) into a cloud on ``device``.

    With ``return_meta`` returns ``(cloud, meta)``, where meta carries the
    file's VIEWPOINT (tx ty tz qw qx qy qz).
    """
    if use_native:
        from fastdem_tpu_torch import native

        out = native.load_pcd(path)
        if out is not None:
            xyz, channels, viewpoint = out
            cloud = from_numpy(xyz, capacity=capacity, device=device, **channels)
            if return_meta:
                return cloud, {"viewpoint": viewpoint}
            return cloud
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        data_mode = None
        while True:
            raw_line = f.readline()
            if not raw_line:  # EOF before DATA: malformed / truncated header
                raise ValueError(f"not a PCD file (no DATA line): {path}")
            line = raw_line.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                if not vals:
                    raise ValueError(f"malformed PCD DATA line: {path}")
                data_mode = vals[0].lower()
                break
        try:
            fields = header["FIELDS"]
            sizes = [int(s) for s in header["SIZE"]]
            types = header["TYPE"]
            counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
            n = int(header["POINTS"][0])
        except (KeyError, IndexError) as e:
            raise ValueError(f"malformed PCD header ({e!r}): {path}") from None
        viewpoint = np.asarray(
            [float(v) for v in header.get(
                "VIEWPOINT", [str(v) for v in DEFAULT_VIEWPOINT]
            )],
            dtype=np.float64,
        )

        dtype_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _FIELD_DTYPES[(typ, size)]
            if cnt == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (cnt,)))
        rec = np.dtype(dtype_fields)

        if data_mode == "binary":
            raw = f.read(rec.itemsize * n)
            arr = np.frombuffer(raw, dtype=rec, count=n)
        elif data_mode == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            out = np.zeros(n, dtype=rec)
            col = 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                if cnt == 1:
                    out[name] = arr[:, col]
                else:
                    out[name] = arr[:, col : col + cnt]
                col += cnt
            arr = out
        else:
            raise ValueError(f"unsupported PCD DATA mode: {data_mode}")

    xyz = np.column_stack(
        [arr["x"], arr["y"], arr["z"]]
    ).astype(np.float32)
    channels: Dict[str, np.ndarray] = {}
    if "intensity" in fields:
        channels["intensity"] = arr["intensity"].astype(np.float32)
    if "rgb" in fields:
        # PCL packs rgb into 4 bytes; the field may be declared F (packed
        # float bits) or U (packed uint, nanoPCL's writer) — both hold the
        # same bit pattern in binary mode, but ascii/typed access differ.
        raw_rgb = arr["rgb"]
        if raw_rgb.dtype.kind == "f":
            bits = raw_rgb.astype(np.float32).view(np.uint32)
        else:
            bits = raw_rgb.astype(np.uint32)
        channels["color"] = np.stack(
            [(bits >> 16) & 0xFF, (bits >> 8) & 0xFF, bits & 0xFF], axis=-1
        ).astype(np.uint8)
    if all(k in fields for k in ("normal_x", "normal_y", "normal_z")):
        channels["normal"] = np.column_stack(
            [arr["normal_x"], arr["normal_y"], arr["normal_z"]]
        ).astype(np.float32)
    for name, ch in (("time", "time"), ("t", "time"), ("ring", "ring"),
                     ("label", "label")):
        if name in fields and ch not in channels:
            dt = np.float32 if ch == "time" else np.int32
            channels[ch] = arr[name].astype(dt)
    cloud = from_numpy(xyz, capacity=capacity, device=device, **channels)
    if return_meta:
        return cloud, {"viewpoint": viewpoint}
    return cloud


def _format_viewpoint(viewpoint) -> str:
    # `viewpoint or DEFAULT` would raise on numpy arrays (ambiguous truth
    # value) — and load_pcd(return_meta=True) returns exactly that type.
    if viewpoint is None or len(viewpoint) == 0:
        viewpoint = DEFAULT_VIEWPOINT
    vp = [float(v) for v in viewpoint]
    if len(vp) != 7:
        raise ValueError("viewpoint must be (tx ty tz qw qx qy qz)")
    return " ".join("%g" % v for v in vp)


def save_pcd(
    path: str,
    cloud: PointCloud,
    binary: bool = True,
    use_native: bool = True,
    viewpoint=None,
    ascii_precision: int = 8,
) -> bool:
    """Save the valid points of a cloud as PCD v0.7.

    The reference writer's conventions: ``viewpoint`` (tx ty tz qw qx qy
    qz) is kept in the header, rgb is a packed TYPE-U field, normals are
    normal_x/y/z, and ascii mode prints floats at ``ascii_precision`` with
    rgb as the packed integer.
    """
    xyz_all, keep, chans = host_arrays(cloud)
    xyz = np.asarray(xyz_all, dtype=np.float32)[keep]
    if binary and use_native:
        from fastdem_tpu_torch import native

        if native.available():
            pick = {name: np.asarray(chans[name])[keep] if name in chans else None
                    for name in ("intensity", "color", "normal")}
            return native.save_pcd(path, xyz, pick["intensity"], pick["color"],
                                   normal=pick["normal"], viewpoint=viewpoint)
    n = xyz.shape[0]
    fields = ["x", "y", "z"]
    sizes = ["4", "4", "4"]
    types = ["F", "F", "F"]
    counts = ["1", "1", "1"]
    fprec = f"%.{int(ascii_precision)}f"
    cols: List[np.ndarray] = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    fmts: List[str] = [fprec] * 3
    if "intensity" in chans:
        fields.append("intensity")
        sizes.append("4")
        types.append("F")
        counts.append("1")
        fmts.append(fprec)
        cols.append(np.asarray(chans["intensity"], np.float32)[keep])
    if "color" in chans:
        rgbu8 = np.asarray(chans["color"])[keep].astype(np.uint32)
        bits = (rgbu8[:, 0] << 16) | (rgbu8[:, 1] << 8) | rgbu8[:, 2]
        # TYPE U like nanoPCL's writer; ascii prints the packed integer.
        fields.append("rgb")
        sizes.append("4")
        types.append("U")
        counts.append("1")
        fmts.append("%d")
        cols.append(bits)
    if "normal" in chans:
        nm = np.asarray(chans["normal"], np.float32)[keep]
        for i, name in enumerate(("normal_x", "normal_y", "normal_z")):
            fields.append(name)
            sizes.append("4")
            types.append("F")
            counts.append("1")
            fmts.append(fprec)
            cols.append(nm[:, i])

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(sizes)}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(counts)}\n"
        f"WIDTH {n}\nHEIGHT 1\n"
        f"VIEWPOINT {_format_viewpoint(viewpoint)}\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    try:
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            if binary:
                # Interleave raw 4-byte records (u32 rgb stays u32).
                rec = np.zeros(
                    n,
                    dtype=np.dtype(
                        [(name, c.dtype) for name, c in zip(fields, cols)]
                    ),
                )
                for name, c in zip(fields, cols):
                    rec[name] = c
                f.write(rec.tobytes())
            else:
                np.savetxt(f, np.column_stack(
                    [c.astype(np.float64) for c in cols]
                ), fmt=fmts)
    except OSError:
        return False
    return True


def load_kitti_bin(
    path: str, capacity: Optional[int] = None, use_native: bool = True, *, device="cuda"
) -> PointCloud:
    """KITTI velodyne .bin: N x (x, y, z, intensity) float32."""
    if use_native:
        from fastdem_tpu_torch import native

        out = native.load_kitti(path)
        if out is not None:
            xyz, channels = out
            return from_numpy(xyz, capacity=capacity, device=device, **channels)
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return from_numpy(
        raw[:, :3], capacity=capacity, device=device, intensity=raw[:, 3].copy()
    )


def save_kitti_bin(path: str, cloud: PointCloud) -> bool:
    xyz_all, keep, chans = host_arrays(cloud)
    xyz = np.asarray(xyz_all, np.float32)[keep]
    inten = (
        np.asarray(chans["intensity"], np.float32)[keep]
        if "intensity" in chans
        else np.zeros(xyz.shape[0], np.float32)
    )
    try:
        np.column_stack([xyz, inten]).astype(np.float32).tofile(path)
    except OSError:
        return False
    return True


# --- Trajectory IO -----------------------------------------------------------


def load_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format: t x y z qx qy qz qw per line.
    Returns (timestamps f64[N], poses f32[N, 4, 4])."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    ts = data[:, 0]
    poses = np.zeros((len(ts), 4, 4), dtype=np.float32)
    for i, row in enumerate(data):
        x, y, z, qx, qy, qz, qw = row[1:8]
        poses[i] = _pose_from_quat(x, y, z, qw, qx, qy, qz)
    return ts, poses


def load_trajectory(path: str):
    """Auto-detecting trajectory loader: TUM lines have 8 columns
    (t x y z qx qy qz qw), KITTI has 12 (3x4 row-major, no timestamps).
    Returns (times_s | None, poses f32[N, 4, 4])."""
    with open(path) as f:
        first = ""
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                first = line
                break
    if len(first.split()) == 12:
        return None, load_trajectory_kitti(path)
    return load_trajectory_tum(path)


def load_trajectory_kitti(path: str) -> np.ndarray:
    """KITTI format: 12 floats per line (3x4 row-major). -> f32[N, 4, 4]."""
    data = np.loadtxt(path, ndmin=2)
    n = data.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :] = data[:, :12].reshape(n, 3, 4)
    return poses


def save_trajectory_tum(path: str, timestamps, poses) -> bool:
    rows = []
    for t, T in zip(timestamps, poses):
        q = _quat_from_pose(np.asarray(T))
        x, y, z = T[0, 3], T[1, 3], T[2, 3]
        rows.append([t, x, y, z, q[1], q[2], q[3], q[0]])
    try:
        np.savetxt(path, np.asarray(rows), fmt="%.9f")
    except OSError:
        return False
    return True


def save_trajectory_kitti(path: str, poses) -> bool:
    """KITTI format: 12 floats per line (3x4 row-major), no timestamps."""
    rows = [np.asarray(T, dtype=np.float64)[:3, :].reshape(12) for T in poses]
    try:
        np.savetxt(path, np.asarray(rows), fmt="%.9f")
    except OSError:
        return False
    return True


def _pose_from_quat(x, y, z, qw, qx, qy, qz):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )
    T[:3, 3] = (x, y, z)
    return T


def _quat_from_pose(T):
    R = T[:3, :3]
    tr = np.trace(R)
    qw = np.sqrt(max(0.0, 1 + tr)) / 2
    qx = np.sqrt(max(0.0, 1 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    qy = np.sqrt(max(0.0, 1 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    qz = np.sqrt(max(0.0, 1 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    qx = np.copysign(qx, R[2, 1] - R[1, 2])
    qy = np.copysign(qy, R[0, 2] - R[2, 0])
    qz = np.copysign(qz, R[1, 0] - R[0, 1])
    return np.array([qw, qx, qy, qz])
