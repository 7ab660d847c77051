"""ROS wire codecs (port of ``fastdem_tpu/runtime/wire.py``): the bytes of
``sensor_msgs/PointCloud2`` and ``grid_map_msgs/GridMap`` payloads, no ROS
runtime required.

  * ``map_to_pointcloud2``: the reference's field table and byte layout:
    x, y, z, every non-internal layer as FLOAT32, color as a packed-float
    ``rgb`` field; column-major cell order, one record per
    finite-elevation cell.
  * ``cloud_to_pointcloud2`` / ``pointcloud2_to_cloud``: the point-cloud
    library's conventions: x/y/z [intensity f32] [ring u16] [time f32]
    [rgb f32] [label u32] [normal_xyz f32]; the reader takes those fields
    at any offsets with the same datatype conversions.
  * ``map_to_gridmap_msg``: the public ``grid_map_msgs/GridMap``
    structure (info plus one Float32MultiArray per non-internal layer,
    column-major data).

A ``PointCloud2`` here is the message content: the field table plus the
little-endian ``data`` buffer. Host numpy: maps and clouds are read from
their device once per call; decoded clouds are built on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from fastdem_tpu_torch.cloud.pointcloud import from_numpy, host_arrays
from fastdem_tpu_torch.grid import gridmap as gm
from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.grid.gridmap import layers
from fastdem_tpu_torch.interop import host_state
from fastdem_tpu_torch.utils.colors import pack_rgb, unpack_rgb


# sensor_msgs/PointField datatype constants (identical in ROS1/ROS2).
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

_NP_DTYPE = {
    INT8: np.int8,
    UINT8: np.uint8,
    INT16: np.int16,
    UINT16: np.uint16,
    INT32: np.int32,
    UINT32: np.uint32,
    FLOAT32: np.float32,
    FLOAT64: np.float64,
}


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int = 1


@dataclasses.dataclass
class PointCloud2:
    """sensor_msgs/PointCloud2 content (transport-invariant part)."""

    frame_id: str
    stamp_ns: int
    height: int
    width: int
    fields: List[PointField]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool


def _np_fields(fields: List[PointField], point_step: int) -> np.dtype:
    """Structured numpy dtype over one point record. Multi-element fields
    (count > 1) become subarrays, matching the wire layout."""
    return np.dtype(
        {
            "names": [f.name for f in fields],
            "formats": [
                _NP_DTYPE[f.datatype]
                if getattr(f, "count", 1) in (0, 1)
                else (_NP_DTYPE[f.datatype], (f.count,))
                for f in fields
            ],
            "offsets": [f.offset for f in fields],
            "itemsize": point_step,
        }
    )


# ---------------------------------------------------------------------------
# Map -> PointCloud2 (the reference's layout)
# ---------------------------------------------------------------------------


def map_to_pointcloud2(
    geom: GridGeometry,
    state,
    frame_id: str = "map",
    stamp_ns: int = 0,
    elevation_layer: str = layers.elevation,
    submap: Optional[Tuple[slice, slice]] = None,
) -> PointCloud2:
    """ElevationMap -> PointCloud2 with the reference's field table and
    byte layout: x/y/z, the non-internal float layers (map layer order,
    minus elevation and color), packed ``rgb``; column-major, finite
    elevation cells only. The layout is world-aligned (start index 0)."""
    # The reference's field order: elevation, elevation_min and
    # elevation_max lead, the other layers follow in creation order.
    head = [layers.elevation, layers.elevation_min, layers.elevation_max]
    ordered = [h for h in head if h in state.layers] + [
        k for k in state.layers if k not in head
    ]
    float_layers = [
        name
        for name in ordered
        if not gm.is_internal(name) and name not in (elevation_layer, layers.color)
    ]
    has_color = layers.color in state.layers
    lyr, position = host_state(
        state, [elevation_layer] + float_layers + ([layers.color] if has_color else [])
    )
    elev = lyr[elevation_layer]
    rs = submap[0] if submap else slice(None)
    cs = submap[1] if submap else slice(None)
    elev = elev[rs, cs]
    # Cell coordinates in double, rounded to f32 at the end: the
    # reference's arithmetic (origin = position + length/2 - res/2 in
    # double, minus index * res, cast to float; length = size * res).
    pos = np.asarray(position, dtype=np.float64)
    res32 = np.float32(geom.resolution)
    res64 = np.float64(res32)
    len_x = np.float64(geom.rows) * res64
    len_y = np.float64(geom.cols) * res64
    origin_x = pos[0] + len_x / 2.0 - res64 / 2.0
    origin_y = pos[1] + len_y / 2.0 - res64 / 2.0
    xi = (origin_x - np.arange(geom.rows, dtype=np.float64) * res64).astype(
        np.float32
    )
    yj = (origin_y - np.arange(geom.cols, dtype=np.float64) * res64).astype(
        np.float32
    )
    x = np.broadcast_to(xi[:, None], (geom.rows, geom.cols))[rs, cs]
    y = np.broadcast_to(yj[None, :], (geom.rows, geom.cols))[rs, cs]

    fields: List[PointField] = []
    off = 0
    for name in ["x", "y", "z"] + float_layers + (
        ["rgb"] if has_color else []
    ):
        fields.append(PointField(name, off, FLOAT32))
        off += 4
    point_step = off

    # Column-major order like the reference (j outer, i inner) ==
    # Fortran ravel of the row-major arrays.
    finite = np.isfinite(elev)
    keep = finite.ravel(order="F")
    cols = {
        "x": x.ravel(order="F")[keep],
        "y": y.ravel(order="F")[keep],
        "z": elev.ravel(order="F")[keep].astype(np.float32),
    }
    for name in float_layers:
        cols[name] = lyr[name][rs, cs].ravel(order="F")[keep].astype(np.float32)
    if has_color:
        cols["rgb"] = (
            lyr[layers.color][rs, cs].ravel(order="F")[keep].astype(np.float32)
        )

    n = int(keep.sum())
    rec = np.zeros(n, dtype=_np_fields(fields, point_step))
    for name, vals in cols.items():
        rec[name] = vals
    return PointCloud2(
        frame_id=frame_id,
        stamp_ns=stamp_ns,
        height=1,
        width=n,
        fields=fields,
        is_bigendian=False,
        point_step=point_step,
        row_step=n * point_step,
        data=rec.tobytes(),
        is_dense=True,
    )


# ---------------------------------------------------------------------------
# Cloud <-> PointCloud2 (the point-cloud library's conventions)
# ---------------------------------------------------------------------------


def cloud_to_pointcloud2(cloud, stamp_ns: Optional[int] = None) -> PointCloud2:
    """Cloud -> PointCloud2: x/y/z f32, then intensity f32 / ring u16 /
    time f32 / rgb f32 / label u32 / normal_x|y|z f32 for the channels the
    cloud has, tightly packed. Masked points are left out."""
    xyz_all, m, chans_all = host_arrays(cloud)
    xyz = xyz_all[m].astype(np.float32)
    n = xyz.shape[0]

    fields: List[PointField] = []
    off = 0

    def add(name, datatype, size):
        nonlocal off
        fields.append(PointField(name, off, datatype))
        off += size

    add("x", FLOAT32, 4)
    add("y", FLOAT32, 4)
    add("z", FLOAT32, 4)
    chans: Dict[str, np.ndarray] = {}
    if "intensity" in chans_all:
        add("intensity", FLOAT32, 4)
        chans["intensity"] = chans_all["intensity"][m]
    if "ring" in chans_all:
        add("ring", UINT16, 2)
        chans["ring"] = chans_all["ring"][m].astype(np.uint16)
    if "time" in chans_all:
        add("time", FLOAT32, 4)
        chans["time"] = chans_all["time"][m]
    if "color" in chans_all:
        add("rgb", FLOAT32, 4)
        chans["rgb"] = pack_rgb(chans_all["color"])[m].astype(np.float32)
    if "label" in chans_all:
        add("label", UINT32, 4)
        chans["label"] = chans_all["label"][m].astype(np.uint32)
    if "normal" in chans_all:
        nrm = chans_all["normal"][m]
        add("normal_x", FLOAT32, 4)
        add("normal_y", FLOAT32, 4)
        add("normal_z", FLOAT32, 4)
        chans["normal_x"] = nrm[:, 0]
        chans["normal_y"] = nrm[:, 1]
        chans["normal_z"] = nrm[:, 2]

    point_step = off
    rec = np.zeros(n, dtype=_np_fields(fields, point_step))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    for name, vals in chans.items():
        rec[name] = vals.astype(rec.dtype[name])
    return PointCloud2(
        frame_id=cloud.frame_id or "",
        stamp_ns=(
            stamp_ns if stamp_ns is not None else int(cloud.timestamp_ns)
        ),
        height=1,
        width=n,
        fields=fields,
        is_bigendian=False,
        point_step=point_step,
        row_step=n * point_step,
        data=rec.tobytes(),
        is_dense=True,
    )


def pointcloud2_to_cloud(msg: PointCloud2, *, device="cuda"):
    """PointCloud2 -> cloud on ``device``: parse x/y/z (+ intensity, ring,
    time, rgb|rgba, label, normal_*) at any offsets, converting datatypes
    as the reference reader does."""
    if msg.is_bigendian:
        raise ValueError("big-endian PointCloud2 not supported")
    n = msg.width * msg.height
    dtype = _np_fields(msg.fields, msg.point_step)
    row_bytes = msg.width * msg.point_step
    if msg.height > 1 and msg.row_step != row_bytes:
        # Organized cloud with row padding: parse row by row at row_step
        # strides (naive frombuffer would read the padding as point
        # records and silently shift every later row).
        if msg.row_step < row_bytes:
            raise ValueError(
                f"row_step {msg.row_step} < width*point_step {row_bytes}"
            )
        rows = [
            np.frombuffer(
                msg.data,
                dtype=dtype,
                count=msg.width,
                offset=r * msg.row_step,
            )
            for r in range(msg.height)
        ]
        rec = np.concatenate(rows)
    else:
        rec = np.frombuffer(msg.data, dtype=dtype, count=n)
    names = {f.name for f in msg.fields}
    if not {"x", "y", "z"} <= names:
        raise ValueError("PointCloud2 missing x/y/z fields")

    def col(name):
        # count>1 fields parse as subarrays; scalar consumers take the
        # first element (the reference reads element 0 at the offset).
        v = rec[name]
        return v[..., 0] if v.ndim > 1 else v

    xyz = np.column_stack(
        [col("x"), col("y"), col("z")]
    ).astype(np.float32)
    channels: Dict[str, np.ndarray] = {}
    if "intensity" in names:
        channels["intensity"] = col("intensity").astype(np.float32)
    if "ring" in names:
        channels["ring"] = col("ring").astype(np.int32)
    for tname in ("t", "time", "timestamp"):
        if tname in names:
            channels["time"] = col(tname).astype(np.float32)
            break
    for cname in ("rgb", "rgba"):
        if cname in names:
            packed = col(cname)
            if packed.dtype != np.float32:
                packed = packed.view(np.float32)
            rgbu8 = unpack_rgb(np.ascontiguousarray(packed))
            channels["color"] = rgbu8  # u8[N, 3], the cloud convention
            break
    if "label" in names:
        channels["label"] = col("label").astype(np.int32)
    if {"normal_x", "normal_y", "normal_z"} <= names:
        channels["normal"] = np.column_stack(
            [col("normal_x"), col("normal_y"), col("normal_z")]
        ).astype(np.float32)
    cloud = from_numpy(xyz, device=device, **channels)
    return cloud.with_frame(msg.frame_id)


# ---------------------------------------------------------------------------
# Map -> grid_map_msgs/GridMap structure
# ---------------------------------------------------------------------------


def map_to_gridmap_msg(
    geom: GridGeometry,
    state,
    frame_id: str = "map",
    stamp_ns: int = 0,
    basic_layers: Tuple[str, ...] = (layers.elevation,),
) -> Dict:
    """ElevationMap -> the public grid_map_msgs/GridMap structure (ETH
    grid_map conventions): info with the pose at the map center, one
    Float32MultiArray per non-internal layer with [column_index,
    row_index] dims and column-major data, start indices 0."""
    names = [k for k in state.layers if not gm.is_internal(k)]
    lyr, position = host_state(state, names)
    pos = np.asarray(position, dtype=np.float64)
    data = []
    for k in names:
        arr = np.asarray(lyr[k], dtype=np.float32)
        data.append(
            {
                "layout": {
                    "dim": [
                        {
                            "label": "column_index",
                            "size": geom.cols,
                            "stride": geom.rows * geom.cols,
                        },
                        {
                            "label": "row_index",
                            "size": geom.rows,
                            "stride": geom.rows,
                        },
                    ],
                    "data_offset": 0,
                },
                "data": arr.ravel(order="F"),
            }
        )
    return {
        "header": {"frame_id": frame_id, "stamp_ns": stamp_ns},
        "info": {
            "header": {"frame_id": frame_id, "stamp_ns": stamp_ns},
            "resolution": geom.resolution,
            "length_x": geom.rows * geom.resolution,
            "length_y": geom.cols * geom.resolution,
            "pose": {
                "position": {"x": float(pos[0]), "y": float(pos[1]), "z": 0.0},
                "orientation": {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0},
            },
        },
        "layers": names,
        "basic_layers": [b for b in basic_layers if b in state.layers],
        "data": data,
        "outer_start_index": 0,
        "inner_start_index": 0,
    }


# ---------------------------------------------------------------------------
# PCL point-record layouts
# ---------------------------------------------------------------------------

# pcl::PointXYZ* memory layouts: 16-byte-aligned SSE records (xyz + 1
# padding float, then per-type extras), binary-compatible with
# pcl::PointCloud<T>::points buffers.
PCL_DTYPES: Dict[str, np.dtype] = {
    "PointXYZ": np.dtype(
        {"names": ["x", "y", "z"],
         "formats": [np.float32] * 3,
         "offsets": [0, 4, 8], "itemsize": 16}
    ),
    "PointXYZI": np.dtype(
        {"names": ["x", "y", "z", "intensity"],
         "formats": [np.float32] * 4,
         "offsets": [0, 4, 8, 16], "itemsize": 32}
    ),
    "PointXYZL": np.dtype(
        {"names": ["x", "y", "z", "label"],
         "formats": [np.float32] * 3 + [np.uint32],
         "offsets": [0, 4, 8, 16], "itemsize": 32}
    ),
    "PointXYZRGB": np.dtype(
        {"names": ["x", "y", "z", "rgb"],
         "formats": [np.float32] * 4,
         "offsets": [0, 4, 8, 16], "itemsize": 32}
    ),
    "PointXYZRGBA": np.dtype(
        {"names": ["x", "y", "z", "rgba"],
         "formats": [np.float32] * 3 + [np.uint32],
         "offsets": [0, 4, 8, 16], "itemsize": 32}
    ),
    "PointNormal": np.dtype(
        {"names": ["x", "y", "z", "normal_x", "normal_y", "normal_z",
                   "curvature"],
         "formats": [np.float32] * 7,
         "offsets": [0, 4, 8, 16, 20, 24, 32], "itemsize": 48}
    ),
    "PointXYZINormal": np.dtype(
        {"names": ["x", "y", "z", "normal_x", "normal_y", "normal_z",
                   "intensity", "curvature"],
         "formats": [np.float32] * 8,
         "offsets": [0, 4, 8, 16, 20, 24, 32, 36], "itemsize": 48}
    ),
    "PointXYZRGBNormal": np.dtype(
        {"names": ["x", "y", "z", "normal_x", "normal_y", "normal_z",
                   "rgb", "curvature"],
         "formats": [np.float32] * 8,
         "offsets": [0, 4, 8, 16, 20, 24, 32, 36], "itemsize": 48}
    ),
}


def cloud_to_pcl(cloud, point_type: str = "PointXYZ") -> np.ndarray:
    """Cloud -> a numpy structured array binary-compatible with
    pcl::PointCloud<point_type>::points. Masked points are left out;
    missing channels fill with zeros."""
    if point_type not in PCL_DTYPES:
        raise ValueError(f"unsupported PCL point type: {point_type!r}")
    dt = PCL_DTYPES[point_type]
    xyz_all, m, chans = host_arrays(cloud)
    xyz = xyz_all[m]
    rec = np.zeros(xyz.shape[0], dtype=dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    names = set(dt.names)
    if "intensity" in names and "intensity" in chans:
        rec["intensity"] = chans["intensity"][m]
    if "label" in names and "label" in chans:
        rec["label"] = chans["label"][m].astype(np.uint32)
    if ("rgb" in names or "rgba" in names) and "color" in chans:
        packed = pack_rgb(chans["color"])[m]
        if "rgb" in names:
            rec["rgb"] = packed.astype(np.float32)
        else:
            bits = packed.view(np.uint32) | np.uint32(0xFF000000)
            rec["rgba"] = bits
    if "normal_x" in names and "normal" in chans:
        nrm = chans["normal"][m]
        rec["normal_x"], rec["normal_y"], rec["normal_z"] = (
            nrm[:, 0], nrm[:, 1], nrm[:, 2],
        )
    return rec


def pcl_to_cloud(rec: np.ndarray, frame_id: str = "", *, device="cuda"):
    """Inverse of cloud_to_pcl, onto ``device``: any structured array with
    x/y/z (+ intensity / label / rgb|rgba / normal_* fields)."""
    names = set(rec.dtype.names or ())
    if not {"x", "y", "z"} <= names:
        raise ValueError("PCL record missing x/y/z")
    xyz = np.column_stack([rec["x"], rec["y"], rec["z"]]).astype(np.float32)
    channels: Dict[str, np.ndarray] = {}
    if "intensity" in names:
        channels["intensity"] = rec["intensity"].astype(np.float32)
    if "label" in names:
        channels["label"] = rec["label"].astype(np.int32)
    if "rgb" in names:
        channels["color"] = unpack_rgb(
            np.ascontiguousarray(rec["rgb"].astype(np.float32))
        )
    elif "rgba" in names:
        packed = (rec["rgba"] & np.uint32(0x00FFFFFF)).view(np.uint32)
        channels["color"] = unpack_rgb(np.ascontiguousarray(packed).view(np.float32))
    if {"normal_x", "normal_y", "normal_z"} <= names:
        channels["normal"] = np.column_stack(
            [rec["normal_x"], rec["normal_y"], rec["normal_z"]]
        ).astype(np.float32)
    cloud = from_numpy(xyz, device=device, **channels)
    return cloud.with_frame(frame_id)
