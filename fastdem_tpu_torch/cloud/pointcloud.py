"""Fixed-capacity SoA point cloud (port of ``fastdem_tpu/cloud/pointcloud.py``).

A cloud holds f32[N, 3] points, a bool[N] validity mask and optional named
channels, all on one device. Padding rows have mask False and xyz set to a
far-away 1e9 sentinel, so an unmasked consumer maps them out of any grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.interop import to_host

CHANNEL_DTYPES = {
    "intensity": np.float32,
    "time": np.float32,
    "ring": np.int32,
    "color": np.uint8,
    "label": np.int32,
    "normal": np.float32,
    "covariance": np.float32,
}


@dataclasses.dataclass
class PointCloud:
    """SoA point cloud.

    Attributes:
      xyz: f32[N, 3] point coordinates.
      mask: bool[N] validity; False entries are padding / filtered out.
      channels: optional per-point channels (see CHANNEL_DTYPES).
      frame_id: sensor frame name.
      timestamp_ns: acquisition time.
      nominal_count: points provided at construction, before masking
        (-1 = unknown); the facade's emptiness check reads it without a
        device sync.
      valid_count: mask-true points at construction (-1 = unknown); picks
        the capacity bucket without a device sync.
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    channels: Dict[str, torch.Tensor]
    frame_id: str = ""
    timestamp_ns: int = 0
    nominal_count: int = -1
    valid_count: int = -1
    # A cloud made by ``stage``: the pinned host tensors its copies read
    # from, held for as long as the cloud lives, so the asynchronous copies
    # never read freed memory.
    pinned_source: Optional[Tuple] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def capacity(self) -> int:
        return int(self.xyz.shape[0])

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def count(self) -> int:
        """Number of valid points (device sync)."""
        return int(self.mask.sum())

    def empty(self) -> bool:
        if self.nominal_count >= 0:
            return self.nominal_count == 0
        return self.capacity == 0 or self.count() == 0

    def has(self, channel: str) -> bool:
        return channel in self.channels

    def with_channel(self, name: str, value: torch.Tensor) -> "PointCloud":
        ch = dict(self.channels)
        ch[name] = value
        return dataclasses.replace(self, channels=ch)

    def with_mask(self, mask: torch.Tensor) -> "PointCloud":
        # The new mask's population is unknown on the host: the
        # construction-time count is dropped rather than left stale.
        return dataclasses.replace(self, mask=mask, valid_count=-1)

    def with_frame(self, frame_id: str) -> "PointCloud":
        return dataclasses.replace(self, frame_id=frame_id)

    def to(self, device) -> "PointCloud":
        """The same cloud with every tensor on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            xyz=self.xyz.to(dev),
            mask=self.mask.to(dev),
            channels={k: v.to(dev) for k, v in self.channels.items()},
        )


def from_numpy(
    xyz: np.ndarray,
    frame_id: str = "",
    timestamp_ns: int = 0,
    capacity: Optional[int] = None,
    *,
    device="cuda",
    **channels: np.ndarray,
) -> PointCloud:
    """Build a cloud on ``device`` (the card unless the caller names the
    CPU) from host arrays, optionally padded to ``capacity``. Rows with a
    non-finite coordinate are invalid."""
    dev = resolve_device(device)
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    finite = np.isfinite(xyz).all(axis=1)
    mask[:n] &= finite
    pad_xyz = np.full((cap, 3), 1e9, dtype=np.float32)
    pad_xyz[:n] = np.where(finite[:, None], xyz, 1e9)
    ch_out: Dict[str, torch.Tensor] = {}
    for name, data in channels.items():
        if data is None:
            continue
        if name not in CHANNEL_DTYPES:
            raise KeyError(f"unknown channel '{name}'")
        data = np.asarray(data)
        buf = np.zeros((cap,) + data.shape[1:], dtype=data.dtype)
        buf[:n] = data
        ch_out[name] = torch.from_numpy(buf).to(dev)
    return PointCloud(
        xyz=torch.from_numpy(pad_xyz).to(dev),
        mask=torch.from_numpy(mask).to(dev),
        channels=ch_out,
        frame_id=frame_id,
        timestamp_ns=timestamp_ns,
        nominal_count=n,
        valid_count=int(np.count_nonzero(mask)),
    )


def stage(cloud: PointCloud, device="cuda") -> PointCloud:
    """Start the copies of a host cloud to ``device`` and return the cloud
    backed by the (possibly still in-flight) device tensors.

    A CPU cloud bound for a CUDA device is copied through pinned host
    memory with ``non_blocking=True`` on the current stream, so the copy
    overlaps host work and is ordered before every later kernel on that
    stream; the returned cloud holds the pinned source (``pinned_source``)
    for as long as it lives. A cloud already on ``device`` is returned as
    it is; any other move is a plain ``to``."""
    dev = resolve_device(device)
    if cloud.device == dev:
        return cloud
    if cloud.device.type != "cpu" or dev.type != "cuda":
        return cloud.to(dev)
    xyz = cloud.xyz.pin_memory()
    mask = cloud.mask.pin_memory()
    ch = {k: v.pin_memory() for k, v in cloud.channels.items()}
    return dataclasses.replace(
        cloud,
        xyz=xyz.to(dev, non_blocking=True),
        mask=mask.to(dev, non_blocking=True),
        channels={k: v.to(dev, non_blocking=True) for k, v in ch.items()},
        pinned_source=(xyz, mask, ch),
    )


def host_arrays(cloud: PointCloud):
    """(xyz, mask, channels) of the cloud as numpy arrays, in one read
    from its device (``interop.to_host``)."""
    host = to_host({"xyz": cloud.xyz, "mask": cloud.mask,
                    **{("ch", k): v for k, v in cloud.channels.items()}})
    ch = {k: host[("ch", k)] for k in cloud.channels}
    return host["xyz"], host["mask"], ch


def compact(cloud: PointCloud) -> PointCloud:
    """Drop masked-out points (order preserved): an exact-size cloud on the
    same device. A CUDA cloud pays a device-to-host read."""
    xyz, keep, ch = host_arrays(cloud)
    return from_numpy(
        xyz[keep],
        frame_id=cloud.frame_id,
        timestamp_ns=cloud.timestamp_ns,
        device=cloud.device,
        **{k: v[keep] for k, v in ch.items()},
    )


def pad_to(cloud: PointCloud, capacity: int) -> PointCloud:
    """Grow the capacity to ``capacity`` with padding rows (on the cloud's
    device)."""
    if capacity == cloud.capacity:
        return cloud
    if capacity < cloud.capacity:
        raise ValueError("pad_to cannot shrink; use compact() first")
    extra = capacity - cloud.capacity
    dev = cloud.device
    xyz = torch.cat(
        [cloud.xyz, torch.full((extra, 3), 1e9, dtype=torch.float32, device=dev)]
    )
    mask = torch.cat([cloud.mask, torch.zeros(extra, dtype=torch.bool, device=dev)])
    ch = {
        k: torch.cat([v, torch.zeros((extra,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)])
        for k, v in cloud.channels.items()
    }
    return dataclasses.replace(
        cloud, xyz=xyz, mask=mask, channels=ch, pinned_source=None
    )


def bucket_capacity(n: int, granularity: int = 4096) -> int:
    """Round up to a multiple of ``granularity``: one batched shape for
    scans of nearby sizes."""
    if n <= 0:
        return granularity
    return ((n + granularity - 1) // granularity) * granularity


def ladder_capacity(n: int, base: int = 4096) -> int:
    """Round up to the geometric capacity ladder base * 2^k."""
    if n <= 0:
        return base
    cap = base
    while cap < n:
        cap *= 2
    return cap


def compact_to_bucket(cloud: PointCloud, base: int = 4096) -> PointCloud:
    """Drop masked-out points (order preserved) and pad to the capacity
    ladder. The result lies on the cloud's device; a CUDA cloud pays one
    device-to-host copy here."""
    xyz, keep, ch = host_arrays(cloud)
    xyz = xyz[keep]
    ch = {k: v[keep] for k, v in ch.items()}
    out = from_numpy(
        xyz,
        frame_id=cloud.frame_id,
        timestamp_ns=cloud.timestamp_ns,
        capacity=ladder_capacity(xyz.shape[0], base),
        device=cloud.device,
        **ch,
    )
    # A nonempty frame whose points were all filtered out stays nonempty.
    return dataclasses.replace(out, nominal_count=cloud.nominal_count)


def extract(cloud: PointCloud, indices) -> PointCloud:
    """New exact-size cloud of the given point indices, every channel
    carried, on the cloud's device. Indices of masked-out points are
    dropped."""
    xyz, mask, ch = host_arrays(cloud)
    idx = np.asarray(
        indices.cpu() if isinstance(indices, torch.Tensor) else indices,
        dtype=np.int64,
    ).reshape(-1)
    keep = idx[mask[idx]]
    return from_numpy(
        xyz[keep],
        frame_id=cloud.frame_id,
        timestamp_ns=cloud.timestamp_ns,
        device=cloud.device,
        **{k: v[keep] for k, v in ch.items()},
    )


def erase(cloud: PointCloud, indices) -> PointCloud:
    """New exact-size cloud without the given point indices; masked-out
    points are dropped too."""
    drop = np.zeros(cloud.capacity, dtype=bool)
    drop[np.asarray(
        indices.cpu() if isinstance(indices, torch.Tensor) else indices,
        dtype=np.int64,
    ).reshape(-1)] = True
    keep = np.flatnonzero(cloud.mask.cpu().numpy() & ~drop)
    return extract(cloud, keep)


def merge(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (on ``a``'s device). A channel present in
    only one input is zero-filled in the other."""
    dev = a.device
    ch = {}
    for name in sorted(set(a.channels) | set(b.channels)):
        va, vb = a.channels.get(name), b.channels.get(name)
        if va is None:
            va = torch.zeros((a.capacity,) + tuple(vb.shape[1:]), dtype=vb.dtype, device=dev)
        if vb is None:
            vb = torch.zeros((b.capacity,) + tuple(va.shape[1:]), dtype=va.dtype, device=dev)
        ch[name] = torch.cat([va, vb.to(dev)])
    return PointCloud(
        xyz=torch.cat([a.xyz, b.xyz.to(dev)]),
        mask=torch.cat([a.mask, b.mask.to(dev)]),
        channels=ch,
        frame_id=a.frame_id,
        timestamp_ns=a.timestamp_ns,
    )
