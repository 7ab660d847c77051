"""The facade's scan inputs through pinned host memory.

A scan's host inputs (the cloud's points, mask and channels, padded to the
step's capacity, and its transforms) are written with numpy into one
pinned buffer, section after section, and reach the device in one
``non_blocking`` copy on the current stream, which orders it before the
step that reads them. The device tensors are views of the copy, so a dtype
and shape survive the trip bit for bit.

``StagingRing`` keeps ``DEPTH`` pairs of such buffers (pinned and device).
Each records a CUDA event after its copy; before the host writes a pinned
buffer again it waits on that event. That wait is the only place the
facade's input path blocks, and it bounds how far the host runs ahead of
the device. A device buffer is written again only by a copy enqueued after
the step that read it, on the same stream: like the step's graph slots,
the ring assumes that a facade's calls share one stream.

``plan`` / ``pack`` / ``unpack`` take plain arrays and buffers, so the
packing runs (and is tested) without a device.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.utils import tracing

# Buffers in a facade's ring: how many scans the host may run ahead of the
# device's copies.
DEPTH = 4

# Each section starts on this many bytes, so every view is aligned for any
# dtype and for vectorized loads.
ALIGN = 256

_STAGE_WAIT = tracing.name_id("facade.stage_wait")
_TORCH_DTYPES: Dict[np.dtype, torch.dtype] = {}


class Part(NamedTuple):
    """One input: ``src`` (a host array) written into the first rows of a
    section of ``rows`` rows, the rest set to ``fill``."""

    src: np.ndarray
    rows: int
    fill: object = 0


class Section(NamedTuple):
    key: str
    offset: int
    dtype: np.dtype
    shape: Tuple[int, ...]
    nbytes: int


def plan(parts: Dict[str, Part]) -> Tuple[Tuple[Section, ...], int]:
    """The sections of ``parts`` in a byte buffer, and its size."""
    secs, off = [], 0
    for key, p in parts.items():
        shape = (p.rows,) + p.src.shape[1:]
        n = math.prod(shape) * p.src.itemsize
        secs.append(Section(key, off, p.src.dtype, shape, n))
        off += -(-n // ALIGN) * ALIGN
    return tuple(secs), off


def pack(buf: np.ndarray, parts: Dict[str, Part], secs) -> None:
    """Write ``parts`` into the uint8 host buffer ``buf`` as ``secs`` lay
    them out."""
    for s in secs:
        p = parts[s.key]
        v = buf[s.offset:s.offset + s.nbytes].view(s.dtype).reshape(s.shape)
        m = p.src.shape[0]
        v[:m] = p.src
        if m < p.rows:
            v[m:] = p.fill


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    t = _TORCH_DTYPES.get(dt)
    if t is None:
        t = _TORCH_DTYPES[dt] = torch.from_numpy(np.empty(0, dtype=dt)).dtype
    return t


def unpack(buf: torch.Tensor, secs) -> Dict[str, torch.Tensor]:
    """The sections of the uint8 tensor ``buf`` (on any device) as tensors,
    views of it."""
    return {s.key: buf[s.offset:s.offset + s.nbytes].view(_torch_dtype(s.dtype)).view(s.shape)
            for s in secs}


class StagingRing:
    """``DEPTH`` pinned and device buffers for the inputs of one CUDA
    facade's scans, used in turn (see the module docstring). Not
    thread-safe, like the facade."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: List[Optional[torch.Tensor]] = [None] * DEPTH
        self.host_np: List[Optional[np.ndarray]] = [None] * DEPTH
        self.dev: List[Optional[torch.Tensor]] = [None] * DEPTH
        self.views: List[Dict] = [{} for _ in range(DEPTH)]  # layout -> device views
        self.events: List[Optional[torch.cuda.Event]] = [None] * DEPTH
        self.turn = 0

    def put(self, parts: Dict[str, Part]) -> Dict[str, torch.Tensor]:
        """``parts`` on the device, as views of one copy enqueued on the
        current stream. Counts ``facade.staged``; where the buffer's last
        copy is still in flight, waits for it under the span
        ``facade.stage_wait`` and counts ``facade.stage_waits``."""
        k = self.turn
        self.turn = (k + 1) % len(self.events)
        ev = self.events[k]
        if ev is None:
            ev = self.events[k] = torch.cuda.Event()
        elif not ev.query():
            tracing.count("facade.stage_waits")
            sp = tracing.begin(_STAGE_WAIT)
            ev.synchronize()
            tracing.end(sp)
        secs, nbytes = plan(parts)
        if self.host[k] is None or self.host[k].numel() < nbytes:
            self.host[k] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.host_np[k] = self.host[k].numpy()
            self.dev[k] = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            self.views[k] = {}
        pack(self.host_np[k], parts, secs)
        self.dev[k][:nbytes].copy_(self.host[k][:nbytes], non_blocking=True)
        ev.record(torch.cuda.current_stream(self.device))
        tracing.count("facade.staged")
        views = self.views[k].get(secs)
        if views is None:
            views = self.views[k][secs] = unpack(self.dev[k], secs)
        return views
