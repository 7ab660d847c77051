"""What every loop shares: the ``Run`` it returns, device completion times
on the host's clock, and the steps of set-up that every loop takes.

A loop is a file ``loops/<name>.py`` that a traffic mix names (``"loop"``
in its file). It defines ``run(config, traffic, log, seconds, trace,
device) -> Run`` (set-up, the measured window, and the program's map
afterwards) and ``history(traffic, log, seconds)``: the order of scans a run
of ``seconds`` integrates, for the control (``control.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check


@dataclasses.dataclass
class Run:
    setup_end: float = 0.0  # perf_counter at the window's start
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    samples: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    history: List[int] = dataclasses.field(default_factory=list)
    layers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    position: Optional[np.ndarray] = None
    pp: Optional[Dict[str, np.ndarray]] = None
    trace: object = None
    memory_peak_bytes: int = 0


class Completion:
    """Device completion times on the host's clock: a CUDA event per mark,
    read against one event whose host time is known; on the CPU the host
    time of the mark."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.base_event = None
        self.base_host = None

    def start(self) -> None:
        if self.cuda:
            self.base_event = torch.cuda.Event(enable_timing=True)
            self.base_event.record()
            self.base_event.synchronize()
        self.base_host = time.perf_counter()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def host_time(self, mark) -> float:
        if self.cuda:
            return self.base_host + self.base_event.elapsed_time(mark) * 1e-3
        return mark


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_map(state):
    return ({k: v.detach().cpu().numpy() for k, v in state.layers.items()},
            state.position.detach().cpu().numpy())


def program_config(config: dict):
    from fastdem_tpu_torch.runtime.node_config import NodeConfig

    return NodeConfig.parse(copy.deepcopy(config["node"]))


def first_of_each_capacity(log) -> List[int]:
    seen, reps = set(), []
    for i, n in enumerate(log.sizes()):
        cap = check.capacity_of(int(n))
        if cap not in seen:
            seen.add(cap)
            reps.append(i)
    return reps


def clouds(log):
    from fastdem_tpu_torch.cloud import pointcloud as pc

    return [pc.from_numpy(x, frame_id="lidar", timestamp_ns=int(s), device="cpu")
            for x, s in zip(log.xyz, log.stamps_ns)]


def settle() -> None:
    """Before the window: collect the garbage of set-up (the generator's),
    so that the window does not pay for it. The process is left as a user
    runs it: no collector or thread settings."""
    gc.collect()


def trace_start(traffic: dict, seconds: float) -> float:
    """Seconds into the window at which the traced sub-window starts: it
    ends ``trace_tail_s`` before the window closes."""
    return max(0.0, seconds - float(traffic["trace_s"]) - float(traffic["trace_tail_s"]))
