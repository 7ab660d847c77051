"""The traced sub-window: ``torch.profiler`` over a few seconds inside the
measured window, and its reduction to device time by kernel, busy time,
idle gaps and what the host was doing in them.

The profiler records device activity only (kernels, copies, fills) and,
with it, the CUDA runtime calls the host makes (``cudaGraphLaunch``,
``cudaMemcpyAsync``, ...), which label the idle gaps. Recording every
PyTorch op on the host as well slowed the replay loop to less than half its
rate on the H100, which would misstate the idle share. The profiler
window is padded by ``PAD_S`` of idle at each end, as the port's
``utils/profiling.py::profile_window`` pads it (kineto drops a device event
that it places outside the window). The span that is reduced lies inside
the padding, from the host's wall clock, which is the clock of kineto's
timestamps (nanoseconds since the epoch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

PAD_S = 0.02
SPAN = "harness.traced"


@dataclasses.dataclass
class Reduced:
    window_s: float  # length of the traced span
    busy_s: float  # union of device activity within it
    kernels: Dict[str, Tuple[int, float]]  # kernel name -> (count, seconds)
    device_ops: List[Tuple[str, float]]  # every device op name -> seconds, largest first
    idle_gaps: List[Tuple[str, float]]  # host activity -> idle seconds, largest first
    device_events: Tuple[int, int] = (0, 0)  # (within the span, all recorded)
    scans: int = 0  # scans integrated within the span (set by the loop)

    def kernel_time(self, *parts: str) -> Tuple[int, float]:
        """(events, seconds) of the kernels whose name holds any of ``parts``."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if any(p in name for p in parts):
                n, s = n + c, s + t
        return n, s


class Tracer:
    """Start / stop the profiler from a loop; ``reduce`` after the window."""

    def __init__(self):
        self.prof = None
        self.span = None  # (start, end) ns on the wall clock

    @staticmethod
    def warm(device) -> None:
        """One tiny profile, so that the profiler's first start (CUPTI's
        set-up) is paid in set-up rather than in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum()
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(PAD_S)
        self.span = (time.time_ns(), None)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.span = (self.span[0], time.time_ns())
        time.sleep(PAD_S)
        self.prof.stop()

    def reduce(self) -> Optional[Reduced]:
        return reduce_events(self.prof.profiler.kineto_results.events(), self.span)


def _label(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def reduce_events(events, span=None) -> Optional[Reduced]:
    """Reduce kineto events over ``span`` (ns), or over the host event
    named ``SPAN`` where no span is given."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # The harness's span shows on the device's timeline too, as a
            # user annotation: it is no device work.
            if e.name() != SPAN and not e.is_user_annotation():
                dev.append((s, s + d, e.name()))
        elif e.name() == SPAN:
            span = span or (s, s + d)
        else:
            host.append((s, s + d, e.name()))
    if span is None:
        return None
    s0, s1 = span
    n_dev = len(dev)
    dev = sorted((max(a, s0), min(b, s1), n) for a, b, n in dev if b > s0 and a < s1)
    kernels: Dict[str, Tuple[int, float]] = {}
    ops: Dict[str, float] = {}
    busy, cur_a, cur_b = 0, None, None
    gaps = []
    last_end = s0
    for a, b, n in dev:
        c, t = kernels.get(n, (0, 0.0))
        kernels[n] = (c + 1, t + (b - a) * 1e-9)
        ops[n] = ops.get(n, 0.0) + (b - a) * 1e-9
        if a > last_end:
            gaps.append((last_end, a))
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last_end = max(last_end, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if s1 > last_end:
        gaps.append((last_end, s1))
    # What the host was doing in each gap: the innermost host op (over all
    # threads) at the gap's middle.
    host.sort()
    by_label: Dict[str, float] = {}
    active: list = []
    i = 0
    for a, b in gaps:  # in order of time: one sweep over the host ops
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        inner = min(active, key=lambda h: h[1] - h[0]) if active else None
        label = "gap: " + (_label(inner[2]) if inner else "no host op")
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-9
    top_ops = sorted(((_label(k), v) for k, v in ops.items()), key=lambda kv: -kv[1])
    top_gaps = sorted(by_label.items(), key=lambda kv: -kv[1])
    return Reduced(window_s=(s1 - s0) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
                   device_ops=top_ops, idle_gaps=top_gaps, device_events=(len(dev), n_dev))
