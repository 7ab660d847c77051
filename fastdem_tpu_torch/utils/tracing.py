"""The port's flight recorder: spans and counters inside the program.

A span is (name, start, end, parent span, scan id, thread). Its times are
``time.perf_counter_ns()``, the clock of ``time.perf_counter()``, so a
caller that keeps ``perf_counter`` samples can select the spans of its own
window. Spans are on unless the environment sets ``FASTDEM_TRACE=0``: an
operator's recorder has to be running already when a stall happens. Off,
each span site costs one call that tests the module's ``ON``.

Storage is a ring of ``CAPACITY`` preallocated rows of eight int64 fields
(seq, name, thread, start, end, parent, scan, attr), about 32 MB, whose
pages the system fills only as spans reach them. No Python object is kept
per span, so the ring gives the cyclic collector nothing to walk. Names are
interned to small ints (``name_id``). A span's sequence number comes from
``next()`` on an ``itertools.count``, which is atomic under the GIL, so
the node's threads write without a lock; row ``seq % CAPACITY`` holds it
until the ring comes round. A row's ``end`` is -1 while the span is open.

Each thread keeps a stack of its open spans, which gives a span its
parent, and its current scan id. A scan gets its id where it enters the
program: ``runtime.driver.MappingDriver.on_scan`` in the node, which hands
it with the queued scan to the intake thread (``set_scan``), and
``mapping.pipeline.FastDEM.integrate`` otherwise (``begin_scan``).

Spans of the host (``begin`` / ``end``, or ``record`` for one whose times
are known afterwards) and of the device: ``device_span`` opens a span when
a step's work has been enqueued (or, after ``device_start``, at an event
recorded before that work) and records a CUDA event behind it, drawn
from a pool of ``EVENTS`` per device; the span's end is the event's
completion on the host's clock, worked out when the event's slot is used
again or when the ring is read (``table``, ``export_chrome``), never by
waiting on the step's stream. The events are read against anchor events
recorded about once a second on a stream of their own, each kept only if
seen complete within ``ANCHOR_POLL_NS`` of its record.

Counters (``counters()``): the registry's own (``count``), the collector's
collections by generation (``host.gc_collections.<n>``), and counters that
live elsewhere, read where they are (``register``): K1 / K4's
``launches``, the driver's ``dropped_scans`` / ``intake_errors``, the
graphs' replays. ``step.device_allocs`` is the caching allocator's
``num_device_alloc``, read at most once per ``ALLOC_EVERY`` step calls,
each reading kept as a zero-length span with the count as its ``attr``.

The collector's runs are spans too (``host.gc``, the generation as
``attr``), through ``gc.callbacks``, installed once.

While ``torch.profiler`` records, each host span is also a
``record_function`` range of the same name, and its ``attr`` holds the
bit ``PROFILED``: readers of the spans can leave out what the profiler
slowed. A span's site may add bits of its own to its ``attr`` (``tag``).
``export_chrome`` writes the
ring as Chrome-trace events on the wall clock (``time.time_ns()``, the
clock of kineto's timestamps), from an anchor between the two clocks taken
anew at export as the tightest of a few paired reads, so a profiler trace
and the spans open together in Perfetto.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import struct
import sys
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _prof

ON = os.environ.get("FASTDEM_TRACE", "1") != "0"

# A 51 s window at 1,000 scans a second, at about ten spans a scan.
CAPACITY = 1 << 19
# CUDA events per device for the device spans: a slot is used again
# EVENTS step calls later, by when its step has long completed.
EVENTS = 256
# Step calls per reading of the allocator's device allocations.
ALLOC_EVERY = 64
# Host ns between two anchors of the device clock, and the longest an
# anchor may take to be seen complete.
ANCHOR_EVERY_NS = 1_000_000_000
ANCHOR_POLL_NS = 50_000
# The ``attr`` of a host span recorded while torch.profiler recorded.
PROFILED = 1 << 62

_FIELDS = ("seq", "name", "thread", "start", "end", "parent", "scan", "attr")
_ROW = struct.Struct("<8q")
_pack = _ROW.pack_into
_now = time.perf_counter_ns

_names: List[str] = []
_ids: Dict[str, int] = {}
_names_lock = threading.Lock()


def name_id(name: str) -> int:
    """The small int a span name is stored as."""
    i = _ids.get(name)
    if i is None:
        with _names_lock:
            i = _ids.get(name)
            if i is None:
                i = _ids[name] = len(_names)
                _names.append(name)
    return i


def _alloc(capacity: int) -> None:
    global _RING, _BUF, _Q, _MASK, _seq, _capacity
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, not {capacity}")
    _RING = np.zeros((capacity, len(_FIELDS)), dtype=np.int64)
    _BUF = memoryview(_RING).cast("B")
    _Q = _BUF.cast("q")
    _MASK = capacity - 1
    _capacity = capacity
    # Sequence numbers start at 1: a row never written reads seq 0.
    _seq = itertools.count(1)


_alloc(CAPACITY)

# Thread index -> name; index 0 is the device's lane.
_threads: Dict[int, str] = {0: "device"}
_thread_ids = itertools.count(1)
_scan_ids = itertools.count(1)


class _Thread(threading.local):
    def __init__(self):
        tid = next(_thread_ids)
        _threads[tid] = threading.current_thread().name
        # [scan id, thread index, -1 (no parent), open spans ...]
        self.st = [0, tid, -1]


_t = _Thread()
_open_rf: Dict[int, object] = {}


def _annotate(seq: int, name: int) -> None:
    _Q[((seq & _MASK) << 3) + 7] = PROFILED
    rf = _prof.record_function(_names[name])
    rf.__enter__()
    _open_rf[seq] = rf


def _unannotate(seq: int) -> None:
    rf = _open_rf.pop(seq, None)
    if rf is not None:
        rf.__exit__(None, None, None)


def begin(name: int, t: int = 0) -> int:
    """Open a span of this thread (at ``t``, else now), a child of its
    innermost open span; its handle, -1 when spans are off."""
    if not ON:
        return -1
    st = _t.st
    seq = next(_seq)
    _pack(_BUF, (seq & _MASK) << 6, seq, name, st[1], t or _now(), -1, st[-1], st[0], 0)
    st.append(seq)
    if _prof._is_profiler_enabled:
        _annotate(seq, name)
    return seq


def end(seq: int, t: int = 0) -> None:
    """Close the span ``begin`` returned (at ``t``, else now)."""
    if seq < 0:
        return
    t = t or _now()
    j = (seq & _MASK) << 3
    if _Q[j] == seq:
        _Q[j + 4] = t
    st = _t.st
    if st[-1] == seq:
        st.pop()
    elif seq in st[3:]:  # above a child left open by an exception
        del st[st.index(seq, 3):]
    if _open_rf:
        _unannotate(seq)


def record(name: int, start: int, end: int, scan: Optional[int] = None,
           parent: Optional[int] = None, attr: int = 0, thread: Optional[int] = None) -> int:
    """A closed span whose times are known (its scan, parent and thread
    default to this thread's); its sequence number, -1 when off."""
    if not ON:
        return -1
    st = _t.st
    seq = next(_seq)
    _pack(_BUF, (seq & _MASK) << 6, seq, name, st[1] if thread is None else thread, start,
          end, st[-1] if parent is None else parent, st[0] if scan is None else scan, attr)
    return seq


def open_span(name: int, attr: int = 0, thread: Optional[int] = None) -> int:
    """A span that starts now and is closed by ``close`` from anywhere; it
    is no parent of this thread's later spans."""
    if not ON:
        return -1
    return record(name, _now(), -1, attr=attr, thread=thread)


def close(seq: int, t: int = 0) -> None:
    if seq < 0:
        return
    t = t or _now()
    j = (seq & _MASK) << 3
    if _Q[j] == seq:
        _Q[j + 4] = t


def tag(seq: int, attr: int) -> None:
    """Add ``attr``'s bits to the ``attr`` of the span ``begin`` returned."""
    if seq < 0:
        return
    j = (seq & _MASK) << 3
    if _Q[j] == seq:
        _Q[j + 7] |= attr


def mark(name: int, attr: int) -> None:
    """A zero-length span holding a reading in ``attr``."""
    t = _now()
    record(name, t, t, attr=attr)


# -- scans ---------------------------------------------------------------
def new_scan() -> int:
    return next(_scan_ids)


def set_scan(scan: int) -> None:
    """This thread's spans belong to ``scan`` from now on (0: none)."""
    _t.st[0] = scan


def current_scan() -> int:
    return _t.st[0]


def begin_scan(name: int) -> int:
    """``begin``, giving this thread a new scan id first if it has none;
    close with ``end_scan``, which clears an id given here."""
    if not ON:
        return -1
    st = _t.st
    if st[0]:
        return begin(name) << 1
    st[0] = next(_scan_ids)
    return begin(name) << 1 | 1


def end_scan(h: int) -> None:
    if h < 0:
        return
    end(h >> 1)
    if h & 1:
        _t.st[0] = 0


# -- counters ------------------------------------------------------------
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()
_linked: Dict[str, list] = {}
_gc_counts = [0, 0, 0]


def count(name: str, n: int = 1) -> None:
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def register(name: str, obj, attr: str) -> None:
    """Report ``obj.<attr>`` (an int kept where it lives) as the counter
    ``name``, summed over every live object registered under it."""
    with _counts_lock:
        refs = [r for r in _linked.get(name, []) if r[0]() is not None]
        refs.append((weakref.ref(obj), attr))
        _linked[name] = refs


def counters() -> Dict[str, int]:
    """Every counter as it stands."""
    with _counts_lock:
        out = dict(_counts)
        linked = {k: list(v) for k, v in _linked.items()}
    for gen, n in enumerate(_gc_counts):
        out[f"host.gc_collections.{gen}"] = n
    for name, refs in linked.items():
        live = [(o, a) for o, a in ((r(), a) for r, a in refs) if o is not None]
        if live:
            out[name] = sum(int(getattr(o, a)) for o, a in live)
    return out


# -- the collector -------------------------------------------------------
_GC = name_id("host.gc")
_gc_open = [-1]


def _on_gc(phase: str, info: dict) -> None:
    gen = info["generation"]
    if phase == "start":
        _gc_open[0] = open_span(_GC, attr=gen)
    else:
        close(_gc_open[0])
        _gc_open[0] = -1
        _gc_counts[gen] += 1


gc.callbacks.append(_on_gc)


# -- the device ----------------------------------------------------------
class _DeviceClock:
    """Device spans of one CUDA device: a pool of events, each read against
    an anchor event recorded on a stream of its own.

    An anchor is kept only if it is seen complete within
    ``ANCHOR_POLL_NS`` of its record, and its host time is the middle of
    that interval: the device may queue a stream behind another's work
    (streams share its hardware queues), and an anchor run late would place
    every event read against it early. Every event is made (recorded once)
    before it is timed: an event's first record creates it, which takes
    longer than the record. A completion read before its span's start,
    which the anchor's error can give, is read as the start: no work ends
    before the host has enqueued it."""

    def __init__(self, device):
        self.index = device.index
        self.stream = torch.cuda.Stream(device)
        self.streams: Dict[int, object] = {}  # stream id -> Stream, for ``record``
        self.events = [self._made_event() for _ in range(EVENTS)]
        self.seqs = [-1] * EVENTS
        self.anchors: List = [None] * EVENTS
        # A slot's start event, for a span timed between two events
        # (``device_start``); made at the slot's first such use.
        self.starts: List = [None] * EVENTS
        self.started = [False] * EVENTS
        self.slots = itertools.count()
        self.anchor = self._try_anchor()
        if self.anchor is None:  # the device is busy: wait for it once
            torch.cuda.synchronize(device)
            while self.anchor is None:
                self.anchor = self._try_anchor()
        self.t_anchor = _now()

    def _made_event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def _try_anchor(self):
        ev = self._made_event()
        t0 = _now()
        ev.record(self.stream)
        while not ev.query():
            if _now() - t0 > ANCHOR_POLL_NS:
                return None
        return ev, (t0 + _now()) // 2

    def _current_stream(self):
        sid = torch._C._cuda_getCurrentStream(self.index)[0]
        st = self.streams.get(sid)
        if st is None:
            st = self.streams[sid] = torch.cuda.current_stream(self.index)
        return st

    def _refresh(self, now: int) -> None:
        if now - self.t_anchor >= ANCHOR_EVERY_NS:
            self.t_anchor = now
            anchor = self._try_anchor()
            if anchor is not None:
                self.anchor = anchor

    def _resolve(self, k: int, wait: bool) -> None:
        seq = self.seqs[k]
        if seq < 0:
            return
        ev = self.events[k]
        self.seqs[k] = -1
        if wait:
            ev.synchronize()
        a_ev, a_host = self.anchors[k]
        self.anchors[k] = None
        try:
            ms = a_ev.elapsed_time(ev)
        except RuntimeError:  # not complete yet: the span stays open
            count("step.device_unresolved")
            return
        j = (seq & _MASK) << 3
        if _Q[j] != seq:
            return
        if self.started[k]:
            _Q[j + 3] = a_host + int(round(a_ev.elapsed_time(self.starts[k]) * 1e6))
        _Q[j + 4] = max(a_host + int(round(ms * 1e6)), _Q[j + 3])

    def _slot(self, started: bool) -> int:
        k = next(self.slots) % EVENTS
        self._resolve(k, wait=False)
        self.started[k] = started
        return k

    def before_enqueue(self) -> int:
        """A slot whose start event is recorded now on the current stream."""
        k = self._slot(True)
        if self.starts[k] is None:
            self.starts[k] = self._made_event()
        self.starts[k].record(self._current_stream())
        return k

    def after_enqueue(self, seq: int, k: int = -1) -> None:
        if k < 0:
            k = self._slot(False)
        self.events[k].record(self._current_stream())
        self.seqs[k] = seq
        self.anchors[k] = self.anchor
        self._refresh(_now())

    def resolve_all(self) -> None:
        for k in range(EVENTS):
            self._resolve(k, wait=True)


_clocks: Dict[int, _DeviceClock] = {}
_clocks_lock = threading.Lock()


def _clock(device) -> _DeviceClock:
    clock = _clocks.get(device.index)
    if clock is None:
        with _clocks_lock:
            clock = _clocks.get(device.index)
            if clock is None:
                clock = _clocks[device.index] = _DeviceClock(device)
    return clock


def device_start(device) -> int:
    """On a CUDA ``device``: an event recorded now on the current stream,
    where a ``device_span(..., since=)`` that this thread opens next starts;
    its handle, -1 when spans are off."""
    if not ON:
        return -1
    return _clock(device).before_enqueue()


def device_span(name: int, device, since: int = -1) -> None:
    """On a CUDA ``device``: a span from now, when this thread has enqueued
    its work, to that work's completion on the device; given ``since``
    (``device_start``'s handle), from that event's completion instead, so
    that the span holds only the work enqueued between the two, and the
    waits it makes on the device."""
    if not ON:
        return
    _clock(device).after_enqueue(open_span(name, thread=0), since)


_ALLOCS = name_id("step.device_allocs")
_step_calls = itertools.count()


def sample_allocs(device) -> None:
    """Once per ``ALLOC_EVERY`` calls: read the caching allocator's device
    allocations on a CUDA ``device`` (``step.device_allocs``)."""
    if next(_step_calls) % ALLOC_EVERY:
        return
    n = int(torch.cuda.memory.memory_stats_as_nested_dict(device).get("num_device_alloc", 0))
    with _counts_lock:
        _counts["step.device_allocs"] = n
    mark(_ALLOCS, n)


def resolve() -> None:
    """Close every device span whose event is pending (waits for them)."""
    for clock in list(_clocks.values()):
        clock.resolve_all()


# -- reading -------------------------------------------------------------
def wall_offset_ns(reads: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the tightest of a
    few paired reads."""
    best = None
    for _ in range(reads):
        a = _now()
        w = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class Table:
    """The ring's rows, oldest first, as numpy columns named as the fields
    (``seq``, ``name``, ``thread``, ``start``, ``end``, ``parent``,
    ``scan``, ``attr``); ``total`` spans were ever written."""

    def __init__(self, rows: np.ndarray, names: List[str], total: int, capacity: int,
                 threads: Dict[int, str]):
        keep = rows[:, 0] > 0
        rows = rows[keep]
        rows = rows[np.argsort(rows[:, 0], kind="stable")]
        for i, f in enumerate(_FIELDS):
            setattr(self, f, rows[:, i])
        self.names = names
        self.total = total
        self.capacity = capacity
        self.threads = threads

    def __len__(self) -> int:
        return len(self.seq)

    def id_of(self, name: str) -> int:
        return self.names.index(name) if name in self.names else -1

    def covers(self, t0_s: float) -> bool:
        """Whether every span that started at or after ``t0_s`` (seconds on
        the ``perf_counter`` clock) is still in the ring."""
        if self.total <= self.capacity:
            return True
        return len(self) > 0 and int(self.start[0]) <= int(t0_s * 1e9)

    def select(self, name: str, t0_s: float, t1_s: float) -> np.ndarray:
        """Rows of the closed spans ``name`` that started in [t0_s, t1_s)."""
        a, b = int(t0_s * 1e9), int(t1_s * 1e9)
        return np.flatnonzero((self.name == self.id_of(name)) & (self.start >= a)
                              & (self.start < b) & (self.end >= self.start))

    def until_profiled(self, t0_s: float, t1_s: float) -> float:
        """``t1_s``, or the start of the first host span in [t0_s, t1_s)
        recorded while torch.profiler recorded, if earlier: such spans
        carry the profiler's cost."""
        a, b = int(t0_s * 1e9), int(t1_s * 1e9)
        p = self.start[((self.attr & PROFILED) != 0) & (self.start >= a) & (self.start < b)]
        return float(p.min()) * 1e-9 if len(p) else t1_s

    def durations_ms(self, rows: np.ndarray) -> np.ndarray:
        return (self.end[rows] - self.start[rows]) * 1e-6

    def parent_name_ids(self, rows: np.ndarray) -> np.ndarray:
        """The name id of each row's parent; -1 where it has none or the
        ring lost it."""
        p = self.parent[rows]
        if not len(self):
            return np.full(len(p), -1)
        i = np.clip(np.searchsorted(self.seq, p), 0, len(self) - 1)
        return np.where(self.seq[i] == p, self.name[i], -1)

def table() -> Table:
    """The ring as it stands, the device spans resolved first."""
    resolve()
    total = next(_seq) - 1  # the count's next value is a fresh number
    return Table(_RING.copy(), list(_names), total, _capacity, dict(_threads))


def table_since(t0_s: float, reader: str) -> Optional[Table]:
    """``table()`` for a reader of the spans from ``t0_s`` (seconds on the
    ``perf_counter`` clock) on; None where the ring holds no span or has
    come round past ``t0_s``, which it says on standard error, so that a
    ring that lost part of the window is never read as a number."""
    tab = table()
    if not len(tab):
        return None
    if not tab.covers(t0_s):
        print(f"{reader}: the span ring ({tab.capacity} rows) came round past the "
              f"window's start; {tab.total} spans were written", file=sys.stderr)
        return None
    return tab


def export_chrome(path: str) -> int:
    """Write the ring as a Chrome trace (JSON, ``ts`` in microseconds on the
    wall clock); the number of spans written."""
    tab = table()
    off = wall_offset_ns()
    pid = os.getpid()
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "fastdem_tpu_torch"}}]
    events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in sorted(tab.threads.items())]
    for i in range(len(tab)):
        s, e = int(tab.start[i]), int(tab.end[i])
        ev = {"name": tab.names[int(tab.name[i])], "ph": "X", "pid": pid,
              "tid": int(tab.thread[i]), "ts": (s + off) / 1e3,
              "dur": max(e - s, 0) / 1e3 if e >= 0 else 0.0,
              "args": {"seq": int(tab.seq[i]), "parent": int(tab.parent[i]),
                       "scan": int(tab.scan[i]), "attr": int(tab.attr[i]),
                       "open": e < 0}}
        events.append(ev)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"clock": "wall ns since the epoch / 1e3",
                                 "perf_to_wall_ns": off, "spans_written": tab.total,
                                 "capacity": tab.capacity, "counters": counters()}}, f)
    return len(tab)


def reset(capacity: int = CAPACITY) -> None:
    """An empty ring of ``capacity`` rows and no counts of the registry's
    own; counters kept elsewhere stay as they are."""
    resolve()
    _alloc(capacity)
    with _counts_lock:
        _counts.clear()
    _gc_counts[:] = [0, 0, 0]
