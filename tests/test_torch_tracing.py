"""The port's flight recorder (``fastdem_tpu_torch/utils/tracing.py``) on
the CPU: spans nest with their parents and scan ids across threads, the
ring comes round and says so, ``FASTDEM_TRACE=0`` records no span while the
timers' ``tick_ms`` and the counters advance, the counter registry reads
the counters where they live, the collector's runs are spans, the Chrome
export lands on the wall clock, and the facade, the graph step and the
async node emit their spans for every scan.

Threads are waited on with joins, ``drain()`` and events, never with
sleeps alone.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import fastdem_tpu_torch as ft
from fastdem_tpu_torch.ops import polar_field, resample
from fastdem_tpu_torch.runtime import driver as drv
from fastdem_tpu_torch.runtime import providers as prov
from fastdem_tpu_torch.utils import graphs, tracing
from test_torch_graphs import RecordingGraphs
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_ring():
    tracing.reset()
    yield
    tracing.reset()


def rows(tab, name):
    return np.flatnonzero(tab.name == tab.id_of(name))


def named(tab, i):
    return tab.names[int(tab.name[i])]


def children(tab, seq):
    return np.flatnonzero(tab.parent == seq)


def kid_names(tab, seq):
    """The sorted names of a span's children, the collector's runs (which
    may land anywhere) left out."""
    return sorted(n for n in (named(tab, c) for c in children(tab, seq)) if n != "host.gc")


def test_spans_nest_with_parents_and_scans_across_threads():
    outer, inner, leaf = (tracing.name_id(n) for n in ("t.outer", "t.inner", "t.leaf"))
    n_threads, per_thread = 12, 200
    errors = []
    barrier = threading.Barrier(n_threads)
    scans = [tracing.new_scan() for _ in range(n_threads)]

    def work(k):
        try:
            barrier.wait(timeout=30)
            tracing.set_scan(scans[k])
            for _ in range(per_thread):
                a = tracing.begin(outer)
                b = tracing.begin(inner)
                tracing.end(tracing.begin(leaf))
                tracing.end(b)
                tracing.end(a)
            tracing.set_scan(0)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    tab = tracing.table()
    for name in ("t.outer", "t.inner", "t.leaf"):
        assert len(rows(tab, name)) == n_threads * per_thread
    # Every sequence number once, every span closed after it opened.
    assert len(np.unique(tab.seq)) == len(tab)
    assert (tab.end >= tab.start).all()
    seq_row = {int(s): i for i, s in enumerate(tab.seq)}
    for i in rows(tab, "t.leaf"):
        p = seq_row[int(tab.parent[i])]
        g = seq_row[int(tab.parent[p])]
        assert (named(tab, p), named(tab, g)) == ("t.inner", "t.outer")
        assert tab.parent[g] == -1
        # One thread, one scan: the whole chain shares both.
        assert tab.thread[i] == tab.thread[p] == tab.thread[g]
        assert tab.scan[i] == tab.scan[p] == tab.scan[g] != 0
        assert tab.start[g] <= tab.start[p] <= tab.start[i] <= tab.end[i] <= tab.end[p] \
            <= tab.end[g]
    by_thread = {}
    for i in rows(tab, "t.outer"):
        by_thread.setdefault(int(tab.thread[i]), set()).add(int(tab.scan[i]))
    assert sorted(s for v in by_thread.values() for s in v) == sorted(scans)
    assert all(len(v) == 1 for v in by_thread.values())


def test_begin_scan_gives_an_id_only_where_none_is_carried():
    n = tracing.name_id("t.scan")
    h = tracing.begin_scan(n)
    own = tracing.current_scan()
    assert own > 0
    tracing.end_scan(h)
    assert tracing.current_scan() == 0
    carried = tracing.new_scan()
    tracing.set_scan(carried)
    tracing.end_scan(tracing.begin_scan(n))
    assert tracing.current_scan() == carried
    tracing.set_scan(0)
    tab = tracing.table()
    assert list(tab.scan[rows(tab, "t.scan")]) == [own, carried]


def test_an_exception_leaves_no_span_on_the_stack():
    a, b = tracing.name_id("t.a"), tracing.name_id("t.b")
    outer = tracing.begin(a)
    tracing.begin(b)  # never ended, as when its code raised
    tracing.end(outer)
    after = tracing.begin(a)
    tracing.end(after)
    tab = tracing.table()
    i = rows(tab, "t.a")[-1]
    assert tab.parent[i] == -1
    assert tab.end[rows(tab, "t.b")[0]] == -1  # left open, and not read as closed
    assert len(tab.select("t.b", 0.0, 1e12)) == 0


def test_ring_wraps_and_says_so(capsys):
    tracing.reset(capacity=64)
    n = tracing.name_id("t.wrap")
    t0 = time.perf_counter()
    for k in range(100):
        tracing.record(n, 10_000 + k, 10_001 + k)
    tab = tracing.table()
    assert (tab.total, len(tab), tab.capacity) == (100, 64, 64)
    # The oldest rows went: seq 37..100 stay, in order.
    assert list(tab.seq) == list(range(37, 101))
    assert list(tab.start) == [10_000 + k for k in range(36, 100)]
    # A window from before the oldest span kept is not covered; one after is.
    assert not tab.covers(10_000 * 1e-9)
    assert tab.covers(t0)
    assert tracing.table_since(10_000 * 1e-9, "t.reader") is None
    assert "came round past the window's start" in capsys.readouterr().err
    assert tracing.table_since(t0, "t.reader") is not None
    with pytest.raises(ValueError, match="power of two"):
        tracing.reset(capacity=100)


def test_trace_off_records_no_span_while_ticks_and_counters_advance(monkeypatch):
    monkeypatch.setattr(tracing, "ON", False)
    monkeypatch.setattr(graphs, "BACKEND", RecordingGraphs())
    before = tracing.counters()
    step = graphs.jit(lambda x: x * 2.0, donate=False)
    for _ in range(3):
        step(torch.ones(4))
    gc.collect()
    with driver(viz_rate=50.0) as d:
        feed(d, 2)
        assert d.drain(timeout=120.0)
        wait_for(lambda: len(d.tick_ms["viz"]) >= 2)
        assert all(ms > 0.0 for ms in d.tick_ms["viz"])
    after = tracing.counters()
    # Captured: the step above and the facade's (one scan size).
    assert len(d.mapper._map.step.graphs) == 1
    assert after["step.captures"] == before.get("step.captures", 0) + 2
    assert after["host.gc_collections.2"] >= before["host.gc_collections.2"] + 1
    assert sum(g.replays for g in step.stats()) == 3
    assert len(tracing.table()) == 0


def test_environment_switches_spans_off():
    code = ("from fastdem_tpu_torch.utils import tracing as t; "
            "n = t.name_id('x'); t.end(t.begin(n)); tab = t.table(); "
            "print(t.ON, int((tab.name == n).sum()))")
    for value, want in (("0", "False 0"), ("1", "True 1")):
        env = dict(os.environ, PYTHONPATH=ROOT, FASTDEM_TRACE=value)
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == want.split()


def test_counter_registry_reads_counters_where_they_live(monkeypatch):
    monkeypatch.setattr(polar_field, "launches", 7)
    monkeypatch.setattr(resample, "launches", 11)
    monkeypatch.setattr(graphs, "BACKEND", RecordingGraphs())
    gc.collect()
    base = tracing.counters().get("graphs.replays", 0)
    step = graphs.jit(lambda x: x + 1.0, donate=False)
    for n in (4, 4, 4, 8):
        step(torch.zeros(n))
    c = tracing.counters()
    assert (c["polar_field.launches"], c["resample.launches"]) == (7, 11)
    assert [g.replays for g in step.stats()] == [3, 1]
    assert c["graphs.replays"] == base + 4
    monkeypatch.setattr(polar_field, "launches", 8)
    assert tracing.counters()["polar_field.launches"] == 8
    with driver() as d:
        d.dropped_scans = 5
        assert tracing.counters()["node.dropped_scans"] == 5
        assert tracing.counters()["node.intake_errors"] == 0


def test_gc_collect_is_a_span():
    before = tracing.counters()["host.gc_collections.2"]
    t0 = time.perf_counter_ns()
    gc.collect()
    t1 = time.perf_counter_ns()
    tab = tracing.table()
    i = rows(tab, "host.gc")
    i = i[tab.attr[i] == 2]
    assert len(i) >= 1
    assert t0 <= tab.start[i[-1]] <= tab.end[i[-1]] <= t1
    assert tracing.counters()["host.gc_collections.2"] >= before + 1


def test_export_round_trip_on_the_wall_clock(tmp_path):
    n = tracing.name_id("t.export")
    wall0 = time.time_ns()
    h = tracing.begin(n)
    time.sleep(0.02)
    tracing.end(h)
    wall1 = time.time_ns()
    tracing.record(n, 5, 9, scan=3, attr=42)
    path = tmp_path / "spans.json"
    assert tracing.export_chrome(str(path)) == len(tracing.table())
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e["name"] == "t.export"]
    live = next(e for e in spans if e["args"]["attr"] == 0)
    # On the wall clock, within the reads around it.
    assert wall0 - 1e6 <= live["ts"] * 1e3 <= live["ts"] * 1e3 + live["dur"] * 1e3 <= wall1 + 1e6
    assert live["dur"] >= 19_000  # us
    known = next(e for e in spans if e["args"]["attr"] == 42)
    off = doc["otherData"]["perf_to_wall_ns"]
    assert known["ts"] == pytest.approx((5 + off) / 1e3)
    assert known["dur"] == pytest.approx(0.004)
    assert known["args"]["scan"] == 3
    names = {e["args"]["name"] for e in doc["traceEvents"] if e.get("name") == "thread_name"}
    assert threading.current_thread().name in names


def test_wall_offset_agrees_with_the_clocks():
    off = tracing.wall_offset_ns()
    assert abs(time.perf_counter_ns() + off - time.time_ns()) < 5e6


# -- the program's spans -------------------------------------------------
T_BS = np.eye(4, dtype=np.float32)
T_BS[2, 3] = 1.0


def ring_scan(seed, n=3000):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.5, 3.5, n)
    z = rng.normal(-1.0, 0.02, n)
    return np.stack([rad * np.cos(ang), rad * np.sin(ang), z], -1).astype(np.float32)


def pose(k):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.2 * k
    return T


def stamp(k):
    return (k + 1) * 10**8


def driver(**kw):
    calib = prov.StaticCalibration("base")
    calib.set_extrinsic("lidar", T_BS)
    odom = prov.TransformBuffer("base", "map")
    for k in range(8):
        odom.add_pose(stamp(k), pose(k))
    kw.setdefault("postprocess_rate", 0.0)
    kw.setdefault("viz_rate", 0.0)
    cfg = ft.Config()
    cfg.raycasting.enabled = False
    return drv.MappingDriver(ft.GridGeometry.from_length(6.0, 6.0, 0.1), cfg,
                             calibration=calib, odometry=odom, async_intake=True,
                             device="cpu", **kw)


def feed(d, n):
    for k in range(n):
        assert d.on_scan(ft.cloud.from_numpy(ring_scan(k), frame_id="lidar",
                                             timestamp_ns=stamp(k), device="cpu"))


def wait_for(cond, timeout=60.0):
    ev = threading.Event()
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        ev.wait(0.01)


def coverage(tab, i):
    """The share of span ``i`` its children (not the collector's runs)
    cover."""
    c = children(tab, tab.seq[i])
    c = c[(tab.end[c] >= tab.start[c]) & (tab.name[c] != tab.id_of("host.gc"))]
    iv = sorted(zip(tab.start[c], tab.end[c]))
    covered, cur = 0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            if cur is not None:
                covered += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        covered += cur[1] - cur[0]
    return covered / max(int(tab.end[i] - tab.start[i]), 1)


def facade_spans_per_scan(tab):
    """For each scan id that ran ``facade.integrate``: the names of its
    children, with the integrate span's row."""
    out = {}
    for i in rows(tab, "facade.integrate"):
        out[int(tab.scan[i])] = (i, kid_names(tab, tab.seq[i]))
    return out


def test_facade_emits_its_spans_per_scan():
    cfg = ft.Config()
    cfg.raycasting.enabled = False
    mapper = ft.FastDEM(ft.GridGeometry.from_length(6.0, 6.0, 0.1), cfg, device="cpu")
    for k in range(3):
        assert mapper.integrate(ft.cloud.from_numpy(ring_scan(k), frame_id="lidar",
                                                    device="cpu"), T_BS, pose(k))
    assert not mapper.integrate(None, T_BS, pose(0))  # dropped: its prep span still closes
    tab = tracing.table()
    per_scan = facade_spans_per_scan(tab)
    assert len(per_scan) == 4 and 0 not in per_scan
    done = [s for s, (_, kids) in per_scan.items() if "step.call" in kids]
    assert len(done) == 3
    for s in done:
        i, kids = per_scan[s]
        assert kids == ["facade.callbacks", "facade.prep", "step.call"]
        assert coverage(tab, i) >= 0.9
        assert set(tab.scan[children(tab, tab.seq[i])]) == {s}
    assert tracing.current_scan() == 0


def test_graph_step_spans_on_the_recording_double(monkeypatch):
    monkeypatch.setattr(graphs, "BACKEND", RecordingGraphs())
    cfg = ft.Config()
    cfg.raycasting.enabled = False
    mapper = ft.FastDEM(ft.GridGeometry.from_length(6.0, 6.0, 0.1), cfg, device="cpu")
    before = tracing.counters()
    for k in range(3):
        assert mapper.integrate(ft.cloud.from_numpy(ring_scan(k), frame_id="lidar",
                                                    device="cpu"), T_BS, pose(k))
    after = tracing.counters()
    assert after["step.captures"] == before.get("step.captures", 0) + 1
    # A LOCAL step's move makes new layers: the graph copies each of them,
    # and the position, into its slot on every replay, and says so.
    copies = len(mapper.live_state().layers) + 1
    assert after["step.slot_copies"] == before.get("step.slot_copies", 0) + 3 * copies
    tab = tracing.table()
    calls = rows(tab, "step.call")
    assert len(calls) == 3
    kids = [kid_names(tab, tab.seq[i]) for i in calls]
    assert kids[0] == ["step.capture"]
    assert kids[1] == kids[2] == ["step.clone_out", "step.copy_in", "step.launch"]
    cap = rows(tab, "step.capture")[0]
    assert kid_names(tab, tab.seq[cap]) == ["step.clone_out", "step.copy_in", "step.launch"]
    launches = tab.attr[rows(tab, "step.launch")]
    assert (launches == graphs.SLOT_COPIES | copies).all() and len(launches) == 3
    # No device spans on the CPU.
    assert len(rows(tab, "step.device")) == 0


def test_async_node_emits_its_spans_per_scan():
    with driver(viz_rate=40.0, postprocess_rate=20.0) as d:
        d.sinks["map"] = lambda payload: None
        feed(d, 6)
        assert d.drain(timeout=120.0)
        wait_for(lambda: len(d.tick_ms["viz"]) >= 1 and len(d.tick_ms["postprocess"]) >= 1)
    assert (d.scan_count, d.dropped_scans, d.intake_errors) == (6, 0, 0)
    tab = tracing.table()
    per_scan = facade_spans_per_scan(tab)
    assert len(per_scan) == 6
    queued = {int(tab.scan[i]): i for i in rows(tab, "node.queue")}
    assert set(queued) == set(per_scan)
    # The queue span keeps the scan's stamp.
    assert sorted(int(tab.attr[i]) for i in queued.values()) == [stamp(k) for k in range(6)]
    intake_waits = rows(tab, "node.lock_wait")
    intake_waits = intake_waits[tab.scan[intake_waits] > 0]
    assert sorted(int(s) for s in tab.scan[intake_waits]) == sorted(per_scan)
    for s, (i, kids) in per_scan.items():
        assert kids == ["facade.callbacks", "facade.prep", "step.call"]
        assert coverage(tab, i) >= 0.9
        q = queued[s]
        w = intake_waits[tab.scan[intake_waits] == s][0]
        # queue -> lock wait -> integrate, in this order, on the intake thread.
        assert tab.end[q] <= tab.start[w] <= tab.end[w] <= tab.start[i]
        assert tab.thread[w] == tab.thread[i] == tab.thread[q]
    # Ticks: the lock, the host read and the publish inside the viz tick;
    # the chain inside the post-processing tick; tick_ms from the spans.
    viz = rows(tab, "node.tick.viz")[0]
    assert kid_names(tab, tab.seq[viz]) == ["node.lock_held", "node.lock_wait", "node.publish"]
    held = next(c for c in children(tab, tab.seq[viz]) if named(tab, c) == "node.lock_held")
    assert kid_names(tab, tab.seq[held]) == ["node.to_host"]
    assert tab.scan[viz] == 0
    pp = rows(tab, "node.tick.postprocess")[0]
    assert set(kid_names(tab, tab.seq[pp])) >= {"pp.chain", "node.to_host"}
    assert d.tick_ms["viz"][0] == pytest.approx((tab.end[viz] - tab.start[viz]) * 1e-6)


def test_node_tool_writes_its_spans_at_exit(tmp_path):
    out = tmp_path / "spans.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "fastdem_tpu_torch.tools.fastdem_node",
                        "--preset", "local_mapping", "--synthetic", "3", "--device", "cpu",
                        "--async-intake", "--out", str(tmp_path), "--trace-out", str(out)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"spans -> {out}" in r.stderr
    spans = [e for e in json.loads(out.read_text())["traceEvents"] if e["ph"] == "X"]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["node.queue"]) == 3
    assert len({e["args"]["scan"] for e in by_name["facade.integrate"]}) == 3


def test_spans_under_the_profiler_are_ranges_and_flagged():
    from torch.profiler import ProfilerActivity, profile

    n = tracing.name_id("t.profiled")
    t0 = time.perf_counter()
    tracing.end(tracing.begin(n))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.end(tracing.begin(n))
    t1 = time.perf_counter()
    tracing.end(tracing.begin(n))
    tab = tracing.table()
    i = rows(tab, "t.profiled")
    assert list(tab.attr[i]) == [0, tracing.PROFILED, 0]
    assert tab.until_profiled(t0, t1 + 1.0) == pytest.approx(tab.start[i[1]] * 1e-9)
    assert "t.profiled" in {e.name for e in prof.events()}
