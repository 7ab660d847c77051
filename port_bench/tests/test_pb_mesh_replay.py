"""The ``mesh_replay`` loop (four processes, one 2x2 mesh block each) at a
small size on the CPU with gloo: a sound run comes out correct, the
bfloat16 control and a planted fault (one block's elevation 1 cm off) do
not; the ``mesh.*`` readers' arithmetic on span tables and reduced
traces made by hand; the result line names every rank's card; and the
loop exits at once, starting no process, against a facade that takes
no ``mesh=``."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fastdem_tpu_torch.mapping.pipeline as pipeline
from fastdem_tpu_torch.parallel import sharding
from port_bench import control
from port_bench.harness import bench, check
from port_bench.tests.small import small

CELL = "global_vlp16_mesh2x2.replay_4proc"
SECONDS = 1.5
READERS = ["mesh.sync_ms_per_call", "mesh.rank_host_ms_per_scan_max",
           "mesh.rank_device_ms_per_scan_max"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(seed=3_000_000_123):
    cfg, tr = small(CELL)
    return bench.run_cell(CELL, seed, SECONDS, False, "cpu", time.perf_counter(),
                          out=lambda *_: None, config=cfg, traffic=tr)


def test_four_processes_agree_with_the_reference():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["state_err"]["value"] == 0.0
    assert r["metrics"]["scans_per_s"]["value"] > 0


def test_bfloat16_control_is_not_correct():
    cfg, tr = small(CELL)
    numbers, _ = control.control_numbers(CELL, 7, "cpu", SECONDS, cfg, tr)
    correct, _ = check.judge(numbers, bench.load_json(bench.limits_file(CELL)))
    assert not correct, numbers


def test_fault_one_block_one_centimetre_off(monkeypatch):
    """Rank 0 (this process) assembles the map with block (0, 0)'s
    elevation 1 cm high."""
    gather = sharding.gather_state

    def off(sharded, *a, **k):
        full = gather(sharded, *a, **k)
        if full is not None:
            rows, cols = sharded.layout.block_shape
            e = full.layers["elevation"]
            e[:rows, :cols] += 0.01
        return full

    monkeypatch.setattr(sharding, "gather_state", off)
    r = _run()
    assert not r["correct"], r["checks"]


def test_loop_refuses_a_facade_without_mesh_at_once(monkeypatch):
    class OldFacade:
        def __init__(self, geom, cfg=None, position=(0.0, 0.0), *, device="cuda"):
            raise AssertionError("built")

    def no_process(*a, **k):
        raise AssertionError("a process was started")

    loop = bench.loop("mesh_replay")
    monkeypatch.setattr(pipeline, "FastDEM", OldFacade)
    monkeypatch.setattr(loop.subprocess, "Popen", no_process)
    cfg, tr = small(CELL)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as exit_:
        loop.run(cfg, tr, None, SECONDS, False, torch.device("cpu"))
    assert exit_.value.code == 2
    assert time.perf_counter() - t0 < 5.0


def test_result_line_names_every_rank_card(monkeypatch):
    monkeypatch.setattr(bench, "device_info", bench.device_info)
    loop = bench.loop("mesh_replay")
    loop._report_every_card()
    loop._report_every_card()  # once is enough: the report is not wrapped twice
    kind = "NVIDIA H100 80GB HBM3"
    cards = [{"kind": kind, "index": r, "memory_peak_bytes": 230 + (r == 2)} for r in range(4)]
    run = SimpleNamespace(devices=cards, memory_peak_bytes=230)
    assert bench.device_info(torch.device("cuda", 0), run) == {
        "platform": "gpu", "kind": kind, "count": 4, "memory_peak_bytes": 231}
    # A run that carries no cards (on the CPU) keeps the harness's report.
    cpu = bench.device_info(torch.device("cpu"), SimpleNamespace(memory_peak_bytes=0))
    assert cpu["platform"] == "cpu" and cpu["count"] == 0
    with pytest.raises(RuntimeError, match="shared a card"):
        loop.cards_info(cards[:3] + [dict(cards[3], index=1)])
    with pytest.raises(RuntimeError, match="several kinds"):
        loop.cards_info(cards[:3] + [dict(cards[3], kind="another card")])


# ---- the readers ------------------------------------------------------------------

T0 = 3.0e9  # the window's start (seconds on the perf_counter clock)
TRAFFIC = {"trace_s": 2.0, "trace_tail_s": 1.0}
WINDOW_S = 10.0  # so the readers' window is [T0, T0 + 7 s)


@pytest.fixture
def tracing():
    from fastdem_tpu_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def rank_table(tracing, spans):
    """A table of the closed spans (name, seconds into the window, ms,
    attr); the recorder is emptied after it."""
    for name, at, ms, attr in spans:
        start = int(round((T0 + at) * 1e9))
        tracing.record(tracing.name_id(name), start, start + int(ms * 1e6), attr=attr)
    tab = tracing.table()
    tracing.reset()
    return tab


def scans(at, host_ms):
    return [("facade.integrate", t, host_ms, 0) for t in at]


def traced(scans, **kernels_ms):
    """A rank's reduced trace: kernel name -> (count, seconds)."""
    return SimpleNamespace(scans=scans,
                           kernels={k: (1, ms * 1e-3) for k, ms in kernels_ms.items()})


def ctx(tables, traces=None):
    return SimpleNamespace(run=SimpleNamespace(setup_end=T0, window_s=WINDOW_S,
                                               rank_tables=tables, rank_traces=traces),
                           traffic=TRAFFIC, trace=None)


def test_readers_take_the_slowest_rank_in_the_window(tracing):
    profiled = tracing.PROFILED
    t0 = rank_table(tracing, scans((1.0, 2.0, 3.0, 6.5), 1.0)
                    + [("mesh.sync.device", 1.5, 2.0, 0), ("mesh.sync.device", 3.5, 4.0, 0),
                       # the profiler's first span cuts the window at 6 s
                       ("facade.prep", 6.0, 0.1, profiled),
                       ("mesh.sync.device", 6.6, 100.0, 0)])
    t1 = rank_table(tracing, scans((1.0, 2.0, 3.0), 2.0)
                    + [("mesh.sync.device", 1.5, 1.0, 0),
                       ("facade.integrate", -0.5, 50.0, 0),  # before the window
                       ("facade.integrate", 6.2, 50.0, 0)])  # after its end
    t2 = rank_table(tracing, scans((1.0, 2.0), 1.5) + [("mesh.sync.device", 1.5, 3.5, 0)])
    # Copies, fills and the NCCL collective are no part of a card's step.
    traces = [traced(4, step=2.0, Memcpy_HtoD=9.0, ncclDevKernel_AllReduce=50.0),
              traced(2, step=0.5, Memset=9.0),
              traced(3, step=2.25, k1=0.75)]
    c = ctx([t0, t1, t2], traces)
    got = {n: bench.reader(n)(c) for n in READERS}
    assert got["mesh.sync_ms_per_call"] == pytest.approx(3.5)  # rank 2; rank 0's mean is 3.0
    assert got["mesh.rank_host_ms_per_scan_max"] == pytest.approx(2.0)  # rank 1
    assert got["mesh.rank_device_ms_per_scan_max"] == pytest.approx(1.0)  # rank 2
    traces[1].scans = 0  # a rank with no traced scan: nothing to read
    assert bench.reader("mesh.rank_device_ms_per_scan_max")(c) is None


def test_readers_find_nothing_without_rank_tables_or_spans(tracing):
    for n in READERS:
        assert bench.reader(n)(SimpleNamespace(run=SimpleNamespace(setup_end=T0,
                                                                   window_s=WINDOW_S),
                                               traffic=TRAFFIC, trace=None)) is None
    host_only = rank_table(tracing, [("facade.integrate", 1.0, 1.0, 0)])
    c = ctx([host_only, host_only], [None, None])
    assert bench.reader("mesh.rank_host_ms_per_scan_max")(c) == pytest.approx(1.0)
    assert bench.reader("mesh.sync_ms_per_call")(c) is None  # no card: no device spans
    assert bench.reader("mesh.rank_device_ms_per_scan_max")(c) is None  # untraced
    assert np.isfinite(bench.reader("mesh.rank_host_ms_per_scan_max")(c))
