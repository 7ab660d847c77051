"""The readers of the program's spans (``metrics/<name>.py`` over
``fastdem_tpu_torch/utils/tracing.py``): their arithmetic and their window
(from the window's start to the traced sub-window's start) on a recorder
filled by hand, a ring that came round past the window, and a program
without the recorder."""

import gc
import sys
from types import SimpleNamespace

import pytest

from port_bench.harness import bench

T0 = 3.0e9  # the window's start (seconds on the perf_counter clock), far from any real span
TRAFFIC = {"trace_s": 2.0, "trace_tail_s": 1.0}
WINDOW_S = 10.0  # so the readers' window is [T0, T0 + 7 s)

READERS = ["node.queue_wait_ms_p50", "node.lock_wait_ms_per_scan", "facade.prep_ms_per_scan",
           "step.host_ms_per_scan", "step.device_allocs_per_1k_scans", "host.gc_ms_per_s"]


@pytest.fixture
def tracing():
    from fastdem_tpu_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def ctx():
    return SimpleNamespace(run=SimpleNamespace(setup_end=T0, window_s=WINDOW_S),
                           traffic=TRAFFIC, trace=None)


def ns(s):
    return int(round(s * 1e9))


def span(tracing, name, at_s, ms, **kw):
    """A closed span ``name`` starting ``at_s`` seconds into the window."""
    start = ns(T0 + at_s)
    return tracing.record(tracing.name_id(name), start, start + int(ms * 1e6), **kw)


def read(name):
    return bench.reader(name)(ctx())


def test_queue_wait_is_the_median_of_the_window(tracing):
    for at, ms in ((-0.5, 100.0), (1.0, 1.0), (2.0, 3.0), (3.0, 2.0), (7.5, 100.0)):
        span(tracing, "node.queue", at, ms, scan=tracing.new_scan())
    assert read("node.queue_wait_ms_p50") == pytest.approx(2.0)


def test_lock_wait_counts_the_intake_scans_only(tracing):
    span(tracing, "node.lock_wait", 1.0, 0.5, scan=7)
    span(tracing, "node.lock_wait", 2.0, 1.5, scan=8)
    span(tracing, "node.lock_wait", 2.5, 50.0, scan=0)  # a timer's wait
    span(tracing, "node.lock_wait", 8.0, 50.0, scan=9)  # in the traced sub-window
    assert read("node.lock_wait_ms_per_scan") == pytest.approx(1.0)


def test_prep_and_step_host_per_scan(tracing):
    for at, prep, call in ((1.0, 0.2, 1.0), (2.0, 0.4, 3.0), (7.2, 9.0, 9.0)):
        fi = span(tracing, "facade.integrate", at, 5.0, scan=tracing.new_scan())
        span(tracing, "facade.prep", at, prep, parent=fi)
        span(tracing, "step.call", at + 0.001, call, parent=fi)
    chain = span(tracing, "pp.chain", 3.0, 200.0)
    span(tracing, "step.call", 3.0, 100.0, parent=chain)  # the chain's graph
    assert read("facade.prep_ms_per_scan") == pytest.approx(0.3)
    assert read("step.host_ms_per_scan") == pytest.approx(2.0)


def test_device_allocs_over_the_calls_between_readings(tracing):
    for at, n in ((-1.0, 50), (1.0, 100), (3.0, 104), (6.0, 110), (7.5, 999)):
        start = ns(T0 + at)
        tracing.record(tracing.name_id("step.device_allocs"), start, start, attr=n)
    fi = span(tracing, "facade.integrate", 0.5, 1.0)
    for k in range(50):
        # 40 calls between the first and the last reading of the window.
        span(tracing, "step.call", 0.9 + k * 0.125, 0.5, parent=fi)
    assert read("step.device_allocs_per_1k_scans") == pytest.approx((110 - 100) * 1e3 / 40)


def test_device_allocs_need_two_readings(tracing):
    start = ns(T0 + 1.0)
    tracing.record(tracing.name_id("step.device_allocs"), start, start, attr=3)
    assert read("step.device_allocs_per_1k_scans") is None


def test_gc_ms_per_second_of_the_window(tracing):
    for at, ms in ((-0.1, 80.0), (1.0, 4.0), (5.0, 10.0), (7.1, 80.0)):
        span(tracing, "host.gc", at, ms, attr=2)
    assert read("host.gc_ms_per_s") == pytest.approx(14.0 / 7.0)


def test_a_wrapped_ring_reads_none_and_says_so(tracing, capsys):
    tracing.reset(capacity=16)
    for k in range(40):
        span(tracing, "node.queue", 0.5 + k * 0.01, 1.0, scan=k + 1)
    for name in READERS:
        assert read(name) is None
    err = capsys.readouterr().err
    assert all(f"{name}: the span ring" in err for name in READERS)


def test_an_empty_ring_reads_none(tracing):
    gc.disable()  # a collection would be a span
    try:
        tracing.reset()
        for name in READERS:
            assert read(name) is None
    finally:
        gc.enable()


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    import fastdem_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "fastdem_tpu_torch.utils.tracing", None)
    for name in READERS:
        assert read(name) is None


def test_the_window_ends_at_the_first_span_the_profiler_slowed(tracing):
    for at, ms in ((1.0, 1.0), (2.0, 1.0)):
        span(tracing, "facade.prep", at, ms)
    for at in (3.0, 4.0):  # recorded while torch.profiler recorded
        span(tracing, "facade.prep", at, 50.0, attr=tracing.PROFILED)
    span(tracing, "facade.prep", 5.0, 50.0)
    assert read("facade.prep_ms_per_scan") == pytest.approx(1.0)
