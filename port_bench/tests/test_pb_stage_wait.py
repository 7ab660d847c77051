"""The reader of the facade's staging waits
(``metrics/facade.stage_wait_ms_per_scan.py``) on a recorder filled by
hand: its sum over the window's integrate calls, its window, and a program
without the staging ring."""

import gc
import sys

import pytest

from port_bench.tests.test_pb_program_spans import ctx, span

READER = "facade.stage_wait_ms_per_scan"


def read():
    from port_bench.harness import bench

    return bench.reader(READER)(ctx())


@pytest.fixture
def tracing():
    from fastdem_tpu_torch.mapping import staging  # noqa: F401 (interns the span's name)
    from fastdem_tpu_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def test_waits_summed_over_the_windows_integrate_calls(tracing):
    for at, wait in ((-0.5, 50.0), (1.0, 0.0), (2.0, 0.3), (3.0, 0.0), (4.0, 0.5), (7.5, 50.0)):
        fi = span(tracing, "facade.integrate", at, 2.0, scan=tracing.new_scan())
        prep = span(tracing, "facade.prep", at, 1.0, parent=fi)
        if wait:
            span(tracing, "facade.stage_wait", at + 1e-4, wait, parent=prep)
    assert read() == pytest.approx(0.8 / 4)


def test_no_wait_reads_zero(tracing):
    gc.disable()  # a collection would be a span
    try:
        span(tracing, "facade.integrate", 1.0, 2.0, scan=tracing.new_scan())
        assert read() == 0.0
    finally:
        gc.enable()


def test_the_window_ends_at_the_first_span_the_profiler_slowed(tracing):
    span(tracing, "facade.integrate", 1.0, 2.0)
    span(tracing, "facade.stage_wait", 1.0, 0.4)
    span(tracing, "facade.integrate", 3.0, 2.0, attr=tracing.PROFILED)
    span(tracing, "facade.stage_wait", 3.0, 9.0)
    assert read() == pytest.approx(0.4)


def test_a_program_without_the_ring_reads_none(monkeypatch):
    from fastdem_tpu_torch.utils import tracing

    tracing.reset()
    span(tracing, "facade.integrate", 1.0, 2.0)
    monkeypatch.setattr(tracing, "_names", ["-" if n == "facade.stage_wait" else n
                                            for n in tracing._names])
    assert read() is None
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "fastdem_tpu_torch.utils.tracing", None)
    import fastdem_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    assert read() is None
    tracing.reset()
