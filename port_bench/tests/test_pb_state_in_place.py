"""The reader of the donating step's in-place share
(``metrics/step.state_in_place_pct.py``) on a recorder filled by hand: its
share of the window's facade step calls, the calls it leaves out, and a
program whose step marks no copy-in."""

import gc
import sys

import pytest

from port_bench.tests.test_pb_program_spans import ctx, span

READER = "step.state_in_place_pct"


def read():
    from port_bench.harness import bench

    return bench.reader(READER)(ctx())


@pytest.fixture
def tracing():
    from fastdem_tpu_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def call(tracing, at, attr, capture=False, profiled=False):
    """A facade call whose step's copy-in carries ``attr`` (under a capture
    span on a first call, as ``utils/graphs.py`` nests it)."""
    fi = span(tracing, "facade.integrate", at, 2.0, scan=tracing.new_scan(),
              attr=tracing.PROFILED if profiled else 0)
    sc = span(tracing, "step.call", at + 1e-4, 1.0, parent=fi)
    if capture:
        sc = span(tracing, "step.capture", at + 2e-4, 0.9, parent=sc)
    span(tracing, "step.copy_in", at + 3e-4, 0.1, parent=sc, attr=attr)


def test_share_of_the_windows_facade_calls(tracing):
    from fastdem_tpu_torch.utils import graphs

    IN, COPIED = graphs.STATE_IN_PLACE, graphs.STATE_COPIED_IN
    call(tracing, -0.5, IN)  # before the window
    call(tracing, 1.0, COPIED, capture=True)
    for at in (2.0, 3.0, 4.0):
        call(tracing, at, IN)
    call(tracing, 5.0, COPIED)
    call(tracing, 7.5, COPIED)  # in the traced sub-window
    # A step call outside the facade (the chain's graph) is left out.
    chain = span(tracing, "pp.chain", 3.5, 5.0)
    sc = span(tracing, "step.call", 3.5, 1.0, parent=chain)
    span(tracing, "step.copy_in", 3.5, 0.1, parent=sc, attr=COPIED)
    assert read() == pytest.approx(100.0 * 3 / 5)


def test_every_call_in_place_reads_100(tracing):
    from fastdem_tpu_torch.utils import graphs

    gc.disable()  # a collection would be a span
    try:
        for at in (1.0, 2.0):
            call(tracing, at, graphs.STATE_IN_PLACE)
        assert read() == 100.0
    finally:
        gc.enable()


def test_the_window_ends_at_the_first_span_the_profiler_slowed(tracing):
    from fastdem_tpu_torch.utils import graphs

    call(tracing, 1.0, graphs.STATE_COPIED_IN)
    call(tracing, 2.0, graphs.STATE_IN_PLACE)
    call(tracing, 3.0, graphs.STATE_IN_PLACE | tracing.PROFILED, profiled=True)
    assert read() == pytest.approx(50.0)


def test_no_facade_call_reads_none(tracing):
    span(tracing, "pp.chain", 1.0, 2.0)
    assert read() is None


def test_a_program_without_the_mark_reads_none(monkeypatch):
    from fastdem_tpu_torch.utils import graphs, tracing

    tracing.reset()
    call(tracing, 1.0, 0)
    monkeypatch.delattr(graphs, "STATE_IN_PLACE")
    assert read() is None
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "fastdem_tpu_torch.utils.tracing", None)
    import fastdem_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    assert read() is None
    tracing.reset()
