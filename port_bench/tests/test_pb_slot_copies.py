"""The reader of the donated outputs the step copies into its graph's
slots (``metrics/step.slot_copies_per_scan.py``) on a recorder filled by
hand: its mean over the window's facade step calls, the calls it leaves
out, and a program whose launches carry no count."""

import sys

import pytest

from port_bench.tests.test_pb_program_spans import ctx, span

READER = "step.slot_copies_per_scan"


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
    """A facade call whose step's replay carries ``attr`` on its launch
    (under a capture span on a first call, as ``utils/graphs.py`` nests
    it)."""
    fi = span(tracing, "facade.integrate", at, 2.0, scan=tracing.new_scan(),
              attr=tracing.PROFILED if profiled else 0)
    sc = span(tracing, "step.call", at + 1e-4, 1.0, parent=fi)
    if capture:
        sc = span(tracing, "step.capture", at + 2e-4, 0.9, parent=sc)
    span(tracing, "step.copy_in", at + 3e-4, 0.1, parent=sc)
    span(tracing, "step.launch", at + 4e-4, 0.1, parent=sc, attr=attr)


def test_mean_over_the_windows_facade_calls(tracing):
    from fastdem_tpu_torch.utils import graphs

    MARK = graphs.SLOT_COPIES
    call(tracing, -0.5, MARK | 50)  # before the window
    call(tracing, 1.0, MARK | 12, capture=True)
    for at in (2.0, 3.0, 4.0):
        call(tracing, at, MARK | 11)
    call(tracing, 5.0, MARK | 0)
    call(tracing, 7.5, MARK | 40)  # in the traced sub-window
    # A step call outside the facade (the chain's graph) is left out.
    chain = span(tracing, "pp.chain", 3.5, 5.0)
    sc = span(tracing, "step.call", 3.5, 1.0, parent=chain)
    span(tracing, "step.launch", 3.5, 0.1, parent=sc, attr=MARK | 30)
    assert read() == pytest.approx((12 + 3 * 11 + 0) / 5)


def test_a_step_written_in_place_reads_0(tracing):
    from fastdem_tpu_torch.utils import graphs

    for at in (1.0, 2.0):
        call(tracing, at, graphs.SLOT_COPIES)
    assert read() == 0.0


def test_the_window_ends_at_the_first_span_the_profiler_slowed(tracing):
    from fastdem_tpu_torch.utils import graphs

    call(tracing, 1.0, graphs.SLOT_COPIES | 4)
    call(tracing, 2.0, graphs.SLOT_COPIES | 2)
    call(tracing, 3.0, graphs.SLOT_COPIES | 9 | tracing.PROFILED, profiled=True)
    assert read() == pytest.approx(3.0)


def test_launches_without_the_count_read_none(tracing):
    """A program that marks no count (the facade's calls replay, their
    launches carry 0), and one with no facade call."""
    for at in (1.0, 2.0):
        call(tracing, at, 0)
    assert read() is None
    tracing.reset()
    span(tracing, "pp.chain", 1.0, 2.0)
    assert read() is None


def test_a_program_without_the_mark_reads_none(monkeypatch):
    from fastdem_tpu_torch.utils import graphs, tracing

    tracing.reset()
    call(tracing, 1.0, 0)
    monkeypatch.delattr(graphs, "SLOT_COPIES")
    assert read() is None
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "fastdem_tpu_torch.utils.tracing", None)
    import fastdem_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    assert read() is None
    tracing.reset()
