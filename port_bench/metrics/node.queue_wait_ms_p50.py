"""Median of the program's ``node.queue`` spans (``utils/tracing.py``): a
scan's wait from ``MappingDriver.on_scan`` until the intake thread takes
it, over the scans queued in the window before the traced sub-window (or
before the first span the profiler slowed, if earlier)."""

from port_bench.harness import runs
from port_bench.harness.stats import percentile


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import tracing
    except ImportError:
        return None  # a program without the recorder
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "node.queue_wait_ms_p50")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    return percentile(tab.durations_ms(tab.select("node.queue", t0, t1)), 50)
