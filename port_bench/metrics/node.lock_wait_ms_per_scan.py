"""Mean over scans of the intake thread's ``node.lock_wait`` span
(``utils/tracing.py``): from letting the waiting readers in until the
driver's lock is held, for the scans of the window before the traced
sub-window (or before the first span the profiler slowed, if earlier).
The timers' waits carry no scan id and are left out."""

from port_bench.harness import runs
from port_bench.harness.stats import per_item


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import tracing
    except ImportError:
        return None  # a program without the recorder
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "node.lock_wait_ms_per_scan")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    rows = tab.select("node.lock_wait", t0, t1)
    rows = rows[tab.scan[rows] > 0]
    return per_item(float(tab.durations_ms(rows).sum()), len(rows))
