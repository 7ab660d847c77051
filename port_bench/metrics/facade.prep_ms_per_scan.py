"""Mean of the program's ``facade.prep`` span (``utils/tracing.py``):
``FastDEM.integrate``'s host work before the step (provider lookups, the
bucket, the copy to the device, the pad, the transforms), over the scans
of the window before the traced sub-window (or before the first span the
profiler slowed, if earlier)."""

from port_bench.harness import runs
from port_bench.harness.stats import per_item


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import tracing
    except ImportError:
        return None  # a program without the recorder
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "facade.prep_ms_per_scan")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    rows = tab.select("facade.prep", t0, t1)
    return per_item(float(tab.durations_ms(rows).sum()), len(rows))
