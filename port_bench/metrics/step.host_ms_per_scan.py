"""Mean host time of the facade's step call, the program's ``step.call``
span under ``facade.integrate`` (``utils/tracing.py``: slot copy-in, graph
launch, clone-out and the call's own work), over the scans of the window
before the traced sub-window (or before the first span the profiler
slowed, if earlier)."""

from port_bench.harness import runs
from port_bench.harness.stats import per_item


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import tracing
    except ImportError:
        return None  # a program without the recorder
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "step.host_ms_per_scan")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    rows = tab.select("step.call", t0, t1)
    rows = rows[tab.parent_name_ids(rows) == tab.id_of("facade.integrate")]
    return per_item(float(tab.durations_ms(rows).sum()), len(rows))
