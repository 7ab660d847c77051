"""Device allocations of the caching allocator per 1,000 scans: the
change of the program's ``step.device_allocs`` readings
(``utils/tracing.py``, ``num_device_alloc`` read every 64 step calls)
between the first and the last reading of the window before the traced
sub-window (or before the first span the profiler slowed, if earlier),
over the facade's step calls between those two readings."""

from port_bench.harness import runs


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import tracing
    except ImportError:
        return None  # a program without the recorder
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "step.device_allocs_per_1k_scans")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    marks = tab.select("step.device_allocs", t0, t1)
    if len(marks) < 2:
        return None
    a, b = marks[0], marks[-1]
    calls = tab.select("step.call", tab.start[a] * 1e-9, tab.start[b] * 1e-9)
    calls = calls[tab.parent_name_ids(calls) == tab.id_of("facade.integrate")]
    if not len(calls):
        return None
    return float(tab.attr[b] - tab.attr[a]) * 1e3 / len(calls)
