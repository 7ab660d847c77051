"""Milliseconds a second the process spent in the cyclic collector: the
program's ``host.gc`` spans (``utils/tracing.py``, from ``gc.callbacks``)
that started in the window before the traced sub-window (or before the
first span the profiler slowed, if earlier), over its length."""

from port_bench.harness import runs


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import tracing
    except ImportError:
        return None  # a program without the recorder
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "host.gc_ms_per_s")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    if t1 <= t0:
        return None
    return float(tab.durations_ms(tab.select("host.gc", t0, t1)).sum()) / (t1 - t0)
