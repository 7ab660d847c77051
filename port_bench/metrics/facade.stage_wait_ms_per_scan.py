"""Host ms per scan that ``FastDEM.integrate`` waits for a staging buffer
still in flight: the program's ``facade.stage_wait`` spans
(``mapping/staging.py``, inside ``facade.prep``) summed over the window
before the traced sub-window (or before the first span the profiler
slowed, if earlier), over the ``facade.integrate`` spans of the same
window. None for a program whose facade has no staging ring."""

from port_bench.harness import runs
from port_bench.harness.stats import per_item


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import tracing
    except ImportError:
        return None  # a program without the recorder
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "facade.stage_wait_ms_per_scan")
    if tab is None or tab.id_of("facade.stage_wait") < 0:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    waits = tab.select("facade.stage_wait", t0, t1)
    return per_item(float(tab.durations_ms(waits).sum()),
                    len(tab.select("facade.integrate", t0, t1)))
