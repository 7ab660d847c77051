"""Share of the facade's step calls whose donated map came in as the
graph's own slots, so that nothing of it was copied in: 100 x the
``step.call`` spans under ``facade.integrate`` with a ``step.copy_in`` child
marked ``graphs.STATE_IN_PLACE`` in its ``attr``, over all those calls, in
the window before the traced sub-window (or before the first span the
profiler slowed, if earlier). None for a program whose step marks no
copy-in (one without a donating facade)."""

import numpy as np

from port_bench.harness import runs
from port_bench.harness.stats import per_item


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import graphs, tracing
    except ImportError:
        return None  # a program without the recorder
    flag = getattr(graphs, "STATE_IN_PLACE", None)
    if flag is None:
        return None
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "step.state_in_place_pct")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    calls = tab.select("step.call", t0, t1)
    calls = calls[tab.parent_name_ids(calls) == tab.id_of("facade.integrate")]
    copies = tab.select("step.copy_in", t0, t1)
    in_place = copies[(tab.attr[copies] & flag) != 0]
    n = int(np.isin(tab.seq[calls], tab.parent[in_place]).sum())
    return per_item(100.0 * n, len(calls))
