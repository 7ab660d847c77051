"""Donated outputs the facade's step copies into its graph's slots, a
scan: the mean, over the ``step.call`` spans under ``facade.integrate`` in
the window before the traced sub-window (or before the first span the
profiler slowed, if earlier), of the count that the call's replay carries
in its ``step.launch`` span's ``attr`` beside ``graphs.SLOT_COPIES`` (a
first call's replay sits under its ``step.capture``). 0 where the step
writes its whole state in place. None for a program whose launches carry
no such count."""

import numpy as np

from port_bench.harness import runs
from port_bench.harness.stats import per_item


def read(ctx):
    try:
        from fastdem_tpu_torch.utils import graphs, tracing
    except ImportError:
        return None  # a program without the recorder
    mark = getattr(graphs, "SLOT_COPIES", None)
    if mark is None:
        return None
    t0 = ctx.run.setup_end
    tab = tracing.table_since(t0, "step.slot_copies_per_scan")
    if tab is None:
        return None
    t1 = tab.until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    calls = tab.select("step.call", t0, t1)
    calls = calls[tab.parent_name_ids(calls) == tab.id_of("facade.integrate")]
    launches = tab.select("step.launch", t0, t1)
    launches = launches[(tab.attr[launches] & mark) != 0]
    owner = tab.parent[launches]
    i = np.clip(np.searchsorted(tab.seq, owner), 0, len(tab) - 1)
    captured = (tab.seq[i] == owner) & (tab.name[i] == tab.id_of("step.capture"))
    owner = np.where(captured, tab.parent[i], owner)
    mine = np.isin(owner, tab.seq[calls])
    copies = tab.attr[launches[mine]] & (mark - 1)
    return per_item(float(copies.sum()), int(np.isin(tab.seq[calls], owner[mine]).sum()))
