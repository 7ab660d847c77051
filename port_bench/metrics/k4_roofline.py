"""K4's share of its roofline: one read of the field per cell (the exact
window) over the map's cells, bound by ``bounds.k4_lookup_bound``, over the
device time of one launch (``lookup_kernel``) in the traced sub-window."""

from port_bench.harness import bounds


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    launches, seconds = t.kernel_time("lookup_kernel")
    if launches == 0 or seconds <= 0:
        return None
    bound_ms, _ = bounds.k4_lookup_bound(ctx.geom.num_cells, 1)
    return 100.0 * bound_ms * launches / (seconds * 1e3)
