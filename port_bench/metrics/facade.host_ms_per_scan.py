"""Host ms per scan inside ``FastDEM.integrate`` (a harness span around the
mapper's call), over the window's scans before the traced sub-window."""

from port_bench.harness.stats import per_item


def read(ctx):
    s = ctx.run.samples.get("facade_host_ms", [])
    return per_item(sum(s), len(s))
