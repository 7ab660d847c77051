"""Device kernel ms per scan in the traced sub-window (the step's graph
kernels; copies and fills excluded)."""

from port_bench.harness.stats import per_item


def read(ctx):
    t = ctx.trace
    if t is None or not t.scans:
        return None
    ms = sum(s for name, (c, s) in t.kernels.items()
             if not name.startswith(("Memcpy", "Memset"))) * 1e3
    return per_item(ms, t.scans)
