"""Scans integrated in the window over the window's length (the window
closes after a device synchronisation)."""

from port_bench.harness.stats import rate


def read(ctx):
    if "scans" not in ctx.run.counts:
        return None
    return rate(int(ctx.run.counts["scans"]), ctx.run.window_s)
