"""Median of the host time from a scan's due time to the facade's
``on_preprocessed`` callback (queue wait, staging, the lock, the facade's
host part and the step's enqueue), over the window's scans before the
traced sub-window: the host's part of the median latency."""

from port_bench.harness.stats import percentile


def read(ctx):
    return percentile(ctx.run.samples.get("enqueue_ms", []), 50)
