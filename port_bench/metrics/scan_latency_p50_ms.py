"""Median, over every scan due in the window, of the time from the scan's
due time to the completion on the device of its map update (a CUDA event
recorded in the facade's ``on_preprocessed`` callback, read on the host's
clock); a scan that never completed counts with the time until the
harness gave up on it."""

from port_bench.harness.stats import percentile


def read(ctx):
    return percentile(ctx.run.samples.get("scan_latency_ms", []), 50)
