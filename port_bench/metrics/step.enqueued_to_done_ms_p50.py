"""Median of the time from the facade's ``on_preprocessed`` callback (the
step just enqueued) to the completion on the device of the scan's map
update, over the window's scans before the traced sub-window: the device's
part of the median latency, the step's run and any device work queued
ahead of it."""

from port_bench.harness.stats import percentile


def read(ctx):
    return percentile(ctx.run.samples.get("enqueued_to_done_ms", []), 50)
