"""100 x (1 - the union of device activity over the traced span): the
device's idle share in the traced sub-window, read from the trace alone.

The profiler records every kernel of every graph replay, and that slows a
closed loop's host: the replay loop runs at about half its untraced rate
while it is traced, so in a replay cell this reads the traced loop. The
result's info line gives the scans per second of both parts of the window."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
