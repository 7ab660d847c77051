"""K1's share of its roofline: the least time the card could take for one
launch (``bounds.k1_bound``: the field's bytes over HBM's rate, or its
operations over the float32 rate) over the device time of one launch
(its column and row kernels) in the traced sub-window."""

import math

from port_bench.harness import bounds
from port_bench.reference import raycasting as rc
from port_bench.reference.config import parse_config
from port_bench.reference.step import build_step


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    launches, _ = t.kernel_time("polar_row_kernel")
    _, seconds = t.kernel_time("polar_column_kernel", "polar_row_kernel")
    if launches == 0 or seconds <= 0:
        return None
    cfg = parse_config(ctx.config["node"])
    geom = ctx.geom
    A = int(cfg.raycasting.num_azimuth_bins)
    rbf = float(cfg.raycasting.range_bin_factor)
    max_range = build_step(geom, cfg).ray_max_range
    _, R, _ = rc.polar_dims(geom, A, rbf, max_range)
    win = rc.column_windows(geom, A, rbf, max_range, "cpu")
    nfold = max(1, int(math.ceil(1.0 / rbf)))
    bound_ms, _ = bounds.k1_bound(R, A, nfold, win.lvl.numpy(), win.shift.numpy(), True)
    return 100.0 * bound_ms * launches / (seconds * 1e3)
