"""Mean of the program's ``mesh.sync.device`` spans
(``parallel/distributed.py::CallSync``: between CUDA events recorded on the
stream just before and just after a call's all-reduce, so the collective
alone, which waits there for the slowest rank's card), per call in the
window before the traced sub-window, on the rank that waits longest: the
imbalance between the cards of a mesh."""

from port_bench.harness import mesh
from port_bench.harness.stats import per_item


def read(ctx):
    def per_rank(tab, t0, t1):
        rows = tab.select("mesh.sync.device", t0, t1)
        return per_item(float(tab.durations_ms(rows).sum()), len(rows))

    return mesh.slowest(ctx, per_rank)
