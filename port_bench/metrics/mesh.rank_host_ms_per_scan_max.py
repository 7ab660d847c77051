"""Mean of the program's ``facade.integrate`` spans (the host's time in
``FastDEM.integrate``) per scan in the window before the traced
sub-window, on the slowest rank of a mesh: the host path of each rank,
with the contention of the mesh's processes for one host."""

from port_bench.harness import mesh
from port_bench.harness.stats import per_item


def read(ctx):
    def per_rank(tab, t0, t1):
        rows = tab.select("facade.integrate", t0, t1)
        return per_item(float(tab.durations_ms(rows).sum()), len(rows))

    return mesh.slowest(ctx, per_rank)
