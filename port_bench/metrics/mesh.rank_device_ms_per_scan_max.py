"""Device kernel ms per scan in each rank's traced sub-window of a mesh
(``torch.profiler`` on every rank; the kernels that
``step.device_ms_per_scan`` sums on one card, less the NCCL collective,
whose time is its wait for the other cards), on the slowest rank: each
card's part of a scan, the shared part that every card repeats included."""

from port_bench.harness import mesh
from port_bench.harness.stats import per_item


def read(ctx):
    def per_rank(t):
        ms = sum(s for name, (c, s) in t.kernels.items()
                 if not name.startswith(("Memcpy", "Memset")) and "nccl" not in name.lower())
        return per_item(ms * 1e3, t.scans)

    return mesh.slowest_trace(ctx, per_rank)
