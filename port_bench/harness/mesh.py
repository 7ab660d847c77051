"""What the ``mesh.*`` readers share: every rank's span table and reduced
device trace from the ``mesh_replay`` loop (``Run.rank_tables`` and
``Run.rank_traces``, rank 0's first), and the slowest rank's value.

A span table is read over the window before the traced sub-window. One
``perf_counter`` clock serves every process of a host, so rank 0's window
bounds select the other ranks' spans. None where a run has no such tables
(another loop, or a program without the recorder), or where a rank's ring
came round past the window's start or holds no span to read; likewise
where a rank has no trace (an untraced run, or no card)."""

from __future__ import annotations

from typing import Callable, Optional

from . import runs


def _largest(per_rank, values) -> Optional[float]:
    got = []
    for v in values:
        r = per_rank(v)
        if r is None:
            return None
        got.append(r)
    return max(got) if got else None


def slowest(ctx, per_rank: Callable) -> Optional[float]:
    """The largest of ``per_rank(table, t0, t1)`` over the ranks."""
    tables = getattr(ctx.run, "rank_tables", None)
    if not tables:
        return None
    t0 = ctx.run.setup_end
    t1 = tables[0].until_profiled(t0, t0 + runs.trace_start(ctx.traffic, ctx.run.window_s))
    return _largest(lambda tab: per_rank(tab, t0, t1) if len(tab) and tab.covers(t0) else None,
                    tables)


def slowest_trace(ctx, per_rank: Callable) -> Optional[float]:
    """The largest of ``per_rank(trace)`` over the ranks' reduced traces."""
    traces = getattr(ctx.run, "rank_traces", None)
    if not traces:
        return None
    return _largest(lambda t: per_rank(t) if t is not None and t.scans else None, traces)
