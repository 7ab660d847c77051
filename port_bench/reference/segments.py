"""Segmented-array primitives over a sorted key array (port of
``fastdem_tpu/ops/segments.py``), for the sort-based rasterizer
(``mapping/rasterize.py::rasterize``).

"Reduce by key into a dense table" as: sort by key (stable ``torch.sort``),
then head flags, segmented scans and a ``searchsorted`` per dense key.

Key layout convention: arrays sorted ascending by (invalid, key, ...);
invalid entries sort to the tail with key = num_keys.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def segment_heads(keys_sorted: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Boolean head flag per sorted position (first element of its run)."""
    changed = keys_sorted != torch.roll(keys_sorted, 1)
    changed[:1].fill_(True)
    return valid_sorted & changed


def segmented_scan(
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    values: torch.Tensor,
    heads: torch.Tensor,
    reverse: bool = False,
) -> torch.Tensor:
    """Inclusive segmented scan: out[i] is the ``op``-reduction of
    ``values`` over the run holding i, from the run's start up to i (or
    from i to the run's end when ``reverse``).

    A log-depth scan over (value, head) pairs: the reference's associative
    scan groups its operands another way, so the results are the same for
    an ``op`` that is exact (min, max). Invalid tail positions carry no
    head, so in ``reverse`` mode they flow into the last valid run: fill
    them with the op's identity first (e.g. -inf for max)."""
    if reverse:
        tails = torch.roll(heads, -1)
        tails[-1:].fill_(True)
        return segmented_scan(op, values.flip(0), tails.flip(0)).flip(0)
    v, f = values, heads
    d = 1
    while d < v.shape[0]:
        # (a, fa) . (b, fb) = (fb ? b : op(a, b), fa | fb), a = position i - d.
        comb = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        v = torch.cat([v[:d], comb])
        f = torch.cat([f[:d], f[:-d] | f[d:]])
        d *= 2
    return v


def dense_lookup(
    keys_sorted: torch.Tensor, num_keys: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-dense-key positions into the sorted array: (left, right, hit),
    the [num_keys] searchsorted bounds of each key's run and whether the
    key is present."""
    queries = torch.arange(num_keys, dtype=keys_sorted.dtype, device=keys_sorted.device)
    left = torch.searchsorted(keys_sorted, queries, side="left")
    right = torch.searchsorted(keys_sorted, queries, side="right")
    return left, right, right > left


def gather_at(values_sorted: torch.Tensor, pos: torch.Tensor, hit: torch.Tensor,
              fill=float("nan")) -> torch.Tensor:
    """values_sorted[pos] where hit, else fill."""
    n = values_sorted.shape[0]
    return torch.where(hit, values_sorted[torch.clamp(pos, 0, n - 1)], fill)
