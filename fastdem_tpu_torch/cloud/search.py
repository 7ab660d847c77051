"""Spatial neighbour search: brute-force tiles, a CSR voxel grid with an
exactness certificate, and voxel buckets (port of
``fastdem_tpu/cloud/search.py``, re-derived for the GPU).

  * brute (``knn_brute``, ``radius_*_brute``): query x data tiles of
    direct-difference distances with a running top-k; exact at any N.
  * grid (``DenseGrid``, ``knn_grid``, ``radius_search_grid``): points
    sorted by cell key with CSR starts; each query gathers the nine
    z-columns of its 3x3x3 neighbourhood (three cells each, one
    contiguous span of the sorted cloud). A query's result is certified
    exact when no column span overflowed its cap and the kth distance is
    at most one bucket side (every point outside the neighbourhood is
    farther); the queries that fail take the brute tile, so the result is
    exact at any N.
  * bucket (``BucketGrid``): up to ``per_bucket`` candidates from each of
    the 27 neighbouring buckets; approximate, for callers that opt in.

Every query returns fixed-shape (indices, distances), padded with index -1
and distance +inf. Distances are ``sqrt(fma(dz, dz, fma(dy, dy, dx*dx)))``
of the direct differences, the reference's compiled form, so the grid and
the brute paths agree bit for bit. Ties in distance go to the lowest point
index: candidates are ranked by one int64 key (distance bits, index), so
the order does not depend on how a device breaks ties in a top-k.

A function given tensors runs on their device; given numpy arrays it makes
its tensors on ``device``, the card unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.grid.geometry import floor_i32
from fastdem_tpu_torch.numerics import div_f32, sqrt_f32, sum_sq

_INF = float("inf")
_I32_MAX = 2**31 - 1
_NO_KEY = 0x7F800000 << 32  # the key of (+inf, 0): no candidate

_NEIGHBOR_OFFSETS = [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]

# Self-kNN point count above which method="auto" takes the grid path.
_GRID_CROSSOVER = 32768
# knn_grid: grid passes before the brute tile, the bucket's growth between
# them, the largest column cap, and the cell budget of its geometry (the
# keys are int64 and no table scales with the cell count).
_GRID_PASSES = 4
_GRID_GROWTH = 2.0
_GRID_CAP_MAX = 1024
_GRID_MAX_CELLS = 2**60

# Bytes one candidate tile may take: ~1 GB on the card, less on the CPU.
_TILE_BYTES = {"cuda": 1 << 30, "cpu": 1 << 26}
# Bytes per candidate a tile's passes hold at once (coordinates,
# differences, the float64 FMA steps, keys).
_BYTES_PER_CAND = 96


def _rows_per_tile(lanes: int, device: torch.device) -> int:
    budget = _TILE_BYTES.get(device.type, _TILE_BYTES["cpu"])
    return max(1, budget // max(1, lanes * _BYTES_PER_CAND))


def _as_tensors(xyz, mask, device):
    """(xyz f32 [N, 3], mask bool [N]) as tensors on one device: the
    tensors' own, or ``device`` (default the card) for host arrays."""
    if isinstance(xyz, torch.Tensor) and device is None:
        dev = xyz.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    return xyz, mask


def _pack(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 key ordering (d2, idx): d2 >= 0 (or +inf), whose f32 bits
    order as integers; idx in [0, 2^31)."""
    return (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def _unpack(key: torch.Tensor):
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    idx = (key & 0xFFFFFFFF).to(torch.int32)
    return d2, idx


def _smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys of each row, ascending (keys are unique per
    row, so the result does not depend on the device's tie order)."""
    return torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False, sorted=True).values


def _finish(keys: torch.Tensor, k: int):
    """Sorted keys [Q, k'] -> (idx i32 [Q, k], dist f32 [Q, k]) with -1 /
    +inf padding."""
    d2, idx = _unpack(keys)
    idx = torch.where(torch.isfinite(d2), idx, -1)
    if d2.shape[1] < k:
        pad = k - d2.shape[1]
        d2 = torch.cat([d2, torch.full((d2.shape[0], pad), _INF, device=d2.device)], 1)
        idx = torch.cat([idx, torch.full((idx.shape[0], pad), -1, dtype=torch.int32,
                                         device=idx.device)], 1)
    return idx, sqrt_f32(d2)


def _self_ids(nq, queries, exclude_self, self_indices, dev):
    if not exclude_self:
        return None
    if self_indices is not None:
        return torch.as_tensor(self_indices, device=dev).to(torch.int64)
    if queries is None:
        return torch.arange(nq, device=dev)
    return None


def _brute_tiles(xyz, mask, q, sid, chunk, data_chunk):
    """Yield (q0, q1, d0, d1, d2 tile, ok tile) over query x data tiles;
    excluded pairs (masked data, self) are +inf in d2 and False in ok."""
    n, nq, dev = xyz.shape[0], q.shape[0], xyz.device
    for q0 in range(0, nq, chunk):
        q1 = min(nq, q0 + chunk)
        qq = q[q0:q1]
        for d0 in range(0, n, data_chunk):
            d1 = min(n, d0 + data_chunk)
            d2 = sum_sq(xyz[None, d0:d1] - qq[:, None])
            ok = mask[None, d0:d1].expand(q1 - q0, -1)
            if sid is not None:
                cols = torch.arange(d0, d1, device=dev)
                ok = ok & (cols[None, :] != sid[q0:q1, None])
            yield q0, q1, d0, d1, torch.where(ok, d2, _INF), ok


def _tile_shape(n, nq, lanes, dev, chunk, data_chunk):
    if data_chunk is None:
        data_chunk = min(n, 16384 if dev.type == "cuda" else 8192)
    data_chunk = max(1, data_chunk)
    if chunk is None:
        chunk = _rows_per_tile(data_chunk + lanes, dev)
    return max(1, min(chunk, max(nq, 1))), data_chunk


def knn_brute(
    xyz,
    mask,
    k: int,
    queries=None,
    exclude_self: bool = True,
    chunk: Optional[int] = None,
    data_chunk: Optional[int] = None,
    self_indices=None,
    *,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN at any N: query x data tiles with a running top-k.

    Returns (idx i32[Q, k], dist f32[Q, k]); padding idx=-1, dist=inf."""
    xyz, mask = _as_tensors(xyz, mask, device)
    dev = xyz.device
    q = xyz if queries is None else torch.as_tensor(queries, dtype=torch.float32, device=dev)
    n, nq = xyz.shape[0], q.shape[0]
    sid = _self_ids(nq, queries, exclude_self, self_indices, dev)
    chunk, data_chunk = _tile_shape(n, nq, k, dev, chunk, data_chunk)
    out = torch.empty((nq, min(k, n)), dtype=torch.int64, device=dev)
    best = None
    for q0, q1, d0, d1, d2, _ in _brute_tiles(xyz, mask, q, sid, chunk, data_chunk):
        keys = _pack(d2, torch.arange(d0, d1, device=dev).expand(q1 - q0, -1))
        best = keys if d0 == 0 else torch.cat([best, keys], 1)
        best = _smallest(best, k)
        if d1 == n:
            out[q0:q1] = best
    return _finish(out, k)


def radius_count_brute(
    xyz,
    mask,
    radius: float,
    queries=None,
    exclude_self: bool = True,
    chunk: Optional[int] = None,
    data_chunk: Optional[int] = None,
    *,
    device=None,
) -> torch.Tensor:
    """Exact within-radius neighbour counts i32[Q] at any N."""
    xyz, mask = _as_tensors(xyz, mask, device)
    dev = xyz.device
    q = xyz if queries is None else torch.as_tensor(queries, dtype=torch.float32, device=dev)
    nq = q.shape[0]
    r2 = float(np.float32(radius * radius))
    sid = _self_ids(nq, queries, exclude_self, None, dev)
    chunk, data_chunk = _tile_shape(xyz.shape[0], nq, 0, dev, chunk, data_chunk)
    cnt = torch.zeros(nq, dtype=torch.int32, device=dev)
    for q0, q1, _, _, d2, ok in _brute_tiles(xyz, mask, q, sid, chunk, data_chunk):
        cnt[q0:q1] += (ok & (d2 <= r2)).sum(dim=1).to(torch.int32)
    return cnt


def radius_search_brute(
    xyz,
    mask,
    radius: float,
    max_neighbors: int,
    queries=None,
    exclude_self: bool = True,
    chunk: Optional[int] = None,
    data_chunk: Optional[int] = None,
    self_indices=None,
    *,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact radius neighbour sets at any N: the ``max_neighbors`` closest
    in-radius points per query, ascending, padded with -1 / inf, and the
    exact in-radius count (a count above the cap shows truncation).

    Returns (idx i32[Q, max_neighbors], dist f32[Q, max_neighbors],
    count i32[Q])."""
    xyz, mask = _as_tensors(xyz, mask, device)
    dev = xyz.device
    q = xyz if queries is None else torch.as_tensor(queries, dtype=torch.float32, device=dev)
    n, nq = xyz.shape[0], q.shape[0]
    r2 = float(np.float32(radius * radius))
    sid = _self_ids(nq, queries, exclude_self, self_indices, dev)
    chunk, data_chunk = _tile_shape(n, nq, max_neighbors, dev, chunk, data_chunk)
    out = torch.empty((nq, min(max_neighbors, n)), dtype=torch.int64, device=dev)
    cnt = torch.zeros(nq, dtype=torch.int32, device=dev)
    best = None
    for q0, q1, d0, d1, d2, ok in _brute_tiles(xyz, mask, q, sid, chunk, data_chunk):
        inr = ok & (d2 <= r2)
        cnt[q0:q1] += inr.sum(dim=1).to(torch.int32)
        keys = _pack(torch.where(inr, d2, _INF),
                     torch.arange(d0, d1, device=dev).expand(q1 - q0, -1))
        best = keys if d0 == 0 else torch.cat([best, keys], 1)
        best = _smallest(best, max_neighbors)
        if d1 == n:
            out[q0:q1] = best
    idx, dist = _finish(out, max_neighbors)
    return idx, dist, cnt


class BucketGrid:
    """Sorted voxel-bucket index over a fixed cloud (approximate search).

    Bucket keys linearize coordinates clipped to [0, 1023] per axis around
    the cloud's bounding box; points sort by key (stable, so a bucket's
    points keep their index order) and each query reads up to
    ``per_bucket`` points of each of its 27 neighbouring buckets.
    """

    _B = 1024

    def __init__(self, xyz, mask, bucket_size: float, *, device=None):
        xyz, mask = _as_tensors(xyz, mask, device)
        self.xyz, self.mask = xyz, mask
        self.bucket_size = float(bucket_size)
        mins = torch.where(mask[:, None], xyz, _INF).amin(dim=0)
        self.origin = torch.where(torch.isfinite(mins), mins, 0.0) - self.bucket_size
        key = self._key(self._coords(xyz))
        key = torch.where(mask, key, _I32_MAX)
        self.sorted_key, order = torch.sort(key, stable=True)
        self.order = order.to(torch.int32)
        self.sorted_xyz = xyz[order]

    def _coords(self, p: torch.Tensor) -> torch.Tensor:
        c = floor_i32(div_f32(p - self.origin, self.bucket_size))
        return torch.clamp(c, 0, self._B - 1)

    def _key(self, c: torch.Tensor) -> torch.Tensor:
        return (c[..., 0] * self._B + c[..., 1]) * self._B + c[..., 2]

    def candidates(self, queries, per_bucket: int = 8):
        """Candidate point indices from the 27 neighbouring buckets, bucket
        by bucket, ``per_bucket`` slots each.

        Returns (cand_idx i32[Q, 27*M] into the original cloud, valid)."""
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.xyz.device)
        dev = queries.device
        n = self.sorted_key.shape[0]
        off = torch.tensor(_NEIGHBOR_OFFSETS, dtype=torch.int32, device=dev)
        nb = self._coords(queries)[:, None, :] + off[None]  # [Q, 27, 3]
        ok = ((nb >= 0) & (nb < self._B)).all(dim=-1)
        key = self._key(nb).contiguous()
        start = torch.searchsorted(self.sorted_key, key, right=False)
        end = torch.searchsorted(self.sorted_key, key, right=True)
        pos = start[..., None] + torch.arange(per_bucket, device=dev)  # [Q, 27, M]
        valid = ok[..., None] & (pos < end[..., None])
        cand = torch.where(valid, self.order[pos.clamp(0, n - 1)], -1)
        q = queries.shape[0]
        return cand.reshape(q, -1), valid.reshape(q, -1)

    def _cand_d2(self, queries, per_bucket):
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.xyz.device)
        cand, valid = self.candidates(queries, per_bucket)
        diff = self.xyz[cand.clamp_min(0).long()] - queries[:, None, :]
        sq = diff * diff
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        return cand, valid, d2

    def knn(self, queries, k: int, per_bucket: int = 8, exclude_self_idx=None):
        cand, valid, d2 = self._cand_d2(queries, per_bucket)
        d2 = torch.where(valid, d2, _INF)
        if exclude_self_idx is not None:
            ex = torch.as_tensor(exclude_self_idx, device=cand.device)
            d2 = torch.where(cand == ex[:, None], _INF, d2)
        # Ties go to the lowest lane (bucket, then slot), as the
        # reference's k argmin passes do.
        lanes = torch.arange(d2.shape[1], device=d2.device).expand_as(d2)
        d2k, lane = _unpack(_smallest(_pack(d2, lanes), k))
        idx = torch.gather(cand, 1, lane.long()).clamp_min(0)
        return _finish(_pack(d2k, idx), k)

    def radius_count(self, queries, radius: float, per_bucket: int = 8,
                     exclude_self_idx=None) -> torch.Tensor:
        """Points within ``radius`` (exact when bucket_size >= radius and no
        bucket holds more than ``per_bucket`` points)."""
        cand, valid, d2 = self._cand_d2(queries, per_bucket)
        ok = valid & (d2 <= float(np.float32(radius * radius)))
        if exclude_self_idx is not None:
            ex = torch.as_tensor(exclude_self_idx, device=cand.device)
            ok = ok & (cand != ex[:, None])
        return ok.sum(dim=1).to(torch.int32)


class DenseGrid:
    """CSR voxel grid for exact kNN (build once, query many).

    Tight dims from the masked bounding box with a one-bucket empty margin
    on every side; points sorted by their (x, y, z) cell key (int64), z
    fastest. A cell's first sorted position is a binary search of the
    sorted keys, the CSR start without a table the size of the grid. A
    z-column of three cells is one contiguous span ``[start(key - 1),
    start(key + 2))``, so a query's 27-cell neighbourhood is nine spans of
    the sorted cloud, gathered per query (gathers are native on the GPU).
    """

    def __init__(
        self,
        xyz,
        mask,
        bucket_size: float,
        max_cells: int = 4_000_000,
        dims: Optional[Tuple[int, int, int]] = None,
        origin=None,
        *,
        device=None,
    ):
        xyz, mask = _as_tensors(xyz, mask, device)
        self.xyz, self.mask = xyz, mask
        dev = xyz.device
        n = xyz.shape[0]
        if dims is None or origin is None:
            bucket_size, dims, origin = _grid_geometry(xyz, mask, bucket_size, max_cells)
        self.bucket_size = float(bucket_size)
        self.origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
        self.dims = tuple(int(d) for d in dims)
        self.ncells = self.dims[0] * self.dims[1] * self.dims[2]
        key = torch.where(mask, self._key(self._coords(xyz)), self.ncells)
        self.sorted_key, order = torch.sort(key, stable=True)
        self.order = order.to(torch.int32)
        self.sorted_xyz = xyz[order]
        # Original index -> sorted position (self-exclusion).
        self.inv_order = torch.empty(n, dtype=torch.int64, device=dev)
        self.inv_order[order] = torch.arange(n, device=dev)

    def _coords(self, p: torch.Tensor) -> torch.Tensor:
        c = floor_i32(div_f32(p - self.origin, self.bucket_size))
        hi = torch.tensor(self.dims, dtype=torch.int32, device=p.device) - 2
        return torch.minimum(torch.clamp_min(c, 1), hi)

    def _key(self, c: torch.Tensor) -> torch.Tensor:
        _, ny, nz = self.dims
        c = c.to(torch.int64)
        return (c[..., 0] * ny + c[..., 1]) * nz + c[..., 2]

    def _start(self, key: torch.Tensor) -> torch.Tensor:
        """First sorted position of each cell key (= points with a smaller
        key): a binary search of the sorted keys, so no table scales with
        the grid's cell count."""
        return torch.searchsorted(self.sorted_key, key.contiguous())

    def occupancy_max(self) -> int:
        """The most points any cell holds (one read to the host)."""
        valid = self.sorted_key[self.sorted_key < self.ncells]
        if valid.numel() == 0:
            return 0
        return int(torch.unique_consecutive(valid, return_counts=True)[1].max())

    def column_cap(self) -> int:
        """The most points in the three-cell z-span around any point's own
        cell (one read to the host): a query's spans rarely hold more."""
        key = self.sorted_key[self.sorted_key < self.ncells]
        if key.numel() == 0:
            return 1
        return int((self._start(key + 2) - self._start(key - 1)).max())

    def _spans(self, qq: torch.Tensor):
        """Start / end sorted positions of the nine column spans around
        each query, i64[B, 9] each."""
        _, ny, nz = self.dims
        base = self._key(self._coords(qq))
        offs = torch.tensor(
            [(dx * ny + dy) * nz - 1 for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
            device=qq.device,
        )
        ck = base[:, None] + offs[None]
        return self._start(ck), self._start(ck + 3)

    def _candidates(self, qq, capc, spos):
        """Sorted positions [B, 9*capc], their d2 (+inf where invalid or
        self) and the per-query overflow flag."""
        n = self.sorted_xyz.shape[0]
        start, end = self._spans(qq)
        pos = start[..., None] + torch.arange(capc, device=qq.device)  # [B, 9, capc]
        valid = pos < end[..., None]
        pos = pos.clamp_max(n - 1).reshape(qq.shape[0], -1)
        valid = valid.reshape(qq.shape[0], -1)
        if spos is not None:
            valid = valid & (pos != spos[:, None])
        d2 = sum_sq(self.sorted_xyz[pos] - qq[:, None, :])
        overflow = ((end - start) > capc).any(dim=1)
        return pos, torch.where(valid, d2, _INF), overflow

    def knn(
        self,
        queries,
        k: int,
        cap: int = 64,
        self_pos=None,
        chunk: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Candidate-column kNN with an exactness certificate.

        ``self_pos``: per-query sorted position to exclude (``inv_order``
        for self-kNN), or None.

        Returns (idx i32[Q, k], dist f32[Q, k], exact bool[Q]);
        ``exact[i]`` certifies row i is the true kNN."""
        dev = self.xyz.device
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        nq = queries.shape[0]
        n = self.xyz.shape[0]
        capc = max(1, min(cap, n))
        b2 = float(np.float32(self.bucket_size * self.bucket_size))
        if chunk is None:
            chunk = _rows_per_tile(9 * capc, dev)
        kk = min(k, 9 * capc)
        keys = torch.empty((nq, kk), dtype=torch.int64, device=dev)
        exact = torch.empty(nq, dtype=torch.bool, device=dev)
        for q0 in range(0, nq, chunk):
            q1 = min(nq, q0 + chunk)
            sp = None if self_pos is None else torch.as_tensor(self_pos, device=dev)[q0:q1]
            pos, d2, overflow = self._candidates(queries[q0:q1], capc, sp)
            best = _smallest(_pack(d2, self.order[pos]), kk)
            kth = _unpack(best[:, -1])[0]
            keys[q0:q1] = best
            exact[q0:q1] = ~overflow & torch.isfinite(kth) & (kth <= b2)
        idx, dist = _finish(keys, k)
        if kk < k:
            exact = torch.zeros_like(exact)
        return idx, dist, exact

    def knn_uncapped(self, queries, k: int, self_pos=None):
        """``knn`` without a column cap: every point of the nine spans is a
        candidate (the spans are flattened, sorted by (query, distance,
        index) and cut at k), so only the kth-distance condition can fail
        the certificate. For the few sparse queries a capped pass leaves."""
        dev = self.xyz.device
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        nq = queries.shape[0]
        b2 = float(np.float32(self.bucket_size * self.bucket_size))
        start, end = self._spans(queries)
        lens = (end - start).sum(dim=1)
        budget = _TILE_BYTES.get(dev.type, _TILE_BYTES["cpu"]) // _BYTES_PER_CAND
        # Query chunks whose candidates fit the budget (a query alone may
        # exceed it).
        bounds = torch.cumsum(lens, 0).cpu().numpy()
        keys = torch.full((nq, k), _NO_KEY, dtype=torch.int64, device=dev)
        q0 = 0
        while q0 < nq:
            base = bounds[q0 - 1] if q0 else 0
            q1 = max(q0 + 1, int(np.searchsorted(bounds, base + budget, side="right")))
            q1 = min(q1, nq)
            st, en = start[q0:q1].flatten(), end[q0:q1].flatten()
            span_len = en - st
            tot = int(span_len.sum())
            if tot:
                span = torch.repeat_interleave(torch.arange(span_len.numel(), device=dev),
                                               span_len)
                first = torch.cumsum(span_len, 0) - span_len
                pos = st[span] + torch.arange(tot, device=dev) - first[span]
                qid = span // 9
                d2 = sum_sq(self.sorted_xyz[pos] - queries[q0:q1][qid])
                if self_pos is not None:
                    sp = torch.as_tensor(self_pos, device=dev)[q0:q1]
                    d2 = torch.where(pos == sp[qid], _INF, d2)
                key = _pack(d2, self.order[pos])
                order = torch.sort(key).indices
                order = order[torch.sort(qid[order], stable=True).indices]
                qs, ks = qid[order], key[order]
                group_first = torch.cumsum(torch.bincount(qs, minlength=q1 - q0), 0)
                group_first = group_first - torch.bincount(qs, minlength=q1 - q0)
                rank = torch.arange(tot, device=dev) - group_first[qs]
                take = rank < k
                keys[q0 + qs[take], rank[take]] = ks[take]
            q0 = q1
        idx, dist = _finish(keys, k)
        kth = _unpack(keys[:, -1])[0]
        return idx, dist, torch.isfinite(kth) & (kth <= b2)


def _grid_geometry(xyz, mask, bucket_size: float, max_cells: int):
    """Masked bounding box -> (bucket_size, dims, origin): one-bucket
    margin on each side; the bucket grows while the grid would exceed
    ``max_cells`` or an axis 2^30 cells. Only the box's six numbers leave
    the device."""
    if isinstance(xyz, torch.Tensor):
        m = mask[:, None]
        lo_t = torch.where(m, xyz, _INF).amin(dim=0)
        hi_t = torch.where(m, xyz, -_INF).amax(dim=0)
        lo, hi = torch.stack([lo_t, hi_t]).cpu().numpy()
    else:
        pts = np.asarray(xyz, np.float32)[np.asarray(mask)]
        lo, hi = (pts.min(axis=0), pts.max(axis=0)) if len(pts) else (None, None)
    if lo is None or not np.isfinite(lo).all():
        lo = hi = np.zeros(3, np.float32)
    b = float(bucket_size)
    while True:
        dims = np.maximum(np.ceil((hi - lo) / np.float32(b) + np.float32(1e-6)), 1).astype(
            np.int64) + 2
        if int(dims.prod()) <= max_cells and int(dims.max()) <= 2**30:
            break
        b *= 1.5
    return b, tuple(int(d) for d in dims), (lo - np.float32(b)).astype(np.float32)


def _auto_bucket_size(xyz, mask, k: int, sample: int = 512) -> float:
    """Bucket side targeting ~90% certificate hits: brute-kNN a seeded
    sample of the valid points against the whole cloud and take 1.2x the
    90th percentile of the kth-neighbour distances."""
    xyz, mask = _as_tensors(xyz, mask, None if isinstance(xyz, torch.Tensor) else "cuda")
    mask_np = mask.cpu().numpy()
    n_valid = int(mask_np.sum())
    if n_valid <= k + 1:
        return 1.0
    valid_idx = np.nonzero(mask_np)[0]
    rng = np.random.default_rng(0)
    s = min(sample, n_valid)
    sel = valid_idx[rng.choice(n_valid, s, replace=False)]
    sel_t = torch.as_tensor(sel, device=xyz.device)
    _, d = knn_brute(xyz, mask, k, queries=xyz[sel_t], exclude_self=True,
                     self_indices=sel_t)
    dk = d[:, -1].cpu().numpy()
    dk = dk[np.isfinite(dk)]
    if dk.size == 0:
        return 1.0
    return float(max(1.2 * np.percentile(dk, 90), 1e-3))


# Statistics of the last knn_grid call: the queries; per grid pass its
# bucket side, column cap, queries and certified rows; the rows that took
# the brute tile.
last_grid_stats: dict = {"queries": 0, "passes": [], "fallback": 0}


def knn_grid(
    xyz,
    mask,
    k: int,
    bucket_size: Optional[float] = None,
    cap: int = 64,
    queries=None,
    exclude_self: bool = True,
    tail=None,
    tail_args: tuple = (),
    *,
    device=None,
):
    """Exact kNN through grid passes with the brute tile last. Masked
    self-queries return -1 / inf.

    The first pass uses ``bucket_size`` (by default measured, see
    ``_auto_bucket_size``) and caps the column spans at the largest span
    around any point (at least ``cap``, at most ``_GRID_CAP_MAX``). The
    rows whose certificate fails (sparse regions: floating points,
    outliers) go to uncapped passes (``DenseGrid.knn_uncapped``) with a
    bucket ``_GRID_GROWTH`` times larger each, up to ``_GRID_PASSES``
    passes, and the rest to the brute tile. The grid's cell count is not
    bounded (``DenseGrid`` keeps no table of it), so far outliers do not
    widen the buckets of the dense part.

    ``tail``: optional consumer ``tail(xyz, idx, *tail_args)`` run on the
    final neighbour lists; the return is then (idx, dist, tail_out)."""
    xyz, mask = _as_tensors(xyz, mask, device)
    dev = xyz.device
    self_knn = queries is None and exclude_self
    q = xyz if queries is None else torch.as_tensor(queries, dtype=torch.float32, device=dev)
    nq = q.shape[0]
    if bucket_size is None:
        bucket_size = _auto_bucket_size(xyz, mask, k)
    idx = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    dist = torch.full((nq, k), _INF, device=dev)
    rows = torch.nonzero(mask).flatten() if queries is None else torch.arange(nq, device=dev)
    passes = []
    b = float(bucket_size)
    for level in range(_GRID_PASSES):
        if rows.numel() == 0:
            break
        b, dims, origin = _grid_geometry(xyz, mask, b, _GRID_MAX_CELLS)
        grid = DenseGrid(xyz, mask, b, dims=dims, origin=origin)
        spos = grid.inv_order[rows] if self_knn else None
        if level == 0:
            capc = min(max(cap, grid.column_cap()), _GRID_CAP_MAX)
            gi, gd, ex = grid.knn(q[rows], k, cap=capc, self_pos=spos)
        else:
            capc = None
            gi, gd, ex = grid.knn_uncapped(q[rows], k, self_pos=spos)
        idx[rows[ex]] = gi[ex]
        dist[rows[ex]] = gd[ex]
        n_ok = int(ex.sum())
        passes.append({"bucket": b, "cap": capc, "rows": int(rows.numel()), "certified": n_ok})
        rows = rows[~ex]
        b *= _GRID_GROWTH
    if rows.numel():
        bi, bd = knn_brute(xyz, mask, k, queries=q[rows], exclude_self=self_knn,
                           self_indices=rows if self_knn else None)
        idx[rows] = bi
        dist[rows] = bd
    last_grid_stats.update(queries=nq, passes=passes, fallback=int(rows.numel()))
    if tail is not None:
        return idx, dist, tail(xyz, idx, *tail_args)
    return idx, dist


def radius_search_grid(
    xyz,
    mask,
    radius: float,
    max_neighbors: int,
    *,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact self radius search: a grid with bucket side = radius (the
    27-neighbourhood holds the whole ball) whose column cap is three times
    the largest cell occupancy, so no span overflows and no row needs a
    fallback. Clouds whose densest cell holds more than 128 points (radius
    >> spacing) take the brute tile. Masked rows return empty results.

    Returns (idx i32[N, max_neighbors] ascending, dist f32[N,
    max_neighbors], count i32[N] exact in-radius count)."""
    xyz, mask = _as_tensors(xyz, mask, device)
    dev = xyz.device
    n = xyz.shape[0]
    r2 = float(np.float32(radius * radius))
    bucket_size, dims, origin = _grid_geometry(xyz, mask, float(radius), _GRID_MAX_CELLS)
    grid = None
    if bucket_size <= radius + 1e-6:
        grid = DenseGrid(xyz, mask, bucket_size, dims=dims, origin=origin)
        mx = grid.occupancy_max()
        if mx > 128:
            grid = None
    if grid is None:
        idx, dist, cnt = radius_search_brute(xyz, mask, radius, max_neighbors)
        keep = mask[:, None]
        return (torch.where(keep, idx, -1), torch.where(keep, dist, _INF),
                torch.where(mask, cnt, 0))
    capc = max(1, 3 * mx)
    chunk = _rows_per_tile(9 * capc, dev)
    kk = min(max_neighbors, 9 * capc)
    keys = torch.empty((n, kk), dtype=torch.int64, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    for q0 in range(0, n, chunk):
        q1 = min(n, q0 + chunk)
        pos, d2, _ = grid._candidates(xyz[q0:q1], capc, grid.inv_order[q0:q1])
        inr = d2 <= r2
        cnt[q0:q1] = inr.sum(dim=1).to(torch.int32)
        keys[q0:q1] = _smallest(_pack(torch.where(inr, d2, _INF), grid.order[pos]), kk)
    idx, dist = _finish(keys, max_neighbors)
    keep = mask[:, None]
    return (torch.where(keep, idx, -1), torch.where(keep, dist, _INF),
            torch.where(mask, cnt, 0))


def knn(xyz, mask, k: int, bucket_size: Optional[float] = None, method: str = "auto",
        *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN over the cloud (each point's k nearest other points).

    Every method is exact except "bucket":
      * "auto": the grid path from ``_GRID_CROSSOVER`` points up, the
        brute tile below;
      * "brute": the tiled exact search (masked rows are searched too);
      * "grid": the grid with its certificate and brute fallback (masked
        rows return -1 / inf);
      * "bucket": capped 27-bucket candidates, approximate."""
    xyz, mask = _as_tensors(xyz, mask, device)
    n = xyz.shape[0]
    if method == "auto":
        method = "grid" if n >= _GRID_CROSSOVER else "brute"
    if method == "brute":
        return knn_brute(xyz, mask, k)
    if method == "grid":
        return knn_grid(xyz, mask, k, bucket_size=bucket_size)
    if method != "bucket":
        raise ValueError(f"unknown search method: {method!r}")
    if bucket_size is None:
        raise ValueError("bucket method requires bucket_size")
    grid = BucketGrid(xyz, mask, bucket_size)
    return grid.knn(xyz, k, exclude_self_idx=torch.arange(n, dtype=torch.int32,
                                                           device=xyz.device))
