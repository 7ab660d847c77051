"""Multi-process runtime: the ``torch.distributed`` bootstrap, the check
that keeps a mesh facade's ranks at the same scan, the sharded npz
checkpoint and the scaling report (port of
``fastdem_tpu/parallel/distributed.py``).

One process per card (or several on one card), each given the
coordinator's address, the process count and its rank; a block mesh over
every rank's device (``make_global_mesh``); every rank fed the same scans.
The GLOBAL step runs no collective. A mesh facade
(``mapping.pipeline.FastDEM(mesh=...)``) runs one per
``integrate_sequence`` call (``CallSync``); the LOCAL move's strips,
post-processing halos, checkpoints and the assembly of a map on one rank
(``sharding.gather_state``) go through the host. The backend is gloo
(host tensors; blocks on a card are staged through pinned host memory),
which also serves several ranks on one card, or
``"cpu:gloo,cuda:nccl"`` for one card a rank: gloo for the host
exchanges and NCCL for the per-call collective on the card, run so on four
H100s of one host (``port_bench``'s ``mesh_replay`` loop).

Usage (one command per process):
  python -m fastdem_tpu_torch.parallel.distributed --coordinator host0:1234 \
      --num-processes 2 --process-id $RANK [--device cpu]

Library use:
  init_distributed("host0:1234", num_processes, process_id)
  mesh = make_global_mesh()
  mapper = FastDEM(geom, cfg, mesh=mesh, device=mesh.local_devices()[0])
"""

from __future__ import annotations

import argparse
import collections
import datetime
import io as _io
import json
import os
import time
import zipfile
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.utils import tracing

_SYNC = tracing.name_id("mesh.sync")
_SYNC_DEVICE = tracing.name_id("mesh.sync.device")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
    timeout_s: Optional[float] = None,
) -> None:
    """Join the process group at ``tcp://coordinator_address`` (a no-op
    for one process). Nothing on the machine names a cluster: the address,
    the count and the rank are the caller's. ``backend`` is gloo or
    ``"cpu:gloo,cuda:nccl"`` (one card a rank: call ``torch.cuda.set_device``
    first); ``timeout_s`` bounds every wait of the group (torch's default
    without it)."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need a coordinator address and a process id")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        **kw,
    )


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_global_mesh(
    shape: Optional[Tuple[int, int]] = None,
    n: Optional[int] = None,
    devices: Optional[Sequence] = None,
):
    """A block mesh over every rank: ``n`` blocks (default: one per rank's
    device), each rank owning a contiguous run of them on ``devices``
    (default: its card)."""
    from fastdem_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(n=n, shape=shape, devices=devices)


class Agreement(NamedTuple):
    """What every rank of a mesh held at the end of a checked call."""

    scans: int  # scans integrated since the facade was made
    resets: int


class CallSync:
    """The check that every rank of a mesh facade holds the same scans at
    the end of each ``integrate_sequence`` call.

    At a call's end each rank writes its row (scans integrated so far,
    resets) into a [world, 2] int64 table of zeros, and one all-reduce
    sums the tables: NCCL on the rank's card, enqueued on the current
    stream behind the call's steps, with the sum copied to pinned host
    memory behind an event; gloo, which waits, on the CPU. The host does
    not wait on the card's: ``check``, which the next call makes when it
    starts, does, and raises RuntimeError on every rank, naming the ranks
    whose row differs from the most common one.
    With one process there is no collective and each call is agreed as it
    ends.

    Spans: ``mesh.sync`` (the host's enqueue) and, on a card,
    ``mesh.sync.device``, between two events on the stream, one recorded
    just before the all-reduce and one just after it: the collective
    alone, which waits there for the slowest rank's card to reach it.
    Counters, kept here: ``mesh.calls`` and ``mesh.collectives``."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, device
        self.calls = 0
        self.collectives = 0
        self.agreed = Agreement(0, 0)
        self._pending = False
        self._cuda = device.type == "cuda"
        if world > 1:
            self._rows = torch.zeros((world, 2), dtype=torch.int64, pin_memory=self._cuda)
            self._rows_np = self._rows.numpy()
            self._sum = torch.zeros((world, 2), dtype=torch.int64, pin_memory=self._cuda)
            if self._cuda:
                self._dev = torch.zeros((world, 2), dtype=torch.int64, device=device)
                self._event = torch.cuda.Event()
        tracing.register("mesh.calls", self, "calls")
        tracing.register("mesh.collectives", self, "collectives")

    def begin(self) -> None:
        """A call starts: the previous call's collective is checked."""
        self.check()
        self.calls += 1

    def end(self, scans: int, resets: int) -> None:
        """A call has enqueued its steps: enqueue the collective."""
        if self.world == 1:
            self.agreed = Agreement(scans, resets)
            return
        import torch.distributed as dist

        sp = tracing.begin(_SYNC)
        self._rows_np[:] = 0
        self._rows_np[self.rank] = (scans, resets)
        if self._cuda:
            self._dev.copy_(self._rows, non_blocking=True)
            since = tracing.device_start(self.device)
            dist.all_reduce(self._dev)
            tracing.device_span(_SYNC_DEVICE, self.device, since)
            self._sum.copy_(self._dev, non_blocking=True)
            self._event.record()
        else:
            self._sum.copy_(self._rows)
            dist.all_reduce(self._sum)
        self.collectives += 1
        self._pending = True
        tracing.end(sp)

    def check(self) -> Agreement:
        """The last call's agreement, its collective waited for and checked
        first if it has not been."""
        if not self._pending:
            return self.agreed
        if self._cuda:
            self._event.synchronize()
        self._pending = False
        rows = [tuple(int(v) for v in r) for r in self._sum.numpy()]
        common, _ = collections.Counter(rows).most_common(1)[0]
        differ = [r for r, row in enumerate(rows) if row != common]
        if differ:
            held = "; ".join(f"rank {r}: {row[0]} scans, {row[1]} resets"
                             for r, row in enumerate(rows))
            raise RuntimeError(
                f"the mesh's ranks hold different scans at the end of call {self.calls}: "
                f"{held}; ranks {differ} differ")
        self.agreed = Agreement(*common)
        return self.agreed


def _npy_header(rows: int, cols: int) -> bytes:
    from numpy.lib import format as npfmt

    buf = _io.BytesIO()
    npfmt.write_array_header_1_0(
        buf, {"descr": "<f4", "fortran_order": True, "shape": (rows, cols)}
    )
    return buf.getvalue()


def _fits_without_zip64(members) -> bool:
    """Whether a STORE zip of ``members`` [(name, size)] needs no ZIP64:
    the checks ``zipfile`` makes with ``allowZip64=False`` (a member over
    ZIP64_LIMIT / 1.05, a central directory past ZIP64_LIMIT), made before
    any byte is written or sent."""
    offset = 0
    for name, size in members:
        if size * 1.05 > zipfile.ZIP64_LIMIT:
            return False
        offset += 30 + len(name.encode()) + size
    return offset <= zipfile.ZIP64_LIMIT


def save_sharded_npz(
    path: str, geom, state, frame_id: str = "map", col_block: int = 0
) -> bool:
    """Checkpoint a block-sharded map in the reference npz schema without
    assembling a whole layer anywhere.

    The npy payload is Fortran order, so a layer streams to the zip as
    contiguous column blocks: for each block of columns, rank 0 takes the
    pieces of the map blocks that hold them (its own by slicing, the
    others' through gloo, in slot order), appends the block's bytes to the
    open zip member and drops it. Peak host memory is one
    ``rows x col_block`` block. ``col_block`` 0 picks ~16 MB blocks.

    The bytes equal ``io.npz.save_npz``'s of the gathered map (STORE mode,
    Fortran-order ``<f4``, real 32-bit sizes). A map that would need ZIP64
    is refused on every rank before anything is written: False, and no
    file. A write that fails on rank 0 (a bad path, a full disk) is
    broadcast after each step, so every rank stops and returns False, and
    the partial file is removed. ``state`` may also be a whole
    GridMapState. Every rank calls this; rank 0 writes."""
    from fastdem_tpu_torch.io.npz import METADATA_VERSION, zip_member_info
    from fastdem_tpu_torch.parallel.sharding import ShardedState

    rows, cols = geom.rows, geom.cols
    if col_block <= 0:
        col_block = max(1, (16 << 20) // max(rows * 4, 1))
    bw = min(col_block, cols)
    sharded = isinstance(state, ShardedState)
    if sharded:
        mesh, layout = state.mesh, state.layout
        rank, world = mesh.rank, mesh.world
        names = sorted(state.layer_names)
        if world > 1:
            import torch.distributed as dist

            every = [None] * world
            dist.all_gather_object(every, names)
            names = sorted(next(n for n in every if n))
    else:
        rank, world = 0, 1
        names = sorted(state.layers)
    write = rank == 0

    pos = np.asarray(state.position.detach().cpu(), dtype=np.float64)
    meta = {
        "version": METADATA_VERSION,
        "resolution": geom.resolution,
        "position": [float(pos[0]), float(pos[1])],
        "frame_id": frame_id,
        "size": [rows, cols],
        "start_index": [0, 0],
    }
    meta_buf = _io.BytesIO()
    np.lib.format.write_array(
        meta_buf, np.asanyarray(np.bytes_(json.dumps(meta).encode())), allow_pickle=False
    )
    header = _npy_header(rows, cols)
    layer_size = len(header) + rows * cols * 4
    members = [(n + ".npy", layer_size) for n in names]
    members.append(("meta.npy", len(meta_buf.getvalue())))
    if not _fits_without_zip64(members):
        return False

    def column_block(name: str, c0: int, c1: int) -> Optional[np.ndarray]:
        """Columns [c0, c1) of layer ``name`` on rank 0 (None elsewhere)."""
        if not sharded:
            return np.asarray(state.layers[name][:, c0:c1].detach().cpu(), dtype=np.float32)
        out = np.empty((rows, c1 - c0), np.float32) if write else None
        for slot in mesh.slots():
            r0, r1, b0, b1 = layout.rect(slot)
            lo, hi = max(c0, b0), min(c1, b1)
            if lo >= hi:
                continue
            owner = mesh.owner(slot)
            if owner == rank:
                piece = state.blocks[slot][name][:, lo - b0:hi - b0]
                if write:
                    out[r0:r1, lo - c0:hi - c0] = piece.cpu().numpy()
                else:
                    import torch.distributed as dist

                    dist.send(piece.cpu().contiguous(), 0)
            elif write:
                import torch.distributed as dist

                buf = torch.empty((r1 - r0, hi - lo), dtype=torch.float32)
                dist.recv(buf, owner)
                out[r0:r1, lo - c0:hi - c0] = buf.numpy()
        return out

    files = {"zf": None, "member": None}
    ok = True

    def attempt(write_step) -> bool:
        """Run ``write_step`` on rank 0 while the checkpoint is good, then
        make rank 0's word every rank's: a write that fails on rank 0 stops
        the others before they send another column block."""
        nonlocal ok
        if write and ok:
            try:
                write_step()
            except (OSError, zipfile.LargeZipFile):
                ok = False
        if sharded and world > 1:
            import torch.distributed as dist

            flag = torch.tensor([int(ok)], dtype=torch.int32)
            dist.broadcast(flag, 0)
            ok = bool(flag.item())
        return ok

    def open_zip():
        files["zf"] = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=False)

    def open_member(name):
        zi = zip_member_info(name + ".npy")
        zi.file_size = layer_size  # zipfile's ZIP64 check sees the real size
        files["member"] = files["zf"].open(zi, mode="w")
        files["member"].write(header)

    def close_member():
        files["member"].close()
        files["member"] = None

    def close_zip():
        files["zf"].writestr(zip_member_info("meta.npy"), meta_buf.getvalue())
        files["zf"].close()
        files["zf"] = None

    try:
        if attempt(open_zip):
            for name in names:
                if not attempt(lambda: open_member(name)):
                    break
                for c0 in range(0, cols, bw):
                    blk = column_block(name, c0, min(c0 + bw, cols))
                    if not attempt(
                        lambda: files["member"].write(np.asfortranarray(blk).tobytes(order="F"))
                    ):
                        break
                if not attempt(close_member):
                    break
            attempt(close_zip)
    finally:
        # A failed checkpoint leaves no handle open and no truncated file
        # posing as the map.
        for h in (files["member"], files["zf"]):
            if h is not None:
                try:
                    h.close()
                except (OSError, zipfile.LargeZipFile, ValueError):
                    pass
        if write and not ok:
            try:
                os.unlink(path)
            except OSError:
                pass
    return ok


def _timer(devices):
    """(start, stop) -> seconds between them: CUDA events on the first
    card, every card synchronised; the host clock on the CPU."""
    cards = [d for d in devices if d.type == "cuda"]

    def start():
        for d in cards:
            torch.cuda.synchronize(d)
        if cards:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(cards[0]))
            return ev
        return time.perf_counter()

    def stop(t0):
        if cards:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(cards[0]))
            for d in cards:
                torch.cuda.synchronize(d)
            return t0.elapsed_time(ev) / 1e3
        return time.perf_counter() - t0

    return start, stop


def scaling_report(
    geom,
    cfg,
    scans: int = 16,
    points: int = 30000,
    mode: str = "strong",
    mesh=None,
    *,
    device="cuda",
) -> dict:
    """ms/scan unsharded on ``device`` against sharded over ``mesh``
    (default: ``make_mesh()``, one block per card).

    ``mode="strong"``: the same map; ``speedup = t_single / t_sharded`` and
    ``efficiency = speedup / N`` over the mesh's N blocks (BASELINE.md's
    metric: >= 80% scaling efficiency at N >= 2).

    ``mode="weak"``: the map grows with the mesh (rows x mx, cols x my:
    each block a constant size); ``efficiency = t_single / t_sharded`` and
    ``speedup = efficiency * N``.

    With several blocks on one card (or on the CPU) both are overhead
    probes of the blocks, not scaling: the blocks share one device. Times
    come from CUDA events with every card synchronised (the host clock on
    the CPU), after one warm-up step. Both steps run compiled, as
    ``build_integrate`` and ``build_sharded_integrate`` do by default
    (``compiled`` in the result is the sharded step's ``step.compiled``)."""
    if mode not in ("strong", "weak"):
        raise ValueError(f"unknown scaling mode: {mode!r}")
    from fastdem_tpu_torch.device import resolve_device
    from fastdem_tpu_torch.grid.geometry import GridGeometry
    from fastdem_tpu_torch.mapping.pipeline import build_integrate, create_map_state
    from fastdem_tpu_torch.parallel import sharding as sh

    dev = resolve_device(device)
    mesh = mesh if mesh is not None else sh.make_mesh()
    rng = np.random.default_rng(0)
    n = points
    xyz = torch.tensor(
        np.column_stack(
            [rng.uniform(-6, 6, n), rng.uniform(-6, 6, n), rng.normal(-1.0, 0.05, n)]
        ).astype(np.float32),
        device=dev,
    )
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    T = torch.eye(4, device=dev)

    def time_step(step, state, devices):
        start, stop = _timer(devices)
        state, _ = step(state, xyz, mask, T, T)
        t0 = start()
        for _ in range(scans):
            state, _ = step(state, xyz, mask, T, T)
        return stop(t0) / scans

    # Both sides compiled (CUDA graphs on a card, the first call capturing),
    # so the ratio compares like with like.
    base_step = build_integrate(geom, cfg, device=dev)
    t_single = time_step(base_step, create_map_state(geom, cfg, device=dev), [dev])

    n_blocks = mesh.size
    if mode == "weak":
        geom_n = GridGeometry(
            rows=geom.rows * mesh.shape[0], cols=geom.cols * mesh.shape[1],
            resolution=geom.resolution,
        )
    else:
        geom_n = geom
    stepN, shard = sh.build_sharded_integrate(geom_n, cfg, mesh)
    t_sharded = time_step(
        stepN, shard(create_map_state(geom_n, cfg, device=dev)), mesh.local_devices()
    )
    if mode == "weak":
        efficiency = t_single / t_sharded
        speedup = efficiency * n_blocks
    else:
        speedup = t_single / t_sharded
        efficiency = speedup / n_blocks
    return {
        "devices": n_blocks,
        "cards": len([d for d in mesh.local_devices() if d.type == "cuda"]) * mesh.world,
        "mode": mode,
        "formulation": stepN.formulation,
        "compiled": stepN.compiled,
        "map_shape_sharded": geom_n.shape,
        "ms_single": t_single * 1e3,
        "ms_sharded": t_sharded * 1e3,
        "speedup": speedup,
        "efficiency": efficiency,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of rank 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--map-size", type=float, default=50.0)
    ap.add_argument("--resolution", type=float, default=0.1)
    ap.add_argument("--blocks", type=int, default=0,
                    help="blocks in the mesh (default: one per process)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from fastdem_tpu_torch.config import Config, MappingMode
    from fastdem_tpu_torch.grid.geometry import GridGeometry

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    mesh = make_global_mesh(n=args.blocks or None, devices=[args.device])
    print(f"process {mesh.rank}/{mesh.world} mesh {mesh.shape} "
          f"blocks here {mesh.local_slots()}", flush=True)
    geom = GridGeometry.from_length(args.map_size, args.map_size, args.resolution)
    cfg = Config()
    cfg.mapping.mode = MappingMode.GLOBAL
    print(scaling_report(geom, cfg, mesh=mesh, device=args.device), flush=True)
    shutdown()


if __name__ == "__main__":
    main()
