"""Sharded map checkpoints for maps too large to assemble on one host (the
port's counterpart of ``fastdem_tpu/io/orbax_ckpt.py``; Orbax is a JAX
library, so this is a directory of ``.npy`` files instead).

``save_sharded`` has each rank write its own blocks, one ``.npy`` per
layer per block (``blocks/<i>_<j>/<layer>.npy``), and rank 0 the position
(``position.npy``) and ``meta.json`` in the reference's schema (version,
resolution, rows, cols, frame_id) plus the mesh shape and the layer names.
``load_sharded`` restores onto any mesh shape: each target block reads
only the rectangles of the source blocks it overlaps (memory-mapped), so
no layer is assembled whole; without a mesh it restores a whole
GridMapState. The npz path (``io.npz``, ``parallel.distributed.
save_sharded_npz``) stays the reference-compatible interchange format.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.grid.gridmap import GridMapState

META = "meta.json"
VERSION = 1


def _block_dir(path: str, slot) -> str:
    return os.path.join(path, "blocks", f"{slot[0]}_{slot[1]}")


def save_sharded(path: str, geom: GridGeometry, state, frame_id: str = "map") -> None:
    """Write the ShardedState ``state`` as a checkpoint directory at
    ``path``. Every rank calls it and writes its own blocks; the ranks meet
    at a barrier before returning, so the directory is complete when any
    of them returns."""
    mesh = state.mesh
    path = os.path.abspath(path)
    for slot, blk in state.blocks.items():
        d = _block_dir(path, slot)
        os.makedirs(d, exist_ok=True)
        host = {k: v.detach().cpu().numpy() for k, v in blk.items()}
        for name, arr in host.items():
            np.save(os.path.join(d, name + ".npy"), np.ascontiguousarray(arr, np.float32))
    if mesh.rank == 0:
        np.save(os.path.join(path, "position.npy"),
                state.position.detach().cpu().numpy().astype(np.float32))
        meta = {
            "version": VERSION,
            "resolution": geom.resolution,
            "rows": geom.rows,
            "cols": geom.cols,
            "frame_id": frame_id,
            "mesh": list(mesh.shape),
            "layers": sorted(state.layer_names),
        }
        with open(os.path.join(path, META), "w") as f:
            json.dump(meta, f)
    if mesh.world > 1:
        import torch.distributed as dist

        dist.barrier()


def load_sharded(path: str, mesh=None, *, device="cuda") -> Tuple[GridGeometry, object, dict]:
    """(geom, state, meta) of the checkpoint at ``path``.

    With ``mesh`` the state is a ShardedState on that mesh, of any shape the
    map divides: each owned block is filled from the rectangles of the
    source blocks it overlaps, read through memory maps, and placed on its
    slot's device. Without a mesh, a whole GridMapState on ``device``."""
    from fastdem_tpu_torch.device import resolve_device
    from fastdem_tpu_torch.parallel.sharding import ShardedState, map_sharding

    path = os.path.abspath(path)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    if int(meta.get("version", -1)) > VERSION:
        raise ValueError(f"{path}: unsupported checkpoint version {meta.get('version')}")
    geom = GridGeometry(
        rows=int(meta["rows"]), cols=int(meta["cols"]), resolution=float(meta["resolution"])
    )
    names = list(meta["layers"])
    position = np.load(os.path.join(path, "position.npy")).astype(np.float32)
    src_shape = tuple(int(v) for v in meta["mesh"])
    src_br, src_bc = geom.rows // src_shape[0], geom.cols // src_shape[1]

    def read(r0: int, r1: int, c0: int, c1: int):
        """Layers over global cells [r0, r1) x [c0, c1) from the source
        blocks that overlap them."""
        out = {k: np.empty((r1 - r0, c1 - c0), np.float32) for k in names}
        for i in range(r0 // src_br, (r1 - 1) // src_br + 1):
            for j in range(c0 // src_bc, (c1 - 1) // src_bc + 1):
                br0, bc0 = i * src_br, j * src_bc
                lo_r, hi_r = max(r0, br0), min(r1, br0 + src_br)
                lo_c, hi_c = max(c0, bc0), min(c1, bc0 + src_bc)
                d = _block_dir(path, (i, j))
                for k in names:
                    src = np.load(os.path.join(d, k + ".npy"), mmap_mode="r")
                    out[k][lo_r - r0:hi_r - r0, lo_c - c0:hi_c - c0] = (
                        src[lo_r - br0:hi_r - br0, lo_c - bc0:hi_c - bc0]
                    )
        return out

    if mesh is None:
        dev = resolve_device(device)
        layers = {k: torch.tensor(v, device=dev) for k, v in read(0, geom.rows, 0, geom.cols).items()}
        return geom, GridMapState(layers=layers, position=torch.tensor(position, device=dev)), meta
    layout = map_sharding(mesh, geom.shape)
    blocks = {}
    for slot in mesh.local_slots():
        r0, r1, c0, c1 = layout.rect(slot)
        dev = mesh.device(slot)
        blocks[slot] = {k: torch.tensor(v, device=dev) for k, v in read(r0, r1, c0, c1).items()}
    pos = torch.tensor(position, device=mesh.local_devices()[0])
    return geom, ShardedState(mesh=mesh, shape=geom.shape, blocks=blocks, position=pos), meta
