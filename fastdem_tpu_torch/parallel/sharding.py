"""Block-sharded maps: a fixed-origin GLOBAL map split into a 2D mesh of
blocks (port of ``fastdem_tpu/parallel/sharding.py``).

A ``BlockMesh`` of mx x my slots holds the map's [rows, cols] layers as
blocks of [rows/mx, cols/my] cells. Each slot has a device and an owning
rank: in one process every slot is local and slots may share a device (a
2x2 mesh on one card is four blocks on ``cuda:0``); under
``torch.distributed`` each rank owns a contiguous run of slots and only
the owner holds a block's layers. A ``ShardedState`` is the owned blocks
plus the replicated map position. Scans are replicated: every rank is fed
the same points, a few hundred KB next to a map of GBs.

``build_sharded_integrate`` has two formulations, chosen by the
configuration, never by the device:

  * ``"shardmap_windowed"`` (GLOBAL mode with a finite range filter): each
    block updates the global update window clamped onto itself
    (``mapping.pipeline.build_integrate(spmd_blocks=...)``), so a scan
    needs no exchange between blocks at all. The part of a scan that
    depends only on the replicated inputs -- the transform, the z
    variance, the filters, the global window, the polar slope scatter and
    the ray field (K1) -- is computed once per device and shared by that
    device's blocks; the rasterizer, the field lookup (K4) and the map
    update run per block.
  * ``"blocks_fullmap"`` (LOCAL mode, or no window): every block updates
    all of itself. LOCAL's move: where every slot lies on one device of
    one process, each block gathers its shifted cells from the others with
    the shift on the device; across devices or processes the shift is read
    to the host once per scan to exchange the shifted strips (slice copies,
    gloo send / recv staged through host memory across processes).

Both equal the unsharded step bit for bit on every layer. With ``jit``
(the default, as the reference's ``jax.jit``) each device's part of a
scan is one CUDA graph (``build_sharded_integrate``).
``sharded_postprocess`` runs the post-processing chain per block on the
block plus a halo of neighbouring cells, exchanged the same way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastdem_tpu_torch.config import MappingMode
from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.grid import gridmap
from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.grid.gridmap import GridMapState
from fastdem_tpu_torch.mapping.pipeline import DeviceMap, IntegrateAux, _phases_of, missing_layers
from fastdem_tpu_torch.numerics import recip_f32
from fastdem_tpu_torch.parallel.distributed import CallSync
from fastdem_tpu_torch.utils import graphs, tracing

MAP_AXES = ("mx", "my")
_GATHER = tracing.name_id("mesh.gather")

Slot = Tuple[int, int]
Rect = Tuple[int, int, int, int]  # r0, r1, c0, c1 (half-open, global cells)


def _world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _most_square(n: int) -> Tuple[int, int]:
    a = int(math.sqrt(n))
    while n % a != 0:
        a -= 1
    return (n // a, a)


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """mx x my block slots; ``devices[i][j]`` is the slot's device on its
    owner (None on the other ranks) and ``owners[i][j]`` the owning rank.
    Hashable by value: a compiled step keys its graphs on the mesh."""

    shape: Tuple[int, int]
    devices: Tuple[Tuple[Optional[torch.device], ...], ...]
    owners: Tuple[Tuple[int, ...], ...]
    rank: int = 0
    world: int = 1

    axis_names = MAP_AXES
    graph_constant = True  # a constant of a graph's signature (utils/graphs.py)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def slots(self) -> List[Slot]:
        return [(i, j) for i in range(self.shape[0]) for j in range(self.shape[1])]

    def owner(self, slot: Slot) -> int:
        return self.owners[slot[0]][slot[1]]

    def device(self, slot: Slot) -> Optional[torch.device]:
        return self.devices[slot[0]][slot[1]]

    def local_slots(self) -> List[Slot]:
        return [s for s in self.slots() if self.owner(s) == self.rank]

    def local_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for s in self.local_slots():
            if self.device(s) not in out:
                out.append(self.device(s))
        return out

    def make_map(self, *args) -> "MeshMap":
        """``MeshMap(self, *args)``: the map of a facade on this mesh."""
        return MeshMap(self, *args)


def make_mesh(
    n: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> BlockMesh:
    """A block mesh of ``n`` slots (default: this rank's devices times the
    ranks). ``shape`` defaults to the most-square factoring of ``n``
    (8 -> 4x2), as in the reference, so halos are short on both axes.

    ``devices``: this rank's devices (default: one CUDA card per rank,
    ``cuda:(rank % cards)``; raises without CUDA). Each rank owns n / world
    contiguous slots in row-major order, spread over its devices in
    contiguous groups; slots may share a device."""
    rank, world = _world()
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises: no CUDA, and no device named
        devices = [torch.device("cuda", rank % torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    n = int(n) if n else len(devs) * world
    if shape is None:
        shape = _most_square(n)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if n % world:
        raise ValueError(f"{n} blocks do not divide over {world} processes")
    per = n // world
    owners, devices_out = [], []
    for i in range(shape[0]):
        orow, drow = [], []
        for j in range(shape[1]):
            k = i * shape[1] + j
            owner = k // per
            orow.append(owner)
            q = k - owner * per
            drow.append(devs[q * len(devs) // per] if owner == rank else None)
        owners.append(tuple(orow))
        devices_out.append(tuple(drow))
    return BlockMesh(shape=shape, devices=tuple(devices_out), owners=tuple(owners),
                     rank=rank, world=world)


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Where each slot's block lies in a [rows, cols] map."""

    mesh: BlockMesh
    rows: int
    cols: int

    def __post_init__(self):
        mx, my = self.mesh.shape
        if self.rows % mx or self.cols % my:
            raise ValueError(
                f"map shape {(self.rows, self.cols)} not divisible by mesh {self.mesh.shape}"
            )

    @property
    def block_shape(self) -> Tuple[int, int]:
        return self.rows // self.mesh.shape[0], self.cols // self.mesh.shape[1]

    def rect(self, slot: Slot) -> Rect:
        br, bc = self.block_shape
        return (slot[0] * br, (slot[0] + 1) * br, slot[1] * bc, (slot[1] + 1) * bc)


def map_sharding(mesh: BlockMesh, shape: Tuple[int, int]) -> BlockLayout:
    """The block layout of a [rows, cols] layer: rows over 'mx', cols over
    'my' (the reference's ``NamedSharding(mesh, P("mx", "my"))``)."""
    return BlockLayout(mesh, int(shape[0]), int(shape[1]))


def state_shardings(mesh: BlockMesh, state) -> Dict[str, BlockLayout]:
    """The layout of every layer of ``state`` (the position is replicated)."""
    return {k: map_sharding(mesh, tuple(v.shape)) for k, v in state.layers.items()}


@dataclasses.dataclass
class ShardedState:
    """The owned blocks of a block-sharded map: ``blocks[slot]`` is
    {layer name: f32[rows/mx, cols/my]} on the slot's device, and
    ``position`` the replicated f32[2] map centre (on this rank's first
    device)."""

    mesh: BlockMesh
    shape: Tuple[int, int]
    blocks: Dict[Slot, Dict[str, torch.Tensor]]
    position: torch.Tensor

    @property
    def layout(self) -> BlockLayout:
        return map_sharding(self.mesh, self.shape)

    @property
    def layer_names(self) -> List[str]:
        first = next(iter(self.blocks.values()), None)
        return list(first) if first is not None else []

    def block(self, slot: Slot) -> GridMapState:
        """One block as a GridMapState (the position is the whole map's)."""
        dev = self.mesh.device(slot)
        return GridMapState(layers=self.blocks[slot], position=self.position.to(dev))


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def shard_state(state, mesh: BlockMesh) -> ShardedState:
    """Place a whole map (a GridMapState on any device, or with numpy
    layers) onto the mesh: each owned slot gets a copy of its block on its
    device. Under several processes each rank places only its own blocks
    from its (identical) copy of the map."""
    first = next(iter(state.layers.values()))
    layout = map_sharding(mesh, tuple(first.shape))
    blocks = {}
    for slot in mesh.local_slots():
        r0, r1, c0, c1 = layout.rect(slot)
        dev = mesh.device(slot)
        blocks[slot] = {
            k: torch.as_tensor(
                v[r0:r1, c0:c1] if isinstance(v, torch.Tensor) else np.asarray(v)[r0:r1, c0:c1]
            ).to(device=dev, dtype=torch.float32).clone().contiguous()
            for k, v in state.layers.items()
        }
    pos = torch.as_tensor(
        _host_array(state.position).astype(np.float32)
        if not isinstance(state.position, torch.Tensor)
        else state.position
    )
    position = pos.to(device=mesh.local_devices()[0], dtype=torch.float32).clone()
    return ShardedState(mesh=mesh, shape=(layout.rows, layout.cols), blocks=blocks,
                        position=position)


def clone_state(sharded: ShardedState) -> ShardedState:
    """A copy of ``sharded`` whose tensors are its own."""
    return ShardedState(sharded.mesh, sharded.shape,
                        {slot: {k: v.clone() for k, v in blk.items()}
                         for slot, blk in sharded.blocks.items()},
                        sharded.position.clone())


def gather_state(sharded: ShardedState, device=None) -> Optional[GridMapState]:
    """The whole map on ``device`` (default: the mesh's first device of
    this rank), for tests, checks and small maps.

    In one process it is returned. Across processes every rank calls this
    and rank 0 returns the map (None on the others): each block it
    does not own comes to it through the host (gloo), all its layers in one
    message. The map is assembled whole there, so large maps are written
    with ``distributed.save_sharded_npz`` instead, which never assembles a
    layer. Span ``mesh.gather``."""
    mesh = sharded.mesh
    sp = tracing.begin(_GATHER)
    try:
        if mesh.world == 1:
            return _assembled(sharded, sharded.blocks, device)
        import torch.distributed as dist

        names = sorted(sharded.layer_names)
        got: Dict[Slot, Dict[str, torch.Tensor]] = {}
        layout = sharded.layout
        for slot in mesh.slots():
            owner = mesh.owner(slot)
            if owner == mesh.rank == 0:
                got[slot] = sharded.blocks[slot]
            elif owner == mesh.rank:
                data = torch.stack([sharded.blocks[slot][k] for k in names])
                dist.send(_staged(data), 0)
            elif mesh.rank == 0:
                r0, r1, c0, c1 = layout.rect(slot)
                buf = torch.empty((len(names), r1 - r0, c1 - c0), dtype=torch.float32)
                dist.recv(buf, owner)
                got[slot] = dict(zip(names, buf))
        return _assembled(sharded, got, device) if mesh.rank == 0 else None
    finally:
        tracing.end(sp)


def _assembled(sharded: ShardedState, blocks, device) -> GridMapState:
    dev = resolve_device(device) if device is not None else sharded.mesh.local_devices()[0]
    layout = sharded.layout
    full = {
        k: torch.empty(sharded.shape, dtype=torch.float32, device=dev)
        for k in sharded.layer_names
    }
    for slot, blk in blocks.items():
        r0, r1, c0, c1 = layout.rect(slot)
        for k, v in blk.items():
            full[k][r0:r1, c0:c1] = v.to(dev)
    return GridMapState(layers=full, position=sharded.position.to(dev).clone())


# ---- the exchange of block rectangles --------------------------------------


def _intersect(a: Rect, b: Rect) -> Optional[Rect]:
    r0, r1 = max(a[0], b[0]), min(a[1], b[1])
    c0, c1 = max(a[2], b[2]), min(a[3], b[3])
    if r0 >= r1 or c0 >= c1:
        return None
    return (r0, r1, c0, c1)


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` for gloo (pinned when it comes from a card)."""
    if t.device.type == "cuda":
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t.contiguous().clone()


def fetch_regions(
    sharded: ShardedState, names: Sequence[str], regions: Dict[Slot, Rect]
) -> Dict[Slot, torch.Tensor]:
    """For each owned slot, the layers ``names`` over its region (global
    cells, possibly beyond the map) as f32[len(names), h, w] on the slot's
    device, NaN where the region leaves the map (an unmeasured cell).

    ``regions`` must hold EVERY slot of the mesh, computed alike on every
    rank: each rank then knows which of its pieces the others need. In one
    process a piece is a slice copy; across processes the owner sends it
    to the needing rank through gloo (host tensors), one message per piece,
    all posted at once and then waited on."""
    mesh, layout = sharded.mesh, sharded.layout
    names = list(names)
    out: Dict[Slot, torch.Tensor] = {}
    for slot in mesh.local_slots():
        r0, r1, c0, c1 = regions[slot]
        out[slot] = torch.full(
            (len(names), r1 - r0, c1 - c0), float("nan"), dtype=torch.float32,
            device=mesh.device(slot),
        )
    index = {s: k for k, s in enumerate(mesh.slots())}
    pending = []
    works = []
    for dst in mesh.slots():
        reg = regions[dst]
        for src in mesh.slots():
            piece = _intersect(reg, layout.rect(src))
            if piece is None:
                continue
            src_owner, dst_owner = mesh.owner(src), mesh.owner(dst)
            if mesh.rank not in (src_owner, dst_owner):
                continue
            br0, _, bc0, _ = layout.rect(src)
            pr0, pr1, pc0, pc1 = piece
            dr0, dc0 = pr0 - reg[0], pc0 - reg[2]
            tag = index[src] * mesh.size + index[dst]
            if src_owner == mesh.rank:
                blk = sharded.blocks[src]
                data = torch.stack(
                    [blk[k][pr0 - br0:pr1 - br0, pc0 - bc0:pc1 - bc0] for k in names]
                )
                if dst_owner == mesh.rank:
                    out[dst][:, dr0:dr0 + pr1 - pr0, dc0:dc0 + pc1 - pc0] = data.to(
                        mesh.device(dst)
                    )
                else:
                    import torch.distributed as dist

                    buf = _staged(data)
                    works.append((dist.isend(buf, dst_owner, tag=tag), buf))
            else:
                import torch.distributed as dist

                buf = torch.empty((len(names), pr1 - pr0, pc1 - pc0), dtype=torch.float32)
                works.append((dist.irecv(buf, src_owner, tag=tag), buf))
                pending.append((dst, dr0, dc0, buf))
    for work, _ in works:
        work.wait()
    for dst, dr0, dc0, buf in pending:
        _, h, w = buf.shape
        out[dst][:, dr0:dr0 + h, dc0:dc0 + w] = buf.to(mesh.device(dst))
    return out


# ---- the integrate step -----------------------------------------------------


def _shift_on_device(geom: GridGeometry, layout: BlockLayout, state: ShardedState,
                     target_xy: torch.Tensor) -> ShardedState:
    """``gridmap.move`` over the blocks of a mesh whose slots all lie on one
    device of this process: new[r, c] = old[r - kr, c - kc], NaN where that
    leaves the map. The shift stays on the device: each destination block
    gathers its rows and columns from the layer assembled from the blocks,
    so nothing is read to the host."""
    res = geom.resolution
    pos = state.position
    delta = gridmap.round_half_away((target_xy - pos) * recip_f32(res)).to(torch.int32)
    new_position = pos + delta.to(torch.float32) * res
    dev = pos.device
    src_r = torch.arange(geom.rows, dtype=torch.int32, device=dev) - delta[0]
    src_c = torch.arange(geom.cols, dtype=torch.int32, device=dev) - delta[1]
    inside = (((src_r >= 0) & (src_r < geom.rows))[:, None]
              & ((src_c >= 0) & (src_c < geom.cols))[None, :])
    src_r = src_r.clamp(0, geom.rows - 1).long()
    src_c = src_c.clamp(0, geom.cols - 1).long()
    mx, my = layout.mesh.shape
    blocks: Dict[Slot, Dict[str, torch.Tensor]] = {slot: {} for slot in state.blocks}
    for name in state.layer_names:
        whole = torch.cat([
            torch.cat([state.blocks[(i, j)][name] for j in range(my)], dim=1)
            for i in range(mx)
        ])
        for slot, out in blocks.items():
            r0, r1, c0, c1 = layout.rect(slot)
            got = whole.index_select(0, src_r[r0:r1]).index_select(1, src_c[c0:c1])
            out[name] = torch.where(inside[r0:r1, c0:c1], got, np.nan)
    return ShardedState(state.mesh, state.shape, blocks, new_position)


def _shift_by_exchange(geom: GridGeometry, layout: BlockLayout, state: ShardedState,
                       target_xy: torch.Tensor) -> ShardedState:
    """The same move where the blocks lie on several devices or processes:
    the shift is read to the host (one sync) to cut the strips each block
    takes from its neighbours (``fetch_regions``: slice copies, gloo
    across processes)."""
    res = geom.resolution
    pos = state.position
    delta = gridmap.round_half_away(
        (target_xy.to(pos.device) - pos) * recip_f32(res)
    ).to(torch.int32)
    kr, kc = (int(v) for v in delta.tolist())
    new_position = pos + delta.to(torch.float32) * res
    if kr == 0 and kc == 0:
        return ShardedState(state.mesh, state.shape, state.blocks, new_position)
    regions = {}
    for slot in state.mesh.slots():
        r0, r1, c0, c1 = layout.rect(slot)
        regions[slot] = (r0 - kr, r1 - kr, c0 - kc, c1 - kc)
    names = state.layer_names
    moved = fetch_regions(state, names, regions)
    blocks = {s: {k: t[n] for n, k in enumerate(names)} for s, t in moved.items()}
    return ShardedState(state.mesh, state.shape, blocks, new_position)


@dataclasses.dataclass
class _Plan:
    """One scan over a mesh's owned blocks. ``work[dev]`` is the scan's
    work on the blocks of one device: (that device's part of the state,
    xyz, mask, T_bs, T_wb, intensity, color_packed) -> (its part of the new
    state, IntegrateAux). ``exchange`` is LOCAL's move where it crosses
    devices or processes, run eagerly before the work; None where the work
    holds the whole scan."""

    formulation: str
    by_device: Dict[torch.device, List[Slot]]
    work: Dict[torch.device, object]
    exchange: Optional[object]


def _plan(
    geom: GridGeometry, cfg, mesh: BlockMesh, window_update, polar_field_impl,
    full_blocks: bool, step_kwargs: dict,
) -> _Plan:
    """The per-scan plan over the mesh's owned blocks; ValueError where the
    windowed formulation does not apply (``full_blocks`` False)."""
    if window_update is False and not full_blocks:
        raise ValueError("caller pinned window_update=False")
    by_device = {
        dev: [s for s in mesh.local_slots() if mesh.device(s) == dev]
        for dev in mesh.local_devices()
    }
    phases = {
        dev: _phases_of(
            geom, cfg, dev, step_kwargs, polar_field_impl=polar_field_impl,
            window_update=window_update, spmd_blocks=mesh.shape, full_blocks=full_blocks,
        )
        for dev in by_device
    }
    layout = map_sharding(mesh, geom.shape)
    local_mode = cfg.mapping.mode == MappingMode.LOCAL
    one_device = mesh.world == 1 and len(by_device) == 1

    def work_on(ph, slots):
        def work(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
            if local_mode and one_device:
                state = _shift_on_device(geom, layout, state, T_wb[:2, 3])
            pos = state.position
            sh = ph.shared(pos, xyz, mask, T_bs, T_wb)
            nonempty = torch.any(mask)
            blocks = {}
            for slot in slots:
                pa = ph.block(sh, pos, intensity, color_packed, slot)
                bstate = GridMapState(layers=state.blocks[slot], position=pos)
                blocks[slot] = ph.update(bstate, nonempty, pa).layers
            aux = IntegrateAux(
                world_xyz=sh.xyz_world, world_mask=sh.keep, z_var=sh.z_var,
                obs=None, oow_points=sh.oow_points,
            )
            return ShardedState(state.mesh, state.shape, blocks, pos), aux

        return work

    def exchange(state, target_xy):
        return _shift_by_exchange(geom, layout, state, target_xy)

    return _Plan(
        formulation="blocks_fullmap" if full_blocks else "shardmap_windowed",
        by_device=by_device,
        work={dev: work_on(phases[dev], slots) for dev, slots in by_device.items()},
        exchange=exchange if local_mode and not one_device else None,
    )


def _plan_of(geom, cfg, mesh, window_update, polar_field_impl, step_kwargs) -> _Plan:
    """The windowed plan where it applies, else ``blocks_fullmap``: a choice
    made from the configuration alone."""
    try:
        return _plan(geom, cfg, mesh, window_update, polar_field_impl, False, step_kwargs)
    except ValueError:
        return _plan(geom, cfg, mesh, False, polar_field_impl, True, step_kwargs)


def _over_devices(plan: _Plan, fns: dict, state: ShardedState, args: tuple):
    """``fns[dev](that device's part of state, *args on dev)`` on each device,
    the parts merged; returns (state, the first device's other output)."""
    blocks: Dict[Slot, Dict[str, torch.Tensor]] = {}
    head = None
    for dev, slots in plan.by_device.items():
        part = ShardedState(state.mesh, state.shape, {s: state.blocks[s] for s in slots},
                            state.position.to(dev))
        out = fns[dev](part, *(None if t is None else t.to(dev, non_blocking=True)
                               for t in args))
        part, extra = out if isinstance(out, tuple) else (out, None)
        blocks.update(part.blocks)
        if head is None:
            head = (part.position, extra)
    return ShardedState(state.mesh, state.shape, blocks, head[0]), head[1]


def _attach(fn, plan: _Plan, fns: dict, jit: bool):
    fn.formulation = plan.formulation
    fn.compiled = ("eager" if not jit
                   else "after_exchange" if plan.exchange is not None else "whole")
    fn.per_device = fns
    return fn


def _step_of(plan: _Plan, jit: bool, donate: bool):
    """The per-scan step of ``plan``: the exchange, if any, then each
    device's work (one graph per device and signature with ``jit``)."""
    fns = {dev: graphs.jit(w, donate=donate) if jit else graphs.plain(w)
           for dev, w in plan.work.items()}

    def step(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        if plan.exchange is not None:
            state = plan.exchange(state, T_wb[:2, 3])
        return _over_devices(plan, fns, state, (xyz, mask, T_bs, T_wb, intensity, color_packed))

    return _attach(step, plan, fns, jit)


def _scans(step):
    """K stacked scans through ``step`` (which returns (state, aux)), scan
    after scan with no host read in between."""

    def run(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        static_tbs = T_bs.dim() == 2
        for k in range(xyz.shape[0]):
            state, _ = step(
                state, xyz[k], mask[k], T_bs if static_tbs else T_bs[k], T_wb[k],
                None if intensity is None else intensity[k],
                None if color_packed is None else color_packed[k],
            )
        return state

    return run


def build_sharded_integrate(
    geom: GridGeometry,
    cfg,
    mesh: BlockMesh,
    window_update: Optional[bool] = None,
    polar_field_impl: Optional[str] = None,
    *,
    jit: bool = True,
    donate: bool = True,
    **step_kwargs,
):
    """The integrate step over a block mesh:

      step(sharded_state, xyz, mask, T_bs, T_wb, intensity=None,
           color_packed=None) -> (sharded_state, IntegrateAux)

    with the scan's tensors replicated (on any device; each device takes
    its copy) and ``aux.obs`` None. ``step.formulation`` is
    ``"shardmap_windowed"`` where GLOBAL mode and a finite range filter
    let the window engage, else ``"blocks_fullmap"`` (see the module
    docstring): a choice made from the configuration alone. Neither runs a
    collective in a GLOBAL step. Channels are taken when given.
    ``step_kwargs`` are ``build_integrate``'s ray, voxel-count and
    window-margin options.

    ``jit`` and ``donate`` are the reference's. With ``jit`` each device's
    part of a scan on CUDA tensors (K1 once, then K4 and the update per
    block) is one CUDA graph per signature (``utils/graphs.py``: the mesh,
    the channels and the scan capacity), replayed once a scan; a graph
    never spans devices. ``step.compiled`` says how much of the scan the
    graphs hold:

      * ``"whole"``: the whole scan. That is every windowed step, every
        GLOBAL fallback, and LOCAL's fallback in one process with every
        slot on one device, whose move is then a gather with the shift on
        the device;
      * ``"after_exchange"``: LOCAL's fallback over several devices or
        processes. Its move reads the shift to the host and exchanges
        strips between blocks (gloo across processes), eagerly; one graph
        per device holds the rest of the scan;
      * ``"eager"``: ``jit=False``, every op dispatched from Python (the
        oracle the graphs are held to).

    With ``donate`` the state passed in is consumed and the returned
    blocks and position are the graphs' own slots, updated in place;
    without it the step never updates its input. A capture that fails
    raises, naming the signature. On the CPU ``jit`` runs the step as it
    is, on a copy of the blocks. ``step.per_device`` maps each device to
    its graph step (or to its ``graphs.plain`` step with ``jit=False``).

    Returns (step, shard_fn) with shard_fn(state) = shard_state(state, mesh).
    """
    plan = _plan_of(geom, cfg, mesh, window_update, polar_field_impl, step_kwargs)
    return _step_of(plan, jit, donate), lambda s: shard_state(s, mesh)


def build_sharded_integrate_sequence(
    geom: GridGeometry,
    cfg,
    mesh: BlockMesh,
    *,
    jit: bool = True,
    donate: bool = True,
    **seq_kwargs,
):
    """Batched replay over a block-sharded map: K stacked scans

      seq(sharded_state, xyz[K, N, 3], mask[K, N], T_bs, T_wb[K, 4, 4],
          intensity=None, color_packed=None) -> sharded_state

    through ``build_sharded_integrate``'s step (the same formulation, the
    same keyword arguments), scan after scan with no host read in between,
    so the map equals the step loop's bit for bit. ``T_bs`` is one 4x4 or
    one per scan.

    ``jit`` / ``donate`` as in ``build_sharded_integrate``. Where the step
    is ``"whole"``, each device's K scans are one CUDA graph per (mesh, K,
    N, channels): the counterpart of the reference's jitted ``lax.scan``,
    with K1 launched K times and K4 K times per block in a replay. Where it
    is ``"after_exchange"``, the K scans run the compiled step one after
    another (each move exchanges strips first). Returns (seq, shard_fn)."""
    kw = dict(seq_kwargs)
    window_update = kw.pop("window_update", None)
    polar_field_impl = kw.pop("polar_field_impl", None)
    plan = _plan_of(geom, cfg, mesh, window_update, polar_field_impl, kw)
    if plan.exchange is not None:
        step = _step_of(plan, jit, donate)
        return _attach(_scans(step), plan, step.per_device, jit), lambda s: shard_state(s, mesh)
    fns = {
        dev: graphs.jit(_scans(w), donate=donate) if jit else graphs.plain(_scans(w))
        for dev, w in plan.work.items()
    }

    def seq(state, xyz, mask, T_bs, T_wb, intensity=None, color_packed=None):
        return _over_devices(plan, fns, state, (xyz, mask, T_bs, T_wb, intensity,
                                                color_packed))[0]

    return _attach(seq, plan, fns, jit), lambda s: shard_state(s, mesh)


class MeshMap(DeviceMap):
    """A mesh facade's map (see ``FastDEM``): this process's blocks, in
    place; a value set to ``state`` is cloned or sharded."""

    def __init__(self, mesh: BlockMesh, geom: GridGeometry, cfg, position,
                 has_intensity: bool, has_color: bool, device: torch.device):
        if device not in mesh.local_devices():
            raise ValueError(f"{device} is not a device of this process's blocks")
        self.mesh = mesh
        super().__init__(geom, cfg, position, has_intensity, has_color, device)
        self.state = self._state
        sync = CallSync(mesh.rank, mesh.world, device)
        self.begin, self.end, self.check = sync.begin, sync.end, sync.check

    def compile(self, cfg, margin: float):
        step, _ = build_sharded_integrate(
            self.geom, cfg, self.mesh, window_margin=margin, jit=True, donate=True,
        )
        return step

    def rebuild(self, cfg, step) -> None:
        for old in getattr(self.step, "per_device", {}).values():
            old.clear()
        self.step = step
        shape = self._state.layout.block_shape
        for slot, blk in self._state.blocks.items():
            blk.update(missing_layers(blk, cfg, self.has_intensity, self.has_color, shape,
                                      self.mesh.device(slot)))

    @property
    def state(self) -> ShardedState:
        return clone_state(self._state)

    @state.setter
    def state(self, value) -> None:
        self._state = (clone_state(value) if isinstance(value, ShardedState)
                       else shard_state(value, self.mesh))

    def reset(self) -> None:
        for blk in self._state.blocks.values():
            for v in blk.values():
                v.fill_(np.nan)


# ---- post-processing ----------------------------------------------------------


def postprocess_halo(pp_cfg, resolution: float, median_kernel: Optional[int] = None) -> int:
    """Cells a block's chain results depend on beyond the block: the
    uncertainty fusion's search disk, one cell per inpainting pass, the
    features' analysis disk and the median's half width, summed (a bound:
    the chain's stencils never reach further)."""
    from fastdem_tpu_torch.postprocess.stencil import disk_offsets

    def radius(r_m):
        return max((max(abs(a), abs(b)) for a, b in disk_offsets(r_m, resolution)), default=0)

    halo = 0
    if pp_cfg.uncertainty_fusion.enabled:
        halo += radius(pp_cfg.uncertainty_fusion.search_radius)
    if pp_cfg.inpainting.enabled:
        halo += int(pp_cfg.inpainting.max_iterations)
    if pp_cfg.feature_extraction.enabled:
        halo += radius(pp_cfg.feature_extraction.analysis_radius)
    if median_kernel:
        halo += int(median_kernel) // 2
    return halo


def sharded_postprocess(
    geom: GridGeometry,
    pp_cfg,
    mesh: BlockMesh,
    sharded: ShardedState,
    inputs: Tuple[str, str, str] = ("elevation", "upper_bound", "lower_bound"),
    median: Optional[Tuple[int, int]] = None,
) -> ShardedState:
    """The post-processing chain (``apply_postprocess_fn``) over a sharded
    map: each block runs it on itself plus a halo of ``postprocess_halo``
    cells (fetched from its neighbours: slices in one process, gloo across
    processes) and keeps its own cells. Where the halo meets the map edge
    the block's region ends there, as the map does. ``median`` = (kernel,
    min_valid) adds ``elevation_smoothed``, the median of the chain's
    elevation. Returns the outputs as a ShardedState."""
    from fastdem_tpu_torch.postprocess import apply_postprocess_fn, smooth_median

    layout = sharded.layout
    h = postprocess_halo(pp_cfg, geom.resolution, median[0] if median else None)
    regions = {}
    for slot in mesh.slots():
        r0, r1, c0, c1 = layout.rect(slot)
        regions[slot] = (max(r0 - h, 0), min(r1 + h, geom.rows),
                         max(c0 - h, 0), min(c1 + h, geom.cols))
    data = fetch_regions(sharded, inputs, regions)
    fns = {}
    blocks = {}
    for slot, stack in data.items():
        reg = regions[slot]
        shape = (reg[1] - reg[0], reg[3] - reg[2])
        if shape not in fns:
            fns[shape] = apply_postprocess_fn(
                GridGeometry(shape[0], shape[1], geom.resolution), pp_cfg
            )
        out = fns[shape](stack[0], stack[1], stack[2])
        if median:
            out["elevation_smoothed"] = smooth_median(out["elevation"], *median)
        r0, r1, c0, c1 = layout.rect(slot)
        blocks[slot] = {
            k: v[r0 - reg[0]:r1 - reg[0], c0 - reg[2]:c1 - reg[2]].contiguous()
            for k, v in out.items()
        }
    return ShardedState(mesh, sharded.shape, blocks, sharded.position)

