"""The compiled block-sharded step (``parallel/sharding.py`` with
``jit=True`` / ``donate=True``), on the CPU.

* Capture safety: the whole sharded step (windowed, and the one-process
  LOCAL fallback whose move is a gather with the shift on the device) and
  the sharded sequence run under ``test_torch_graphs.CaptureGuard`` after
  one warm-up call: no host read, no copy from host memory.
* The graph plumbing: ``graphs.BACKEND`` is the recording double of
  ``test_torch_graphs.py``, so the slots, the donation and the cloning are
  those of the card. The compiled step and sequence then equal their
  ``jit=False`` forms bit for bit on every layer, and JAX's
  ``build_sharded_integrate(..., donate=True)`` (the shard_map windowed
  step, its ``lax.scan`` sequence and the GSPMD LOCAL fallback) on the
  8-device virtual mesh at the tolerances of ``test_torch_sharding.py``.
* The donated blocks and position are the graph's slots; the mesh is a
  constant of the signature and the blocks its leaves; one graph per
  channel set, scan capacity and sequence length K.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.mapping import pipeline as pl_j
from fastdem_tpu.parallel import sharding as sh_j
from fastdem_tpu_torch.mapping.pipeline import create_map_state
from fastdem_tpu_torch.parallel import sharding as sh
from fastdem_tpu_torch.utils import graphs
from test_torch_graphs import guarded, recorded  # noqa: F401 (fixture)
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)
from test_torch_sharding import (I4, assert_bitwise, config, cpu_mesh, local_stream,
                                 windowed_stream)
from test_torch_window import layers_agree

T_BS_LOCAL = I4.copy()
T_BS_LOCAL[2, 3] = 1.0


def windowed_case():
    """The reference's ``TestShardMapWindowed`` setting (test_torch_sharding)."""
    return (ft.GridGeometry.from_length(32.0, 32.0, 0.25), config(ft, range_max=5.0),
            windowed_stream(), I4)


def local_case():
    """LOCAL moves of 3.2 cells per scan along x: strips cross block edges."""
    return ft.GridGeometry.from_length(16.0, 16.0, 0.25), config(ft, "LOCAL"), \
        local_stream(), T_BS_LOCAL


CASES = {"windowed": windowed_case, "local": local_case}


def tensors(stream, T_bs):
    return [(torch.tensor(x), torch.tensor(m), torch.tensor(T_bs), torch.tensor(p))
            for x, m, p in stream]


def run(step, state, stream, T_bs):
    aux = None
    for args in tensors(stream, T_bs):
        state, aux = step(state, *args)
    return state, aux


def stacked(stream, T_bs):
    return (torch.tensor(np.stack([s[0] for s in stream])),
            torch.tensor(np.stack([s[1] for s in stream])), torch.tensor(T_bs),
            torch.tensor(np.stack([s[2] for s in stream])))


# ---- capture safety -----------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_is_capture_safe(case):
    geom, cfg, stream, T_bs = CASES[case]()
    mesh = cpu_mesh(4, (2, 2))
    step, shard = sh.build_sharded_integrate(geom, cfg, mesh)
    assert step.compiled == "whole"
    assert step.formulation == ("shardmap_windowed" if case == "windowed" else "blocks_fullmap")
    (x0, m0, tbs, p0), (x1, m1, _, p1) = tensors(stream[:2], T_bs)
    state, _ = step(shard(create_map_state(geom, cfg, has_intensity=True, device="cpu")),
                    x0, m0, tbs, p0, torch.rand(len(x0)))
    state, aux = guarded(step, state, x1, m1, tbs, p1, torch.rand(len(x1)))
    assert aux.obs is None


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_sequence_is_capture_safe(case):
    geom, cfg, stream, T_bs = CASES[case]()
    seq, shard = sh.build_sharded_integrate_sequence(geom, cfg, cpu_mesh(4, (2, 2)))
    assert seq.compiled == "whole"
    guarded(seq, shard(create_map_state(geom, cfg, device="cpu")), *stacked(stream, T_bs))


def test_exchange_is_named_where_the_move_crosses_processes():
    """A LOCAL mesh whose slots lie in two processes moves by exchanging
    strips (eagerly); the windowed step still holds the whole scan."""
    cpu = torch.device("cpu")
    mesh = sh.BlockMesh(shape=(2, 2), devices=((cpu, cpu), (None, None)),
                        owners=((0, 0), (1, 1)), rank=0, world=2)
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.25)
    step, _ = sh.build_sharded_integrate(geom, config(ft, "LOCAL"), mesh)
    seq, _ = sh.build_sharded_integrate_sequence(geom, config(ft, "LOCAL"), mesh)
    assert (step.compiled, seq.compiled) == ("after_exchange", "after_exchange")
    step, _ = sh.build_sharded_integrate(geom, config(ft, range_max=3.0), mesh)
    assert step.compiled == "whole"
    step, _ = sh.build_sharded_integrate(geom, config(ft, "LOCAL"), mesh, jit=False)
    assert step.compiled == "eager"


# ---- graph against eager, and the plumbing ------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_step_equals_eager_and_donates_slots(recorded, case):
    geom, cfg, stream, T_bs = CASES[case]()
    mesh = cpu_mesh()
    eager, shard = sh.build_sharded_integrate(geom, cfg, mesh, jit=False)
    step, _ = sh.build_sharded_integrate(geom, cfg, mesh)
    s_e = s_g = shard(create_map_state(geom, cfg, device="cpu"))
    (graph_step,) = step.per_device.values()
    for k, args in enumerate(tensors(stream, T_bs)):
        s_e, aux_e = eager(s_e, *args)
        s_g, aux_g = step(s_g, *args)
        assert_bitwise(sh.gather_state(s_e), sh.gather_state(s_g))
        for f in ("world_xyz", "world_mask", "z_var"):
            assert torch.equal(getattr(aux_e, f), getattr(aux_g, f)), (k, f)
        # The returned blocks and position are the graph's slots.
        (graph,) = graph_step.graphs.values()
        leaves = [t for slot in s_g.blocks.values() for t in slot.values()] + [s_g.position]
        assert all(t is s for t, s in zip(leaves, graph.slots)), k
    assert graph.stats.replays == len(stream) and len(recorded.bodies) == 1
    if case == "local":
        assert float(s_g.position[0]) > 2.0


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_sequence_equals_eager(recorded, case):
    geom, cfg, stream, T_bs = CASES[case]()
    mesh = cpu_mesh()
    eager, shard = sh.build_sharded_integrate_sequence(geom, cfg, mesh, jit=False)
    seq, _ = sh.build_sharded_integrate_sequence(geom, cfg, mesh)
    args = stacked(stream, T_bs)
    ref = eager(shard(create_map_state(geom, cfg, device="cpu")), *args)
    got = seq(shard(create_map_state(geom, cfg, device="cpu")), *args)
    assert_bitwise(sh.gather_state(ref), sh.gather_state(got))
    loop, _ = run(sh.build_sharded_integrate(geom, cfg, mesh, jit=False)[0],
                  shard(create_map_state(geom, cfg, device="cpu")), stream, T_bs)
    assert_bitwise(sh.gather_state(loop), sh.gather_state(got))
    (graph_seq,) = seq.per_device.values()
    assert len(graph_seq.graphs) == 1


@pytest.mark.parametrize("build", ["block step", "sharded step"])
def test_windowed_blocks_are_written_in_place(recorded, build):
    """The windowed block step (``spmd_blocks=(2, 2)``, one graph per
    block) and the sharded step (one graph holding the device's four
    blocks), compiled and donating, on the recording double: each graph
    copies no donated output into its slot (every block is written in
    place), the returned blocks are the slots, the blocks equal the
    unsharded windowed step's map bit for bit after every scan, and the
    eager sharded step leaves the blocks passed in as they were."""
    geom, cfg, stream, T_bs = windowed_case()
    mesh = cpu_mesh(4, (2, 2))
    ref_step = ft.build_integrate(geom, cfg, jit=False, device="cpu")
    ref = create_map_state(geom, cfg, device="cpu")
    state = sh.shard_state(create_map_state(geom, cfg, device="cpu"), mesh)
    if build == "block step":
        step = ft.build_integrate(geom, cfg, spmd_blocks=mesh.shape, device="cpu")
        steps = [step]
    else:
        step, _ = sh.build_sharded_integrate(geom, cfg, mesh)
        eager, _ = sh.build_sharded_integrate(geom, cfg, mesh, jit=False)
        steps = list(step.per_device.values())
    for args in tensors(stream, T_bs):
        ref, _ = ref_step(ref, *args)
        if build == "block step":
            blocks = {slot: step(state.block(slot), *args, block=slot)[0].layers
                      for slot in mesh.slots()}
            state = sh.ShardedState(state.mesh, state.shape, blocks, state.position)
        else:
            kept = sh.gather_state(state)
            assert_bitwise(ref, sh.gather_state(eager(state, *args)[0]))
            assert_bitwise(kept, sh.gather_state(state))
            state, _ = step(state, *args)
        assert_bitwise(ref, sh.gather_state(state))
        graphs_ = [g for s in steps for g in s.graphs.values()]
        slots = {id(t) for g in graphs_ for t in g.slots}
        assert all(id(t) in slots for b in state.blocks.values() for t in b.values())
    assert len(graphs_) == (4 if build == "block step" else 1)
    for g in graphs_:
        assert g.stats.slot_copies_per_replay == g.stats.slot_copies == 0
        assert g.stats.replays == len(stream)


def test_signature_keys(recorded):
    """The mesh is a constant of the signature and the blocks its leaves;
    one graph per channel set and scan capacity, and per K for the
    sequence; a signature seen before replays."""
    geom, cfg, stream, T_bs = windowed_case()
    mesh = cpu_mesh(4, (2, 2))
    state = sh.shard_state(create_map_state(geom, cfg, has_intensity=True, device="cpu"), mesh)
    spec, leaves = graphs._flatten(state)
    assert ("mesh", ("const", mesh)) in spec[2]
    assert len(leaves) == 4 * len(state.layer_names) + 1
    step, _ = sh.build_sharded_integrate(geom, cfg, mesh)
    (graph_step,) = step.per_device.values()
    x, m, tbs, p = tensors(stream, T_bs)[0]
    for n, channel in ((4000, False), (4000, True), (2000, False), (4000, True)):
        state, _ = step(state, x[:n], m[:n], tbs, p, torch.rand(n) if channel else None)
    assert sorted(g.stats.replays for g in graph_step.graphs.values()) == [1, 1, 2]

    seq, shard = sh.build_sharded_integrate_sequence(geom, cfg, mesh)
    state = shard(create_map_state(geom, cfg, device="cpu"))
    xyz, mask, tbs, poses = stacked(stream, T_bs)
    for K in (3, 2, 3):
        state = seq(state, xyz[:K], mask[:K], tbs, poses[:K])
    (graph_seq,) = seq.per_device.values()
    assert sorted(g.stats.replays for g in graph_seq.graphs.values()) == [1, 2]


# ---- against JAX --------------------------------------------------------------


def test_compiled_windowed_step_and_sequence_against_jax(recorded):
    """JAX's donated shard_map step and its jitted scan on the 8-device
    virtual mesh, at the session tolerances of
    ``test_windowed_step_against_jax_sharded``."""
    geom, cfg, stream, T_bs = windowed_case()
    step, shard = sh.build_sharded_integrate(geom, cfg, cpu_mesh())
    sN, _ = run(step, shard(create_map_state(geom, cfg, device="cpu")), stream, T_bs)
    seq, _ = sh.build_sharded_integrate_sequence(geom, cfg, cpu_mesh())
    sS = seq(shard(create_map_state(geom, cfg, device="cpu")), *stacked(stream, T_bs))
    assert_bitwise(sh.gather_state(sN), sh.gather_state(sS))

    geom_j = fj.GridGeometry.from_length(32.0, 32.0, 0.25)
    cfg_j = config(fj, range_max=5.0)
    stepJ, shardJ = sh_j.build_sharded_integrate(geom_j, cfg_j, sh_j.make_mesh(8), donate=True)
    seqJ, _ = sh_j.build_sharded_integrate_sequence(geom_j, cfg_j, sh_j.make_mesh(8),
                                                    donate=True)
    sJ = shardJ(pl_j.create_map_state(geom_j, cfg_j))
    for xyz, mask, T_wb in stream:
        sJ, _ = stepJ(sJ, jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(T_bs),
                      jnp.asarray(T_wb))
    qJ = seqJ(shardJ(pl_j.create_map_state(geom_j, cfg_j)),
              *(jnp.asarray(a.numpy()) for a in stacked(stream, T_bs)))
    for ref in (sJ, qJ):
        got = sh.gather_state(sS)
        np.testing.assert_array_equal(np.asarray(ref.position), got.position.numpy())
        layers_agree({k: np.asarray(v) for k, v in ref.layers.items()}, got)


def test_compiled_local_fallback_against_jax_gspmd(recorded):
    """The compiled LOCAL fallback (the move a gather on the device) against
    JAX's GSPMD fallback on the 8-device virtual mesh, compared as
    ``test_local_move_against_jax_gspmd`` compares."""
    geom, cfg, stream, T_bs = local_case()
    step, shard = sh.build_sharded_integrate(geom, cfg, cpu_mesh())
    assert step.compiled == "whole"
    sN, _ = run(step, shard(create_map_state(geom, cfg, device="cpu")), stream, T_bs)
    geom_j = fj.GridGeometry.from_length(16.0, 16.0, 0.25)
    cfg_j = config(fj, "LOCAL")
    stepJ, shardJ = sh_j.build_sharded_integrate(geom_j, cfg_j, sh_j.make_mesh(8), donate=True)
    assert stepJ.formulation == "gspmd_fullmap"
    sJ = shardJ(pl_j.create_map_state(geom_j, cfg_j))
    for xyz, mask, T_wb in stream:
        sJ, _ = stepJ(sJ, jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(T_bs),
                      jnp.asarray(T_wb))
    got = sh.gather_state(sN)
    np.testing.assert_allclose(np.asarray(sJ.position), got.position.numpy())
    layers_agree({k: np.asarray(v) for k, v in sJ.layers.items()}, got)


def test_device_move_equals_the_exchange():
    """The on-device gather and the strip exchange move the blocks alike,
    bit for bit, for shifts inside a block, across blocks and off the map."""
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.25)
    mesh = cpu_mesh(4, (2, 2))
    rng = np.random.default_rng(3)
    layers = {k: rng.normal(size=geom.shape).astype(np.float32) for k in ("a", "b")}
    layers["a"][rng.random(geom.shape) < 0.2] = np.nan
    layout = sh.map_sharding(mesh, geom.shape)
    for xy in ((0.0, 0.0), (0.3, -0.6), (-5.2, 3.9), (40.0, 0.0)):
        state = sh.shard_state(ft.state_from_numpy(layers, [0.1, -0.2], device="cpu"), mesh)
        target = torch.tensor(xy, dtype=torch.float32)
        got = sh._shift_on_device(geom, layout, state, target)
        ref = sh._shift_by_exchange(geom, layout, state, target)
        assert_bitwise(sh.gather_state(ref), sh.gather_state(got))


def test_sharded_builders_take_jit_and_donate():
    import inspect

    for fn in (sh.build_sharded_integrate, sh.build_sharded_integrate_sequence):
        params = inspect.signature(fn).parameters
        for name in ("jit", "donate"):
            assert params[name].default is True and params[name].kind == params[name].KEYWORD_ONLY
    assert "donate" in inspect.signature(sh_j.build_sharded_integrate).parameters


def test_guard_refuses_a_host_value():
    """``.tolist()`` reads a CPU tensor without a dispatched op; the
    host-value guard that ``guarded`` adds refuses it, as a capture on the
    card would."""
    from test_torch_graphs import HostValueGuard

    x = torch.arange(4)
    with pytest.raises(AssertionError, match="tolist"):
        with HostValueGuard():
            x.tolist()
    with pytest.raises(AssertionError, match="__bool__"):
        with HostValueGuard():
            bool(x.any())
