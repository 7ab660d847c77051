"""The port's block-sharded map (``fastdem_tpu_torch/parallel/sharding.py``)
against its unsharded step and against the JAX package.

(a) The mesh: shapes follow the reference's most-square rule.
(b) The windowed formulation on the reference's ``TestShardMapWindowed``
    configuration (``tests/test_sharding.py``: 32x32 m at 0.25 m, range
    5 m, raycast on, 3 moving scans of 4,000 points) over 8 blocks on the
    CPU: bit for bit equal to the port's unsharded windowed step on every
    layer, for the step and the sequence; equal to the per-block step of
    ``build_integrate(spmd_blocks=...)`` (so sharing a device's phase A
    changes nothing); and held to JAX's ``build_sharded_integrate`` on the
    8-device virtual mesh at the session tolerances of
    ``tests/test_torch_window.py``.
(c) Refusals and the fallback: LOCAL mode (moves that cross blocks, the
    reference's ``TestShardedLocalMode``) and a GLOBAL map without a
    window take ``blocks_fullmap``, bit for bit equal to the unsharded
    step.
(d) No ``torch.distributed`` collective runs inside a step.
(e) The post-processing chain per block with its halo against the
    unsharded chain (and JAX's sharded chain) on the reference's 64x64 map
    with 15% NaN holes across block edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.mapping import pipeline as pl_j
from fastdem_tpu.parallel import sharding as sh_j
from fastdem_tpu_torch.mapping.pipeline import build_integrate, create_map_state
from fastdem_tpu_torch.parallel import sharding as sh
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)
from test_torch_window import layers_agree


def scan(n=2048, seed=0):
    """The reference test's ring scan."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.5, 6.0, n)
    xyz = np.column_stack(
        [rad * np.cos(ang), rad * np.sin(ang), rng.normal(-1.0, 0.05, n)]
    ).astype(np.float32)
    return xyz, np.ones(n, dtype=bool)


def pose(x, y):
    p = np.eye(4, dtype=np.float32)
    p[0, 3], p[1, 3] = x, y
    return p


def config(pkg, mode="GLOBAL", range_max=None):
    cfg = pkg.Config()
    cfg.mapping.mode = getattr(pkg.MappingMode, mode)
    cfg.raycasting.enabled = True
    if range_max is not None:
        cfg.point_filter.range_max = range_max
    return cfg


def cpu_mesh(n=8, shape=None):
    return sh.make_mesh(n, shape=shape, devices=["cpu"])


def assert_bitwise(ref, got):
    assert set(ref.layers) == set(got.layers)
    for name, a in ref.layers.items():
        np.testing.assert_array_equal(
            a.numpy().view(np.int32), got.layers[name].numpy().view(np.int32), err_msg=name
        )
    np.testing.assert_array_equal(ref.position.numpy(), got.position.numpy())


def run_unsharded(geom, cfg, stream, T_bs):
    step = build_integrate(geom, cfg, device="cpu")
    s = create_map_state(geom, cfg, device="cpu")
    for xyz, mask, T_wb in stream:
        s, _ = step(s, torch.tensor(xyz), torch.tensor(mask), torch.tensor(T_bs),
                    torch.tensor(T_wb))
    return s


def run_sharded(geom, cfg, stream, T_bs, mesh=None):
    mesh = mesh or cpu_mesh()
    step, shard = sh.build_sharded_integrate(geom, cfg, mesh)
    s = shard(create_map_state(geom, cfg, device="cpu"))
    aux = None
    for xyz, mask, T_wb in stream:
        s, aux = step(s, torch.tensor(xyz), torch.tensor(mask), torch.tensor(T_bs),
                      torch.tensor(T_wb))
    return s, aux, step


# ---- (a) the mesh -----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_shape_matches_jax(n):
    mesh = cpu_mesh(n)
    jmesh = sh_j.make_mesh(n)
    assert mesh.shape == (jmesh.shape["mx"], jmesh.shape["my"])
    assert mesh.axis_names == jmesh.axis_names
    assert mesh.size == n and len(mesh.local_slots()) == n
    assert mesh.local_devices() == [torch.device("cpu")]


def test_mesh_refuses_a_wrong_shape_and_needs_a_device():
    with pytest.raises(ValueError):
        cpu_mesh(8, shape=(3, 2))
    with pytest.raises(ValueError):
        sh_j.make_mesh(8, shape=(3, 2))
    assert cpu_mesh(8).shape == (4, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sh.make_mesh(4)


def test_shard_and_gather_round_trip():
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.5)  # 32x32
    rng = np.random.default_rng(11)
    state = ft.state_from_numpy(
        {"elevation": rng.normal(size=geom.shape).astype(np.float32)}, [0.5, -1.0], device="cpu"
    )
    sharded = sh.shard_state(state, cpu_mesh())
    assert sorted(sharded.blocks) == cpu_mesh().slots()
    assert tuple(sharded.blocks[(3, 1)]["elevation"].shape) == (8, 16)
    assert_bitwise(state, sh.gather_state(sharded))
    layout = sh.map_sharding(cpu_mesh(), geom.shape)
    assert layout.rect((3, 1)) == (24, 32, 16, 32) and layout.block_shape == (8, 16)
    assert sh.state_shardings(cpu_mesh(), state) == {"elevation": layout}
    with pytest.raises(ValueError, match="divisible"):
        sh.map_sharding(cpu_mesh(), (30, 32))


# ---- (b) the windowed formulation --------------------------------------------


def windowed_stream():
    xyz, mask = scan(4000, seed=3)
    return [(xyz, mask, pose(1.5 * k, -0.7 * k)) for k in range(3)]


I4 = np.eye(4, dtype=np.float32)


@pytest.fixture(scope="module")
def windowed():
    geom = ft.GridGeometry.from_length(32.0, 32.0, 0.25)  # 128x128
    cfg = config(ft, range_max=5.0)  # window 64 << 128: the gate engages
    stream = windowed_stream()
    ref = run_unsharded(geom, cfg, stream, I4)
    return geom, cfg, stream, ref


def test_windowed_step_bitwise_equals_unsharded(windowed):
    geom, cfg, stream, ref = windowed
    sN, aux, step = run_sharded(geom, cfg, stream, I4)
    assert step.formulation == "shardmap_windowed"
    assert aux.obs is None and int(aux.oow_points) == 0
    assert len(sN.blocks) == 8 and tuple(sN.blocks[(0, 0)]["elevation"].shape) == (32, 64)
    assert_bitwise(ref, sh.gather_state(sN))
    assert int(torch.isfinite(ref.layers["elevation"]).sum()) > 1000


def test_windowed_sequence_bitwise_equals_unsharded(windowed):
    geom, cfg, stream, ref = windowed
    seq, shard = sh.build_sharded_integrate_sequence(geom, cfg, cpu_mesh())
    assert seq.formulation == "shardmap_windowed"
    out = seq(
        shard(create_map_state(geom, cfg, device="cpu")),
        torch.tensor(np.stack([s[0] for s in stream])),
        torch.tensor(np.stack([s[1] for s in stream])),
        torch.tensor(I4),
        torch.tensor(np.stack([s[2] for s in stream])),
    )
    assert_bitwise(ref, sh.gather_state(out))


def test_per_block_step_equals_shared_phase_a(windowed):
    """build_integrate(spmd_blocks) run once per block, each computing its
    own phase A, gives the layers of the sharded step, which computes the
    block-independent part once per device."""
    geom, cfg, stream, ref = windowed
    mesh = cpu_mesh()
    step = build_integrate(geom, cfg, spmd_blocks=mesh.shape, device="cpu")
    sharded = sh.shard_state(create_map_state(geom, cfg, device="cpu"), mesh)
    blocks = {slot: sharded.block(slot) for slot in mesh.slots()}
    for xyz, mask, T_wb in stream:
        for slot in mesh.slots():
            blocks[slot], aux = step(blocks[slot], torch.tensor(xyz), torch.tensor(mask),
                                     torch.tensor(I4), torch.tensor(T_wb), block=slot)
            assert aux.obs is None
    got = sh.ShardedState(mesh, geom.shape, {s: b.layers for s, b in blocks.items()},
                          sharded.position)
    assert_bitwise(ref, sh.gather_state(got))


def test_windowed_step_against_jax_sharded(windowed):
    """The port's sharded step against JAX's shard_map step on the 8-device
    virtual mesh, at the session tolerances of the unsharded step."""
    geom, cfg, stream, _ = windowed
    sN, _, _ = run_sharded(geom, cfg, stream, I4)
    geom_j = fj.GridGeometry.from_length(32.0, 32.0, 0.25)
    stepJ, shardJ = sh_j.build_sharded_integrate(
        geom_j, config(fj, range_max=5.0), sh_j.make_mesh(8), donate=False
    )
    assert stepJ.formulation == "shardmap_windowed"
    sJ = shardJ(pl_j.create_map_state(geom_j, config(fj, range_max=5.0)))
    for xyz, mask, T_wb in stream:
        sJ, _ = stepJ(sJ, jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(I4),
                      jnp.asarray(T_wb))
    got = sh.gather_state(sN)
    np.testing.assert_array_equal(np.asarray(sJ.position), got.position.numpy())
    layers_agree({k: np.asarray(v) for k, v in sJ.layers.items()}, got)


# ---- (c) refusals and the fallback ------------------------------------------


def test_windowed_refuses_what_it_cannot_run():
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.25)
    mesh = cpu_mesh()
    for cfg in (config(ft, "LOCAL"), config(ft, range_max=None)):
        with pytest.raises(ValueError):
            sh._plan(geom, cfg, mesh, None, None, False, {})
        step, _ = sh.build_sharded_integrate(geom, cfg, mesh)
        assert step.formulation == "blocks_fullmap"
    with pytest.raises(ValueError, match="divisible"):
        build_integrate(ft.GridGeometry(100, 96, 0.25), config(ft, range_max=3.0),
                        spmd_blocks=(3, 2), device="cpu")
    with pytest.raises(ValueError, match="GLOBAL"):
        build_integrate(geom, config(ft, "LOCAL"), spmd_blocks=(4, 2), device="cpu")


def local_stream():
    xyz, mask = scan()
    return [(xyz, mask, pose(0.8 * k, -0.3 * k)) for k in range(4)]


def test_local_move_across_blocks_bitwise():
    """LOCAL mode over blocks: poses advance 3.2 cells per scan along x, so
    every move carries strips across block edges; every layer and the
    position equal the unsharded step's bit for bit."""
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.25)  # 64x64
    cfg = config(ft, "LOCAL")
    T_bs = I4.copy()
    T_bs[2, 3] = 1.0
    stream = local_stream()
    ref = run_unsharded(geom, cfg, stream, T_bs)
    sN, _, step = run_sharded(geom, cfg, stream, T_bs)
    assert step.formulation == "blocks_fullmap"
    assert_bitwise(ref, sh.gather_state(sN))
    assert float(ref.position[0]) > 2.0


def test_local_move_against_jax_gspmd():
    """The same session against JAX's GSPMD fallback, at the reference
    test's tolerances."""
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.25)
    T_bs = I4.copy()
    T_bs[2, 3] = 1.0
    stream = local_stream()
    sN, _, _ = run_sharded(geom, config(ft, "LOCAL"), stream, T_bs)
    geom_j = fj.GridGeometry.from_length(16.0, 16.0, 0.25)
    step1 = pl_j.build_integrate(geom_j, config(fj, "LOCAL"), donate=False)
    s1 = pl_j.create_map_state(geom_j, config(fj, "LOCAL"))
    for xyz, mask, T_wb in stream:
        s1, _ = step1(s1, jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(T_bs),
                      jnp.asarray(T_wb))
    got = sh.gather_state(sN)
    np.testing.assert_allclose(np.asarray(s1.position), got.position.numpy())
    layers_agree({k: np.asarray(v) for k, v in s1.layers.items()}, got)


@pytest.mark.parametrize("method", ["polar", "sampled"])
def test_global_fullmap_fallback_bitwise(method):
    """A GLOBAL map without a window (no range bound, or the sampled
    raycast, which scatters into the whole map) updates whole blocks."""
    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.25)
    cfg = config(ft)  # no range bound: no window
    cfg.raycasting.method = method
    xyz, mask = scan()
    stream = [(xyz, mask, pose(0.3 * k, 0.2 * k)) for k in range(2)]
    ref = run_unsharded(geom, cfg, stream, I4)
    sN, aux, step = run_sharded(geom, cfg, stream, I4)
    assert step.formulation == "blocks_fullmap" and aux.oow_points is None
    assert_bitwise(ref, sh.gather_state(sN))


@pytest.mark.parametrize("side,mode", [(73.0, "packed"), (60.0, "rows")])
def test_fullmap_fallback_over_the_unsharded_rasterizer(side, mode):
    """The fallback picks the rasterizer from the whole map's update area,
    as the unsharded step does: a 730 x 730 LOCAL map (532,900 cells, above
    2^19) runs packed mode, a 600 x 600 one rows mode, each on a 2x2 mesh
    of blocks below 2^19 cells. Near-tie scans (a 13-bit index and a post,
    so the pairs tie in the argmin key) make the blocks' argmin carries
    depend on the whole scan's z range and point index; the voxel counts
    take the unsharded path (representatives, where a block's own table
    would hold presence lanes in rows mode). Every layer and the position
    equal the unsharded step's bit for bit."""
    from test_torch_replay import near_ties

    geom = ft.GridGeometry.from_length(side, side, 0.1)
    cfg = config(ft, "LOCAL")
    rng = np.random.default_rng(9)
    stream = []
    for k in range(2):
        xyz, mask = scan(n=8192, seed=k)
        xyz = near_ties(xyz * np.array([4.0, 4.0, 1.0], np.float32))
        xyz[-5:, 2] += 4.0
        stream.append((xyz, mask & (rng.random(8192) > 0.02), pose(0.6 * k, -0.4 * k)))
    T_bs = I4.copy()
    T_bs[2, 3] = 1.0
    assert build_integrate(geom, cfg, device="cpu").scatter_mode == mode
    ref = run_unsharded(geom, cfg, stream, T_bs)
    sN, _, step = run_sharded(geom, cfg, stream, T_bs, mesh=cpu_mesh(4, (2, 2)))
    assert step.formulation == "blocks_fullmap"
    assert_bitwise(ref, sh.gather_state(sN))
    assert (ref.layers["n_points"] > 0).sum() > 4000


# ---- (d) no collective ----------------------------------------------------------


def test_no_collective_in_the_step(monkeypatch, windowed):
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a collective ran inside the step")

    for name in ("all_reduce", "all_gather", "all_gather_object", "broadcast", "send",
                 "recv", "isend", "irecv", "barrier", "reduce_scatter", "all_to_all",
                 "gather", "scatter", "batch_isend_irecv"):
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, refuse)
    geom, cfg, stream, ref = windowed
    sN, _, _ = run_sharded(geom, cfg, stream, I4)
    monkeypatch.undo()
    assert_bitwise(ref, sh.gather_state(sN))


# ---- (e) post-processing ----------------------------------------------------------


def pp_config(pkg):
    pp = pkg.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    return pp


def test_postprocess_halo_from_the_config():
    """Uncertainty fusion 1 cell + 3 inpainting passes + the features' 3-cell
    disk + the 3x3 median = 8 cells at 0.1 m (chip_smoke.py's margin)."""
    pp = pp_config(ft)
    assert sh.postprocess_halo(pp, 0.1, median_kernel=3) == 8
    assert sh.postprocess_halo(pp, 0.1) == 7
    assert sh.postprocess_halo(ft.PostProcessConfig(), 0.1) == 0


def test_sharded_postprocess_against_unsharded_and_jax():
    from fastdem_tpu.postprocess import apply_postprocess_fn as pp_j
    from fastdem_tpu_torch.postprocess import apply_postprocess_fn, smooth_median

    geom = ft.GridGeometry.from_length(16.0, 16.0, 0.25)  # 64x64
    rng = np.random.default_rng(7)
    elev = rng.normal(-1.0, 0.2, geom.shape).astype(np.float32)
    elev[rng.uniform(size=geom.shape) < 0.15] = np.nan
    upper, lower = elev + 0.2, elev - 0.2
    names = ("elevation", "upper_bound", "lower_bound")
    state = ft.state_from_numpy(dict(zip(names, (elev, upper, lower))), [0.0, 0.0],
                                device="cpu")
    mesh = cpu_mesh()
    out = sh.gather_state(sh.sharded_postprocess(
        geom, pp_config(ft), mesh, sh.shard_state(state, mesh), median=(3, 5)
    ))
    ref = apply_postprocess_fn(geom, pp_config(ft))(*(torch.tensor(a) for a in (elev, upper, lower)))
    ref["elevation_smoothed"] = smooth_median(ref["elevation"], 3, 5)
    assert set(out.layers) == set(ref)
    for name, r in ref.items():
        # Every stencil reads its cells' neighbours the same way in a block
        # with its halo as in the whole map: bit for bit.
        np.testing.assert_array_equal(r.numpy().view(np.int32),
                                      out.layers[name].numpy().view(np.int32), err_msg=name)
    assert int(torch.isfinite(out.layers["slope"]).sum()) > 2000

    lyr_sh = sh_j.map_sharding(sh_j.make_mesh(8))
    fn = pp_j(fj.GridGeometry.from_length(16.0, 16.0, 0.25), pp_config(fj))
    outJ = jax.jit(fn, in_shardings=(lyr_sh,) * 3)(
        *(jax.device_put(a, lyr_sh) for a in (elev, upper, lower))
    )
    for name, a in outJ.items():
        a, b = np.asarray(a), out.layers[name].numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        both = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(b[both], a[both], rtol=1e-5, atol=1e-5, err_msg=name)
