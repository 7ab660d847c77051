"""The scan-batched replay step on the port (``build_integrate_sequence(
microbatch=m)``, ``build_integrate_fused`` and
``rasterize_scatter_rows_batched``), on the CPU.

The cases of ``tests/test_replay.py`` (fused and microbatch against the
step loop, the divisibility check, LOCAL's position walk): the reference
holds every decision layer to the loop exactly and lets the raycasting
layer differ on max(1, size/1000) cells; the port runs each scan's dense
prep with the step's own ops, so here every layer equals the loop's bit
for bit. Then the batched rasterizer against JAX's (every field bit for
bit, NaN sets exact) and the port's microbatch sequence against JAX's at
the pipeline tolerances of ``test_torch_pipeline.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.mapping import pipeline as pl_j
from fastdem_tpu.mapping import rasterize as ras_j
from fastdem_tpu.utils.colors import pack_rgb as pack_j
from fastdem_tpu_torch.mapping import pipeline as pl_t
from fastdem_tpu_torch.mapping import rasterize as ras_t
from fastdem_tpu_torch.utils.colors import pack_rgb as pack_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import assert_layers_agree
from test_torch_replay import assert_bitwise, near_ties
from test_torch_scatter_modes import FIELDS, assert_same

T_BS = np.eye(4, dtype=np.float32)
T_BS[2, 3] = 1.0


def scans(K, N, rng, step_x=0.3):
    """``tests/test_replay.py::_scans``."""
    ang = rng.uniform(0, 2 * np.pi, (K, N))
    rad = rng.uniform(0.5, 6.0, (K, N))
    x, y = rad * np.cos(ang), rad * np.sin(ang)
    z = 0.2 * np.sin(0.7 * x) * np.cos(0.5 * y) - 1.0 + rng.normal(0, 0.02, (K, N))
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = step_x * np.arange(K)
    return xyz, poses


@pytest.fixture(scope="module")
def geom():
    return ft.GridGeometry.from_length(10.0, 10.0, 0.1)


def config(raycast=True, local=False):
    cfg = ft.Config()
    cfg.raycasting.enabled = raycast
    if local:
        cfg.mapping.mode = ft.MappingMode.LOCAL
    return cfg


def loop(geom, cfg, xyz, mask, poses, intensity=None, T_bs=T_BS):
    step = ft.build_integrate(geom, cfg, has_intensity=intensity is not None, device="cpu")
    s = ft.create_map_state(geom, cfg, has_intensity=intensity is not None, device="cpu")
    for k in range(xyz.shape[0]):
        s, _ = step(s, torch.tensor(xyz[k]), torch.tensor(mask[k]),
                    torch.tensor(T_bs if T_bs.ndim == 2 else T_bs[k]), torch.tensor(poses[k]),
                    None if intensity is None else torch.tensor(intensity[k]))
    return s


def batched(fn, geom, cfg, xyz, mask, poses, intensity=None, T_bs=T_BS):
    s = ft.create_map_state(geom, cfg, has_intensity=intensity is not None, device="cpu")
    return fn(s, torch.tensor(xyz), torch.tensor(mask), torch.tensor(T_bs), torch.tensor(poses),
              None if intensity is None else torch.tensor(intensity))


@pytest.mark.parametrize("raycast", [False, True])
def test_fused_matches_step_loop(geom, rng, raycast):
    """Phase A of all K scans as one batch (one sparse frame)."""
    cfg = config(raycast)
    K, N = 5, 4096
    xyz, poses = scans(K, N, rng)
    mask = np.ones((K, N), dtype=bool)
    mask[2, 1000:] = False
    fused = pl_t.build_integrate_fused(geom, cfg, device="cpu")
    got = batched(fused, geom, cfg, xyz, mask, poses)
    assert_bitwise(got, loop(geom, cfg, xyz, mask, poses))
    assert torch.isfinite(got.layers["elevation"]).sum() > 3000


@pytest.mark.parametrize("raycast", [False, True])
def test_microbatch_matches_step_loop(geom, rng, raycast):
    """m = 4 over 8 scans: LOCAL mode, a sparse frame and intensity cover
    the position walk, the masking and the channels; one scan's extrinsic
    per frame."""
    cfg = config(raycast, local=True)
    K, N = 8, 4096
    xyz, poses = scans(K, N, rng, step_x=0.4)
    mask = np.ones((K, N), dtype=bool)
    mask[3, 500:] = False
    intensity = rng.random((K, N)).astype(np.float32)
    T_bs = np.tile(T_BS, (K, 1, 1))
    T_bs[:, 2, 3] = np.linspace(0.8, 1.2, K)
    seq = pl_t.build_integrate_sequence(geom, cfg, has_intensity=True, microbatch=4,
                                        device="cpu")
    got = batched(seq, geom, cfg, xyz, mask, poses, intensity, T_bs)
    assert_bitwise(got, loop(geom, cfg, xyz, mask, poses, intensity, T_bs))
    assert torch.isfinite(got.layers["intensity"]).sum() > 3000


def test_microbatch_requires_divisible_k(geom, rng):
    K, N = 5, 1024
    xyz, poses = scans(K, N, rng)
    seq = pl_t.build_integrate_sequence(geom, config(), microbatch=4, device="cpu")
    with pytest.raises(ValueError, match="multiple of microbatch"):
        batched(seq, geom, config(), xyz, np.ones((K, N), bool), poses)


def test_fused_local_mode_follows_robot(geom, rng):
    """LOCAL positions come from the pose-only lattice walk on the device;
    the final position and the moved layers are the loop's."""
    cfg = config(raycast=False, local=True)
    K, N = 6, 2048
    xyz, poses = scans(K, N, rng, step_x=0.75)
    mask = np.ones((K, N), dtype=bool)
    fused = pl_t.build_integrate_fused(geom, cfg, device="cpu")
    got = batched(fused, geom, cfg, xyz, mask, poses, T_bs=np.eye(4, dtype=np.float32))
    assert abs(float(got.position[0]) - 0.75 * (K - 1)) <= 0.05 + 1e-6
    assert_bitwise(got, loop(geom, cfg, xyz, mask, poses, T_bs=np.eye(4, dtype=np.float32)))


def test_fused_in_other_scatter_modes(geom, rng):
    """Without a batched phase A (twophase here) the fused step runs phase
    A scan by scan before the first update: still the loop's map."""
    K, N = 3, 2048
    xyz, poses = scans(K, N, rng)
    mask = np.ones((K, N), dtype=bool)
    fused = pl_t.build_integrate_fused(geom, config(), scatter_mode="twophase", device="cpu")
    step = ft.build_integrate(geom, config(), scatter_mode="twophase", device="cpu")
    s = ft.create_map_state(geom, config(), device="cpu")
    for k in range(K):
        s, _ = step(s, torch.tensor(xyz[k]), torch.tensor(mask[k]), torch.tensor(T_BS),
                    torch.tensor(poses[k]))
    assert_bitwise(batched(fused, geom, config(), xyz, mask, poses), s)


@pytest.mark.parametrize("side", [100, 400])
def test_rows_batched_matches_jax(rng, side):
    """K = 8 near-tie scans of 4,096 points through both packages'
    ``rasterize_scatter_rows_batched``, each scan at its own position;
    and each frame equal to the port's one-scan ``rasterize_scatter_rows``.
    At 100 x 100 cells the presence lanes ride the table in both; at
    400 x 400 the one-scan table holds them (160,001 x 36 < 2^23) and the
    reference's K-scaled bound drops them, so there the port is held to
    its one-scan rasterizer and to JAX on the fields the voxel count does
    not touch."""
    K, n = 8, 4096
    gj, gt = GeomJ(side, side, 0.1), ft.GridGeometry(side, side, 0.1)
    half = 0.045 * side
    xyz = np.stack([
        near_ties(np.column_stack([rng.uniform(-half, half, n), rng.uniform(-half, half, n),
                                   rng.normal(-1.0, 0.2, n)]).astype(np.float32))
        for _ in range(K)
    ])
    xyz[:, -3:, 2] += 4.0  # posts: the argmin quantum passes the near-tie gap
    mask = rng.random((K, n)) > 0.03
    z_var = rng.uniform(1e-4, 1e-2, (K, n)).astype(np.float32)
    intensity = rng.uniform(0, 100, (K, n)).astype(np.float32)
    color = rng.integers(0, 256, (K, n, 3)).astype(np.uint8)
    positions = rng.uniform(-0.3, 0.3, (K, 2)).astype(np.float32)
    ref = jax.jit(lambda p, x, m, v, i, c: ras_j.rasterize_scatter_rows_batched(
        gj, p, x, m, v, intensity=i, color_packed=c, with_voxel_count=True))(
        jnp.asarray(positions), jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(z_var),
        jnp.asarray(intensity), pack_j(jnp.asarray(color)))
    args = [torch.tensor(a) for a in (positions, xyz, mask, z_var, intensity)]
    col = pack_t(torch.tensor(color))
    got = ras_t.rasterize_scatter_rows_batched(gt, *args[:4], intensity=args[4],
                                               color_packed=col, with_voxel_count=True)
    assert int(got.touched.sum()) > 8 * 1500
    same = FIELDS if side == 100 else FIELDS[:-1]
    for name in same:
        assert_same(getattr(ref, name), getattr(got, name), name)
    for k in range(K):
        one = ras_t.rasterize_scatter_rows(gt, args[0][k], args[1][k], args[2][k], args[3][k],
                                           intensity=args[4][k], color_packed=col[k],
                                           with_voxel_count=True)
        for name in FIELDS:
            assert_same(getattr(one, name), getattr(got, name)[k], f"frame {k} {name}")


def test_microbatch_matches_jax_microbatch(rng):
    """The port's microbatch sequence against JAX's (m = 4, 8 scans of
    4,096 points, raycast on, GLOBAL)."""
    K, N = 8, 4096
    xyz, poses = scans(K, N, rng)
    mask = np.ones((K, N), dtype=bool)
    mask[5, 2000:] = False
    cfg_j = fj.Config()
    cfg_j.raycasting.enabled = True
    geom_j = fj.GridGeometry.from_length(10.0, 10.0, 0.1)
    seq_j = pl_j.build_integrate_sequence(geom_j, cfg_j, donate=False, microbatch=4)
    s_j = seq_j(pl_j.create_map_state(geom_j, cfg_j), jnp.asarray(xyz), jnp.asarray(mask),
                jnp.asarray(T_BS), jnp.asarray(poses))
    geom_t = ft.GridGeometry.from_length(10.0, 10.0, 0.1)
    seq_t = pl_t.build_integrate_sequence(geom_t, config(), microbatch=4, device="cpu")
    s_t = batched(seq_t, geom_t, config(), xyz, mask, poses)
    np.testing.assert_array_equal(np.asarray(s_j.position), s_t.position.numpy())
    assert_layers_agree(s_j.layers, s_t)
    np.testing.assert_array_equal(np.asarray(s_j.layers["obstacle"]),
                                  s_t.layers["obstacle"].numpy())
    assert torch.isfinite(s_t.layers["raycasting"]).sum() > 3000
