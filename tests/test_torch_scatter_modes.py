"""The rasterizer's other formulations on the port -- packed, twophase and
sort, with ``ops/segments.py`` -- against the JAX package's on the CPU.

Each rasterizer takes the same near-tie scans (``test_torch_replay.
near_ties``: pairs 4 um apart in z, the higher at the lower index) as the
jitted JAX function, and every ``CellObservations`` field must match bit
for bit, NaN sets included. The one stated exception is the packed colour
of twophase: JAX's float min runs on XLA's CPU code, which flushes
subnormal packed colours (red < 128) to zero; the port returns the colour
(as its batch colour layer does, ROADMAP section 3).

Then ``build_integrate(scatter_mode=...)`` over 4 scans against JAX's at
the pipeline tolerances of ``test_torch_pipeline.py`` (rtol 1e-5, atol
1e-6 on >= 99.9% of the cells of every layer, ``n_points`` and the
elevation NaN set exact), and the configurations the reference refuses.
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
from fastdem_tpu.ops import segments as seg_j
from fastdem_tpu.utils.colors import pack_rgb as pack_j
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.mapping import rasterize as ras_t
from fastdem_tpu_torch.ops import segments as seg_t
from fastdem_tpu_torch.utils.colors import pack_rgb as pack_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import assert_layers_agree
from test_torch_replay import near_ties

FIELDS = ("touched", "min_z", "min_z_var", "max_z", "max_intensity", "color", "voxel_count")


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(ref, got, what):
    """Equal NaN sets, and every other value bit for bit (NaN payloads
    and signs are not compared)."""
    ref = ref.numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if ref.dtype == np.float32:
        nan = np.isnan(ref)
        np.testing.assert_array_equal(nan, np.isnan(got), err_msg=f"{what}: NaN set")
        ref, got = ref[~nan], got[~nan]
    np.testing.assert_array_equal(bits(ref), bits(got), err_msg=what)


# ---- ops/segments.py -----------------------------------------------------------


def test_segments_match_jax(rng):
    n, num_keys = 3000, 700
    keys = np.sort(rng.integers(0, num_keys, n)).astype(np.int32)
    keys[-200:] = num_keys  # the invalid tail
    valid = keys < num_keys
    vals = rng.normal(size=n).astype(np.float32)
    vals[rng.random(n) < 0.01] = np.nan
    vals_guarded = np.where(valid, vals, -np.inf).astype(np.float32)
    kj, kt = jnp.asarray(keys), torch.tensor(keys)
    heads_j = seg_j.segment_heads(kj, jnp.asarray(valid))
    heads_t = seg_t.segment_heads(kt, torch.tensor(valid))
    np.testing.assert_array_equal(np.asarray(heads_j), heads_t.numpy())
    for op_j, op_t in ((jnp.maximum, torch.maximum), (jnp.minimum, torch.minimum)):
        for reverse in (False, True):
            ref = jax.jit(lambda v, h: seg_j.segmented_scan(op_j, v, h, reverse))(
                jnp.asarray(vals_guarded), heads_j)
            got = seg_t.segmented_scan(op_t, torch.tensor(vals_guarded), heads_t, reverse)
            assert_same(ref, got, f"{op_t.__name__} {reverse}")
    lj = seg_j.dense_lookup(kj, num_keys)
    lt = seg_t.dense_lookup(kt, num_keys)
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref = seg_j.gather_at(jnp.asarray(vals), lj[0], lj[2])
    got = seg_t.gather_at(torch.tensor(vals), lt[0], lt[2])
    assert_same(ref, got, "gather_at")
    assert int(lt[2].sum()) > 500


# ---- the rasterizers -------------------------------------------------------------


def scan(rng, n, half, exact_ties=False):
    """A near-tie scan over [-half, half]^2 with a dense patch, invalid
    points, intensity, colours and variances. With 8,192 points (a 13-bit
    index) the post's z range makes the argmin key's quantum wider than
    the near-tie gaps, so the pairs tie in the key. ``exact_ties``: 60
    groups of 6 points in one cell with equal z and equal variance and
    colours of their own."""
    xyz = np.column_stack([rng.uniform(-half, half, n), rng.uniform(-half, half, n),
                           0.3 * np.sin(rng.uniform(0, 6, n)) + rng.normal(0, 0.05, n)])
    xyz[: n // 4, :2] = rng.uniform(-1.0, 1.0, (n // 4, 2))  # several points a cell
    xyz = near_ties(xyz.astype(np.float32))
    xyz[-5:, 2] += 4.0  # a post: a z range of ~4.6 m, a quantum of ~18 um
    mask = rng.random(n) > 0.03
    z_var = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    z_var[1::7] = z_var[::7][: len(z_var[1::7])]  # equal variances within near-tie pairs
    intensity = rng.uniform(0, 100, n).astype(np.float32)
    color = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    if exact_ties:
        for _ in range(60):
            idx = rng.choice(n - 5, 6, replace=False)
            xyz[idx, :2] = xyz[idx[0], :2] + rng.uniform(0, 0.01, (6, 2))
            xyz[idx, 2] = xyz[idx[0], 2]
            z_var[idx] = z_var[idx[0]]
            mask[idx] = True
            # Red >= 128: normal packed floats, which JAX's float min does
            # not flush, so the tie rule itself is compared bit for bit.
            color[idx, 0] = rng.integers(128, 256, 6)
    return xyz, mask, z_var, intensity, color


MODES = {
    # name: (JAX function, port function, keyword arguments of both)
    "packed": (ras_j.rasterize_scatter_packed, ras_t.rasterize_scatter_packed, {}),
    "packed_span": (ras_j.rasterize_scatter_packed, ras_t.rasterize_scatter_packed,
                    {"voxel_count_mode": "span"}),
    "twophase": (ras_j.rasterize_scatter, ras_t.rasterize_scatter, {}),
    "sort": (ras_j.rasterize, ras_t.rasterize, {}),
}


@pytest.mark.parametrize("side", [100, 300])
@pytest.mark.parametrize("mode", list(MODES))
def test_rasterizer_matches_jax(rng, mode, side):
    """100 x 100 cells keep the presence lanes; 300 x 300 (90,000 cells *
    32 > 2^21) counts voxels through one representative point each.
    Packed and twophase also take groups of points tied in z and variance
    with colours of their own (packed keeps the lowest index's colour,
    twophase the smallest colour); sort mode is held to JAX without them,
    as JAX's unstable sort may order such a group any way."""
    fn_j, fn_t, kw = MODES[mode]
    n = 8192
    xyz, mask, z_var, intensity, color = scan(rng, n, 0.05 * side * 0.9,
                                              exact_ties=mode != "sort")
    gj, gt = GeomJ(side, side, 0.1), GeomT(side, side, 0.1)
    pos = np.array([0.13, -0.27], np.float32)
    ref = jax.jit(lambda x, m, v, i, c: fn_j(
        gj, jnp.asarray(pos), x, m, v, intensity=i, color_packed=c, with_voxel_count=True,
        **kw))(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(z_var),
               jnp.asarray(intensity), pack_j(jnp.asarray(color)))
    got = fn_t(gt, torch.tensor(pos), torch.tensor(xyz), torch.tensor(mask),
               torch.tensor(z_var), intensity=torch.tensor(intensity),
               color_packed=pack_t(torch.tensor(color)), with_voxel_count=True, **kw)
    assert int(got.touched.sum()) > 2000
    assert int((got.voxel_count > 1).sum()) > 100
    for name in FIELDS:
        r, g = getattr(ref, name), getattr(got, name)
        if name == "color" and mode == "twophase":
            # XLA's CPU float min flushes subnormal colours (red < 128).
            r, g = np.asarray(r), g.numpy()
            sub = (g.view(np.int32) & 0x7F800000) == 0
            assert sub.any() and (r[sub] == 0).all()
            r, g = r[~sub], g[~sub]
        assert_same(r, g, name)


def test_packed_min_z_is_the_argmin_point(rng):
    """Packed mode's min_z is its argmin point's z: at near-ties within one
    quantum the lower index (the higher point) wins, so it differs from
    rows mode's exact min there, and equals it elsewhere."""
    n = 8192
    xyz, mask, z_var, _, _ = scan(rng, n, 4.0)
    g = GeomT(100, 100, 0.1)
    args = (g, torch.zeros(2), torch.tensor(xyz), torch.tensor(mask), torch.tensor(z_var))
    rows = ras_t.rasterize_scatter_rows(*args)
    packed = ras_t.rasterize_scatter_packed(*args)
    t = rows.touched
    assert torch.equal(t, packed.touched)
    assert torch.equal(rows.max_z[t], packed.max_z[t])
    assert torch.equal(rows.min_z_var[t], packed.min_z_var[t])
    assert (packed.min_z[t] >= rows.min_z[t]).all()
    differ = (packed.min_z[t] != rows.min_z[t]).float().mean()
    assert 0.05 < differ < 0.9


def test_windowed_packed_and_twophase_cut_the_full_map(rng):
    """A window rebases the table: the observations are the full map's cut
    to the window (the scan's points all inside it, so the z range the
    argmin key quantizes over is the same)."""
    n = 4096
    xyz, mask, z_var, intensity, _ = scan(rng, n, 1.5)
    g = GeomT(100, 100, 0.1)
    pos = torch.tensor([0.13, -0.27])
    r0, c0, wr, wc = 30, 28, 40, 44
    win = (torch.tensor(r0, dtype=torch.int32), torch.tensor(c0, dtype=torch.int32), wr, wc)
    args = (g, pos, torch.tensor(xyz), torch.tensor(mask), torch.tensor(z_var))
    for fn in (ras_t.rasterize_scatter_packed, ras_t.rasterize_scatter, ras_t.rasterize):
        full = fn(*args, intensity=torch.tensor(intensity), with_voxel_count=True)
        cut = fn(*args, intensity=torch.tensor(intensity), with_voxel_count=True, window=win)
        assert int(cut.touched.sum()) == int(full.touched.sum()) > 500
        for name in FIELDS[:-2] + ("voxel_count",):
            np.testing.assert_array_equal(
                bits(getattr(full, name)[r0:r0 + wr, c0:c0 + wc]), bits(getattr(cut, name)),
                err_msg=f"{fn.__name__} {name}")


# ---- the step -------------------------------------------------------------------


def session(rng, K=4, n=8192):
    out = []
    for k in range(K):
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(0.5, 4.5, n)
        x, y = rad * np.cos(ang), rad * np.sin(ang)
        z = 0.2 * np.sin(0.7 * x) * np.cos(0.5 * y) - 1.0 + rng.normal(0, 0.02, n)
        T = np.eye(4, dtype=np.float32)
        T[0, 3], T[1, 3] = 0.21 * k, -0.07 * k
        xyz = near_ties(np.column_stack([x, y, z]).astype(np.float32))
        xyz[-5:, 2] += 4.0  # a post (see ``scan``)
        out.append((xyz, T))
    return out


@pytest.mark.parametrize("mode,raycast,local", [("packed", True, True),
                                                ("twophase", True, False),
                                                ("sort", False, True)])
def test_build_integrate_modes_match_jax(rng, mode, raycast, local):
    """Four near-tie scans into a 10 x 10 m map at 0.1 m (100 x 100 cells)
    through ``build_integrate(scatter_mode=mode)`` of both packages."""
    maps = []
    for pkg in (fj, ft):
        cfg = pkg.Config()
        cfg.raycasting.enabled = raycast
        cfg.mapping.mode = pkg.MappingMode.LOCAL if local else pkg.MappingMode.GLOBAL
        geom = pkg.GridGeometry.from_length(10.0, 10.0, 0.1)
        if pkg is fj:
            step = pl_j.build_integrate(geom, cfg, scatter_mode=mode, donate=False)
            state = pl_j.create_map_state(geom, cfg)
        else:
            step = ft.build_integrate(geom, cfg, scatter_mode=mode, device="cpu")
            state = ft.create_map_state(geom, cfg, device="cpu")
        maps.append([pkg, step, state])
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    for xyz, T in session(rng):
        for m in maps:
            pkg, step, state = m
            arr = jnp.asarray if pkg is fj else torch.tensor
            m[2], _ = step(state, arr(xyz), arr(np.ones(len(xyz), bool)), arr(T_bs), arr(T))
    sj, st = maps[0][2], maps[1][2]
    np.testing.assert_array_equal(np.asarray(sj.position), st.position.numpy())
    assert_layers_agree(sj.layers, st)
    for name in ("n_points", "obstacle", "elevation_min", "elevation_max"):
        np.testing.assert_array_equal(np.asarray(sj.layers[name]), st.layers[name].numpy(),
                                      err_msg=name)
    assert torch.isfinite(st.layers["elevation"]).sum() > 3000
    if raycast:
        assert torch.isfinite(st.layers["raycasting"]).sum() > 3000


def test_scatter_mode_validations():
    geom = ft.GridGeometry.from_length(10.0, 10.0, 0.1)
    cfg = ft.Config()
    cfg.raycasting.enabled = True
    with pytest.raises(ValueError, match="span"):
        ft.build_integrate(geom, cfg, scatter_mode="twophase", voxel_count_mode="span",
                           device="cpu")
    with pytest.raises(ValueError, match="raycasting disabled"):
        ft.build_integrate(geom, cfg, scatter_mode="sort", device="cpu")
    with pytest.raises(ValueError, match="unknown scatter_mode"):
        ft.build_integrate(geom, cfg, scatter_mode="bogus", device="cpu")
    for mode in ("rows", "packed"):
        assert callable(ft.build_integrate(geom, cfg, scatter_mode=mode,
                                           voxel_count_mode="span", device="cpu"))
    cfg.raycasting.enabled = False
    assert callable(ft.build_integrate(geom, cfg, scatter_mode="sort", device="cpu"))
