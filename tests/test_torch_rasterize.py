"""The port's row-scatter rasterizer against the JAX package's.

Same clouds (numpy, from a seed) through ``rasterize_scatter_rows`` of both
packages on the CPU. ``touched``, ``voxel_count``, ``min_z`` / ``max_z``,
intensity, color and the gather rider's output must match bit for bit;
``min_z_var`` to rtol 1e-6 (it is the same gathered value, so in practice
also bitwise). The ordered f32 <-> int32 map must be bitwise identical,
-0.0, infinities, NaN payloads and denormals included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import pointcloud as pc_j
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.mapping import rasterize as ras_j
from fastdem_tpu_torch.cloud import pointcloud as pc_t
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.mapping import rasterize as ras_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits_equal(ref, got, what):
    assert ref is not None and got is not None, what
    np.testing.assert_array_equal(bits(ref), bits(got), err_msg=what)


SPECIAL_F32 = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 3.4028235e38, -3.4028235e38,
     1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38, 1e-40, -1e-40],
    dtype=np.float32,
)


def test_ordered_map_bitwise():
    nan_payloads = np.array(
        [0x7FC00000, 0x7F800001, 0x7FBFFFFF, 0xFFC00000, 0xFF800123, 0x7FC0BEEF],
        dtype=np.uint32,
    ).view(np.float32)
    x = np.concatenate([SPECIAL_F32, nan_payloads,
                        np.random.default_rng(0).normal(size=1000).astype(np.float32)])
    ref = np.asarray(ras_j._f32_ordered_i32(jnp.asarray(x)))
    got = ras_t._f32_ordered_i32(torch.tensor(x))
    np.testing.assert_array_equal(ref, got.numpy())
    back = ras_t._i32_ordered_f32(got)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), x.view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(ras_j._i32_ordered_f32(jnp.asarray(ref))).view(np.uint32),
        back.numpy().view(np.uint32),
    )
    # Monotone on the non-NaN values (-0.0 maps just below +0.0).
    finite = x[~np.isnan(x)]
    m = ras_t._f32_ordered_i32(torch.tensor(finite)).numpy()
    assert np.all(np.diff(finite[np.argsort(m)]) >= 0)


def make_cloud(rng, n, capacity, geom_t, ties):
    half = 0.55 * max(geom_t.length)
    xyz = np.column_stack([
        rng.uniform(-half, half, n),
        rng.uniform(-half, half, n),
        rng.normal(0.0, 0.4, n),
    ]).astype(np.float32)
    xyz[rng.random(n) < 0.02] = np.nan  # invalid rows
    if ties:
        # Groups of points in one cell with bitwise-equal z: the argmin
        # carry must pick the same (smallest-index) point.
        for g in range(40):
            idx = rng.choice(n, 6, replace=False)
            xyz[idx, :2] = xyz[idx[0], :2] + rng.uniform(0, 0.01, (6, 2))
            xyz[idx, 2] = xyz[idx[0], 2]
    return xyz


@pytest.mark.parametrize(
    "n,capacity,ties,mode",
    [
        (3000, 4096, False, "exact"),
        (3000, 4096, True, "exact"),
        (2500, 2500, True, "span"),
    ],
)
def test_rasterize_rows_matches_jax(rng, n, capacity, ties, mode):
    gj = GeomJ.from_length(8.0, 6.0, 0.1)
    gt = GeomT.from_length(8.0, 6.0, 0.1)
    xyz = make_cloud(rng, n, capacity, gt, ties)
    intensity = rng.uniform(0, 100, n).astype(np.float32)
    color = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    cj = pc_j.from_numpy(xyz, capacity=capacity, intensity=intensity, color=color)
    ct = pc_t.from_numpy(xyz, capacity=capacity, intensity=intensity, color=color,
                         device="cpu")
    np.testing.assert_array_equal(np.asarray(cj.mask), ct.mask.numpy())
    z_var = rng.uniform(1e-4, 1e-2, capacity).astype(np.float32)
    pos = np.array([0.13, -0.27], dtype=np.float32)

    from fastdem_tpu.utils.colors import pack_rgb as pack_j
    from fastdem_tpu_torch.mapping.pipeline import pack_rgb as pack_t

    col_j = pack_j(cj.channels["color"])
    col_t = pack_t(ct.channels["color"])
    assert_bits_equal(col_j, col_t, "pack_rgb")

    # A polar-style extra scatter and a gather rider over its table.
    e_size = 1025
    e_ids = rng.integers(0, e_size, capacity).astype(np.int32)
    e_vals = rng.normal(size=capacity).astype(np.float32)
    e_vals[rng.random(capacity) < 0.5] = np.inf
    r_idx = rng.integers(0, e_size - 1, 700).astype(np.int32)

    def run_j(xyz_, mask_, zv_, inten_, col_, ids_, vals_, ridx_):
        return ras_j.rasterize_scatter_rows(
            gj, jnp.asarray(pos), xyz_, mask_, zv_, intensity=inten_,
            color_packed=col_, with_voxel_count=True,
            extra_min_scatter=(ids_, vals_, e_size),
            phase_gather_rider=lambda t: (t * 2.0, ridx_),
            voxel_count_mode=mode,
        )

    ref = jax.jit(run_j)(cj.xyz, cj.mask, jnp.asarray(z_var),
                         cj.channels["intensity"], col_j, jnp.asarray(e_ids),
                         jnp.asarray(e_vals), jnp.asarray(r_idx))
    got = ras_t.rasterize_scatter_rows(
        gt, torch.tensor(pos), ct.xyz, ct.mask, torch.tensor(z_var),
        intensity=ct.channels["intensity"], color_packed=col_t,
        with_voxel_count=True,
        extra_min_scatter=(torch.tensor(e_ids), torch.tensor(e_vals), e_size),
        voxel_count_mode=mode,
    )
    assert got.touched.sum() > 500
    for name in ("touched", "voxel_count", "min_z", "max_z", "max_intensity", "color"):
        assert_bits_equal(getattr(ref, name), getattr(got, name), name)
    # The port hands the extra table itself on; the reference's rider
    # gathers from it.
    assert tuple(got.extra.shape) == (e_size - 1,)
    assert_bits_equal(ref.extra, (got.extra * 2.0)[torch.tensor(r_idx).long()], "extra")
    np.testing.assert_allclose(
        got.min_z_var.numpy(), np.asarray(ref.min_z_var), rtol=1e-6, equal_nan=True
    )


def test_rasterize_all_masked():
    gt = GeomT.from_length(2.0, 2.0, 0.1)
    xyz = torch.zeros((16, 3))
    obs = ras_t.rasterize_scatter_rows(
        gt, torch.zeros(2), xyz, torch.zeros(16, dtype=torch.bool),
        torch.ones(16), with_voxel_count=True,
    )
    assert not obs.touched.any()
    assert torch.isnan(obs.min_z).all() and (obs.voxel_count == 0).all()


def test_voxel_count_fallback_and_window_raise(rng):
    """Beyond 2^23 row-table entries the voxel count comes from one
    representative point per z-voxel, counted into its cell (the
    reference's ``voxel_unique_mask`` fallback): equal to JAX's bit for
    bit. A window rebases the table: its observations are the full map's,
    cut to the window."""
    gt, gj = GeomT(rows=500, cols=500, resolution=0.1), GeomJ(rows=500, cols=500, resolution=0.1)
    assert (gt.num_cells + 1) * (3 + 32) > (1 << 23)
    n = 20000
    xyz = np.column_stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                           rng.normal(0, 0.4, n)]).astype(np.float32)
    xyz[::5, 2] = np.round(xyz[::5, 2], 1)  # z on voxel boundaries
    mask = rng.random(n) > 0.05
    pos = np.array([0.37, -0.21], np.float32)
    ref = jax.jit(lambda x, m: ras_j.rasterize_scatter_rows(
        gj, jnp.asarray(pos), x, m, jnp.ones(n, jnp.float32), with_voxel_count=True))(
        jnp.asarray(xyz), jnp.asarray(mask))
    got = ras_t.rasterize_scatter_rows(gt, torch.tensor(pos), torch.tensor(xyz),
                                       torch.tensor(mask), torch.ones(n), with_voxel_count=True)
    assert int((got.voxel_count > 1).sum()) > 1000
    for name in ("voxel_count", "touched", "min_z", "max_z"):
        assert_bits_equal(getattr(ref, name), getattr(got, name), name)

    g = GeomT.from_length(8.0, 6.0, 0.1)
    n = 3000
    xyz = torch.tensor(make_cloud(rng, n, n, g, False))
    mask = torch.ones(n, dtype=torch.bool)
    zv = torch.tensor(rng.uniform(1e-4, 1e-2, n).astype(np.float32))
    pos = torch.tensor([0.13, -0.27])
    full = ras_t.rasterize_scatter_rows(g, pos, xyz, mask, zv, with_voxel_count=True)
    r0, c0, wr, wc = 17, 9, 40, 33
    win = ras_t.rasterize_scatter_rows(
        g, pos, xyz, mask, zv, with_voxel_count=True,
        window=(torch.tensor(r0, dtype=torch.int32), torch.tensor(c0, dtype=torch.int32),
                wr, wc),
    )
    assert 0 < win.touched.sum() < full.touched.sum()
    # min_z_var is left out: the window drops points, which moves the z
    # range the argmin carry is quantised over (in the pipeline the window
    # holds every valid point).
    for name in ("touched", "voxel_count", "min_z", "max_z"):
        assert_bits_equal(getattr(full, name)[r0:r0 + wr, c0:c0 + wc],
                          getattr(win, name), name)


def test_rows_at_2_20_cells_match_jax(rng):
    """Rows mode on a 1024 x 1024 map (2^20 cells, where the reference's
    pipeline would switch to its packed rasterizer): equal to JAX's
    ``rasterize_scatter_rows`` called directly, bit for bit on every
    layer, the voxel count through its fallback included."""
    gt, gj = GeomT(rows=1024, cols=1024, resolution=0.1), GeomJ(rows=1024, cols=1024, resolution=0.1)
    n = 30000
    xyz = np.column_stack([rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
                           rng.normal(0, 0.5, n)]).astype(np.float32)
    xyz[:5000, :2] = rng.uniform(-3, 3, (5000, 2))  # a dense patch: several points a cell
    mask = np.isfinite(xyz).all(axis=1)
    z_var = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    intensity = rng.uniform(0, 100, n).astype(np.float32)
    color = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    from fastdem_tpu.utils.colors import pack_rgb as pack_j
    from fastdem_tpu_torch.utils.colors import pack_rgb as pack_t

    pos = np.array([0.05, 0.15], np.float32)
    ref = jax.jit(lambda x, m, v, i, c: ras_j.rasterize_scatter_rows(
        gj, jnp.asarray(pos), x, m, v, intensity=i, color_packed=c, with_voxel_count=True))(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(z_var), jnp.asarray(intensity),
        pack_j(jnp.asarray(color)))
    got = ras_t.rasterize_scatter_rows(
        gt, torch.tensor(pos), torch.tensor(xyz), torch.tensor(mask), torch.tensor(z_var),
        intensity=torch.tensor(intensity), color_packed=pack_t(torch.tensor(color)),
        with_voxel_count=True)
    assert int(got.touched.sum()) > 20000
    for name in ("touched", "min_z", "max_z", "min_z_var", "max_intensity", "color",
                 "voxel_count"):
        assert_bits_equal(getattr(ref, name), getattr(got, name), name)
