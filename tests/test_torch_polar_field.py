"""The port's polar ray field (K1's plain twin) against the JAX package.

At the three shapes of the reference's own kernel test
(``tests/test_rowops.py::TestPallasPolarField``), the port's
``polar_smeared_field`` on the CPU -- where it runs K1's plain PyTorch twin
-- is held against JAX's XLA formulation and against the Pallas kernel in
interpret mode: identical finite sets, heights within 4e-6 (the one affine
evaluation h = z0 + slope * d may or may not be contracted into an FMA).
The CPU path must never count a kernel launch, and asking for the kernel on
a CPU tensor raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.ops.pallas_polar import polar_smeared_field_pallas
from fastdem_tpu.postprocess import raycasting as ray_j
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.ops import polar_field as k1
from fastdem_tpu_torch.postprocess import raycasting as ray_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [
    (2048, 0.25, 12.81, True),
    (1024, 0.5, 9.0, True),
    (2048, 0.25, 12.81, False),
]
SENSOR = np.array([0.07, -0.03, 1.2], dtype=np.float32)


def table(rng, R, A):
    tbl = rng.uniform(-2.0, 0.5, R * A).astype(np.float32)
    tbl[rng.random(R * A) < 0.97] = np.inf
    return tbl


def assert_field_close(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    np.testing.assert_array_equal(np.isfinite(ref), np.isfinite(got))
    both = np.isfinite(ref)
    np.testing.assert_allclose(got[both], ref[both], rtol=0, atol=4e-6)


@pytest.mark.parametrize("num_az,rbf,maxr,exact", SHAPES)
def test_plain_twin_matches_xla_and_pallas(rng, num_az, rbf, maxr, exact):
    gj = GeomJ.from_length(15.0, 15.0, 0.1)
    gt = GeomT.from_length(15.0, 15.0, 0.1)
    A, R, dr = ray_t.polar_dims(gt, num_az, rbf, maxr)
    assert (A, R, dr) == ray_j.polar_dims(gj, num_az, rbf, maxr)
    tbl = table(rng, R, A)
    so_j, so_t = jnp.asarray(SENSOR), torch.tensor(SENSOR)

    ref_xla = ray_j.polar_smeared_field(
        gj, so_j, jnp.asarray(tbl), num_az, rbf, maxr, exact_window=exact,
        impl="xla",
    )
    ref_pallas = polar_smeared_field_pallas(
        gj, so_j, jnp.asarray(tbl), num_az, rbf, maxr, exact_window=exact,
        interpret=True,
    )
    before = k1.launches
    for impl in ("auto", "xla"):
        got = ray_t.polar_smeared_field(
            gt, so_t, torch.tensor(tbl), num_az, rbf, maxr, exact_window=exact,
            impl=impl,
        )
        assert got.dtype == torch.float32 and tuple(got.shape) == (R, A)
        assert_field_close(ref_xla, got)
        assert_field_close(ref_pallas, got)
    assert k1.launches == before


def test_column_windows_match_jax():
    for geom_args, num_az, rbf, maxr in [((15.0, 15.0, 0.1), 2048, 0.25, 12.81),
                                         ((12.0, 12.0, 0.2), 1024, 0.5, None)]:
        gj, gt = GeomJ.from_length(*geom_args), GeomT.from_length(*geom_args)
        A, R, dr = ray_t.polar_dims(gt, num_az, rbf, maxr)
        lj, sj = ray_j._column_windows(gj, A, R, dr)
        lt, st = ray_t._column_windows(gt, A, R, dr)
        np.testing.assert_array_equal(lj, lt)
        np.testing.assert_array_equal(sj, st)
        win = ray_t.column_windows(gt, num_az, rbf, maxr, "cpu")
        assert win.lvl.dtype == torch.int32 and tuple(win.lvl.shape) == (R,)
        assert (win.max_lvl, win.max_shift) == (int(lj.max()), int(sj.max()))


def test_kernel_refuses_cpu_tensors(rng):
    gt = GeomT.from_length(15.0, 15.0, 0.1)
    A, R, dr = ray_t.polar_dims(gt, 2048, 0.25, 12.81)
    tbl = torch.tensor(table(rng, R, A))
    before = k1.launches
    with pytest.raises(ValueError, match="CUDA"):
        ray_t.polar_smeared_field(
            gt, torch.tensor(SENSOR), tbl, 2048, 0.25, 12.81, exact_window=True,
            impl="pallas",
        )
    with pytest.raises(ValueError, match="unknown polar_field_impl"):
        ray_t.polar_smeared_field(gt, torch.tensor(SENSOR), tbl, 2048, 0.25,
                                  12.81, impl="pallas_interpret")
    assert k1.launches == before


def test_kernel_refuses_bad_fold_widths(rng):
    """The column pass folds 1..NFOLD_MAX rows; anything else is refused
    before a launch."""
    gt = GeomT.from_length(15.0, 15.0, 0.1)
    A, R, dr = ray_t.polar_dims(gt, 1024, 0.5, 9.0)
    scat = torch.tensor(table(rng, R, A)).reshape(R, A)
    win = ray_t.column_windows(gt, 1024, 0.5, 9.0, "cpu")
    so = torch.tensor(SENSOR)
    for nfold in (1, k1.NFOLD_MAX):
        k1._check_inputs(scat, win, so, nfold)
    before = k1.launches
    for nfold in (0, k1.NFOLD_MAX + 1):
        with pytest.raises(ValueError, match="nfold"):
            k1._check_inputs(scat, win, so, nfold)
    with pytest.raises(ValueError, match="CUDA"):
        k1.polar_field_cuda(scat, win, so, dr, 2, True)
    assert k1.launches == before


def test_scatter_spec_and_resample_match_jax(rng):
    """Polar keys and slopes match bit for bit. The per-cell lookups use
    atan2 and hypot, which neither library rounds correctly: last-ulp
    differences move at most 0.2% of cells across a bin boundary."""
    gj = GeomJ.from_length(15.0, 15.0, 0.1)
    gt = GeomT.from_length(15.0, 15.0, 0.1)
    n = 20000
    xyz = np.column_stack([
        rng.uniform(-9, 9, n), rng.uniform(-9, 9, n), rng.uniform(-1.5, 0.8, n)
    ]).astype(np.float32)
    mask = rng.random(n) < 0.95
    pos = np.array([0.3, -0.2], dtype=np.float32)
    so = np.array([0.31, -0.17, 1.05], dtype=np.float32)
    ref = jax.jit(
        lambda p, x, m, s: ray_j.polar_scatter_spec(gj, p, x, m, s, 2048, 0.25, 12.81)
    )(pos, xyz, mask, so)
    got = ray_t.polar_scatter_spec(
        gt, torch.tensor(pos), torch.tensor(xyz), torch.tensor(mask),
        torch.tensor(so), 2048, 0.25, 12.81,
    )
    np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    assert ref[2] == got[2]

    ref = jax.jit(lambda p, s: ray_j.resample_indices(gj, p, s, 2048, 0.25, 12.81))(
        pos, so
    )
    got = ray_t.resample_indices(gt, torch.tensor(pos), torch.tensor(so),
                                 2048, 0.25, 12.81)
    for name, a, b in zip(("a0", "a1", "r_idx", "in_range"), ref, got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape == gt.shape, name
        assert np.mean(a != b) <= 2e-3, name
