"""K4, the per-cell lookup of the polar ray field, and the raycast's
standalone forms, against the JAX package.

(a) K4's plain twin against the reference's Pallas kernel
    ``resample_min2`` run in interpret mode, on the same seeded field
    (transposed from the kernel's [A, R] to the port's [R, A]) and indices:
    equal bit for bit where the kernel's min is finite, NaN and untouched
    where it is not; the one-read form against the kernel with a1 = a0.
(b) ``polar_resample`` with ``exact_window`` (one read) against the
    two-read form on a scattered LiDAR table, in the port: bitwise-equal
    heights and touched sets (the claim of
    ``tests/test_kernels_parity.py::test_exact_window_single_gather_bitwise``).
(c) ``polar_resample``, ``ray_min_height_polar`` and ``apply_raycasting``'s
    standalone forms against JAX at the polar tolerances of
    ``tests/test_torch_polar_field.py``: atan2 is not correctly rounded in
    either library, so up to 0.2% of cells may look up another bin; every
    other cell has the same touched flag and a height within 4e-6.
(d) The main path's K4, the lookup with its index math: its plain twin
    equals ``resample_indices`` followed by ``resample_plain`` bit for bit,
    and is held against JAX's jitted ``resample_indices`` plus the gather of
    its pipeline (``fastdem_tpu/mapping/pipeline.py`` phase_a) with at most
    0.2% of cells differing: on the flagship's full map and on a GLOBAL
    window whose offsets are int32 device scalars, with one read and two.
The CPU path never counts a launch, and the kernels refuse CPU tensors and
bad window scalars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.config.config import RaycastingConfig as RayCfgJ
from fastdem_tpu.grid import gridmap as gm_j
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.ops.pallas_resample import resample_min2
from fastdem_tpu.postprocess import raycasting as ray_j
from fastdem_tpu_torch.config import RaycastingConfig as RayCfgT
from fastdem_tpu_torch.grid import gridmap as gm_t
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.ops import resample as k4
from fastdem_tpu_torch.postprocess import raycasting as ray_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

LOOKUP_SHARE = 2e-3  # cells whose lookup may differ (atan2 last ulp)


def field_and_indices(rng, A, R, shape, nan_share=0.0):
    field = rng.uniform(-2.0, 0.5, (A, R)).astype(np.float32)
    field[rng.random((A, R)) < 0.97] = np.inf
    field[rng.random((A, R)) < nan_share] = np.nan
    a0 = rng.integers(0, A, shape).astype(np.int32)
    a1 = rng.integers(0, A, shape).astype(np.int32)
    r = rng.integers(0, R, shape).astype(np.int32)
    return field, a0, a1, r


@pytest.mark.parametrize("two_reads", [True, False])
@pytest.mark.parametrize("nan_share", [0.0, 0.01])
def test_twin_matches_pallas_interpret(rng, two_reads, nan_share):
    A, R, shape = 256, 96, (37, 41)
    field, a0, a1, r = field_and_indices(rng, A, R, shape, nan_share)
    # Dense finite regions too, so that many cells see two finite values.
    field[:, :8] = rng.uniform(-2.0, 0.5, (A, 8)).astype(np.float32)
    r[:10] = rng.integers(0, 8, (10, shape[1]))
    in_range = rng.random(shape) < 0.9
    ref = np.asarray(resample_min2(
        jnp.asarray(field), jnp.asarray(a0), jnp.asarray(a1 if two_reads else a0),
        jnp.asarray(r), interpret=True,
    ))
    before = k4.launches
    h, touched = k4.resample_plain(
        torch.tensor(field.T.copy()), torch.tensor(a0),
        torch.tensor(a1) if two_reads else None, torch.tensor(r), torch.tensor(in_range),
    )
    assert k4.launches == before
    assert h.dtype == torch.float32 and touched.dtype == torch.bool
    assert tuple(h.shape) == tuple(touched.shape) == shape
    want_touched = np.isfinite(ref) & in_range
    np.testing.assert_array_equal(touched.numpy(), want_touched)
    np.testing.assert_array_equal(h.numpy()[want_touched].view(np.int32),
                                  ref[want_touched].view(np.int32))
    assert np.isnan(h.numpy()[~want_touched]).all()
    assert want_touched.sum() > 300


def scene(rng, n=6000):
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.3, 8.0, n)
    x, y = rad * np.cos(ang), rad * np.sin(ang)
    z = 0.3 * np.sin(x) * np.cos(y) + rng.normal(0, 0.03, n) - 1.0
    xyz = np.column_stack([x, y, z]).astype(np.float32)
    return xyz, rng.uniform(size=n) > 0.1


POS = np.array([0.2, -0.1], dtype=np.float32)
ORIGIN = np.array([0.3, -0.2, 0.8], dtype=np.float32)
POLAR = (2048, 0.25, 9.5)


def table_t(gt, xyz, mask):
    key, vals, size = ray_t.polar_scatter_spec(
        gt, torch.tensor(POS), torch.tensor(xyz), torch.tensor(mask),
        torch.tensor(ORIGIN), *POLAR,
    )
    table = torch.full((size,), float("inf"))
    return table.scatter_reduce_(0, key.long(), vals, "amin")[: size - 1]


def test_exact_window_one_read_equals_two_reads(rng):
    gt = GeomT.from_length(12.0, 12.0, 0.1)
    xyz, mask = scene(rng)
    table = table_t(gt, xyz, mask)
    h2, t2 = ray_t.polar_resample(gt, torch.tensor(POS), torch.tensor(ORIGIN), table,
                                  *POLAR)
    h1, t1 = ray_t.polar_resample(gt, torch.tensor(POS), torch.tensor(ORIGIN), table,
                                  *POLAR, exact_window=True)
    assert t1.sum() > 5000
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())
    np.testing.assert_array_equal(h1.numpy(), h2.numpy())


def assert_rays_close(ref, got):
    (h_j, t_j), (h_t, t_t) = ref, got
    h_j, t_j, h_t, t_t = np.asarray(h_j), np.asarray(t_j), h_t.numpy(), t_t.numpy()
    assert t_j.shape == t_t.shape and t_j.sum() > 5000
    assert np.mean(t_j != t_t) <= LOOKUP_SHARE
    both = t_j & t_t
    close = np.abs(h_j[both] - h_t[both]) <= 4e-6
    assert close.mean() >= 1.0 - LOOKUP_SHARE
    assert np.isnan(h_t[~t_t]).all()


@pytest.mark.parametrize("exact", [False, True])
def test_polar_resample_and_ray_min_height_match_jax(rng, exact):
    gj, gt = GeomJ.from_length(12.0, 12.0, 0.1), GeomT.from_length(12.0, 12.0, 0.1)
    xyz, mask = scene(rng)
    table = table_t(gt, xyz, mask)
    ref = jax.jit(lambda p, o, t: ray_j.polar_resample(gj, p, o, t, *POLAR,
                                                       exact_window=exact))(
        POS, ORIGIN, jnp.asarray(table.numpy()))
    got = ray_t.polar_resample(gt, torch.tensor(POS), torch.tensor(ORIGIN), table,
                               *POLAR, exact_window=exact)
    assert_rays_close(ref, got)
    if not exact:
        ref = jax.jit(lambda p, x, m, o: ray_j.ray_min_height_polar(gj, p, x, m, o, *POLAR))(
            POS, xyz, mask, ORIGIN)
        got = ray_t.ray_min_height_polar(gt, torch.tensor(POS), torch.tensor(xyz),
                                         torch.tensor(mask), torch.tensor(ORIGIN), *POLAR)
        assert_rays_close(ref, got)


@pytest.mark.parametrize("form", ["scan", "polar_table", "fields"])
def test_apply_raycasting_standalone_forms_match_jax(rng, form):
    gj, gt = GeomJ.from_length(12.0, 12.0, 0.1), GeomT.from_length(12.0, 12.0, 0.1)
    xyz, mask = scene(rng)
    # A map whose elevations stick up through some of the scan's rays.
    elev = (0.3 * np.sin(np.arange(120)[:, None] * 0.1) - 0.9
            + rng.normal(0, 0.3, (120, 120))).astype(np.float32)
    elev[rng.random((120, 120)) < 0.3] = np.nan
    fills = {**gm_t.default_layer_fills(), **ray_t.layer_fills()}
    sj = gm_j.create(gj, fills, tuple(POS))
    # Log-odds one conflict away from the clear threshold.
    lo = np.full((120, 120), -0.9, dtype=np.float32)
    sj = sj.replace_layers({"elevation": jnp.asarray(elev),
                            "_visibility_logodds": jnp.asarray(lo)})
    st = gm_t.create(gt, fills, tuple(POS), device="cpu")
    st = st.replace_layers({"elevation": torch.tensor(elev),
                            "_visibility_logodds": torch.tensor(lo)})
    cfg_j, cfg_t = RayCfgJ(), RayCfgT()
    kw_j, kw_t = {}, {}
    if form == "polar_table":
        table = table_t(gt, xyz, mask)
        kw_j["polar_table"], kw_t["polar_table"] = jnp.asarray(table.numpy()), table
    elif form == "fields":
        count = rng.integers(0, 3, (120, 120)).astype(np.float32)
        ray = ray_t.ray_min_height_polar(gt, torch.tensor(POS), torch.tensor(xyz),
                                         torch.tensor(mask), torch.tensor(ORIGIN), *POLAR)
        kw_j["obs_count"], kw_t["obs_count"] = jnp.asarray(count), torch.tensor(count)
        kw_j["ray_min_touched"] = tuple(jnp.asarray(a.numpy()) for a in ray)
        kw_t["ray_min_touched"] = ray
    num_az, rbf, maxr = POLAR
    out_j = jax.jit(lambda s, x, m, o: ray_j.apply_raycasting(
        gj, s, x, m, o, cfg_j, num_azimuth=num_az, range_bin_factor=rbf,
        max_range=maxr, **kw_j))(sj, xyz, mask, ORIGIN)
    out_t = ray_t.apply_raycasting(
        gt, st, torch.tensor(xyz), torch.tensor(mask), torch.tensor(ORIGIN), cfg_t,
        num_azimuth=num_az, range_bin_factor=rbf, max_range=maxr, **kw_t)
    assert set(out_j.layers) == set(out_t.layers)
    for name, ref in out_j.layers.items():
        ref, got = np.asarray(ref), out_t.layers[name].numpy()
        close = np.isclose(got, ref, rtol=0, atol=4e-6, equal_nan=True)
        assert close.mean() >= 1.0 - LOOKUP_SHARE, name
    assert (out_t.layers["ghost_removal"] == 1.0).sum() > 20
    with pytest.raises(ValueError, match="unknown raycasting method"):
        ray_t.apply_raycasting(gt, st, None, None, torch.tensor(ORIGIN), cfg_t,
                               method="bogus")
    if form == "scan":
        # The sampled method, against the same jitted form: identical layers.
        out_j = jax.jit(lambda s, x, m, o: ray_j.apply_raycasting(
            gj, s, x, m, o, cfg_j, method="sampled", num_samples=240))(
            sj, xyz, mask, ORIGIN)
        out_t = ray_t.apply_raycasting(
            gt, st, torch.tensor(xyz), torch.tensor(mask), torch.tensor(ORIGIN), cfg_t,
            method="sampled", num_samples=240)
        for name, ref in out_j.layers.items():
            np.testing.assert_array_equal(out_t.layers[name].numpy(), np.asarray(ref),
                                          err_msg=name)
        assert (out_t.layers["ghost_removal"] == 1.0).sum() > 20


# (d) The main path's K4. Flagship: 15x15 m at 0.1 m, A = 2048, range bin
# factor 0.25, field [515, 2048], the whole map. GLOBAL: 200x200 m at 0.1 m,
# field [962, 2048], the 484x484 window around the sensor.
LOOKUP_CASES = {
    "flagship": ((15.0, 15.0, 0.1), (2048, 0.25, 12.81), None,
                 [0.2, -0.1], [0.31, -0.17, 1.05]),
    "global_window": ((200.0, 200.0, 0.1), (2048, 0.25, 24.0), (484, 484),
                      [0.0, 0.0], [-10.37, 5.21, 1.0]),
}


def lookup_inputs(rng, case):
    geom_args, polar, win, pos, so = LOOKUP_CASES[case]
    gj, gt = GeomJ.from_length(*geom_args), GeomT.from_length(*geom_args)
    A, R, _ = ray_t.polar_dims(gt, *polar)
    field = rng.uniform(-2.0, 0.5, (R, A)).astype(np.float32)
    field[rng.random((R, A)) < 0.5] = np.inf
    pos, so = np.array(pos, np.float32), np.array(so, np.float32)
    window = None
    if win is not None:
        # The pipeline's window_at: centred on the sensor, clipped to the map.
        sr, sc, _ = gt.index_of(torch.tensor(pos), torch.tensor(so[:2]))
        wr, wc = win
        r0 = torch.clamp(torch.clamp(sr, 0, gt.rows) - wr // 2, 0, gt.rows - wr)
        c0 = torch.clamp(torch.clamp(sc, 0, gt.cols) - wc // 2, 0, gt.cols - wc)
        assert r0.dtype == c0.dtype == torch.int32 and r0.dim() == 0
        window = (r0, c0, wr, wc)
    return gj, gt, polar, field, pos, so, window


@pytest.mark.parametrize("two_reads", [False, True])
@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_lookup_twin_equals_indices_then_resample(rng, case, two_reads):
    _, gt, polar, field, pos, so, window = lookup_inputs(rng, case)
    lk = ray_t.polar_lookup(gt, *polar)
    args = (torch.tensor(field), lk, torch.tensor(pos), torch.tensor(so))
    before = k4.launches
    got = k4.resample_lookup(*args, window=window, two_reads=two_reads)
    assert k4.launches == before
    a0, a1, r_idx, in_range = ray_t.resample_indices(
        gt, torch.tensor(pos), torch.tensor(so), *polar, window=window)
    ref = k4.resample_plain(torch.tensor(field), a0, a1 if two_reads else None, r_idx,
                            in_range)
    shape = gt.shape if window is None else window[2:]
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(shape) and g.dtype == r.dtype
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), ref[0].numpy().view(np.int32))
    assert got[1].sum() > 0.3 * got[1].numel()


@pytest.mark.parametrize("two_reads", [False, True])
@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_lookup_twin_matches_jax_indices_and_gather(rng, case, two_reads):
    gj, gt, polar, field, pos, so, window = lookup_inputs(rng, case)
    lk = ray_t.polar_lookup(gt, *polar)
    h_t, t_t = k4.resample_lookup_plain(torch.tensor(field), lk, torch.tensor(pos),
                                        torch.tensor(so), window=window,
                                        two_reads=two_reads)
    win_j = None if window is None else (jnp.int32(int(window[0])), jnp.int32(int(window[1])),
                                         *window[2:])

    def lookup_j(p, s, r0c0):
        w = None if win_j is None else (r0c0[0], r0c0[1], *win_j[2:])
        return ray_j.resample_indices(gj, p, s, *polar, window=w)

    r0c0 = None if win_j is None else jnp.stack(win_j[:2])
    a0, a1, r_idx, in_range = (np.asarray(x) for x in jax.jit(lookup_j)(pos, so, r0c0))
    # JAX's pipeline gathers from the [R, A] field at r_idx * A + a0 (and
    # + a1 with two reads) and takes the min.
    A = polar[0]
    flat = field.reshape(-1)
    h_j = flat[r_idx * A + a0]
    if two_reads:
        h_j = np.minimum(h_j, flat[r_idx * A + a1])
    t_j = np.isfinite(h_j) & in_range
    h_t, t_t = h_t.numpy(), t_t.numpy()
    assert t_j.shape == t_t.shape and t_j.sum() > 0.3 * t_j.size
    assert np.mean(t_j != t_t) <= LOOKUP_SHARE
    both = t_j & t_t
    assert np.mean(h_t[both].view(np.int32) != h_j[both].view(np.int32)) <= LOOKUP_SHARE
    assert np.isnan(h_t[~t_t]).all()


def test_lookup_kernel_refuses_cpu_tensors_and_bad_windows(rng):
    _, gt, polar, field, pos, so, window = lookup_inputs(rng, "global_window")
    lk = ray_t.polar_lookup(gt, *polar)
    args = (torch.tensor(field), lk, torch.tensor(pos), torch.tensor(so))
    before = k4.launches
    with pytest.raises(ValueError, match="CUDA"):
        k4.resample_lookup_cuda(*args, window=window)
    r0, c0, wr, wc = window
    check = k4._check_lookup_inputs
    check(*args, window)
    check(*args, None)
    for bad in ((r0.long(), c0, wr, wc), (r0, int(c0), wr, wc),
                (r0, torch.stack([c0, c0]), wr, wc)):
        with pytest.raises(ValueError, match="window offset"):
            check(*args, bad)
    for bad in ((r0, c0, 0, wc), (r0, c0, wr, gt.cols + 1), (r0, c0, float(wr), wc)):
        with pytest.raises(ValueError, match="window extent"):
            check(*args, bad)
    with pytest.raises(ValueError, match="field must be"):
        check(torch.tensor(field[:-1]), *args[1:], None)
    with pytest.raises(ValueError, match="contiguous"):
        check(torch.tensor(field).t().contiguous().t(), *args[1:], None)
    with pytest.raises(ValueError, match="sensor_origin"):
        check(*args[:3], torch.tensor(so[:2]), None)
    with pytest.raises(ValueError, match="position"):
        check(args[0], lk, torch.tensor(pos).double(), args[3], None)
    assert k4.launches == before


def test_lookup_params_are_the_twins_f32_constants():
    lk = ray_t.polar_lookup(GeomT.from_length(15.0, 15.0, 0.1), 2048, 0.25, 12.81)
    p = lk.params(150, 150, True)
    assert (p.R, p.A, p.wr, p.wc, p.two_reads) == (515, 2048, 150, 150, 1)
    f32 = np.float32
    for name, want in (("half_x", f32(7.5)), ("res", f32(0.1)), ("dr", f32(0.025)),
                       ("a_f", f32(2048)), ("r_max", f32(514 * 0.025)),
                       ("inv_dr", f32(1) / f32(0.025)), ("pi", f32(np.pi)),
                       ("inv_2pi", f32(1) / f32(2 * np.pi))):
        assert f32(getattr(p, name)) == want, name
