"""The port's grid geometry and map ops against the JAX package, bit-exact.

Same inputs (numpy, from a seed) through ``fastdem_tpu.grid`` and
``fastdem_tpu_torch.grid`` on the CPU; every output must match bit for bit,
including padded 1e9-sentinel points, NaN points, exact half-cell moves
and both shift signs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.grid import gridmap as gm_j
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu_torch.grid import gridmap as gm_t
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

GEOMS = [(15.0, 15.0, 0.1), (12.0, 12.0, 0.2), (3.0, 5.0, 0.25)]


def both_geoms(w, h, res):
    return GeomJ.from_length(w, h, res), GeomT.from_length(w, h, res)


def assert_bits_equal(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype, (ref.dtype, got.dtype)
    if ref.dtype.kind == "f":
        np.testing.assert_array_equal(ref.view(np.int32), got.view(np.int32))
    else:
        np.testing.assert_array_equal(ref, got)


def sample_points(rng, geom_t, n=5000):
    half = 0.6 * max(geom_t.length)
    xy = rng.uniform(-half, half, (n, 2)).astype(np.float32)
    # Points exactly on cell edges, padded sentinels and NaN rows.
    res = np.float32(geom_t.resolution)
    xy[:200] = (np.round(xy[:200] / res) * res).astype(np.float32)
    xy[200:220] = 1e9
    xy[220:230] = -1e9
    xy[230:240, 0] = np.nan
    return xy


@pytest.mark.parametrize("w,h,res", GEOMS)
def test_geometry_matches_jax_bitwise(rng, w, h, res):
    gj, gt = both_geoms(w, h, res)
    assert (gj.rows, gj.cols, gj.resolution) == (gt.rows, gt.cols, gt.resolution)
    pos = np.array([0.37, -1.13], dtype=np.float32)
    xy = sample_points(rng, gt)
    pj, pt = jnp.asarray(pos), torch.tensor(pos)

    ref = jax.jit(gj.index_of)(pj, jnp.asarray(xy))
    got = gt.index_of(pt, torch.tensor(xy))
    for a, b in zip(ref, got):
        assert_bits_equal(a, b)
    ref = jax.jit(gj.cell_id_of)(pj, jnp.asarray(xy))
    got = gt.cell_id_of(pt, torch.tensor(xy))
    for a, b in zip(ref, got):
        assert_bits_equal(a, b)
    # The sentinel rows land in the dump slot on the CPU path too.
    assert (got[0][200:230] == gt.num_cells).all()

    rows = rng.integers(0, gt.rows, 300).astype(np.int32)
    cols = rng.integers(0, gt.cols, 300).astype(np.int32)
    ref = gj.position_of(pj, jnp.asarray(rows), jnp.asarray(cols))
    got = gt.position_of(pt, torch.tensor(rows), torch.tensor(cols))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref = gj.cell_centers(pj)
    got = gt.cell_centers(pt)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_sentinel_cast_saturates():
    """The f32 -> int32 cast saturates like the reference's, where a plain
    torch cast on the CPU would wrap to INT_MIN."""
    from fastdem_tpu_torch.grid.geometry import floor_i32

    x = np.array([-1e10, 1e10, np.nan, -2.5, 2.5, 2147483520.0], dtype=np.float32)
    ref = jnp.floor(jnp.asarray(x)).astype(jnp.int32)
    assert_bits_equal(ref, floor_i32(torch.tensor(x)))


def make_states(geom_j, geom_t, rng, pos=(0.0, 0.0)):
    fills = gm_j.default_layer_fills()
    fills["variance"] = 0.0
    sj = gm_j.create(geom_j, fills, pos)
    st = gm_t.create(geom_t, fills, pos, device="cpu")
    vals = {
        k: rng.normal(size=geom_t.shape).astype(np.float32) for k in fills
    }
    vals["elevation"][rng.random(geom_t.shape) < 0.3] = np.nan
    sj = sj.replace_layers({k: jnp.asarray(v) for k, v in vals.items()})
    st = st.replace_layers({k: torch.tensor(v) for k, v in vals.items()})
    return sj, st


@pytest.mark.parametrize(
    "target",
    [
        (0.05, 0.0),  # exactly half a cell at res 0.1: away from zero
        (-0.05, 0.0),
        (0.0, 0.15),  # one and a half cells
        (0.0, -0.15),
        (0.31, -0.42),
        (-1.27, 2.05),
        (40.0, -40.0),  # beyond the map: everything clears
    ],
)
def test_move_matches_jax_bitwise(rng, target):
    gj, gt = both_geoms(3.0, 4.0, 0.1)
    sj, st = make_states(gj, gt, rng, pos=(0.2, -0.3))
    tgt = np.array(target, dtype=np.float32) + np.array([0.2, -0.3], np.float32)
    ref = jax.jit(lambda s, t: gm_j.move(gj, s, t))(sj, jnp.asarray(tgt))
    got = gm_t.move(gt, st, torch.tensor(tgt))
    assert_bits_equal(ref.position, got.position)
    for k in ref.layers:
        assert_bits_equal(ref.layers[k], got.layers[k])


def test_round_half_away_matches_jax():
    x = np.array([-2.5, -1.5, -0.5, -0.0, 0.0, 0.5, 1.5, 2.5, 0.49999997, -3.7],
                 dtype=np.float32)
    assert_bits_equal(gm_j.round_half_away(jnp.asarray(x)),
                      gm_t.round_half_away(torch.tensor(x)))
    # torch.round rounds half to even: the port must not use it here.
    assert torch.round(torch.tensor(0.5)).item() == 0.0


def test_clear_and_snapshot(rng):
    gj, gt = both_geoms(2.0, 2.0, 0.1)
    sj, st = make_states(gj, gt, rng)
    mask = rng.random(gt.shape) < 0.4
    ref = gm_j.clear_at_mask(sj, jnp.asarray(mask))
    got = gm_t.clear_at_mask(st, torch.tensor(mask))
    for k in ref.layers:
        assert_bits_equal(ref.layers[k], got.layers[k])
    cleared = gm_t.clear_all(st)
    assert all(torch.isnan(v).all() for v in cleared.layers.values())
    snap = gm_t.snapshot(st, ["elevation", "missing"])
    assert list(snap.layers) == ["elevation"]
    assert snap.layers["elevation"] is st.layers["elevation"]


def test_create_on_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, gt = both_geoms(1.0, 1.0, 0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gm_t.create(gt, gm_t.default_layer_fills(), device="cuda")


@pytest.mark.parametrize("geom_args", GEOMS)
def test_runtime_helpers_match_jax(geom_args):
    """is_internal, is_finite_mask and submap_slices (the driver's, the
    bridge's and the wire's helpers) answer as JAX's, submaps clipped at
    every edge."""
    gj, gt = both_geoms(*geom_args)
    rng = np.random.default_rng(5)
    elev = rng.normal(size=gj.shape).astype(np.float32)
    elev[rng.random(gj.shape) < 0.3] = np.nan
    sj = gm_j.create(gj, {"elevation": 0.0}).replace_layer("elevation", jnp.asarray(elev))
    st = gm_t.create(gt, {"elevation": 0.0}, device="cpu").replace_layer(
        "elevation", torch.tensor(elev))
    assert_bits_equal(gm_j.is_finite_mask(sj, "elevation"), gm_t.is_finite_mask(st, "elevation"))
    for name in ("elevation", "_kalman_p", "", "_"):
        assert gm_t.is_internal(name) == gm_j.is_internal(name)
    pos = np.array([0.35, -1.15], np.float32)
    for center in ((0.0, 0.0), (2.0, -3.0), (-40.0, 7.0), (0.37, 0.12)):
        for length in ((1.0, 2.0), (3.3, 0.7), (100.0, 100.0)):
            assert (gm_t.submap_slices(gt, pos, center, length)
                    == gm_j.submap_slices(gj, pos, center, length))
