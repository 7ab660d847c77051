"""The port's neighbour search against the JAX package's, on the CPU.

Same seeded clouds through both packages. Tolerances: distances bit for
bit (both compute ``sqrt(fma(dz, dz, fma(dy, dy, dx*dx)))`` of the direct
differences); indices, counts and certificate flags exactly, on scenes
without distance ties (uniform random coordinates). Where the scene has
ties, the port's rule -- the lowest point index first -- is checked on its
own. The grid path is reached on test-sized clouds by lowering the
crossover, as ``tests/test_search_grid.py`` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import search as sj
from fastdem_tpu_torch.cloud import search as st
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


def _np(*xs):
    return [np.asarray(x) for x in xs]


@pytest.fixture(scope="module")
def scene():
    """A 2.5D surface with far outliers (their kth neighbour is farther
    than any sane bucket, so certificates fail and the fallback runs) and
    one masked point."""
    rng = np.random.default_rng(3)
    n = 4000
    xyz = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    xyz[:, 2] = (0.1 * np.sin(xyz[:, 0]) + 0.02 * rng.normal(size=n)).astype(np.float32)
    xyz[:20] *= 6
    mask = np.ones(n, bool)
    mask[7] = False
    return xyz, mask


def test_knn_brute_matches_jax(scene):
    xyz, mask = scene
    ri, rd = _np(*sj.knn_brute(jnp.asarray(xyz), jnp.asarray(mask), 10))
    gi, gd = st.knn_brute(torch.tensor(xyz), torch.tensor(mask), 10)
    np.testing.assert_array_equal(gd.numpy(), rd)
    np.testing.assert_array_equal(gi.numpy(), ri)


def test_knn_grid_matches_jax(scene):
    """Grid with certificate and fallback == JAX's brute oracle (which its
    own tests hold its grid to; the direct comparisons with JAX's grid are
    the explicit-query and auto tests below, smaller to compile), and
    masked self-queries give -1 / inf."""
    xyz, mask = scene
    ri, rd = _np(*sj.knn_brute(jnp.asarray(xyz), jnp.asarray(mask), 10))
    gi, gd = st.knn_grid(torch.tensor(xyz), torch.tensor(mask), 10)
    gi, gd = gi.numpy(), gd.numpy()
    np.testing.assert_array_equal(gd[mask], rd[mask])
    np.testing.assert_array_equal(gi[mask], ri[mask])
    assert (gi[~mask] == -1).all() and np.isinf(gd[~mask]).all()
    stats = st.last_grid_stats
    first = stats["passes"][0]
    assert stats["queries"] == len(xyz) and first["rows"] == len(xyz) - 1  # valid rows
    assert 0.8 * first["rows"] < first["certified"] < first["rows"]
    assert len(stats["passes"]) >= 2  # the outliers took a wider grid or the brute tile


def test_dense_grid_certificate_matches_jax(scene):
    """The per-query pass: the same geometry and the same exactness flags
    as JAX's DenseGrid.knn; certified rows equal the brute result."""
    xyz, mask = scene
    b = st._auto_bucket_size(torch.tensor(xyz), torch.tensor(mask), 10)
    assert b == sj._auto_bucket_size(jnp.asarray(xyz), jnp.asarray(mask), 10)
    gj = sj.DenseGrid(jnp.asarray(xyz), jnp.asarray(mask), b)
    gt = st.DenseGrid(torch.tensor(xyz), torch.tensor(mask), b)
    assert gt.dims == gj.dims
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    ri, rd, rex = _np(*gj.knn(jnp.asarray(xyz), 10, self_pos=gj.inv_order))
    gi, gd, gex = gt.knn(torch.tensor(xyz), 10, self_pos=gt.inv_order)
    np.testing.assert_array_equal(gex.numpy(), rex)
    ex = gex.numpy()
    assert 0.8 < ex.mean() < 1.0
    np.testing.assert_array_equal(gd.numpy()[ex], rd[ex])
    np.testing.assert_array_equal(gi.numpy()[ex], ri[ex])
    # Without the cap only the kth-distance condition can fail: a superset
    # of the rows, each equal to the brute oracle.
    bi, bd = _np(*sj.knn_brute(jnp.asarray(xyz), jnp.asarray(mask), 10))
    ui, ud, uex = gt.knn_uncapped(torch.tensor(xyz), 10, self_pos=gt.inv_order)
    uex = uex.numpy()
    assert (uex >= ex).all() and uex.sum() > ex.sum() * 0.99
    np.testing.assert_array_equal(ud.numpy()[uex], bd[uex])
    np.testing.assert_array_equal(ui.numpy()[uex], bi[uex])


def test_explicit_queries_match_jax(scene):
    xyz, mask = scene
    q = xyz[:64] + 0.01
    ri, rd = _np(*sj.knn_brute(jnp.asarray(xyz), jnp.asarray(mask), 5, queries=jnp.asarray(q),
                               exclude_self=False))
    gi, gd = st.knn_grid(torch.tensor(xyz), torch.tensor(mask), 5, queries=torch.tensor(q))
    np.testing.assert_array_equal(gd.numpy(), rd)
    np.testing.assert_array_equal(gi.numpy(), ri)
    bi, bd = st.knn_brute(torch.tensor(xyz), torch.tensor(mask), 5, queries=torch.tensor(q),
                          exclude_self=False)
    np.testing.assert_array_equal(bd.numpy(), rd)
    np.testing.assert_array_equal(bi.numpy(), ri)


def test_auto_dispatches_exact_above_crossover(monkeypatch):
    monkeypatch.setattr(sj, "_GRID_CROSSOVER", 1000)
    monkeypatch.setattr(st, "_GRID_CROSSOVER", 1000)
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    mask = np.ones(4096, bool)
    ri, rd = _np(*sj.knn(jnp.asarray(xyz), jnp.asarray(mask), 8, method="auto"))
    st.last_grid_stats.update(queries=0, passes=[])
    gi, gd = st.knn(torch.tensor(xyz), torch.tensor(mask), 8, method="auto")
    assert st.last_grid_stats["queries"] == 4096 and st.last_grid_stats["passes"]  # the grid
    np.testing.assert_array_equal(gd.numpy(), rd)
    np.testing.assert_array_equal(gi.numpy(), ri)


def test_ties_go_to_the_lowest_index():
    """Triplicated points (zero distances, many ties): grid == brute bit
    for bit, distances == JAX's, and each tie group is in index order."""
    pts = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]], np.float32)
    pts = np.repeat(pts, 3, axis=0)
    mask = np.ones(15, bool)
    gi, gd = st.knn_grid(torch.tensor(pts), torch.tensor(mask), 4, bucket_size=0.5)
    bi, bd = st.knn_brute(torch.tensor(pts), torch.tensor(mask), 4)
    np.testing.assert_array_equal(gd.numpy(), bd.numpy())
    np.testing.assert_array_equal(gi.numpy(), bi.numpy())
    _, rd = sj.knn_brute(jnp.asarray(pts), jnp.asarray(mask), 4)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    d, i = gd.numpy(), gi.numpy()
    same = (d[:, 1:] == d[:, :-1]) & (i[:, 1:] >= 0)
    assert same.any() and (i[:, 1:][same] > i[:, :-1][same]).all()
    assert list(i[0]) == [1, 2, 3, 4]  # point 0's five duplicates, lowest first


@pytest.mark.parametrize("radius,cap", [(0.45, 12), (0.8, 40)])
def test_radius_search_matches_jax(scene, radius, cap):
    """Port grid and port brute == JAX's brute (JAX's own tests hold its
    grid to its brute; its dense-table grid takes minutes to compile at
    these caps)."""
    xyz, mask = scene
    xj, mj, xt, mt = jnp.asarray(xyz), jnp.asarray(mask), torch.tensor(xyz), torch.tensor(mask)
    bi, bd, bc = _np(*sj.radius_search_brute(xj, mj, radius, cap))
    gi, gd, gc = (a.numpy() for a in st.radius_search_grid(xt, mt, radius, cap))
    ti, td, tc = (a.numpy() for a in st.radius_search_brute(xt, mt, radius, cap))
    np.testing.assert_array_equal(tc, bc)
    np.testing.assert_array_equal(td, bd)
    np.testing.assert_array_equal(ti, bi)
    np.testing.assert_array_equal(gc[mask], bc[mask])
    np.testing.assert_array_equal(gd[mask], bd[mask])
    np.testing.assert_array_equal(gi[mask], bi[mask])
    assert (gc[~mask] == 0).all() and (gi[~mask] == -1).all()
    assert (gc > cap).any()  # the cap truncates some sets; the count does not
    count = st.radius_count_brute(xt, mt, radius).numpy()
    np.testing.assert_array_equal(count, np.asarray(sj.radius_count_brute(xj, mj, radius)))


def test_radius_grid_dense_clump():
    """A clump far denser than the rest: the column cap follows the
    densest cell, so the grid stays exact without a fallback."""
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(0, 0.02, (300, 3)),
                          rng.uniform(-4, 4, (2000, 3))]).astype(np.float32)
    mask = np.ones(pts.shape[0], bool)
    gi, gd, gc = st.radius_search_grid(torch.tensor(pts), torch.tensor(mask), 0.5, 16)
    bi, bd, bc = sj.radius_search_brute(jnp.asarray(pts), jnp.asarray(mask), 0.5, 16)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(bc))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(bd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(bi))


def test_elongated_grid():
    """Dims like (102, 5, 5), far from any chunk alignment."""
    rng = np.random.default_rng(0)
    n = 8000
    xyz = np.column_stack([rng.uniform(0, 100, n), rng.uniform(0, 3, n),
                           rng.uniform(0, 3, n)]).astype(np.float32)
    mask = np.ones(n, bool)
    xt, mt = torch.tensor(xyz), torch.tensor(mask)
    gi, gd = st.knn_grid(xt, mt, 10, bucket_size=1.0)
    bi, bd = sj.knn_brute(jnp.asarray(xyz), jnp.asarray(mask), 10)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(bd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(bi))
    ri, rd, rc = st.radius_search_grid(xt, mt, 1.0, 8)
    bi2, bd2, bc2 = sj.radius_search_brute(jnp.asarray(xyz), jnp.asarray(mask), 1.0, 8)
    np.testing.assert_array_equal(rc.numpy(), np.asarray(bc2))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(bd2))


@pytest.mark.parametrize("per_bucket", [8])
def test_bucket_grid_matches_jax(scene, per_bucket):
    """The approximate bucket search: the same sort order, the same
    per-bucket cut, so the same (approximate) answers."""
    xyz, mask = scene
    n = len(xyz)
    bj = sj.BucketGrid(jnp.asarray(xyz), jnp.asarray(mask), 0.7)
    bt = st.BucketGrid(torch.tensor(xyz), torch.tensor(mask), 0.7)
    np.testing.assert_array_equal(bt.order.numpy(), np.asarray(bj.order))
    ci, cv = _np(*bj.candidates(jnp.asarray(xyz[:200]), per_bucket))
    ti, tv = bt.candidates(torch.tensor(xyz[:200]), per_bucket)
    np.testing.assert_array_equal(ti.numpy(), ci)
    np.testing.assert_array_equal(tv.numpy(), cv)
    ex_j, ex_t = jnp.arange(n, dtype=jnp.int32), torch.arange(n, dtype=torch.int32)
    ri, rd = _np(*bj.knn(jnp.asarray(xyz), 8, per_bucket, exclude_self_idx=ex_j))
    gi, gd = bt.knn(torch.tensor(xyz), 8, per_bucket, exclude_self_idx=ex_t)
    np.testing.assert_array_equal(gd.numpy(), rd)
    np.testing.assert_array_equal(gi.numpy(), ri)
    rc = np.asarray(bj.radius_count(jnp.asarray(xyz), 0.7, per_bucket, exclude_self_idx=ex_j))
    np.testing.assert_array_equal(
        bt.radius_count(torch.tensor(xyz), 0.7, per_bucket, exclude_self_idx=ex_t).numpy(), rc)
    ki, kd = _np(*sj.knn(jnp.asarray(xyz), jnp.asarray(mask), 6, bucket_size=0.7,
                         method="bucket"))
    gi, gd = st.knn(torch.tensor(xyz), torch.tensor(mask), 6, bucket_size=0.7, method="bucket")
    np.testing.assert_array_equal(gd.numpy(), kd)
    np.testing.assert_array_equal(gi.numpy(), ki)


def test_search_refusals_and_devices():
    xyz = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    mask = np.ones(50, bool)
    with pytest.raises(ValueError, match="unknown search method"):
        st.knn(xyz, mask, 3, method="kdtree", device="cpu")
    with pytest.raises(ValueError, match="requires bucket_size"):
        st.knn(xyz, mask, 3, method="bucket", device="cpu")
    i, d = st.knn(xyz, mask, 3, device="cpu")  # host arrays, CPU named
    assert i.device.type == "cpu" and tuple(d.shape) == (50, 3)
    # k beyond the cloud pads with -1 / inf.
    i, d = st.knn_brute(torch.tensor(xyz[:4]), torch.ones(4, dtype=torch.bool), 6)
    assert (i[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()
    if torch.cuda.is_available():
        return
    for call in (lambda: st.knn(xyz, mask, 3), lambda: st.knn_brute(xyz, mask, 3),
                 lambda: st.DenseGrid(xyz, mask, 0.5)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_far_outliers_keep_the_dense_grid_fine():
    """Gross outliers 30x out from a dense sheet: JAX's geometry grows the
    bucket until the box fits 4M cells, and its columns overflow; the
    port's grid has no table that scales with its cell count (it binary
    searches its sorted keys), so the first pass keeps the measured bucket
    and certifies the sheet. Exact either way: equal to the brute tile bit
    for bit."""
    rng = np.random.default_rng(6)
    n = 6000
    xyz = np.column_stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                           0.05 * rng.normal(size=n)]).astype(np.float32)
    xyz[:30] *= 30.0
    mask = np.ones(n, bool)
    gi, gd = st.knn_grid(torch.tensor(xyz), torch.tensor(mask), 10)
    first = st.last_grid_stats["passes"][0]
    assert first["certified"] > 0.9 * n
    bi, bd = sj.knn_brute(jnp.asarray(xyz), jnp.asarray(mask), 10)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(bd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(bi))
    b, dims, _ = sj._grid_geometry(jnp.asarray(xyz), jnp.asarray(mask),
                                   first["bucket"], 4_000_000)
    assert b > first["bucket"]  # JAX's geometry widens the bucket here
