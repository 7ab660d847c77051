"""The port's segmentation against the JAX package's, on the CPU, and the
seven tests of ``tests/test_segmentation.py`` mirrored on the port.

Same seeded clouds through both packages. Tolerances: ``segment_plane``
picks the same hypothesis, its coefficients agree within 1e-6, and its
inliers and fitness are equal except at points within 1e-6 of the
threshold (counted: none on these scenes); ``euclidean_cluster`` labels
and ``segment_ground`` masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import pointcloud as pc_j
from fastdem_tpu.cloud import segmentation as sg_j
from fastdem_tpu_torch.cloud import pointcloud as pc_t
from fastdem_tpu_torch.cloud import segmentation as segm
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


def both(pts, mask=None):
    cj = pc_j.from_numpy(pts)
    ct = pc_t.from_numpy(pts, device="cpu")
    if mask is not None:
        cj, ct = cj.with_mask(jnp.asarray(mask)), ct.with_mask(torch.tensor(mask))
    return cj, ct


def plane_scene(rng, n=2000, tilt=0.3):
    x, y = rng.uniform(-4, 4, n), rng.uniform(-4, 4, n)
    plane = np.column_stack([x, y, tilt * x + rng.normal(0, 0.02, n)])
    noise = rng.uniform(-4, 4, (400, 3))
    return np.vstack([plane, noise]).astype(np.float32)


@pytest.mark.parametrize("seed,refine", [(0, True), (7, False), (2**31 - 1, True)])
def test_segment_plane_matches_jax(seed, refine):
    rng = np.random.default_rng(seed % 1000)
    pts = plane_scene(rng)
    mask = np.ones(len(pts), bool)
    mask[::97] = False
    cj, ct = both(pts, mask)
    thr = 0.05
    rj = sg_j.segment_plane(cj, thr, max_iterations=100, seed=seed, refine=refine)
    rt = segm.segment_plane(ct, thr, max_iterations=100, seed=seed, refine=refine)
    coef_j = np.asarray(rj.model.coefficients)
    coef_t = rt.model.coefficients.numpy()
    np.testing.assert_allclose(coef_t, coef_j, rtol=0, atol=1e-6)
    dist = np.abs(pts @ coef_j[:3] + coef_j[3])
    edge = mask & (np.abs(dist - thr) < 1e-6)
    assert np.count_nonzero(edge) == 0
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert rt.fitness == rj.fitness and rt.iterations == rj.iterations


def test_segment_plane_hypotheses_match_jax():
    """Without the refine the model is the best hypothesis itself, so equal
    coefficients bit for bit mean the same hypothesis won."""
    rng = np.random.default_rng(5)
    pts = plane_scene(rng, tilt=-0.2)
    cj, ct = both(pts)
    rj = sg_j.segment_plane(cj, 0.08, max_iterations=300, seed=3, refine=False)
    rt = segm.segment_plane(ct, 0.08, max_iterations=300, seed=3, refine=False)
    np.testing.assert_array_equal(rt.model.coefficients.numpy().view(np.int32),
                                  np.asarray(rj.model.coefficients).view(np.int32))


@pytest.mark.parametrize("min_size,max_size", [(1, None), (5, 150)])
def test_euclidean_cluster_matches_jax(min_size, max_size):
    rng = np.random.default_rng(2)
    blobs = [rng.normal(0, 0.15, (120, 3)) + c for c in
             ([0, 0, 0], [3, 0, 0], [0, 3, 0], [3, 3, 1])]
    chain = np.column_stack([np.arange(30) * 0.3 + 6, np.zeros(30), np.zeros(30)])
    lone = rng.uniform(10, 20, (10, 3))
    pts = np.vstack(blobs + [chain, lone]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    mask[5] = False
    cj, ct = both(pts, mask)
    kw = dict(tolerance=0.4, min_cluster_size=min_size, max_cluster_size=max_size)
    lj = np.asarray(sg_j.euclidean_cluster(cj, **kw))
    lt = segm.euclidean_cluster(ct, **kw)
    assert lt.dtype == torch.int32
    np.testing.assert_array_equal(lt.numpy(), lj)


def cluster_scene():
    rng = np.random.default_rng(2)
    blobs = [rng.normal(0, 0.15, (120, 3)) + c for c in
             ([0, 0, 0], [3, 0, 0], [0, 3, 0], [3, 3, 1])]
    chain = np.column_stack([np.arange(30) * 0.3 + 6, np.zeros(30), np.zeros(30)])
    return np.vstack(blobs + [chain, rng.uniform(10, 20, (10, 3))]).astype(np.float32)


def per_sweep_propagate(labels, cand, max_sweeps):
    """The propagation as a plain loop that reads the ``changed`` flag after
    every sweep: the reference the sweep blocks are held to."""
    n = labels.shape[0]
    tail = torch.tensor([n])
    for _ in range(max_sweeps):
        lab_ext = torch.cat([labels, tail])
        new = torch.minimum(labels, lab_ext[cand].amin(dim=1))
        new = torch.minimum(new, lab_ext[new.clamp_max(n - 1)])
        changed = bool((new != labels).any())
        segm.host_reads += 1
        segm.sweeps += 1
        labels = new
        if not changed:
            break
    return labels


def counted_cluster(cloud, per_read=None, **kw):
    """(labels, host reads, sweeps) of one ``euclidean_cluster`` call, in
    blocks of ``per_read`` sweeps, or with ``per_sweep_propagate`` when
    ``per_read`` is None."""
    segm.host_reads = segm.sweeps = 0
    kept = segm._propagate, segm._SWEEPS_PER_READ
    if per_read is None:
        segm._propagate = per_sweep_propagate
    else:
        segm._SWEEPS_PER_READ = per_read
    try:
        labels = segm.euclidean_cluster(cloud, **kw)
    finally:
        segm._propagate, segm._SWEEPS_PER_READ = kept
    return labels.numpy(), segm.host_reads, segm.sweeps


@pytest.mark.parametrize("per_read", [2, 3, 8, 64])
def test_cluster_blocks_equal_the_per_sweep_loop(per_read):
    """Blocks of sweeps give the labels of the loop that reads the flag
    after every sweep (``per_sweep_propagate``) and JAX's ``while_loop``,
    with one host read per block."""
    pts = cluster_scene()
    cj, ct = both(pts)
    ref, ref_reads, ref_sweeps = counted_cluster(ct, tolerance=0.4)
    got, reads, sweeps = counted_cluster(ct, per_read, tolerance=0.4)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(sg_j.euclidean_cluster(cj, tolerance=0.4)))
    assert sweeps == ref_sweeps == ref_reads < 64
    assert reads == -(-ref_sweeps // per_read)


def test_cluster_stops_at_max_sweeps_in_a_block():
    """A shuffled chain needs more sweeps than ``max_sweeps`` = 11: blocks
    of 4 run 4 + 4 + 3 sweeps, and the unconverged labels equal the per-sweep
    loop's and JAX's at the same cap."""
    n = 200
    pts = np.column_stack([np.arange(n) * 0.4, np.zeros(n), np.zeros(n)]).astype(np.float32)
    pts = pts[np.random.default_rng(0).permutation(n)]
    cj, ct = both(pts)
    ref, _, ref_sweeps = counted_cluster(ct, tolerance=0.5, max_sweeps=11)
    got, reads, sweeps = counted_cluster(ct, 4, tolerance=0.5, max_sweeps=11)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(sg_j.euclidean_cluster(cj, tolerance=0.5, max_sweeps=11)))
    assert (reads, sweeps, ref_sweeps) == (3, 11, 11)
    assert len(set(got.tolist())) > 1  # the cap cut the propagation short


def test_cluster_sweep_block_is_capture_safe(monkeypatch):
    """Each block of sweeps under the capture guards of
    ``test_torch_graphs.py`` after a warm-up call on the same values: a
    block makes no host read, so the host reads once per block."""
    from test_torch_graphs import guarded

    blocks = []
    plain = segm._sweeps

    def sweeps(count):
        run = plain(count)

        def block(carry):
            blocks.append(count)
            return guarded(run, carry)

        return block

    monkeypatch.setattr(segm, "_sweeps", sweeps)
    _, ct = both(cluster_scene())
    got, reads, n_sweeps = counted_cluster(ct, 3, tolerance=0.4)
    ref, _, _ = counted_cluster(ct, tolerance=0.4)
    np.testing.assert_array_equal(got, ref)
    assert n_sweeps > 3 and blocks == [3] * reads


@pytest.mark.parametrize("cfg", [None, sg_j.GroundSegConfig(
    grid_resolution=0.3, cell_percentile=0.5, ground_thickness=0.2, max_ground_height=1.0,
    min_points_per_cell=3)])
def test_segment_ground_matches_jax(cfg):
    rng = np.random.default_rng(9)
    n = 3000
    ground = np.column_stack([rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
                              0.05 * rng.uniform(-6, 6, n) + rng.normal(0, 0.03, n)])
    boxes = np.column_stack([rng.uniform(-1, 1, 300), rng.uniform(-1, 1, 300),
                             rng.uniform(0.3, 1.5, 300)])
    pts = np.vstack([ground, boxes]).astype(np.float32)
    pts[::50, 2] = np.round(pts[::50, 2], 1)  # z ties inside cells
    mask = np.ones(len(pts), bool)
    mask[::31] = False
    cj, ct = both(pts, mask)
    cfg_t = None if cfg is None else segm.GroundSegConfig(**vars(cfg))
    gj = np.asarray(sg_j.segment_ground(cj, cfg))
    gt = segm.segment_ground(ct, cfg_t)
    np.testing.assert_array_equal(gt.numpy(), gj)
    assert 0.3 < gt.numpy().mean() < 0.95


# Mirrors of tests/test_segmentation.py, on the port alone.


class TestRansacPlane:
    def test_finds_dominant_plane(self, rng):
        n = 800
        plane = np.column_stack(
            [rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.normal(0, 0.01, n)]
        )
        noise = rng.uniform(-2, 2, size=(120, 3))
        noise[:, 2] = rng.uniform(0.5, 2.0, 120)
        pts = np.vstack([plane, noise]).astype(np.float32)
        res = segm.segment_plane(pc_t.from_numpy(pts, device="cpu"), distance_threshold=0.05)
        assert res.fitness > 0.7
        coef = res.model.coefficients.numpy()
        assert abs(abs(coef[2]) - 1.0) < 0.05
        inl = res.inliers.numpy()
        assert inl[:n].mean() > 0.95
        assert inl[n:].mean() < 0.1

    def test_tilted_plane(self, rng):
        n = 600
        x = rng.uniform(-2, 2, n)
        y = rng.uniform(-2, 2, n)
        z = 0.5 * x + rng.normal(0, 0.01, n)
        pts = np.column_stack([x, y, z]).astype(np.float32)
        res = segm.segment_plane(pc_t.from_numpy(pts, device="cpu"), 0.05)
        coef = res.model.coefficients.numpy()
        expected = np.array([-0.5, 0.0, 1.0])
        expected /= np.linalg.norm(expected)
        assert abs(np.dot(coef[:3], expected)) > 0.99


class TestEuclideanCluster:
    def test_two_blobs(self, rng):
        a = rng.normal(0, 0.1, size=(100, 3))
        b = rng.normal(0, 0.1, size=(80, 3)) + np.array([5.0, 0, 0])
        cloud = pc_t.from_numpy(np.vstack([a, b]).astype(np.float32), device="cpu")
        labels = segm.euclidean_cluster(cloud, tolerance=0.5).numpy()
        la, lb = set(labels[:100].tolist()), set(labels[100:].tolist())
        assert len(la) == 1 and len(lb) == 1
        assert la != lb

    def test_min_cluster_size(self, rng):
        a = rng.normal(0, 0.1, size=(100, 3))
        lone = np.array([[50.0, 50.0, 50.0]])
        cloud = pc_t.from_numpy(np.vstack([a, lone]).astype(np.float32), device="cpu")
        labels = segm.euclidean_cluster(cloud, tolerance=0.5, min_cluster_size=5).numpy()
        assert labels[100] == -1
        assert (labels[:100] >= 0).all()

    def test_chain_connectivity(self):
        pts = np.column_stack([np.arange(20) * 0.4, np.zeros(20), np.zeros(20)]).astype(
            np.float32)
        labels = segm.euclidean_cluster(pc_t.from_numpy(pts, device="cpu"), tolerance=0.5)
        assert len(set(labels.tolist())) == 1


class TestGroundSeg:
    def test_flat_ground_with_obstacles(self, rng):
        n = 1500
        ground = np.column_stack(
            [rng.uniform(-5, 5, n), rng.uniform(-5, 5, n), rng.normal(0, 0.02, n)]
        )
        boxes = np.column_stack(
            [rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200), rng.uniform(0.8, 1.5, 200)]
        )
        pts = np.vstack([ground, boxes]).astype(np.float32)
        mask = segm.segment_ground(pc_t.from_numpy(pts, device="cpu")).numpy()
        assert mask[:n].mean() > 0.9
        assert mask[n:].mean() < 0.05

    def test_sloped_terrain(self, rng):
        n = 1200
        x = rng.uniform(-3, 3, n)
        y = rng.uniform(-3, 3, n)
        z = 0.05 * x + rng.normal(0, 0.01, n)
        pts = np.column_stack([x, y, z]).astype(np.float32)
        cfg = segm.GroundSegConfig(max_ground_height=1.0)
        mask = segm.segment_ground(pc_t.from_numpy(pts, device="cpu"), cfg).numpy()
        assert mask.mean() > 0.8
