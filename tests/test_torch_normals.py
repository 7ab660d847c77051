"""The port's normal and covariance estimation against the JAX package's,
on the CPU.

Same seeded clouds through both packages, on the brute path and on the grid
path (reached on test-sized clouds by lowering the crossover in both, as
``test_torch_search.py`` does). Tolerances: neighbour indices exactly; the
set of zero normals exactly; normal components within 1e-5 on >= 99.9% of
points; orientation flips equal except where |n . (vp - p)| < 1e-6 (those
points are counted); covariances within 1e-5, with and without
``regularize``. The bitwise share is printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import normals as nj
from fastdem_tpu.cloud import search as sj
from fastdem_tpu_torch.cloud import normals as nt
from fastdem_tpu_torch.cloud import pointcloud as pc_t
from fastdem_tpu_torch.cloud import search as st
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

N = 3000


@pytest.fixture(scope="module")
def scene():
    """A corrugated surface with a few far points (their neighbourhoods
    stretch, so the grid's certificate fails and its fallback runs), one
    masked point and one isolated pair."""
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    xyz[:, 2] = (0.4 * np.sin(1.3 * xyz[:, 0]) + 0.3 * np.cos(1.7 * xyz[:, 1])
                 + 0.01 * rng.normal(size=N)).astype(np.float32)
    xyz[:10] *= 5
    mask = np.ones(N, bool)
    mask[17] = False
    return xyz, mask


@pytest.fixture(scope="module", params=["brute", "grid"])
def jax_idx(request, scene):
    """JAX's neighbour indices on one path. On the grid path JAX's
    estimators fuse their tail into this search, or re-run it on these
    indices when a certificate fails; either way their result is the jitted
    tail of these indices, which the tests call directly (one compile of the
    grid search per module instead of one per tail)."""
    xyz, mask = scene
    idx, _ = sj.knn(jnp.asarray(xyz), jnp.asarray(mask), 10, method=request.param)
    return request.param, idx


@pytest.fixture
def path(jax_idx, monkeypatch):
    """The port takes its grid path through ``method="auto"``, the
    crossover lowered below the scene's size."""
    if jax_idx[0] == "grid":
        monkeypatch.setattr(st, "_GRID_CROSSOVER", 1000)
    return jax_idx


def port_cloud(xyz, mask):
    return pc_t.from_numpy(xyz, device="cpu").with_mask(torch.tensor(mask))


def test_neighbour_indices_match(scene, path):
    xyz, mask = scene
    idx_t, _ = st.knn(torch.tensor(xyz), torch.tensor(mask), 10)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(path[1]))


def test_normals_match_jax(scene, path):
    xyz, mask = scene
    vp = (0.3, -0.2, 8.0)
    nj_ = np.asarray(nj._normals_tail(jnp.asarray(xyz), path[1],
                                      jnp.asarray(vp, dtype=jnp.float32)))
    nt_ = nt.estimate_normals(port_cloud(xyz, mask), k=10, viewpoint=vp).channels["normal"].numpy()
    zero_j, zero_t = (nj_ == 0).all(1), (nt_ == 0).all(1)
    np.testing.assert_array_equal(zero_t, zero_j)
    # A flip decided on |n . (vp - p)| < 1e-6 may go either way.
    dot = np.abs(np.sum(nj_ * (np.asarray(vp, np.float32) - xyz), axis=1))
    near = dot < 1e-6
    flipped = np.sign(nj_) * np.sign(nt_) < 0
    assert not flipped[~near].any()
    close = (np.abs(nt_ - nj_) <= 1e-5).all(1) | near
    assert close.mean() >= 0.999, np.count_nonzero(~close)
    bitwise = (nt_.view(np.int32) == nj_.view(np.int32)).all(1).mean()
    print(f"{path[0]}: normals bitwise on {bitwise:.4%} of points, "
          f"{np.count_nonzero(near)} near-zero flips")


@pytest.mark.parametrize("regularize", [True, False])
def test_covariances_match_jax(scene, path, regularize):
    xyz, mask = scene
    a = np.asarray(nj._cov_tail(jnp.asarray(xyz), path[1], jnp.float32(1e-3), regularize))
    b = nt.estimate_covariances(port_cloud(xyz, mask), k=10,
                                regularize=regularize).channels["covariance"].numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    bitwise = (b.view(np.int32) == a.view(np.int32)).all((1, 2)).mean()
    print(f"{path[0]} regularize={regularize}: covariances bitwise on {bitwise:.4%}")


def test_normals_follow_the_cloud_device():
    xyz = np.zeros((20, 3), np.float32)
    xyz[:, 0] = np.arange(20)
    out = nt.estimate_normals(pc_t.from_numpy(xyz, device="cpu"), k=4)
    n = out.channels["normal"]
    assert n.device.type == "cpu"
    # A line's normals are unit vectors across it.
    assert (n[:, 0] == 0).all() and torch.allclose(n.norm(dim=1), torch.ones(20))


# Mirrors of tests/test_batch.py::TestNormals, on the port alone.


def test_flat_plane_normals_up(rng):
    xy = rng.uniform(-1, 1, size=(300, 2))
    pts = np.column_stack([xy, np.zeros(300)]).astype(np.float32)
    out = nt.estimate_normals(pc_t.from_numpy(pts, device="cpu"), k=8, viewpoint=(0, 0, 10.0))
    n = out.channels["normal"].numpy()
    assert np.mean(np.abs(n[:, 2]) > 0.99) > 0.95
    assert np.mean(n[:, 2] > 0) > 0.95


def test_covariances_regularized(rng):
    xy = rng.uniform(-1, 1, size=(200, 2))
    pts = np.column_stack([xy, 0.01 * xy[:, 0]]).astype(np.float32)
    out = nt.estimate_covariances(pc_t.from_numpy(pts, device="cpu"), k=8)
    eig = np.linalg.eigvalsh(out.channels["covariance"].numpy())
    np.testing.assert_allclose(eig[:, 2], 1.0, atol=0.05)
    assert np.all(eig[:, 0] < 0.1)
