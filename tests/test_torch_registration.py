"""The port's registration against the JAX package's, on the CPU, and the
oracles of ``tests/test_batch.py`` (``TestRegistration``,
``TestFusedDriver``, ``test_vgicp_dense_matches_sorted_correspondence``,
``test_align_bucket_knn_prep``) mirrored on the port.

Tolerances:
  * ``_nearest``: indices exactly and squared distances bit for bit against
    JAX's jitted Gram tile (after JAX's jitted ``transform_points``);
  * ``_inv3x3`` and ``_robust_weight`` bit for bit against JAX's eager
    calls; ``segal_regularize`` within 1e-5;
  * ``voxel_distributions`` / ``voxel_distribution_table``: keys, valid
    sets, dims and the effective voxel side exactly, means and covariances
    within 1e-5;
  * ``align`` against JAX's default (fused) driver: T within atol 1e-5 (the
    bar ``TestFusedDriver`` sets between JAX's own drivers), error within
    rtol 1e-4 / atol 1e-7, ``converged`` equal, iterations within 1 and the
    correspondence count exactly.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import pointcloud as pc_j
from fastdem_tpu.cloud import registration as reg_j
from fastdem_tpu.cloud import transform as tf_j
from fastdem_tpu_torch.cloud import pointcloud as pc_t
from fastdem_tpu_torch.cloud import registration as reg
from fastdem_tpu_torch.cloud.transform import from_rpy
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


def make_pair(rng, n=600):
    """``TestRegistration.make_pair``: two walls and the ground; source =
    T_true * target, so aligning source onto target recovers inv(T_true)."""
    g = np.column_stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), np.zeros(n)])
    w1 = np.column_stack([rng.uniform(-2, 2, n // 2), np.full(n // 2, 2.0),
                          rng.uniform(0, 1, n // 2)])
    w2 = np.column_stack([np.full(n // 2, -2.0), rng.uniform(-2, 2, n // 2),
                          rng.uniform(0, 1, n // 2)])
    tgt = np.vstack([g, w1, w2]).astype(np.float32)
    T_true = np.asarray(tf_j.from_rpy(0.02, -0.015, 0.05, t=[0.1, -0.07, 0.04]))
    src = (tgt @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    return src, tgt, np.linalg.inv(T_true)


def corrugated(n, seed, rpy=(0.02, -0.01, 0.06), t=(0.25, -0.15, 0.08)):
    """``TestFusedDriver.make_pair``'s scene: a surface corrugated in x and
    y; target = T * source."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    src[:, 2] = 0.4 * np.sin(1.3 * src[:, 0]) + 0.3 * np.cos(1.7 * src[:, 1])
    T = from_rpy(*rpy, t=t, device="cpu").numpy()
    tgt = ((T[:3, :3] @ src.T).T + T[:3, 3]).astype(np.float32)
    return src, tgt, T


def cpu(x):
    return pc_t.from_numpy(x, device="cpu")


# --- helpers ----------------------------------------------------------------


@pytest.mark.parametrize("tile_bytes", [None, 4096 * 40])
def test_nearest_matches_jax_bitwise(monkeypatch, tile_bytes):
    if tile_bytes is not None:  # many source-row tiles
        monkeypatch.setitem(reg._TILE_BYTES, "cpu", tile_bytes)
    rng = np.random.default_rng(1)
    src, tgt, _ = make_pair(rng, 400)
    tgt = tgt + rng.normal(0, 0.003, tgt.shape).astype(np.float32)
    T = np.asarray(tf_j.from_rpy(0.01, 0.02, -0.03, t=[0.05, 0.0, -0.02]))
    mask = np.ones(len(tgt), bool)
    mask[::13] = False
    fj = jax.jit(lambda T, s, t, m: reg_j._nearest(tf_j.transform_points(s, T), t, m))
    idx_j, d2_j = fj(jnp.asarray(T), jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    idx_t, d2_t = reg._nearest(reg._transform(torch.tensor(src), torch.tensor(T)),
                               torch.tensor(tgt), torch.tensor(mask))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d2_t.numpy().view(np.int32), np.asarray(d2_j).view(np.int32))


def test_inv3x3_and_robust_weights_bitwise():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(500, 3, 3)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal(reg._inv3x3(torch.tensor(M)).numpy().view(np.int32),
                                  np.asarray(reg_j._inv3x3(jnp.asarray(M))).view(np.int32))
    r2 = (rng.uniform(0, 3, 2000) ** 2).astype(np.float32)
    r2[:5] = 0.0
    for kernel in ("none", "huber", "cauchy", "tukey"):
        a = np.asarray(reg_j._robust_weight(kernel, 0.7, jnp.asarray(r2)))
        b = reg._robust_weight(kernel, 0.7, torch.tensor(r2)).numpy()
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32), err_msg=kernel)
    with pytest.raises(ValueError, match="robust kernel"):
        reg._robust_weight("nope", 1.0, torch.tensor(r2))


def test_segal_regularize_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(300, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1)
    cov[:5] = np.eye(3, dtype=np.float32) * 0.64  # isotropic (sparse voxels)
    a = np.asarray(reg_j.segal_regularize(jnp.asarray(cov), 1e-3))
    b = reg.segal_regularize(torch.tensor(cov), 1e-3).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def voxel_scene():
    rng = np.random.default_rng(4)
    src, tgt, _ = make_pair(rng, 600)
    tgt = np.vstack([tgt, rng.normal(0, 0.05, (40, 3)) + 7.0]).astype(np.float32)
    mask = np.ones(len(tgt), bool)
    mask[::11] = False
    return tgt, mask


def test_voxel_distributions_match_jax():
    tgt, mask = voxel_scene()
    cj = pc_j.from_numpy(tgt).with_mask(jnp.asarray(mask))
    ct = cpu(tgt).with_mask(torch.tensor(mask))
    kj, mj, cvj, vj = [np.asarray(a) for a in reg_j.voxel_distributions(cj, 0.4)]
    kt, mt, cvt, vt = [a.numpy() for a in reg.voxel_distributions(ct, 0.4)]
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(cvt[vt], cvj[vj], rtol=0, atol=1e-5)


@pytest.mark.parametrize("max_cells", [4_000_000, 300])
def test_voxel_distribution_table_matches_jax(max_cells):
    """The host box loop: at 300 cells the side grows (b *= 1.5) and the
    effective side must be the reference's."""
    tgt, mask = voxel_scene()
    cj = pc_j.from_numpy(tgt).with_mask(jnp.asarray(mask))
    ct = cpu(tgt).with_mask(torch.tensor(mask))
    oj, dj, mj, cj_, vj, bj = reg_j.voxel_distribution_table(cj, 0.4, max_cells)
    ot, dt, mt, ct_, vt, bt = reg.voxel_distribution_table(ct, 0.4, max_cells)
    assert dt == dj and bt == bj
    assert (bt > 0.4) == (max_cells == 300)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct_.numpy(), np.asarray(cj_), rtol=0, atol=1e-5)


def test_stall_rule_follows_criteria_hpp():
    """A previous error <= 0 counts as stalled (nanoPCL criteria.hpp); the
    reference's Python divides by max(prev_err, 1e-30) and does not."""
    assert reg._stalled(0.0, 0.0, 1e-6)
    assert reg._stalled(0.0, 1e-3, 1e-6)
    assert reg._stalled(-1.0, 1e-3, 1e-6)
    jax_rule = abs(0.0 - 1e-3) / max(0.0, 1e-30) < 1e-6
    assert not jax_rule
    assert reg._stalled(1.0, 1.0 - 1e-7, 1e-6)
    assert not reg._stalled(1.0, 0.9, 1e-6)
    assert not reg._stalled(3.4e38, 1.0, 1e-6)


# --- align against JAX ------------------------------------------------------


def assert_results_agree(rt, rj):
    np.testing.assert_allclose(rt.T, np.asarray(rj.T), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.error, rj.error, rtol=1e-4, atol=1e-7)
    assert rt.converged == rj.converged
    assert abs(rt.iterations - rj.iterations) <= 1
    assert rt.num_correspondences == rj.num_correspondences


ALIGN_CASES = (
    [dict(method=m, optimizer=o) for m in ("icp", "point_to_plane", "gicp", "vgicp")
     for o in ("gn", "lm")]
    + [dict(method="icp", optimizer="gn", kernel=k, kernel_scale=0.3)
       for k in ("huber", "cauchy", "tukey")]
    + [dict(method="vgicp", optimizer="lm", correspondence="sorted")]
)


@pytest.mark.parametrize("kw", ALIGN_CASES,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_align_matches_jax(kw):
    rng = np.random.default_rng(42)
    src, tgt, _ = make_pair(rng)
    if "kernel" in kw:  # outliers for the robust kernels to weigh down
        src = np.vstack([src, rng.uniform(-3, 3, (60, 3)).astype(np.float32)])
    kw = dict(kw, max_iterations=40,
              voxel_size=0.8 if kw["method"] == "vgicp" else 0.4)
    rj = reg_j.align(pc_j.from_numpy(src), pc_j.from_numpy(tgt), **kw)
    rt = reg.align(cpu(src), cpu(tgt), **kw)
    assert_results_agree(rt, rj)


def test_vgicp_on_the_benchmark_scene_matches_jax():
    """The registration benchmark's scene (z = 0.1 sin x, nothing along y):
    VGICP's voxel planes cannot see a shift along y, so neither package
    recovers T_true's y; the port's error is JAX's."""
    from fastdem_tpu_torch.tools.common import registration_pair

    src, tgt, T_true = registration_pair(4000, seed=4000)
    kw = dict(method="vgicp", optimizer="lm", voxel_size=1.0)
    rj = reg_j.align(pc_j.from_numpy(src), pc_j.from_numpy(tgt), **kw)
    rt = reg.align(cpu(src), cpu(tgt), **kw)
    assert_results_agree(rt, rj)
    err_j = np.linalg.norm(np.asarray(rj.T)[:3, 3] - T_true[:3, 3])
    err_t = np.linalg.norm(rt.T[:3, 3] - T_true[:3, 3])
    assert abs(err_t - err_j) <= 1e-5
    print(f"VGICP translation error on the benchmark scene: port {err_t!r} m, JAX {err_j!r} m")


def test_align_checks_devices_and_options():
    src, tgt, _ = make_pair(np.random.default_rng(0), 60)
    with pytest.raises(ValueError, match="driver"):
        reg.align(cpu(src), cpu(tgt), driver="nope")
    with pytest.raises(ValueError, match="optimizer"):
        reg.align(cpu(src), cpu(tgt), optimizer="nope")
    with pytest.raises(ValueError, match="method"):
        reg.align(cpu(src), cpu(tgt), method="nope")

    class Elsewhere:  # a cloud whose tensors claim another device
        xyz = torch.empty(0, device="meta")

    with pytest.raises(ValueError, match="different devices"):
        reg.align(cpu(src), Elsewhere())


# --- mirrors of the JAX package's oracles, on the port alone ---------------


class TestRegistration:
    @pytest.mark.parametrize("method", ["icp", "point_to_plane", "gicp", "vgicp"])
    def test_align_recovers_transform(self, rng, method):
        src, tgt, T_expect = make_pair(rng)
        res = reg.align(cpu(src), cpu(tgt), method=method, max_iterations=40,
                        max_correspondence_distance=1.0,
                        voxel_size=0.8 if method == "vgicp" else 0.4,
                        optimizer="lm" if method == "vgicp" else "gn")
        err_t = np.linalg.norm(res.T[:3, 3] - T_expect[:3, 3])
        err_R = np.linalg.norm(res.T[:3, :3] - T_expect[:3, :3])
        assert err_t < (0.08 if method == "vgicp" else 0.03), (method, res)
        assert err_R < 0.05

    @pytest.mark.parametrize("method", ["icp", "gicp", "vgicp"])
    def test_lm_optimizer_recovers_transform(self, rng, method):
        src, tgt, T_expect = make_pair(rng)
        res = reg.align(cpu(src), cpu(tgt), method=method, max_iterations=40,
                        optimizer="lm", voxel_size=0.8)
        assert np.linalg.norm(res.T[:3, 3] - T_expect[:3, 3]) < 0.08

    def test_vgicp_containing_voxel_vs_nearest_mean(self, rng):
        """A point just outside the occupied voxel has a nearest mean but no
        containing voxel, so it gets no correspondence."""
        from fastdem_tpu_torch.cloud.filters import voxel_coords, voxel_key

        tgt = rng.normal(0, 0.05, size=(50, 3)).astype(np.float32)
        keys, vmean, _, vvalid = reg.voxel_distributions(cpu(tgt), 0.4)
        q = torch.tensor([[0.65, 0.0, 0.0]])  # voxel (1, 0, 0): empty
        key = voxel_key(voxel_coords(q, 0.4))
        pos = torch.searchsorted(keys, key).clamp(0, keys.shape[0] - 1)
        assert not bool((keys[pos] == key)[0]), "empty voxel must not match"
        d = np.linalg.norm(vmean.numpy()[vvalid.numpy()] - q.numpy(), axis=1)
        assert d.min() < 0.7

    def test_robust_kernel_with_outliers(self, rng):
        src, tgt, T_expect = make_pair(rng)
        outliers = rng.uniform(-8, 8, size=(100, 3)).astype(np.float32)
        res = reg.align(cpu(np.vstack([src, outliers])), cpu(tgt), method="icp",
                        kernel="huber", kernel_scale=0.3, max_iterations=40)
        assert np.linalg.norm(res.T[:3, 3] - T_expect[:3, 3]) < 0.06


@pytest.mark.parametrize("method,optimizer", [("icp", "gn"), ("gicp", "gn"),
                                              ("point_to_plane", "gn"), ("icp", "lm"),
                                              ("vgicp", "lm")])
def test_fused_matches_host(method, optimizer):
    """``TestFusedDriver``: both drivers give one result, which recovers the
    applied motion (in the port they run the same loop)."""
    src, tgt, T_expect = corrugated(4000, 7)
    kw = dict(method=method, optimizer=optimizer, max_iterations=25, voxel_size=0.8)
    r_host = reg.align(cpu(src), cpu(tgt), driver="host", **kw)
    r_fused = reg.align(cpu(src), cpu(tgt), driver="fused", **kw)
    assert (r_fused.converged, r_fused.iterations, r_fused.num_correspondences) == (
        r_host.converged, r_host.iterations, r_host.num_correspondences)
    np.testing.assert_allclose(r_fused.T, r_host.T, atol=1e-5)
    np.testing.assert_allclose(r_fused.error, r_host.error, rtol=1e-4, atol=1e-7)
    assert np.linalg.norm(r_fused.T[:3, 3] - T_expect[:3, 3]) < 0.08


def test_vgicp_dense_matches_sorted_correspondence():
    src, tgt, T = corrugated(4000, 5)
    kw = dict(method="vgicp", optimizer="lm", voxel_size=0.8)
    r_dense = reg.align(cpu(src), cpu(tgt), correspondence="dense", **kw)
    r_sorted = reg.align(cpu(src), cpu(tgt), correspondence="sorted", **kw)
    assert r_dense.converged and r_sorted.converged
    np.testing.assert_allclose(r_dense.T, r_sorted.T, atol=2e-4)
    assert abs(r_dense.num_correspondences - r_sorted.num_correspondences) <= 2
    assert np.linalg.norm(r_dense.T[:3, 3] - T[:3, 3]) < 0.08
    with pytest.raises(ValueError, match="correspondence"):
        reg.align(cpu(src), cpu(tgt), method="vgicp", correspondence="nope")


def test_align_bucket_knn_prep():
    src, tgt, T = corrugated(5000, 11, rpy=(0.02, -0.01, 0.05), t=(0.2, -0.1, 0.05))
    res = reg.align(cpu(src), cpu(tgt), method="gicp", optimizer="lm",
                    knn_method="bucket", knn_bucket_size=0.5)
    assert res.converged
    assert np.linalg.norm(res.T[:3, 3] - T[:3, 3]) < 0.03


# --- the fused driver: the loop's control flow on the device ----------------


def fused_and_host(kw, src, tgt, block):
    """(host result, fused result in blocks of ``block`` passes, host reads /
    passes, fused reads / passes run / passes used)."""
    reg.host_reads = reg.passes_run = reg.passes_used = 0
    r_host = reg.align(cpu(src), cpu(tgt), driver="host", **kw)
    host = (reg.host_reads, reg.passes_run)
    reg.host_reads = reg.passes_run = reg.passes_used = 0
    kept, reg._FUSED_BLOCK = reg._FUSED_BLOCK, block
    try:
        r_fused = reg.align(cpu(src), cpu(tgt), driver="fused", **kw)
    finally:
        reg._FUSED_BLOCK = kept
    return r_host, r_fused, host, (reg.host_reads, reg.passes_run, reg.passes_used)


def assert_same_result(r_host, r_fused):
    np.testing.assert_array_equal(r_fused.T.view(np.int32), r_host.T.view(np.int32))
    assert np.float32(r_fused.error).view(np.int32) == np.float32(r_host.error).view(np.int32)
    assert (r_fused.converged, r_fused.iterations, r_fused.num_correspondences) == (
        r_host.converged, r_host.iterations, r_host.num_correspondences)


@pytest.mark.parametrize("block", [1, 3, 8])
@pytest.mark.parametrize("kw", ALIGN_CASES,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_fused_equals_host_bitwise(kw, block):
    """Every method x optimizer of ``test_align_matches_jax``: T, the error,
    the iterations, converged and the correspondence count bit for bit; the
    fused driver reads the host once per block of ``block`` passes, needs
    the host loop's passes and runs fewer than ``block`` more."""
    rng = np.random.default_rng(42)
    src, tgt, _ = make_pair(rng, 300)
    if "kernel" in kw:
        src = np.vstack([src, rng.uniform(-3, 3, (30, 3)).astype(np.float32)])
    kw = dict(kw, max_iterations=30, voxel_size=0.8 if kw["method"] == "vgicp" else 0.4)
    r_host, r_fused, (h_reads, h_passes), (reads, run, used) = fused_and_host(
        kw, src, tgt, block)
    assert_same_result(r_host, r_fused)
    assert used == h_passes and h_reads <= h_passes
    assert reads == -(-used // block) and run == reads * block
    assert 0 <= run - used < block


@pytest.mark.parametrize("optimizer", ["gn", "lm"])
@pytest.mark.parametrize("edge", ["no iterations", "one iteration", "too few correspondences",
                                  "no lambda trials", "iteration cap"])
def test_fused_equals_host_at_the_edges(optimizer, edge):
    """The loop's exits: no iteration, the cap, a failed first pass (too
    few correspondences), LM without trials."""
    src, tgt, _ = make_pair(np.random.default_rng(5), 200)
    kw = dict(method="icp", optimizer=optimizer, max_iterations=20)
    kw.update({
        "no iterations": dict(max_iterations=0),
        "one iteration": dict(max_iterations=1),
        "too few correspondences": dict(min_correspondences=10**6),
        "no lambda trials": dict(max_inner_iterations=0),
        "iteration cap": dict(max_iterations=3, translation_eps=0.0, rotation_eps=0.0,
                              relative_error_eps=0.0),
    }[edge])
    r_host, r_fused, (_, h_passes), (reads, run, used) = fused_and_host(kw, src, tgt, 4)
    assert_same_result(r_host, r_fused)
    assert used == h_passes and run - used < 4
    if edge == "iteration cap":
        assert r_host.iterations == 3 and not r_host.converged


def test_fused_block_of_the_whole_bound_reads_once():
    """A block as long as the loop's bound of passes: one host read per
    align, as the reference's one ``lax.while_loop`` program."""
    src, tgt, _ = corrugated(2000, 7)
    kw = dict(method="icp", optimizer="gn", max_iterations=25)
    r_host, r_fused, (h_reads, _), (reads, run, used) = fused_and_host(kw, src, tgt, 25)
    assert_same_result(r_host, r_fused)
    assert reads == 1 and run == 25 and h_reads == r_host.iterations > 1


@pytest.mark.parametrize("optimizer", ["gn", "lm"])
def test_fused_block_is_capture_safe(monkeypatch, optimizer):
    """Each block of the fused driver (GICP, and VGICP's dense and sorted
    voxel lookups) runs under the capture guards of ``test_torch_graphs.py``
    after a warm-up call on the same values."""
    from test_torch_graphs import guarded

    blocks = []

    def jit(fn, donate=True, warm=True):
        def step(carry):
            blocks.append(True)
            return guarded(fn, carry)

        return step

    monkeypatch.setattr(reg.graphs, "jit", jit)
    monkeypatch.setattr(reg, "_FUSED_BLOCK", 2)
    src, tgt, _ = make_pair(np.random.default_rng(1), 200)
    for method, corr in (("gicp", "dense"), ("vgicp", "dense"), ("vgicp", "sorted")):
        r_host = reg.align(cpu(src), cpu(tgt), method=method, optimizer=optimizer,
                           max_iterations=6, voxel_size=0.8, correspondence=corr,
                           driver="host")
        r_fused = reg.align(cpu(src), cpu(tgt), method=method, optimizer=optimizer,
                            max_iterations=6, voxel_size=0.8, correspondence=corr,
                            driver="fused")
        assert_same_result(r_host, r_fused)
    assert len(blocks) >= 3


def test_fused_graph_lives_for_one_call(monkeypatch):
    """The fused driver runs its first block eagerly and the later ones
    through one step made for the call (``graphs.jit(..., warm=False)``:
    the first block loaded the kernels), which nothing keeps once ``align``
    returns. The default driver is the host loop, which makes none."""
    made = []
    real_jit = reg.graphs.jit

    def jit(fn, donate=True, warm=True):
        step = real_jit(fn, donate=donate, warm=warm)
        made.append((weakref.ref(step), donate, warm))
        return step

    monkeypatch.setattr(reg.graphs, "jit", jit)
    src, tgt, _ = corrugated(2000, 7)
    kw = dict(method="icp", optimizer="gn", max_iterations=25)
    r_default = reg.align(cpu(src), cpu(tgt), **kw)
    assert made == []
    for _ in range(2):
        assert_same_result(r_default, reg.align(cpu(src), cpu(tgt), driver="fused", **kw))
    gc.collect()
    assert [(r() is None, donate, warm) for r, donate, warm in made] == [(True, True, False)] * 2
