"""The port's post-processing chain against the JAX package, on the CPU.

Every case of ``tests/test_postprocess.py`` (PCA, inpainting, smoothing,
uncertainty fusion, feature extraction, the chain) runs through the
jitted JAX function and its port on the same input; the chain also runs on
the mapped layers of the golden session (``goldens/session_kalman.npz``)
with the default post-processing configuration and with the C++ golden
test's own (``test_reference_goldens.py::test_postprocess_chain_matches_reference``),
and the map-level ``apply_*`` wrappers run on a map state of those layers.

Tolerances: NaN sets and the ``ok`` mask exact; elevation, bounds, step,
roughness, curvature and normals within 2e-6; slope within 5e-3 degrees
(acos near |n_z| = 1 is ill-conditioned). The port mirrors the reference's
compiled arithmetic (window sums in offset order, its FMA contractions,
its acos lowering) but not its vectorised cosf / atan2f, which differ in
the last ulps. The smallest eigenvalue cancels to a few ulps of the trace
on near-planar windows, and roughness = sqrt(eigenvalue) amplifies those
ulps, so roughness is held within 2e-6 or, where sqrt amplifies, its
square (the eigenvalue, m^2) within 1e-8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.cloud import pca as pca_j
from fastdem_tpu.config import config as cfg_j
from fastdem_tpu.grid import gridmap as gm_j
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu import postprocess as pp_j
from fastdem_tpu_torch import config as cfg_t
from fastdem_tpu_torch import postprocess as pp_t
from fastdem_tpu_torch.cloud import pca as pca_t
from fastdem_tpu_torch.grid import gridmap as gm_t
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "session_kalman.npz")
ATOL = 2e-6
SLOPE_ATOL = 5e-3
# Where sqrt amplifies, roughness^2 (the smallest eigenvalue, m^2).
EIGEN_ATOL = 1e-8


def assert_layer(name, ref, got, atol=ATOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, name
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got), err_msg=f"{name}: NaN set")
    both = np.isfinite(ref)
    diff = np.abs(ref[both] - got[both])
    if name == "roughness":
        over = diff > atol
        r, g = ref[both][over].astype(np.float64), got[both][over].astype(np.float64)
        sq = np.abs(r * r - g * g)
        assert np.all(sq <= EIGEN_ATOL), f"roughness^2 differs by {sq.max()}"
    else:
        assert diff.max(initial=0.0) <= atol, f"{name}: max |diff| {diff.max()}"


def bitwise_share(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    fin = np.isfinite(ref) & np.isfinite(got)
    if not fin.any():
        return 1.0
    return float(np.mean(ref[fin].view(np.int32) == got[fin].view(np.int32)))


def layer_tol(name):
    return SLOPE_ATOL if name == "slope" else ATOL


# ---- the cases of tests/test_postprocess.py -------------------------------

def _hole():
    a = np.ones((10, 10), np.float32)
    a[5, 5] = np.nan
    return a


def _valid_and_hole():
    a = _hole()
    a[3, 3] = 7.0
    return a


def _island():
    a = np.full((10, 10), np.nan, np.float32)
    a[0, 0] = 1.0
    return a


def _frame():
    a = np.full((11, 11), np.nan, np.float32)
    a[0, :] = a[10, :] = a[:, 0] = a[:, 10] = 1.0
    return a


INPAINT_CASES = {
    "fills_small_hole": (_hole, 3, 2),
    "preserves_valid": (_valid_and_hole, 3, 2),
    "min_valid_neighbors": (_island, 1, 2),
    "iterative_expansion": (_frame, 10, 2),
}


@pytest.mark.parametrize("case", sorted(INPAINT_CASES))
def test_inpainting_cases_match_jax(case):
    make, iters, minv = INPAINT_CASES[case]
    a = make()
    ref = jax.jit(lambda x: pp_j.inpaint(x, iters, minv))(jnp.asarray(a))
    got = pp_t.inpaint(torch.tensor(a), iters, minv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _spike():
    a = np.zeros((9, 9), np.float32)
    a[4, 4] = 10.0
    return a


def _edge():
    return np.concatenate([np.zeros((9, 4)), np.ones((9, 5))], axis=1).astype(np.float32)


def _lone():
    a = np.full((9, 9), np.nan, np.float32)
    a[4, 4] = 3.0
    return a


SMOOTH_CASES = {"spike_removed": _spike, "edge_preserved": _edge,
                "insufficient_neighbors_untouched": _lone}


@pytest.mark.parametrize("case", sorted(SMOOTH_CASES))
def test_smoothing_cases_match_jax(case):
    a = SMOOTH_CASES[case]()
    ref = jax.jit(lambda x: pp_j.smooth_median(x, 3, 5))(jnp.asarray(a))
    got = pp_t.smooth_median(torch.tensor(a), 3, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _confident_neighbors():
    up = np.full((9, 9), 1.005, np.float32)
    lo = np.full((9, 9), 0.995, np.float32)
    up[4, 4], lo[4, 4] = 5.0, -5.0
    return up, lo


def _invalid_center():
    return np.full((9, 9), np.nan, np.float32), np.full((9, 9), np.nan, np.float32)


def _uniform():
    return np.full((9, 9), 2.0, np.float32), np.full((9, 9), 1.0, np.float32)


def _noisy_bounds():
    rng = np.random.default_rng(3)
    z = rng.normal(0.0, 0.05, (40, 40)).astype(np.float32)
    r = np.abs(rng.normal(0.02, 0.01, (40, 40))).astype(np.float32)
    up, lo = z + r, z - r
    up[rng.random((40, 40)) < 0.15] = np.nan
    return up, lo


UF_CASES = {"bounds_tighten_toward_confident_neighbors": _confident_neighbors,
            "invalid_center_untouched": _invalid_center,
            "quantiles_of_uniform_field": _uniform, "noisy_bounds": _noisy_bounds}


@pytest.mark.parametrize("radius", [0.15, 0.3])
@pytest.mark.parametrize("case", sorted(UF_CASES))
def test_uncertainty_fusion_cases_match_jax(case, radius):
    """Radius 0.3 m makes a 29-entry window, past the 16 at which the
    reference's cumulative sum switches to blocks."""
    up, lo = UF_CASES[case]()
    cj = cfg_j.UncertaintyFusionConfig(enabled=True, search_radius=radius)
    ct = cfg_t.UncertaintyFusionConfig(enabled=True, search_radius=radius)
    ref = jax.jit(lambda u, l: pp_j.fuse_bounds(u, l, cj, 0.1))(jnp.asarray(up), jnp.asarray(lo))
    got = pp_t.fuse_bounds(torch.tensor(up), torch.tensor(lo), ct, 0.1)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _flat():
    return np.zeros((15, 15), np.float32)


def _tilted():
    x = -(np.arange(15, dtype=np.float32) * 0.1)
    return np.broadcast_to((x * np.tan(np.deg2rad(30.0)))[:, None], (15, 15)).astype(np.float32)


def _step():
    return np.concatenate([np.zeros((15, 7)), np.ones((15, 8))], axis=1).astype(np.float32)


def _nan_center():
    a = _flat()
    a[7, 7] = np.nan
    return a


def _rough():
    rng = np.random.default_rng(5)
    x = np.arange(40)[:, None] * 0.1
    a = (0.3 * np.sin(x) * np.cos(0.7 * np.arange(40)[None, :] * 0.1)
         + rng.normal(0, 0.01, (40, 40))).astype(np.float32)
    a[rng.random((40, 40)) < 0.1] = np.nan
    return a


FEATURE_CASES = {"flat_plane": _flat, "tilted_plane_slope": _tilted,
                 "step_detection": _step, "nan_center_skipped": _nan_center,
                 "rough_terrain": _rough}


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_feature_cases_match_jax(case):
    a = FEATURE_CASES[case]()
    fcj = cfg_j.FeatureExtractionConfig(enabled=True, analysis_radius=0.3)
    fct = cfg_t.FeatureExtractionConfig(enabled=True, analysis_radius=0.3)
    ref = jax.jit(lambda e: pp_j.extract_features(e, fcj, 0.1))(jnp.asarray(a))
    got = pp_t.extract_features(torch.tensor(a), fct, 0.1)
    ok = np.asarray(ref["ok"])
    np.testing.assert_array_equal(got["ok"].numpy(), ok)
    # Values on cells with a full window: on these synthetic planes the
    # clipped border windows are near-isotropic, where the eigenvector is
    # ill-conditioned (the golden-session chain below covers borders).
    full = np.zeros_like(ok)
    full[3:-3, 3:-3] = True
    for name in ("step", "slope", "roughness", "curvature", "normal_x", "normal_y",
                 "normal_z"):
        assert_layer(name, np.where(ok & full, ref[name], np.nan),
                     np.where(ok & full, got[name].numpy(), np.nan), layer_tol(name))
    if case == "tilted_plane_slope":
        assert got["slope"][7, 7].item() == pytest.approx(30.0, abs=1.0)
        assert got["normal_z"][7, 7].item() > 0


def run_both(elev, up, lo, resolution, configure):
    pj, pt = cfg_j.PostProcessConfig(), cfg_t.PostProcessConfig()
    for c in (pj, pt):
        c.uncertainty_fusion.enabled = True
        c.inpainting.enabled = True
        c.feature_extraction.enabled = True
        configure(c)
    H, W = elev.shape
    ref = jax.jit(pp_j.apply_postprocess_fn(GeomJ(H, W, resolution), pj))(
        jnp.asarray(elev), jnp.asarray(up), jnp.asarray(lo))
    got = pp_t.apply_postprocess_fn(GeomT(H, W, resolution), pt)(
        torch.tensor(elev), torch.tensor(up), torch.tensor(lo))
    assert set(ref) == set(got)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


def test_chain_case_matches_jax(rng):
    """``TestPostprocessChain.test_chain_runs``: a 5 m map with one hole."""
    elev = rng.normal(0, 0.05, size=(50, 50)).astype(np.float32)
    elev[10, 10] = np.nan
    ref, got = run_both(elev, elev + 0.1, elev - 0.1, 0.1, lambda c: None)
    assert np.isfinite(got["elevation"][10, 10])
    for name in ref:
        assert_layer(name, ref[name], got[name], layer_tol(name))


# ---- the chain on a mapped state -------------------------------------------

def golden_default(c):
    pass


def golden_reference_test(c):
    c.inpainting.max_iterations = 3
    c.inpainting.min_valid_neighbors = 3
    c.feature_extraction.analysis_radius = 0.3
    c.feature_extraction.min_valid_neighbors = 4


@pytest.mark.parametrize("configure", [golden_default, golden_reference_test])
def test_chain_on_golden_session_matches_jax(configure):
    with np.load(GOLDEN) as data:
        elev, up, lo = data["elevation"], data["upper_bound"], data["lower_bound"]
    ref, got = run_both(elev, up, lo, 0.2, configure)
    expected = {"elevation", "upper_bound", "lower_bound", "uncertainty_range", "step",
                "slope", "roughness", "curvature", "normal_x", "normal_y", "normal_z"}
    assert set(got) == expected
    for name in sorted(ref):
        assert_layer(name, ref[name], got[name], layer_tol(name))
    # The fused bounds, inpainting and step are bit for bit.
    for name in ("elevation", "upper_bound", "lower_bound", "uncertainty_range", "step"):
        assert bitwise_share(ref[name], got[name]) == 1.0, name
    assert np.isfinite(got["slope"]).sum() > 2000
    # Median smoothing of the chain's elevation, as the golden test runs it.
    sm_ref = jax.jit(lambda e: pp_j.smooth_median(e, 3, 5))(jnp.asarray(ref["elevation"]))
    sm_got = pp_t.smooth_median(torch.tensor(got["elevation"]), 3, 5)
    np.testing.assert_array_equal(sm_got.numpy(), np.asarray(sm_ref))


# ---- the map-level wrappers --------------------------------------------------

FEATURE_LAYERS = ("step", "slope", "roughness", "curvature", "_normal_x", "_normal_y",
                  "_normal_z")


def golden_states(previous_features):
    """The golden session's layers as a map state in both packages;
    ``previous_features`` adds feature layers holding 7.0, which cells the
    guards skip must keep."""
    with np.load(GOLDEN) as data:
        arrs = {k: data[k] for k in ("elevation", "upper_bound", "lower_bound")}
    H, W = arrs["elevation"].shape
    if previous_features:
        arrs.update({k: np.full((H, W), 7.0, np.float32) for k in FEATURE_LAYERS})
    sj = gm_j.create(GeomJ(H, W, 0.2), {}).replace_layers(
        {k: jnp.asarray(v) for k, v in arrs.items()})
    st = gm_t.create(GeomT(H, W, 0.2), {}, device="cpu").replace_layers(
        {k: torch.tensor(v) for k, v in arrs.items()})
    return (GeomJ(H, W, 0.2), sj), (GeomT(H, W, 0.2), st)


def _fusion(pp, g, s, cfg):
    return pp.apply_uncertainty_fusion(g, s, cfg.uncertainty_fusion)


def _inpaint_in_place(pp, g, s, cfg):
    return pp.apply_inpainting(g, s, cfg.inpainting)


def _inpaint_to_layer(pp, g, s, cfg):
    return pp.apply_inpainting(g, s, cfg.inpainting, inplace=False)


def _features(pp, g, s, cfg):
    return pp.apply_feature_extraction(g, s, cfg.feature_extraction)


def _smooth(pp, g, s, cfg):
    return pp.apply_spatial_smoothing(s, "elevation", 3, 5)


def _smooth_absent(pp, g, s, cfg):
    return pp.apply_spatial_smoothing(s, "slope", 3, 5)


WRAPPER_CASES = {
    "uncertainty_fusion": (_fusion, False),
    "inpainting_in_place": (_inpaint_in_place, False),
    "inpainting_to_layer": (_inpaint_to_layer, False),
    "features_fresh": (_features, False),
    "features_keep_previous": (_features, True),
    "smoothing": (_smooth, False),
    "smoothing_absent_layer": (_smooth_absent, False),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_map_level_wrappers_match_jax(case):
    """``apply_*`` on a map state: the same layer set and values as the
    jitted JAX wrapper."""
    fn, previous = WRAPPER_CASES[case]
    (gj, sj), (gt, st) = golden_states(previous)
    pj, pt = cfg_j.PostProcessConfig(), cfg_t.PostProcessConfig()
    for c in (pj, pt):
        c.uncertainty_fusion.enabled = True
        c.feature_extraction.enabled = True
    ref = jax.jit(lambda s: fn(pp_j, gj, s, pj))(sj)
    got = fn(pp_t, gt, st, pt)
    assert set(got.layers) == set(ref.layers)
    for name in sorted(ref.layers):
        assert_layer(name, ref.layers[name], got.layers[name].numpy(), layer_tol(name))
    changed = [k for k in got.layers
               if k not in st.layers or got.layers[k] is not st.layers[k]]
    assert bool(changed) != (case == "smoothing_absent_layer"), changed
    if previous:
        assert (got.layers["slope"] == 7.0).sum() > 0  # skipped cells kept


# ---- PCA ---------------------------------------------------------------------

def covariances(kind, rng):
    if kind == "random":
        A = rng.normal(size=(500, 3, 3)).astype(np.float32)
        return np.einsum("nij,nkj->nik", A, A).astype(np.float32)
    if kind == "flat":  # one small eigenvalue: the terrain case
        A = rng.normal(size=(500, 3, 3)).astype(np.float32) * 0.05
        c = np.einsum("nij,nkj->nik", A, A).astype(np.float32)
        c[:, 2, :] *= 0.1
        c[:, :, 2] *= 0.1
        return c
    if kind == "near_diag":
        c = np.zeros((500, 3, 3), np.float32)
        idx = np.arange(3)
        c[:, idx, idx] = rng.uniform(0.0, 1.0, (500, 3)).astype(np.float32)
        return c
    # degenerate: zeros, a repeated eigenvalue, rank one
    c = np.zeros((3, 3, 3), np.float32)
    c[1] = np.eye(3, dtype=np.float32) * 0.5
    v = np.array([0.3, -0.2, 0.9], np.float32)
    c[2] = np.outer(v, v)
    return c


@pytest.mark.parametrize("kind", ["random", "flat", "near_diag", "degenerate"])
def test_eigh3x3_matches_jax(rng, kind):
    cov = covariances(kind, rng)
    lam_j, vec_j = jax.jit(pca_j.eigh3x3)(jnp.asarray(cov))
    lam_t, vec_t = pca_t.eigh3x3(torch.tensor(cov))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(cov).max())))
    np.testing.assert_array_equal(np.isnan(vec_t.numpy()), np.isnan(np.asarray(vec_j)))
    if kind in ("near_diag", "degenerate"):
        np.testing.assert_allclose(vec_t.numpy(), np.asarray(vec_j), rtol=0, atol=ATOL)
    else:
        # The smallest eigenvector (the normal): well separated here.
        np.testing.assert_allclose(vec_t.numpy()[..., 0], np.asarray(vec_j)[..., 0],
                                   rtol=0, atol=1e-4)
    res_j = pca_j.compute_pca(jnp.asarray(cov))
    res_t = pca_t.compute_pca(torch.tensor(cov))
    np.testing.assert_array_equal(res_t.valid.numpy(), np.asarray(res_j.valid))
    if kind == "degenerate":
        assert not bool(res_t.valid[0])
