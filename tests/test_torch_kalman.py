"""The port's Kalman + Welford update against the JAX package's (rtol 1e-6).

Random map states (NaN where never measured) and observations, made with
numpy from a seed, go through ``kalman.update`` of both packages on the
CPU, scan after scan, with and without process noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.config.config import KalmanConfig as KalmanConfigJ
from fastdem_tpu.grid import gridmap as gm_j
from fastdem_tpu.grid.geometry import GridGeometry as GeomJ
from fastdem_tpu.mapping import kalman as kal_j
from fastdem_tpu_torch.config import KalmanConfig as KalmanConfigT
from fastdem_tpu_torch.grid import gridmap as gm_t
from fastdem_tpu_torch.grid.geometry import GridGeometry as GeomT
from fastdem_tpu_torch.mapping import kalman as kal_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (24, 31)


def assert_close(ref, got, what):
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref), rtol=1e-6, atol=0, equal_nan=True,
        err_msg=what,
    )
    np.testing.assert_array_equal(np.isnan(np.asarray(ref)), np.isnan(got.numpy()))


@pytest.mark.parametrize("process_noise", [0.0, 1e-4])
def test_kalman_update_matches_jax(rng, process_noise):
    kw = dict(min_variance=1e-4, max_variance=1e-2, process_noise=process_noise)
    cfg_j, cfg_t = KalmanConfigJ(**kw), KalmanConfigT(**kw)
    fills = gm_j.default_layer_fills()
    fills.update(kal_j.layer_fills())
    fills_t = {**gm_t.default_layer_fills(), **kal_t.layer_fills()}
    assert list(fills) == list(fills_t)
    np.testing.assert_array_equal(list(fills.values()), list(fills_t.values()))
    sj = gm_j.create(GeomJ(SHAPE[0], SHAPE[1], 0.1), fills)
    st = gm_t.create(GeomT(SHAPE[0], SHAPE[1], 0.1), fills, device="cpu")
    step_j = jax.jit(lambda s, z, v, t: kal_j.update(s, cfg_j, z, v, t))
    for _ in range(6):
        touched = rng.random(SHAPE) < 0.6
        z = np.where(touched, rng.normal(0.3, 0.05, SHAPE), np.nan).astype(np.float32)
        var = rng.uniform(-1e-3, 2e-2, SHAPE).astype(np.float32)  # <= 0 falls back
        var[rng.random(SHAPE) < 0.05] = np.nan
        var = np.where(touched, var, np.nan).astype(np.float32)
        sj = step_j(sj, jnp.asarray(z), jnp.asarray(var), jnp.asarray(touched))
        st = kal_t.update(st, cfg_t, torch.tensor(z), torch.tensor(var),
                          torch.tensor(touched))
        assert set(sj.layers) == set(st.layers)
        for k in sj.layers:
            assert_close(sj.layers[k], st.layers[k], k)
    assert (st.layers["n_points"] >= 2).any()
