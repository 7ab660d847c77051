"""The port's sensor noise models against the JAX package's (rtol 1e-6).

The three models' ``z_variance_world`` and ``compute_covariances`` on the
same points and sensor rotations (numpy, from a seed), plus the factory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdem_tpu.config import config as config_j
from fastdem_tpu.sensors import models as mod_j
from fastdem_tpu_torch import config as config_t
from fastdem_tpu_torch.sensors import models as mod_t
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


def rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


MODELS = [
    ("constant", dict(uncertainty=0.03)),
    ("lidar", dict(range_noise=0.02, angular_noise=0.001)),
    ("lidar", dict(range_noise=-0.05, angular_noise=0.003)),
    ("rgbd", dict(normal_a=0.001, normal_b=0.002, normal_c=0.4, lateral_factor=0.001)),
]
CLASSES = {"constant": "ConstantModel", "lidar": "LiDARModel", "rgbd": "RGBDModel"}


@pytest.mark.parametrize("kind,params", MODELS)
def test_models_match_jax(rng, kind, params):
    mj = getattr(mod_j, CLASSES[kind])(**params)
    mt = getattr(mod_t, CLASSES[kind])(**params)
    xyz = rng.uniform(-12, 12, (4000, 3)).astype(np.float32)
    xyz[:20] = rng.uniform(-1e-4, 1e-4, (20, 3))  # near the origin: fallback
    xyz[20:40, 2] = -np.abs(xyz[20:40, 2])  # invalid RGB-D depth
    for _ in range(3):
        r3 = rotation(rng)[2]
        ref = jax.jit(mj.z_variance_world)(jnp.asarray(xyz), jnp.asarray(r3))
        got = mt.z_variance_world(torch.tensor(xyz), torch.tensor(r3))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    # The full covariance (off the mapping path): entries are O(1e-2) and
    # the reference contracts its products into FMAs, so off-diagonal
    # entries near zero agree to about one ulp of the diagonal (1e-9).
    ref = mj.compute_covariances(jnp.asarray(xyz[:500]))
    got = mt.compute_covariances(torch.tensor(xyz[:500]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("sensor_type", ["LIDAR", "RGBD", "CONSTANT"])
def test_create_sensor_model(sensor_type):
    cj, ct = config_j.SensorModelConfig(), config_t.SensorModelConfig()
    cj.type = getattr(config_j.SensorType, sensor_type)
    ct.type = getattr(config_t.SensorType, sensor_type)
    mj, mt = mod_j.create_sensor_model(cj), mod_t.create_sensor_model(ct)
    assert type(mj).__name__ == type(mt).__name__
    assert dataclasses_fields(mj) == dataclasses_fields(mt)
    # One package's config is not the other's.
    with pytest.raises(TypeError):
        mod_t.create_sensor_model(cj)


def dataclasses_fields(obj):
    import dataclasses

    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
