"""The port's copy of JAX's threefry PRNG (``fastdem_tpu_torch/utils/
prng.py``) against ``jax.random`` on the CPU: the draws that
``segment_plane`` makes are the same integers, exactly."""

import jax
import numpy as np
import pytest
import torch

from fastdem_tpu_torch.utils import prng
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("M", [1, 100, 1000])
@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_randint_equals_jax(seed, M):
    for n in (3, 600, 30000, 2**20):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (M, 3), 0, n))
        got = prng.randint(prng.prng_key(seed), (M, 3), 0, n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n}")


def test_key_split_and_bits_equal_jax():
    key = jax.random.PRNGKey(12345)
    assert prng.prng_key(12345) == tuple(int(v) for v in np.asarray(key))
    for got, want in zip(prng.split(prng.prng_key(12345), 3), np.asarray(jax.random.split(key, 3))):
        assert got == tuple(int(v) for v in want)
    bits = np.asarray(jax.random.bits(key, (5, 7), dtype=np.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(prng.prng_key(12345), (5, 7)).numpy(), bits)
    with pytest.raises(OverflowError):
        prng.prng_key(2**31)
