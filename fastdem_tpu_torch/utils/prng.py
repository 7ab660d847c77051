"""JAX's counter-based threefry PRNG in torch integer ops, as far as
``segmentation.segment_plane`` needs it.

The reference draws RANSAC's hypothesis triples with
``jax.random.randint(PRNGKey(seed), (M, 3), 0, n)``; the plane it finds
depends on those draws, so the port reproduces the stream of the JAX
release it is held against (0.9.0, ``jax_threefry_partitionable`` on, its
default) rather than drawing from a ``torch.Generator``:

- ``PRNGKey(seed)`` is ``threefry_seed`` (``jax/_src/prng.py:802``): the
  key (seed >> 32, seed & 0xFFFFFFFF), with a 32-bit seed, so the high
  word is 0;
- the hash is ``threefry_2x32`` (``prng.py:1092``, rounds as in
  ``_threefry2x32_lowering``): 20 rounds of add / rotate / xor with a key
  injection after every four;
- ``split`` (``_threefry_split_foldlike``) hashes the 64-bit counters 0
  and 1 of the shape (2,) as (hi, lo) word pairs: key i = (bits1[i],
  bits2[i]);
- random bits (``_threefry_random_bits_partitionable``, ``prng.py:1184``)
  hash the row-major 64-bit counter of each element and return bits1 ^
  bits2;
- ``_randint`` (``jax/_src/random.py:581``) splits the key, draws a high
  and a low word per element and folds them into [minval, maxval) with
  ``(hi % span) * (2^32 % span) + lo % span``, all mod 2^32, then
  ``% span``.

The words are uint32 values held in int64 tensors and masked after every
add and shift, so the stream is the same on every device. The seed is the
only state: there is no global generator.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry-2x32 hash of the word pairs (x1, x2) under the key
    (k1, k2); int64 tensors holding uint32 values in, the pair out."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed mod 2^32)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit a 32-bit integer")
    return 0, seed & _MASK


def _counters(count: int, device):
    c = torch.arange(count, dtype=torch.int64, device=device)
    return (c >> 32) & _MASK, c & _MASK


def split(key, num: int = 2, device="cpu"):
    """``jax.random.split(key, num)`` as a list of (k1, k2) int pairs."""
    hi, lo = _counters(num, device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return [(int(a), int(b)) for a, b in zip(b1.tolist(), b2.tolist())]


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values in int64)."""
    count = 1
    for s in shape:
        count *= int(s)
    hi, lo = _counters(count, device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def randint(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) with
    scalar bounds inside the int32 range."""
    k1, k2 = split(key, 2, device)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((higher % span) * multiplier) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return (offset + minval).to(torch.int32)
