"""`jax.random.randint(jax.random.PRNGKey(seed), shape, 0, maxval)`, bit for
bit, without JAX.

The reference draws its RANSAC hypotheses from `jax.random`
(plslam_tpu/solvers/pnp.py:57-58); a port that drew others would pick other
hypotheses and could not be held to the reference. This copies what JAX
0.9 computes with its default threefry generator and
`jax_threefry_partitionable = True` (jax/_src/random.py `_randint`,
jax/_src/prng.py `threefry_split` / `threefry_random_bits`):

  key      = PRNGKey(seed)           = (0, seed)  (without x64: 32-bit seeds)
  k1, k2   = split(key)              = threefry2x32(key, counts (0, 0), (0, 1)) per key
  bits(k)  = hi ^ lo of threefry2x32(k, the 64-bit iota over `shape` as (hi, lo) words)
  span     = maxval (minval 0)
  mult     = (2^16 % span)^2 % span, in uint32 (0 once span > 2^16)
  value    = ((bits(k1) % span) * mult + bits(k2) % span) % span

with every operation in uint32, wrapping. Only int32 outputs (JAX's default
integer type without x64), minval 0 (what the reference draws) and seeds
in [0, 2^32) are taken. The words are made in numpy, the range mapping in
torch on the device that holds maxval.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over uint32 arrays."""
    with np.errstate(over="ignore"):
        k1, k2 = np.uint32(k1), np.uint32(k2)
        ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """PRNGKey(seed) -> (k1, k2) uint32, as JAX forms it without x64."""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError("seed must be an integer in [0, 2**32)")
    return np.uint32(0), np.uint32(seed)


def _iota_2x32(shape):
    """The row-major 64-bit iota over `shape` as (hi, lo) uint32 words."""
    n = math.prod(shape)
    iota = np.arange(n, dtype=np.uint64)
    hi = (iota >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def split(key, num: int = 2):
    """jax.random.split(key, num) -> [(k1, k2)] * num."""
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return [(b1[i], b2[i]) for i in range(num)]


def random_bits32(key, shape):
    """32 random bits per element of `shape` (uint32)."""
    hi, lo = _iota_2x32(tuple(shape))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def randint_bits(seed: int, shape):
    """The two uint32 words `randint` maps into its range: (higher, lower),
    each of `shape`. They depend on the seed and shape only."""
    k1, k2 = split(prng_key(seed))
    shape = tuple(int(d) for d in shape)
    return random_bits32(k1, shape), random_bits32(k2, shape)


def randint(seed: int, shape, maxval):
    """jax.random.randint(jax.random.PRNGKey(seed), shape, 0, maxval) with
    int32 output. maxval is a positive integer below 2^31, as a Python int
    or a 0-dim integer tensor; the result is an int64 tensor of `shape` on
    maxval's device (the CPU for an int). The random words come from the
    host (they do not depend on maxval); the mapping into [0, maxval) runs
    on the device in int64 with JAX's uint32 wrap-around made explicit, so a
    maxval left on the card is never read back."""
    span = torch.as_tensor(maxval).to(torch.int64)
    higher, lower = (torch.from_numpy(b.astype(np.int64)).to(span.device) for b in randint_bits(seed, shape))
    wrap = 0xFFFFFFFF
    mult = (((65536 % span) ** 2) & wrap) % span  # 2^32 mod span, as JAX forms it in uint32
    offset = (((higher % span) * mult) & wrap) + lower % span  # each term below 2^62
    return (offset & wrap) % span
