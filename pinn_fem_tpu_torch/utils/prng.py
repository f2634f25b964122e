"""jax.random's threefry draws, in numpy (float32 `uniform` only).

The JAX package draws its initial NN weights with `jax.random.PRNGKey`,
`split` and `uniform` (pinn_fem_tpu/models/fields.py:make_mlp_field).  The
port cannot import jax, so it reproduces those three functions here, bit
for bit, to start every NN document from the weights the JAX CLI starts
from.  The form reproduced is jax's default (`jax_threefry_partitionable`
on, 32-bit mode):

  * a key is two uint32 words; PRNGKey(seed) is (seed >> 32, seed & 0xffffffff);
  * threefry2x32 hashes a pair of uint32 counters under the key (20
    rounds, rotations 13/15/26/6 and 17/29/16/24, a key injection after
    every four rounds, parity constant 0x1BD11BDA);
  * the counters of an array of shape S are the 64-bit iota over S, split
    into its high and low words;
  * split(key, num) is the hash of iota(num), one (x0, x1) pair a key;
  * uniform takes bits = x0 ^ x1, sets them as the mantissa of a float in
    [1, 2) and subtracts 1, then maps f to f * (hi - lo) + lo with one
    rounding (the product and the sum in float64, then float32) and a
    floor at lo.

jax's float64 draw (its x64 mode) is not reproduced: the port computes in
float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 hash of the counter pairs (x0, x1) under `key`."""
    k = (np.uint32(key[0]), np.uint32(key[1]))
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def _hash_iota(key: np.ndarray, size: int):
    count = np.arange(size, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        return threefry2x32(key, hi, lo)


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): the (2,) uint32 key of an integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    x0, x1 = _hash_iota(key, num)
    return np.stack([x0, x1], axis=1)


def uniform(key: np.ndarray, shape: Sequence[int] = (), minval=0.0,
            maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    shape = tuple(int(s) for s in shape)
    x0, x1 = _hash_iota(key, int(np.prod(shape, dtype=np.int64)))
    bits = (x0 ^ x1) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = np.float32(hi - lo)
    out = (f.astype(np.float64) * np.float64(span)
           + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out).reshape(shape)
