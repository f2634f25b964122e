"""jax.random's threefry draws, in numpy.

The JAX package draws its initial NN weights with `jax.random.PRNGKey`,
`split` and `uniform` (pinn_fem_tpu/models/fields.py:make_mlp_field), and
the start vectors of its banded eigensolvers with `normal`
(pinn_fem_tpu/solvers/modal.py, buckling.py).  The port cannot import
jax, so it reproduces the first three here bit for bit, to start every NN
document from the weights the JAX CLI starts from, and `normal` to within
6e-6 relative in float32 (see `normal`).  The form reproduced is jax's
default (`jax_threefry_partitionable` on), in float32 and in its x64 mode:

  * a key is two uint32 words; PRNGKey(seed) is (seed >> 32, seed & 0xffffffff);
  * threefry2x32 hashes a pair of uint32 counters under the key (20
    rounds, rotations 13/15/26/6 and 17/29/16/24, a key injection after
    every four rounds, parity constant 0x1BD11BDA);
  * the counters of an array of shape S are the 64-bit iota over S, split
    into its high and low words;
  * split(key, num) is the hash of iota(num), one (x0, x1) pair a key;
  * float32 uniform takes bits = x0 ^ x1, sets them as the mantissa of a
    float in [1, 2) and subtracts 1, then maps f to f * (hi - lo) + lo
    with one rounding (the product and the sum in float64, then float32)
    and a floor at lo;
  * float64 uniform (jax's x64 mode) takes the 64 bits x0 << 32 | x1, sets
    their top 52 as the mantissa of a double in [1, 2) and subtracts 1,
    then maps f to f * (hi - lo) + lo as one fused multiply-add (one
    rounding of the exact value, as XLA's CPU code computes it) and a
    floor at lo;
  * normal is sqrt(2) erfinv(u), u uniform on (-1, 1) from the
    nextafter of -1 toward 0.
"""

from __future__ import annotations

from fractions import Fraction
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
            maxval=1.0, dtype=np.float32) -> np.ndarray:
    """jax.random.uniform(key, shape, dtype, minval, maxval), dtype float32
    or float64."""
    shape = tuple(int(s) for s in shape)
    x0, x1 = _hash_iota(key, int(np.prod(shape, dtype=np.int64)))
    if np.dtype(dtype) == np.float64:
        return _uniform64(x0, x1, minval, maxval).reshape(shape)
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"uniform draws float32 or float64, not {dtype}")
    bits = (x0 ^ x1) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = np.float32(hi - lo)
    out = (f.astype(np.float64) * np.float64(span)
           + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out).reshape(shape)


def _uniform64(x0: np.ndarray, x1: np.ndarray, minval, maxval) -> np.ndarray:
    """The float64 draw: f = mantissa / 2^52 exactly, then
    fma(f, hi - lo, lo) rounded once (exact rational arithmetic)."""
    mantissa = ((x0.astype(np.uint64) << np.uint64(32))
                | x1.astype(np.uint64)) >> np.uint64(12)
    lo, hi = np.float64(minval), np.float64(maxval)
    span, lo_q = Fraction(float(hi - lo)), Fraction(float(lo))
    out = np.array([float(Fraction(int(m), 1 << 52) * span + lo_q)
                    for m in mantissa], dtype=np.float64)
    return np.maximum(lo, out)


# Giles's single-precision erfinv, the approximation XLA evaluates for
# float32: a polynomial in w - 2.5 for w = -log(1 - x^2) < 5, else in
# sqrt(w) - 3.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """float32 erfinv by Giles's polynomials, each multiply-add rounded
    once (as a fused multiply-add)."""
    f32, f64 = np.float32, np.float64
    x = x.astype(f32)
    w = (-np.log(((f32(1.0) - x) * (f32(1.0) + x)).astype(f64))).astype(f32)

    def horner(coefs, t):
        p = np.full_like(x, f32(coefs[0]))
        for c in coefs[1:]:
            p = (f64(f32(c)) + p.astype(f64) * t.astype(f64)).astype(f32)
        return p

    small = horner(_ERFINV_SMALL, w - f32(2.5))
    large = horner(_ERFINV_LARGE,
                   np.sqrt(w.astype(f64)).astype(f32) - f32(3.0))
    out = np.where(w < f32(5.0), small, large) * x
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1.0, x * np.inf, out).astype(f32)


def normal(key: np.ndarray, shape: Sequence[int] = (),
           dtype=np.float32) -> np.ndarray:
    """jax.random.normal(key, shape, dtype), dtype float32 or float64:
    sqrt(2) erfinv of `uniform` on (nextafter(-1, 0), 1).  The uniform
    draw is jax's bit for bit; XLA's float32 erfinv and log are its own
    approximations, so the float32 result is within 6e-6 relative of
    jax's (87 % of draws bit-equal, the rest in the tails; measured on
    three keys of 64,000 draws); the float64 one takes torch's erfinv,
    within 4e-15 relative."""
    dtype = np.dtype(dtype)
    lo = np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype))
    u = uniform(key, shape, lo, 1.0, dtype)
    if dtype == np.float64:
        import torch

        return np.sqrt(2.0) * torch.special.erfinv(torch.from_numpy(u)).numpy()
    return (np.float32(np.sqrt(2.0)) * _erfinv32(u)).astype(np.float32)
