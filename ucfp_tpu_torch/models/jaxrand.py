"""jax.random's threefry2x32 normals, regenerated in numpy.

The stand-in encoders' weights (models/encoders.py) are drawn in the
reference with `jax.random.split` and `jax.random.normal` under jax's
partitionable threefry scheme (`jax_threefry_partitionable = True`, the
default of jax 0.9). This module draws the same float32 arrays without
jax, bit for bit:

  * `threefry2x32`, `split` and `random_bits32` follow jax/_src/prng.py
    (`_threefry2x32_lowering`, `_threefry_split_foldlike`,
    `_threefry_random_bits_partitionable`: the counter is the flat index
    as a 64-bit integer cut into high and low words, and 32-bit draws are
    the XOR of the two output words);
  * `uniform` follows jax/_src/random.py `_uniform`: 23 random mantissa
    bits under the exponent of 1.0, minus 1, scaled and shifted;
  * `normal` is `sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))`, as
    `_normal_real` draws it, with `erf_inv_f32` the float32 formula that
    XLA compiles for the CPU: the chlo decomposition of erf_inv (Giles'
    polynomial over w = -log1p(-x^2)), XLA's Cephes log1p and log, and
    every multiply that LLVM fuses with the following add on an FMA host
    evaluated as one correctly rounded fused multiply-add (`fma32`).

tests/test_torch_encoders.py holds the bits, the uniforms and the
normals equal to jax's.
"""

from __future__ import annotations

import numpy as np

_f = np.float32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = (x0 + ks[0]).astype(np.uint32)
        x1 = (x1 + ks[1]).astype(np.uint32)
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _iota_2x32(shape: tuple) -> tuple[np.ndarray, np.ndarray]:
    c = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (c >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (c & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def prng_key(seed: int) -> tuple[np.uint32, np.uint32]:
    """jax.random.PRNGKey(seed) for a seed in [0, 2^31) (jax without x64
    takes the seed as an int32)."""
    if not 0 <= seed < 2**31:
        raise ValueError("seed must be in [0, 2^31)")
    return np.uint32(0), np.uint32(seed)


def split(key, num: int = 2) -> list[tuple[np.uint32, np.uint32]]:
    """jax.random.split(key, num), as a list of (k1, k2) pairs."""
    b1, b2 = threefry2x32(key[0], key[1], *_iota_2x32((num,)))
    return [(b1[i], b2[i]) for i in range(num)]


def random_bits32(key, shape: tuple) -> np.ndarray:
    """jax.random.bits(key, shape, uint32)."""
    b1, b2 = threefry2x32(key[0], key[1], *_iota_2x32(tuple(shape)))
    return b1 ^ b2


def uniform(key, shape: tuple, minval, maxval) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    bits = random_bits32(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - _f(1)
    lo, hi = _f(minval), _f(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def fma32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 a * b + c: the product is exact in
    float64, TwoSum gives the sum's rounding error, and rounding the sum
    to odd before the one rounding to float32 avoids double rounding."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    with np.errstate(invalid="ignore", over="ignore"):
        p = a * b
        s = p + c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        bits = s.view(np.int64)
        # one ulp toward the error where the sum was inexact and even
        # (the magnitude grows when the error has the sum's sign)
        step = np.where((err > 0) == (s > 0), 1, -1)
        fix = np.isfinite(s) & (err != 0) & ((bits & 1) == 0)
        bits = bits + np.where(fix, step, 0)
        return bits.view(np.float64).astype(np.float32)


# Cephes' single-precision log, in the order XLA's CPU backend emits it
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def log_f32(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    bits = np.maximum(x, _f(1.17549435e-38)).view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(np.float32) + _f(1)
    m = ((bits & np.uint32(0x007FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    below = m < _f(0.707106781186547524)
    t = (m + _f(-1)) + np.where(below, m, _f(0))
    e = e - np.where(below, _f(1), _f(0))
    t2 = t * t
    t3 = t2 * t
    p = [_f(c) for c in _LOG_P]
    y1 = fma32(fma32(t, p[0], p[1]), t, p[2])
    y2 = fma32(fma32(t, p[3], p[4]), t, p[5])
    y3 = fma32(fma32(t, p[6], p[7]), t, p[8])
    y = fma32(fma32(y1, t3, y2), t3, y3)
    r = fma32(y, t3, e * _f(-2.12194440e-4))
    r = fma32(-t2, _f(0.5), t) + r
    r = fma32(e, _f(0.693359375), r)
    with np.errstate(invalid="ignore"):
        r = np.where(x <= 0, np.where(x == 0, _f(-np.inf), _f(np.nan)), r)
    return np.where(x == np.inf, _f(np.inf), r).astype(np.float32)


# XLA's log1p: Cephes' rational form below sqrt(2) - 1, log(1 + x) above
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)


def log1p_f32(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    large = log_f32(x + _f(1))
    x2 = x * x
    den = np.full_like(x, _f(_LOG1P_DEN[0]))
    for c in _LOG1P_DEN[1:]:
        den = fma32(den, x, _f(c))
    num = np.full_like(x, _f(_LOG1P_NUM[0]))
    for c in _LOG1P_NUM[1:]:
        num = fma32(num, x, _f(c))
    with np.errstate(invalid="ignore", divide="ignore"):
        r = (num / den).astype(np.float32)
    small = x + fma32(x2, _f(-0.5), (x * x2) * r)
    return np.where(np.abs(x) < _f(0.41421356237309504880), small,
                    large).astype(np.float32)


# Giles' single-precision erf_inv coefficients (stablehlo's chlo lowering)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        w = -log1p_f32(x * -x)
        lt = w < _f(5)
        z = np.where(lt, w - _f(2.5), np.sqrt(w) - _f(3)).astype(np.float32)
    p = np.where(lt, _f(_ERFINV_LT5[0]), _f(_ERFINV_GE5[0])).astype(np.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, z, np.where(lt, _f(a), _f(b)))
    return (x * np.where(np.abs(x) == 1, _f(np.inf), p)).astype(np.float32)


def normal(key, shape: tuple) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    lo = np.nextafter(_f(-1), _f(0), dtype=np.float32)
    u = uniform(key, shape, lo, _f(1)).ravel()
    # elementwise, so chunks that stay in cache give the same bits
    out = np.concatenate([erf_inv_f32(u[i:i + 65536])
                          for i in range(0, u.size, 65536)])
    return (_f(np.sqrt(2)) * out).astype(np.float32).reshape(shape)
