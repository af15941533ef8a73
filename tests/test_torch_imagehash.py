"""ucfp_tpu_torch.ops.imagehash against ucfp_tpu.ops.imagehash on the CPU.

Every hash stage is exact integer math, so the port's bytes must be
EQUAL to the reference's. multihash_weighted_topk returns the same ids
and bit-equal scores: the port reproduces XLA's fused multiply-adds in
the weighted sum exactly (ops/imagehash._fma_f32), so no tolerance is
needed there either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import imagehash as J
from ucfp_tpu_torch.modality import image as TI
from ucfp_tpu_torch.ops import imagehash as T

SHAPES = [(100, 37), (48, 640), (256, 256), (64, 64), (32, 32), (9, 8)]


def _t(out):
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("h,w", SHAPES)
def test_multihash_gray_bit_equal(h, w):
    g = np.random.default_rng(h * 1000 + w).integers(0, 256, (5, h, w), np.uint8)
    ref = jax.device_get(J.multihash_kernel_gray(g, h, w))
    got = _t(T.multihash_kernel_gray(g, h, w, device="cpu"))
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("h,w", [(100, 37), (256, 256)])
def test_multihash_rgb_bit_equal(h, w):
    rgb = np.random.default_rng(w).integers(0, 256, (3, h, w, 3), np.uint8)
    ref = jax.device_get(J.multihash_kernel(rgb, h, w))
    got = _t(T.multihash_kernel(rgb, h, w, device="cpu"))
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("h,w", [(256, 256), (48, 640)])
def test_multihash_pre_route_bit_equal(h, w):
    g = np.random.default_rng(7).integers(0, 256, (4, h, w), np.uint8)
    planes = TI.multi_pre_planes(g)
    ref = jax.device_get(J.multihash_kernel_pre(*planes))
    got = _t(T.multihash_kernel_pre(*planes, device="cpu"))
    full = jax.device_get(J.multihash_kernel_gray(g, h, w))
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
        # the host pre-resize is byte-identical to the device resize
        np.testing.assert_array_equal(got[key], np.asarray(full[key]), err_msg=key)


@pytest.mark.parametrize("algo", ["phash", "dhash", "ahash"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_single_hash_bit_equal(algo, h, w):
    rng = np.random.default_rng(h + w)
    g = rng.integers(0, 256, (4, h, w), np.uint8)
    ref = np.asarray(J.single_hash_kernel_gray(g, h, w, algo))
    got = T.single_hash_kernel_gray(g, h, w, algo, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    rgb = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    np.testing.assert_array_equal(
        T.single_hash_kernel(rgb, h, w, algo, device="cpu").numpy(),
        np.asarray(J.single_hash_kernel(rgb, h, w, algo)))


def test_oracle_matches_device_stages():
    g = np.random.default_rng(3).integers(0, 256, (100, 37), np.uint8)
    g32 = T.np_resize(g.astype(np.int64), 32, 32)
    bits = T.phash_bits(torch.from_numpy(g32)[None]).numpy()[0]
    assert sum(int(b) << i for i, b in enumerate(bits)) == T.np_phash(g32)


def test_tables_equal_reference():
    for n in (8, 32):
        np.testing.assert_array_equal(T.dct_matrix_q(n), J.dct_matrix_q(n))
    for n_in, n_out in ((37, 32), (640, 9), (256, 64), (8, 8), (100, 8)):
        np.testing.assert_array_equal(T.resize_matrix_q(n_in, n_out),
                                      J.resize_matrix_q(n_in, n_out))
    assert T.MULTIHASH_DEFAULT_WEIGHTS == J.MULTIHASH_DEFAULT_WEIGHTS
    for w in (None, {"phash_weight": 0.25, "block_distance_threshold": 3}):
        np.testing.assert_array_equal(T.multihash_params(w), J.multihash_params(w))
    assert (T.MULTIHASH_WORDS, T.MULTIHASH_BYTES) == (J.MULTIHASH_WORDS,
                                                       J.MULTIHASH_BYTES)


def _bundle_db(c, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (c, 64, 64), np.uint8)
    half = c // 2
    # near-duplicates so scores spread over the whole range
    imgs[half:] = np.clip(imgs[:c - half].astype(int)
                          + rng.integers(-24, 24, (c - half, 64, 64)), 0, 255)
    out = TI.device_get(T.multihash_kernel_gray(imgs, 64, 64, device="cpu"))
    return np.stack([np.frombuffer(T.serialize_multihash(out, i), "<u4")
                     for i in range(c)])


@pytest.mark.parametrize("weights", [
    None, {"phash_weight": 0.37, "global_weight": 0.77,
           "block_distance_threshold": 5}])
def test_multihash_weighted_topk_equal(weights):
    c, q = 700, 6
    db = _bundle_db(c, seed=11)
    rng = np.random.default_rng(2)
    qm = db[rng.choice(c, q)].copy()
    qm[1, 0] ^= 0xF0F
    valid = rng.random(c) < 0.95
    params = T.multihash_params(weights)
    for k in (10, c):
        s_ref, i_ref = J.multihash_weighted_topk(
            jnp.asarray(qm), jnp.asarray(db), jnp.asarray(valid),
            jnp.asarray(params), k)
        s, i = T.multihash_weighted_topk(
            torch.from_numpy(qm.view(np.int32)), torch.from_numpy(db.view(np.int32)),
            torch.from_numpy(valid), torch.from_numpy(params), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=20000).astype(np.float32) for _ in range(3))
    got = T._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    from fractions import Fraction

    for i in range(0, 20000, 97):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        f = got[i]
        lo, hi = np.nextafter(f, np.float32(-np.inf)), np.nextafter(f, np.float32(np.inf))
        err = abs(Fraction(float(f)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)


def test_serialize_layout_matches_reference():
    g = np.random.default_rng(1).integers(0, 256, (2, 64, 64), np.uint8)
    ref = jax.device_get(J.multihash_kernel_gray(g, 64, 64))
    got = TI.device_get(T.multihash_kernel_gray(g, 64, 64, device="cpu"))
    for i in range(2):
        assert T.serialize_multihash(got, i) == J.serialize_multihash(ref, i)
