"""ucfp_tpu_torch.ops.knn against ucfp_tpu.ops.knn on the CPU.

Hamming distances are integers: equal, ids equal. Cosine ids are equal;
cosine scores agree within 1e-5 absolute, because PyTorch and XLA sum
the float32 dot products in different orders (a few ulps at D <= 64).
The data keep the true top-k scores more than 1e-4 apart, so that
tolerance cannot reorder them. With small-integer vectors every sum is
exact in either order, and the scores are bit-equal too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import knn as J
from ucfp_tpu_torch.ops import fused_scan
from ucfp_tpu_torch.ops import knn as T

SCORE_TOL = 1e-5  # f32 dot summation order (see module doc)


def _separated(scores, k):
    top = np.sort(scores[np.isfinite(scores)])[::-1][: k + 1]
    return np.all(np.diff(top) < -1e-4)


def _vec_case(c, d, q, seed, integer=False):
    rng = np.random.default_rng(seed)
    while True:
        if integer:
            m = rng.integers(-3, 4, (c, d)).astype(np.float32)
            qs = rng.integers(-3, 4, (q, d)).astype(np.float32)
        else:
            m = rng.normal(size=(c, d)).astype(np.float32)
            qs = rng.normal(size=(q, d)).astype(np.float32)
        m[3] = 0.0  # zero-norm row
        valid = np.arange(c) < c - 50  # padding rows
        valid[10:20] = False
        if integer:
            return qs, m, valid
        ref = np.asarray(J.cosine_topk(jnp.asarray(qs), jnp.asarray(m),
                                       jnp.asarray(valid), c)[0])
        if all(_separated(r, 10) for r in ref):
            return qs, m, valid
        seed += 1000


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("d", [16, 64])
def test_cosine_topk(q, d):
    qs, m, valid = _vec_case(2048, d, q, seed=d + q)
    s_ref, i_ref = J.cosine_topk(jnp.asarray(qs), jnp.asarray(m), jnp.asarray(valid), 10)
    s, i = T.cosine_topk(torch.from_numpy(qs), torch.from_numpy(m),
                         torch.from_numpy(valid), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=SCORE_TOL, rtol=0)


def test_cosine_topk_invalid_rows_are_neg_inf():
    qs, m, valid = _vec_case(64, 8, 2, seed=1, integer=True)
    k = 64
    s_ref, i_ref = J.cosine_topk(jnp.asarray(qs), jnp.asarray(m), jnp.asarray(valid), k)
    s, i = T.cosine_topk(torch.from_numpy(qs), torch.from_numpy(m),
                         torch.from_numpy(valid), k)
    # integer data: exact sums in any order -> bit-equal scores, and
    # the -inf tail (invalid + zero-norm rows) in the same order
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    n_bad = int((~valid).sum()) + 1
    assert np.isneginf(s.numpy()[:, -n_bad:]).all()


def test_cosine_zero_query_scores_neg_inf():
    _, m, valid = _vec_case(64, 8, 1, seed=2, integer=True)
    s, _ = T.cosine_topk(torch.zeros(1, 8), torch.from_numpy(m),
                         torch.from_numpy(valid), 5)
    assert np.isneginf(s.numpy()).all()


@pytest.mark.parametrize("w", [2, 4, 134])
def test_hamming_topk(w):
    rng = np.random.default_rng(w)
    c = 3000
    m = rng.integers(0, 2**32, (c, w), dtype=np.uint32)
    m[500:700] = m[4]  # ties
    valid = rng.random(c) < 0.9
    qs = m[[4, 9, 2999]].copy()
    for k in (10, c):
        d_ref, i_ref = J.hamming_topk(jnp.asarray(qs), jnp.asarray(m), jnp.asarray(valid), k)
        d, i = T.hamming_topk(torch.from_numpy(qs.view(np.int32)),
                              torch.from_numpy(m.view(np.int32)),
                              torch.from_numpy(valid), k)
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("q", [1, 5])
def test_cosine_topk_fused(q):
    c = fused_scan.ROWS_PER_TILE * fused_scan.LANES
    qs, m, valid = _vec_case(c, 16, q, seed=40 + q)
    s_ref, i_ref = J.cosine_topk_fused(jnp.asarray(qs), jnp.asarray(m),
                                       jnp.asarray(valid), 8)
    s, i = T.cosine_topk_fused(torch.from_numpy(qs), torch.from_numpy(m),
                               torch.from_numpy(valid), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=SCORE_TOL, rtol=0)


def test_pack_bits_to_u32():
    for fp in (b"", b"\x01", b"\x01\x02\x03\x04\x05", bytes(range(16))):
        np.testing.assert_array_equal(T.pack_bits_to_u32(fp), J.pack_bits_to_u32(fp))


# -- the int8 tier. Every quantity is an integer below 2^24 for D <= 1040
#    (dots up to 127^2 * D, squared norms too), so float32 holds it exactly
#    in any summation order; one sqrt, one division and one product remain,
#    each correctly rounded in XLA and in PyTorch: the scores are bit-equal.
#    Above D = 1040 the squared norms can pass 2^24 and round differently
#    in the two summation orders, so that case allows one ulp.


def _int8_rows(seed, c=300, d=24):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(c, d)).astype(np.float32)
    m[3] = 0.0  # all-zero row
    m[4] = -np.abs(m[4])
    m[4, 2] = -9.0  # absmax is negative
    m[5] = 1e-30  # tiny but nonzero
    m[6, :4] = [127.0, 2.5, -3.5, 0.5]  # .5 cases at scale 1
    m[6, 4:] = 0.0
    return m


def test_quantize_rows_int8_bit_equal():
    m = _int8_rows(1)
    q8_ref, rn_ref = J.quantize_rows_int8(m)
    q8, rn = T.quantize_rows_int8(m)
    assert q8.dtype == np.int8 and rn.dtype == np.float32
    np.testing.assert_array_equal(q8, np.asarray(q8_ref))
    np.testing.assert_array_equal(rn.view(np.int32), np.asarray(rn_ref).view(np.int32))
    assert rn[3] == 0.0 and q8[4, 2] == -127
    assert q8[6, :4].tolist() == [127, 2, -4, 0]  # half to even


def test_quantize_query_rows_bit_equal():
    qm = _int8_rows(2, c=8, d=24)
    qm[0] = 0.0  # zero query
    qm[1, :5] = [127.0, 0.5, 1.5, -2.5, 126.5]
    qm[1, 5:] = 0.0
    ref = np.asarray(J._quantize_query_rows(jnp.asarray(qm)))
    got = T._quantize_query_rows(torch.from_numpy(qm))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy()[1, :5].tolist() == [127, 0, 2, -2, 126]
    assert not got.numpy()[0].any()


@pytest.mark.parametrize("d8", [24, 32])
def test_int8_dots_equals_dot_general(d8):
    import jax

    rng = np.random.default_rng(d8)
    qq = rng.integers(-127, 128, (5, 24)).astype(np.int8)
    m = np.zeros((700, d8), np.int8)
    m[:, :24] = rng.integers(-127, 128, (700, 24))
    m[:2, :24] = 127  # the largest products
    qq[0] = -127
    ref = jax.lax.dot_general(jnp.asarray(qq), jnp.asarray(m[:, :24]),
                              (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    # extra zero columns on the catalog change no dot
    got = T.int8_dots(torch.from_numpy(qq), torch.from_numpy(m))
    assert got.dtype == torch.int32 and got.shape == (5, 700)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="int8"):
        T.int8_dots(torch.from_numpy(qq).int(), torch.from_numpy(m))


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_cosine_topk_int8_bit_equal(q, k):
    m = _int8_rows(10 + q)
    q8, rn = T.quantize_rows_int8(m)
    valid = np.arange(300) < 280
    valid[40:50] = False
    rng = np.random.default_rng(q)
    qs = rng.normal(size=(q, 24)).astype(np.float32)
    qs[0, :3] = [2.5, -0.5, 9.0]
    s_ref, i_ref = J.cosine_topk_int8(jnp.asarray(qs), jnp.asarray(q8),
                                      jnp.asarray(rn), jnp.asarray(valid), k)
    # the port's device catalog carries zero columns up to a multiple of 8
    q8p = np.zeros((300, T.padded_dim(24) + 8), np.int8)
    q8p[:, :24] = q8
    s, i = T.cosine_topk_int8(torch.from_numpy(qs), torch.from_numpy(q8p),
                              torch.from_numpy(rn), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(s_ref).view(np.int32))
    if k == 300:  # invalid and zero-norm rows: the -inf tail, row order
        assert np.isneginf(s.numpy()[:, -(20 + 10 + 1):]).all()


def test_cosine_topk_int8_zero_query_scores_neg_inf():
    q8, rn = T.quantize_rows_int8(_int8_rows(3))
    s, _ = T.cosine_topk_int8(torch.zeros(1, 24), torch.from_numpy(q8),
                              torch.from_numpy(rn), torch.ones(300, dtype=torch.bool), 5)
    assert np.isneginf(s.numpy()).all()


def test_cosine_topk_int8_wide_rows_within_one_ulp():
    """D = 2048 with rows near +-127: squared norms pass 2^24, so the two
    summation orders may round differently, by one ulp at most."""
    rng = np.random.default_rng(7)
    d = 2048
    m = (rng.choice([-1.0, 1.0], (400, d)) * rng.uniform(120, 127, (400, d))).astype(np.float32)
    q8, rn = T.quantize_rows_int8(m)
    _, rn_ref = J.quantize_rows_int8(m)
    qs = (m[[5, 77]] + rng.normal(0, 3, (2, d))).astype(np.float32)
    valid = np.ones(400, bool)
    s_ref, i_ref = J.cosine_topk_int8(jnp.asarray(qs), jnp.asarray(q8),
                                      jnp.asarray(rn), jnp.asarray(valid), 10)
    s, i = T.cosine_topk_int8(torch.from_numpy(qs), torch.from_numpy(q8),
                              torch.from_numpy(rn), torch.from_numpy(valid), 10)
    assert i.numpy()[:, 0].tolist() == [5, 77]
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    ulps = np.abs(s.numpy().view(np.int32) - np.asarray(s_ref).view(np.int32))
    assert ulps.max() <= 1
    ulps = np.abs(rn.view(np.int32) - np.asarray(rn_ref).view(np.int32))
    assert ulps.max() <= 1
