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
