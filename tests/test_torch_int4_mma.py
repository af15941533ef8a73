"""The operand identity of the batched int4 kernel (int8 tensor cores), on
the CPU.

csrc/int4_scan.cu multiplies s8 operands: each catalog row becomes the K = D
vector [16*hi | 16*(lo_b - 8)] of exact signed bytes, each query [qh | ql],
K padded to whole k-steps of 32 and the queries to whole groups of 8, and
the s32 sum is 16*(dot - 8*sum(ql)). `int4_scan.mma_operands` builds those
operands in the kernel's K order and `mma_scores_plain` multiplies them in
int64 and applies the kernel's epilogue (>> 4, + bias, one float32 product,
-inf mask, bf16 round). Integer work and one correctly rounded product:
held bit-equal, no tolerance, to the plain wrappers and to
ucfp_tpu.ops.pallas_int4 in interpret mode, for the uncorrected dots and
both score types, at D = 768 and 770 (a partial last k-step) and Q = 5 and
70 (a partial group of 8; a second pass of 64), and at the widest D the
kernels take, 2 * int4_scan.MAX_DP, where the kernel reads the query
fragments from global memory instead of shared memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import pallas_int4
from ucfp_tpu_torch.ops import int4_scan

C = 1024


def _bits(x):
    x = np.asarray(x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                   else x)
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _sub(w):
    """The reference's weight block: rows padded to a multiple of 8."""
    out = np.zeros((-(-len(w) // 8) * 8, w.shape[1]), np.int8)
    out[: len(w)] = w
    return jnp.asarray(out)


def _case(d: int, q: int):
    rng = np.random.default_rng(d * 100 + q)
    dp = d // 2
    packed_t = rng.integers(-128, 128, (dp, C)).astype(np.int8)  # every byte value
    packed_t[:, 3] = 0  # a zero catalog byte: lo16 = -128
    packed_t[:, 4] = 0x77
    packed_t[:, 6] = -0x79
    inv_n4 = rng.random(C).astype(np.float32)
    inv_n4[[3, 9]] = 0.0
    qs = rng.integers(-127, 128, (q, d)).astype(np.int8)
    qs[0] = 127  # the largest products
    qs[1] = -127
    return packed_t, inv_n4, qs[:, :dp].copy(), qs[:, dp:].copy()


@pytest.mark.parametrize("d", [768, 770, 2 * int4_scan.MAX_DP])
def test_operand_shapes_and_padding(d):
    packed_t, _, wh, wl = _case(d, 5)
    a, b = int4_scan.mma_operands(torch.from_numpy(packed_t), torch.from_numpy(wh),
                                  torch.from_numpy(wl))
    k = 32 * -(-(d // 2) // 16)
    assert a.shape == (C, k) and b.shape == (8, k)
    assert a.dtype == b.dtype == torch.int8
    # every catalog byte unpacks to multiples of 16 in [-128, 112]
    assert bool((a.int() % 16 == 0).all()) and int(a.min()) >= -128 and int(a.max()) <= 112
    # padded queries and K slots past D/2 are zero on the query side
    assert bool((b[5:] == 0).all())
    kk = torch.arange(k) % 32
    pair = (torch.arange(k) // 32) * 16 + kk % 16
    assert bool((b[:, pair >= d // 2] == 0).all())
    # a zero catalog byte: 0 in the hi slots, -128 in the lo slots
    assert bool((a[3, kk < 16] == 0).all()) and bool((a[3, kk >= 16] == -128).all())


@pytest.mark.parametrize("d", [768, 770])
@pytest.mark.parametrize("q", [5, 70])
@pytest.mark.parametrize("kind", ["dots", "float32", "bfloat16"])
def test_mma_identity_matches_plain_and_pallas(d, q, kind):
    dp = d // 2
    packed_t, inv_n4, wh, wl = _case(d, q)
    pt, th, tl = torch.from_numpy(packed_t), torch.from_numpy(wh), torch.from_numpy(wl)
    ti = torch.from_numpy(inv_n4)
    sum_l = 8 * tl.to(torch.int32).sum(dim=1, dtype=torch.int32)
    ref_args = (jnp.asarray(packed_t), _sub(wh), _sub(wl))
    if kind == "dots":
        got = int4_scan.mma_scores_plain(pt, th, tl, sum_l, None, 0, torch.int32)
        assert got.dtype == torch.int32 and got.shape == (q, C)
        np.testing.assert_array_equal(got.numpy(), int4_scan.int4_dots_plain(pt, th, tl).numpy())
        # the reference's dots kernel takes one block of 8 queries a call
        for q0 in range(0, q, 8):
            nb = min(8, q - q0)
            ref = np.asarray(pallas_int4.int4_dots(
                jnp.asarray(packed_t), _sub(wh[q0:q0 + nb]), _sub(wl[q0:q0 + nb]),
                pallas_int4.pick_rpt(C), nb))
            np.testing.assert_array_equal(got.numpy()[q0:q0 + nb], ref.reshape(nb, C))
        return
    dtype = getattr(torch, kind)
    corrs = sum_l.clone()
    corrs[0] += 5  # any corr is subtracted as given
    n = C - 77
    got = int4_scan.mma_scores_plain(pt, th, tl, sum_l - corrs, ti, n, dtype)
    assert got.dtype == dtype and got.shape == (q, C)
    plain = int4_scan.int4_masked_scores_batched_plain(pt, th, tl, corrs, ti, n,
                                                       out_dtype=dtype)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    corr_pad = np.zeros(-(-q // 8) * 8, np.int32)
    corr_pad[:q] = corrs.numpy()
    ref = np.asarray(pallas_int4.int4_masked_scores_batched(
        *ref_args, jnp.asarray(corr_pad), jnp.asarray(inv_n4), pallas_int4.pick_rpt(C),
        jnp.int32(n), out_dtype=getattr(jnp, kind)))[:q]
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert np.isneginf(got.float().numpy()[:, n:]).all()
    assert np.isneginf(got.float().numpy()[:, [3, 9]]).all()


@pytest.mark.parametrize("kind", ["dots", "float32", "bfloat16"])
def test_mma_identity_at_the_widest_width(kind):
    """D/2 = MAX_DP, past the 10,240 pairs whose query fragments fit the
    kernel's shared memory: the same identity, Q = 9 (a partial group)."""
    test_mma_identity_matches_plain_and_pallas(2 * int4_scan.MAX_DP, 9, kind)
