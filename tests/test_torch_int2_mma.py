"""The operand identity of the batched int2 kernel (int8 tensor cores), on
the CPU.

csrc/int2_scan.cu multiplies s8 operands (through csrc/mma_scan.cuh): each
2-bit field of a catalog byte becomes an exact signed byte scaled by 64
(64a = byte & 0xC0; 64b, 64c, 64d = ((byte << s) & 0xC0) ^ 0x80 for s = 2,
4, 6, the +2 bias folded into the XOR), so a catalog row is the K = D
vector [64a | 64b | 64c | 64d] against the query's [qa | qb | qc | qd], K
padded to whole chunks of 16 quarters and the queries to whole groups of
8, and the s32 sum is 64*(dot - 2*(sum qb + sum qc + sum qd)).
`int2_scan.mma_operands` builds those operands in the kernel's K order and
`mma_scores_plain` multiplies them in int64 and applies the kernel's
epilogue (>> 6, + bias, float32(dot) - corr, one float32 product, -inf
mask, bf16 round). Integer work, an exact subtraction and one correctly
rounded product: held bit-equal, no tolerance, to the plain wrapper and to
ucfp_tpu.ops.pallas_int2 in interpret mode, for both score types, at D =
768 and 772 (a partial last chunk) and Q = 2, 5 and 70 (a partial group of
8; a second pass of 64), and at the widest D the kernels take, 4 *
int2_scan.MAX_DQ, where the kernel reads the query fragments from global
memory instead of shared memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import pallas_int2
from ucfp_tpu_torch.ops import int2_scan

C = 1024


def _bits(x):
    x = np.asarray(x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                   else x)
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _case(d: int, q: int):
    rng = np.random.default_rng(d * 100 + q)
    dq = d // 4
    packed_t = rng.integers(-128, 128, (dq, C)).astype(np.int8)  # every byte value
    packed_t[:, 3] = 0  # a zero catalog byte: 64b = 64c = 64d = -128
    packed_t[:, 4] = -128  # every field at its least: a = -2, b + 2 = c + 2 = d + 2 = 0
    packed_t[:, 6] = 127  # every field at its most
    inv_n2 = rng.random(C).astype(np.float32)
    inv_n2[[3, 9]] = 0.0
    qs = rng.integers(-127, 128, (q, d)).astype(np.int8)
    qs[0] = 127  # the largest products
    qs[1] = -127
    qi = qs.astype(np.int32)
    corrs = ((2 * qi[:, dq:].sum(1)).astype(np.float32)
             - np.float32(0.5) * qi.sum(1).astype(np.float32))
    corrs[0] += 3.5  # any corr is subtracted as given
    quarters = [np.ascontiguousarray(qs[:, i * dq:(i + 1) * dq]) for i in range(4)]
    return packed_t, inv_n2, quarters, corrs


def _sub(w):
    """The reference's weight block: rows padded to a multiple of 8."""
    out = np.zeros((-(-len(w) // 8) * 8, w.shape[1]), np.int8)
    out[: len(w)] = w
    return jnp.asarray(out)


@pytest.mark.parametrize("d", [768, 772, 4 * int2_scan.MAX_DQ])
def test_operand_shapes_and_padding(d):
    packed_t, _, quarters, _ = _case(d, 5)
    a, b = int2_scan.mma_operands(torch.from_numpy(packed_t),
                                  [torch.from_numpy(w) for w in quarters])
    dq = d // 4
    k = 64 * -(-dq // int2_scan.MMA_KSTEP_QUARTERS)
    assert a.shape == (C, k) and b.shape == (8, k)
    assert a.dtype == b.dtype == torch.int8
    # every catalog byte unpacks to multiples of 64 in [-128, 64]
    assert bool((a.int() % 64 == 0).all()) and int(a.min()) >= -128 and int(a.max()) <= 64
    # padded queries and K slots past D/4 are zero on the query side
    assert bool((b[5:] == 0).all())
    kk = torch.arange(k) % 64
    quarter = (torch.arange(k) // 64) * 16 + kk % 16
    assert bool((b[:, quarter >= dq] == 0).all())
    # a zero catalog byte: 0 in the a slots, -128 in the three biased fields
    assert bool((a[3, kk < 16] == 0).all()) and bool((a[3, kk >= 16] == -128).all())
    # the field order: a (bits 6-7), then bits 4-5, 2-3, 0-1, against qa..qd
    col = int2_scan.mma_operands(torch.from_numpy(packed_t[:16, 7:8].copy()),
                                 [torch.from_numpy(w[:, :16]) for w in quarters])[0][0]
    byte = torch.from_numpy(packed_t[:16, 7].astype(np.int16)) & 0xFF
    for f, shift in enumerate((6, 4, 2, 0)):
        field = (byte >> shift) & 3
        want = (field - 4 * (field >> 1)) if f == 0 else field - 2  # a signed; b, c, d unbiased
        assert torch.equal(col[16 * f:16 * f + 16].long(), 64 * want.long())
    # the query side holds qa, qb, qc, qd in the same slots
    for f in range(4):
        assert torch.equal(b[:5, 16 * f:16 * f + 16], torch.from_numpy(quarters[f][:, :16]))


def test_sum_stays_inside_int32_at_the_widest_width():
    """The kernel's s32 sum at D/4 = MAX_DQ with every product at its
    largest magnitude: -128 fields against -127 queries."""
    dq = int2_scan.MAX_DQ
    packed_t = torch.full((dq, 8), -128, dtype=torch.int8)  # a = -2, the rest 0 + 2 - 2
    quarters = [torch.full((2, dq), -127, dtype=torch.int8) for _ in range(4)]
    a, b = int2_scan.mma_operands(packed_t, quarters)
    s = a.to(torch.int64) @ b.to(torch.int64).T
    assert int(s.abs().max()) == 4 * dq * 128 * 127 < 2 ** 30
    bias = int2_scan._unbias(torch.stack(quarters)).to(torch.int64)
    dots = (s[:, :2].T >> 6) + bias[:, None]
    assert torch.equal(dots.to(torch.int32), int2_scan._int2_dots_plain(packed_t, quarters))


@pytest.mark.parametrize("d", [768, 772])
@pytest.mark.parametrize("q", [2, 5, 70])
@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_mma_identity_matches_plain_and_pallas(d, q, kind):
    packed_t, inv_n2, quarters, corrs = _case(d, q)
    pt, ti, tc = torch.from_numpy(packed_t), torch.from_numpy(inv_n2), torch.from_numpy(corrs)
    tq = [torch.from_numpy(w) for w in quarters]
    dtype = getattr(torch, kind)
    n = C - 77
    got = int2_scan.mma_scores_plain(pt, tq, tc, ti, n, dtype)
    assert got.dtype == dtype and got.shape == (q, C)
    plain = int2_scan.int2_masked_scores_batched_plain(pt, *tq, tc, ti, n, out_dtype=dtype)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    corr_pad = np.zeros(-(-q // 8) * 8, np.float32)
    corr_pad[:q] = corrs
    ref = np.asarray(pallas_int2.int2_masked_scores_batched(
        jnp.asarray(packed_t), *[_sub(w) for w in quarters], jnp.asarray(corr_pad),
        jnp.asarray(inv_n2), pallas_int2.pick_rpt(C), jnp.int32(n),
        out_dtype=getattr(jnp, kind)))[:q]
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert np.isneginf(got.float().numpy()[:, n:]).all()
    assert np.isneginf(got.float().numpy()[:, [3, 9]]).all()


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_mma_identity_at_the_widest_width(kind):
    """D/4 = MAX_DQ, past the 5,120 quarters whose query fragments fit the
    kernel's shared memory: the same identity, Q = 9 (a partial group)."""
    test_mma_identity_matches_plain_and_pallas(4 * int2_scan.MAX_DQ, 9, kind)
