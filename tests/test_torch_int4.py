"""The port's packed-int4 tier (ucfp_tpu_torch.ops.knn, .int4_scan) against
ucfp_tpu's (ops/knn.py, ops/pallas_int4.py in interpret mode) on the CPU.

Everything here is integer arithmetic or a correctly rounded float32
operation on exact values: the packing, the uncorrected dots, one product
per masked score (and its round-to-nearest-even bf16), and the rescore,
whose float32 sums add integers below 2^24. So packed bytes, dots and
scores are EQUAL, bit for bit, and top-k ids come in the same order —
no tolerance. The CUDA kernels are held bit-equal to the same plain
versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import knn as J
from ucfp_tpu.ops import pallas_int4
from ucfp_tpu_torch.ops import int4_scan
from ucfp_tpu_torch.ops import knn as T


def _rows(rng, n, d):
    return rng.normal(size=(n, d)).astype(np.float32)


def _q8(rows):
    q8, rn = J.quantize_rows_int8(rows)
    return np.array(q8), np.array(rn)


def _bits(x):
    x = np.asarray(x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                   else x)
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _packed_case(c, d, seed, edge=True):
    """Packed columns from random rows, with a zero row, all +-7 codes
    (rows of +-absmax) and, with edge=True, raw bytes of every value."""
    rng = np.random.default_rng(seed)
    rows = _rows(rng, c, d)
    rows[3] = 0.0
    rows[5] = np.where(rng.random(d) < 0.5, -2.0, 2.0)  # every code +-7
    q8, rn = _q8(rows)
    packed_t, inv_n4 = J.pack_int4_cols(jnp.asarray(q8))
    packed_t = np.array(packed_t)
    if edge:
        packed_t[:, 7] = np.resize(np.arange(-128, 128), d // 2)  # bytes beyond the codes
    return q8, rn, packed_t, np.array(inv_n4)


# -- packing ------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 64, 770])
def test_pack_int4_cols_bit_equal(d):
    rng = np.random.default_rng(d)
    rows = _rows(rng, 700, d)
    rows[3] = 0.0  # zero row: inv_n4 == 0
    rows[4] = -np.abs(rows[4])
    rows[6, :4] = [127.0, 18.0, -9.0, 27.0]  # .5 cases of the int4 rounding
    rows[6, 4:] = 0.0
    q8, _ = _q8(rows)
    p_ref, i_ref = J.pack_int4_cols(jnp.asarray(q8))
    p, inv = T.pack_int4_cols(torch.from_numpy(q8))
    assert p.dtype == torch.int8 and p.shape == (d // 2, 700) and p.is_contiguous()
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(_bits(inv), _bits(i_ref))
    assert inv[3] == 0.0
    # chunked (with a tail) == one-shot, on the port and against the reference
    pc, ic = T.pack_int4_cols_chunked(torch.from_numpy(q8), chunk=256)
    assert torch.equal(pc, p) and torch.equal(ic.view(torch.int32), inv.view(torch.int32))
    pr, ir = J.pack_int4_cols_chunked(jnp.asarray(q8), chunk=256)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(pr))


def test_pack_from_padded_device_matrix():
    """The backend packs q8m[:, :D] out of its D8-wide device matrix."""
    q8, _ = _q8(_rows(np.random.default_rng(1), 300, 20))
    wide = torch.zeros((300, T.padded_dim(20) + 8), dtype=torch.int8)
    wide[:, :20] = torch.from_numpy(q8)
    p, inv = T.pack_int4_cols_chunked(wide[:, :20], chunk=128)
    p_ref, i_ref = J.pack_int4_cols(jnp.asarray(q8))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(_bits(inv), _bits(i_ref))


# -- the three kernels' plain versions against their Pallas kernels ---------------


def _sub_weights(q, dp):
    """The reference's [SUB, D/2] weight block with q's rows on top."""
    w = np.zeros((max(pallas_int4.SUB, -(-len(q) // 8) * 8), dp), np.int8)
    w[: len(q)] = q
    return jnp.asarray(w)


@pytest.mark.parametrize("d", [64, 770])
@pytest.mark.parametrize("nq", [1, 5])
def test_int4_dots_plain_matches_pallas(d, nq):
    c, dp = 1024, d // 2
    _, _, packed_t, _ = _packed_case(c, d, seed=d + nq)
    rng = np.random.default_rng(nq)
    qs = rng.integers(-127, 128, (nq, d)).astype(np.int8)
    qs[0, :dp] = 127  # the largest products
    qs[-1, dp:] = -127
    ref = np.asarray(pallas_int4.int4_dots(
        jnp.asarray(packed_t), _sub_weights(qs[:, :dp], dp),
        _sub_weights(qs[:, dp:], dp), pallas_int4.pick_rpt(c), nq))
    pt = torch.from_numpy(packed_t)
    if nq == 1:
        got = int4_scan.int4_dots(pt, torch.from_numpy(qs[0, :dp]),
                                  torch.from_numpy(qs[0, dp:]))
        assert got.shape == (c,)
    else:
        got = int4_scan.int4_dots(pt, torch.from_numpy(qs[:, :dp]),
                                  torch.from_numpy(qs[:, dp:]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("d", [64, 770])
def test_int4_masked_scores_plain_matches_pallas(d):
    c, dp = 2048, d // 2
    _, _, packed_t, inv_n4 = _packed_case(c, d, seed=d)
    inv_n4[9] = 0.0
    qq = np.array(J._quantize_query(jnp.asarray(_rows(np.random.default_rng(2), 1, d)[0])))
    corr = 8 * int(qq[dp:].astype(np.int32).sum())
    for n in (c, c - 1, 1000, 1):
        ref = np.asarray(pallas_int4.int4_masked_scores(
            jnp.asarray(packed_t), _sub_weights(qq[None, :dp], dp),
            _sub_weights(qq[None, dp:], dp), jnp.asarray(inv_n4),
            pallas_int4.pick_rpt(c), jnp.int32(corr), jnp.int32(n)))
        args = (torch.from_numpy(packed_t), torch.from_numpy(qq[:dp]),
                torch.from_numpy(qq[dp:]), torch.from_numpy(inv_n4), corr, n)
        got = int4_scan.int4_masked_scores(*args)
        assert got.dtype == torch.float32 and got.shape == (c,)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert np.isneginf(got.numpy()[n:]).all() and np.isneginf(got.numpy()[[3, 9]]).all()
        assert torch.equal(int4_scan.int4_masked_scores_plain(*args).view(torch.int32),
                           got.view(torch.int32))


@pytest.mark.parametrize("q", [5, 64, 70])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_masked_scores_batched_plain_matches_pallas(q, dtype):
    c, d = 1024, 64
    dp = d // 2
    _, _, packed_t, inv_n4 = _packed_case(c, d, seed=q)
    rng = np.random.default_rng(q)
    qs = rng.integers(-127, 128, (q, d)).astype(np.int8)
    qs[1] = 127  # queries of all +-127
    qs[2] = -127
    corrs = 8 * qs[:, dp:].astype(np.int32).sum(1)
    corrs[0] += 5  # any corr is subtracted as given
    wh, wl = _sub_weights(qs[:, :dp], dp), _sub_weights(qs[:, dp:], dp)
    corr_pad = np.zeros(wh.shape[0], np.int32)
    corr_pad[:q] = corrs
    n = c - 77
    ref = np.asarray(pallas_int4.int4_masked_scores_batched(
        jnp.asarray(packed_t), wh, wl, jnp.asarray(corr_pad), jnp.asarray(inv_n4),
        pallas_int4.pick_rpt(c), jnp.int32(n), out_dtype=getattr(jnp, dtype)))[:q]
    args = (torch.from_numpy(packed_t), torch.from_numpy(qs[:, :dp]),
            torch.from_numpy(qs[:, dp:]), torch.from_numpy(corrs),
            torch.from_numpy(inv_n4), n)
    got = int4_scan.int4_masked_scores_batched(*args, out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (q, c)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    plain = int4_scan.int4_masked_scores_batched_plain(*args, out_dtype=getattr(torch, dtype))
    assert torch.equal(plain.float().view(torch.int32), got.float().view(torch.int32))


def test_bf16_is_f32_rounded():
    c, d = 1024, 32
    _, _, packed_t, inv_n4 = _packed_case(c, d, seed=3)
    qs = np.random.default_rng(3).integers(-127, 128, (4, d)).astype(np.int8)
    args = (torch.from_numpy(packed_t), torch.from_numpy(qs[:, :16]),
            torch.from_numpy(qs[:, 16:]), torch.zeros(4, dtype=torch.int32),
            torch.from_numpy(inv_n4), c)
    f = int4_scan.int4_masked_scores_batched(*args)
    b = int4_scan.int4_masked_scores_batched(*args, out_dtype=torch.bfloat16)
    assert torch.equal(b.view(torch.int16), f.to(torch.bfloat16).view(torch.int16))


def test_kernel_error_cases():
    p = torch.zeros((8, 256), dtype=torch.int8)
    h = torch.zeros(8, dtype=torch.int8)
    with pytest.raises(ValueError, match="C % 128"):
        int4_scan.int4_dots(torch.zeros((8, 192), dtype=torch.int8), h, h)
    with pytest.raises(ValueError, match="int8"):
        int4_scan.int4_dots(p, h.int(), h)
    with pytest.raises(ValueError, match="inv_n4"):
        int4_scan.int4_masked_scores(p, h, h, torch.ones(255), 0, 10)
    with pytest.raises(ValueError, match="one corr per query"):
        int4_scan.int4_masked_scores_batched(
            p, h.expand(3, 8), h.expand(3, 8), torch.zeros(2), torch.ones(256), 10)
    with pytest.raises(ValueError, match="out_dtype"):
        int4_scan.int4_masked_scores_batched(
            p, h[None], h[None], torch.zeros(1), torch.ones(256), 10,
            out_dtype=torch.float16)
    # the reference refuses a non-tile capacity too
    with pytest.raises(ValueError):
        pallas_int4.int4_dots(jnp.zeros((8, 192), jnp.int8),
                              jnp.zeros((8, 8), jnp.int8), jnp.zeros((8, 8), jnp.int8), 128)


def test_cpu_wrappers_count_no_launch():
    before = dict(int4_scan.LAUNCHES)
    p = torch.zeros((8, 256), dtype=torch.int8)
    h = torch.ones(8, dtype=torch.int8)
    int4_scan.int4_dots(p, h, h)
    int4_scan.int4_masked_scores(p, h, h, torch.ones(256), 0, 10)
    int4_scan.int4_masked_scores_batched(p, h[None], h[None], torch.zeros(1),
                                         torch.ones(256), 10)
    assert int4_scan.LAUNCHES == before
    assert set(before) == {"int4_dots", "int4_masked_scores", "int4_masked_scores_batched"}


# -- the pipelines ------------------------------------------------------------------


def _pipeline_case(c, d, seed, q=1, plant=()):
    rng = np.random.default_rng(seed)
    rows = _rows(rng, c, d)
    rows[11] = 0.0  # zero row
    qs = _rows(rng, q, d)
    for i, r in enumerate(plant[:q]):
        qs[i] = rows[r] + 0.02 * rng.normal(size=d).astype(np.float32)
    q8, rn = _q8(rows)
    p_ref, i_ref = J.pack_int4_cols_chunked(jnp.asarray(q8), chunk=1 << 18)
    return rows, qs, q8, rn, np.array(p_ref), np.array(i_ref)


def _port_args(q8, rn, packed_t, inv_n4, pad=8):
    """The port's device layout: q8 with zero columns past D."""
    c, d = q8.shape
    wide = np.zeros((c, d + pad), np.int8)
    wide[:, :d] = q8
    return (torch.from_numpy(wide), torch.from_numpy(rn), torch.from_numpy(packed_t),
            torch.from_numpy(inv_n4))


@pytest.mark.parametrize("c,d,k,pool", [
    (8192, 32, 10, 512),     # _exact_topk_flat selects the pool
    (8192, 32, 10, 4096),    # pool * 2 >= C: exhaustive rescore
    (1 << 20, 16, 5, 2048),  # scores_topk_fused selects the pool
])
def test_cosine_int4_topk_equal(c, d, k, pool):
    rows, qs, q8, rn, packed_t, inv_n4 = _pipeline_case(c, d, seed=c + d, plant=(777,))
    n = c - 300
    valid = np.arange(c) < n
    fvalid = valid.copy()
    fvalid[::3] = False  # a filter: non-prefix validity
    fvalid[777] = True
    args = _port_args(q8, rn, packed_t, inv_n4)
    for vv, n_valid in ((valid, n), (fvalid, None)):
        s_ref, i_ref = J.cosine_int4_topk(
            jnp.asarray(qs[0]), jnp.asarray(q8), jnp.asarray(rn), jnp.asarray(packed_t),
            jnp.asarray(inv_n4), jnp.asarray(vv), k, pool,
            n_valid=None if n_valid is None else jnp.int32(n_valid))
        s, i = T.cosine_int4_topk(torch.from_numpy(qs[0]), *args, torch.from_numpy(vv),
                                  k, pool, n_valid=n_valid)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(_bits(s), _bits(s_ref))
        assert int(i[0]) == 777


@pytest.mark.parametrize("c,d,q,k,pool", [
    (4096, 32, 6, 10, 512),     # _exact_topk_rows selects the pools
    (4096, 32, 3, 10, 4096),    # pool * 2 >= C: the exhaustive int8 product
    (2048, 16, 70, 5, 256),     # across the 64-query chunk edge
    (524288, 16, 4, 5, 640),    # bf16 scores through kernel #1, approx=True
])
def test_cosine_int4_topk_batched_equal(c, d, q, k, pool):
    rows, qs, q8, rn, packed_t, inv_n4 = _pipeline_case(
        c, d, seed=c + q, q=q, plant=(123, 31000 % c, 100, 200))
    if q == 70:
        qs[63] = rows[100] + 0.02
        qs[64] = rows[200] + 0.02
    qs[-1] = 0.0  # a zero query
    n = c - 50
    s_ref, i_ref = J.cosine_int4_topk_batched(
        jnp.asarray(qs), jnp.asarray(q8), jnp.asarray(rn), jnp.asarray(packed_t),
        jnp.asarray(inv_n4), n, k, pool)
    s, i = T.cosine_int4_topk_batched(torch.from_numpy(qs), *_port_args(q8, rn, packed_t,
                                                                        inv_n4), n, k, pool)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(_bits(s), _bits(s_ref))
    assert int(i[0, 0]) == 123


# -- the dispatch cost model -----------------------------------------------------


_GRID = [(cap, dim, q, k) for cap in (1024, 4096, 8192, 1 << 17, 1 << 20, 1 << 21, 1 << 22,
                                      1 << 23, 1 << 24)
         for dim in (16, 17, 64, 768, 1536) for q in (1, 5, 8, 32, 64, 128)
         for k in (1, 10, 100)]


@pytest.mark.parametrize("env", [
    {},
    {"UCFP_SKETCH_COST_MODEL": "0"},
    {"UCFP_COST_HBM_GBPS": "3350", "UCFP_COST_INT4_GBPS": "2000",
     "UCFP_COST_INT4B_GBPS": "1500", "UCFP_COST_GATHER_NS": "2",
     "UCFP_COST_INT4_FLAT_MS": "0.5", "UCFP_COST_INT4B_FLAT_MS": "0.3"},
])
def test_cost_model_equal(monkeypatch, env):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    for cap, dim, q, k in _GRID:
        pool, bpool = T.int4_pool(cap, k), T.int4_batch_pool(cap, k)
        assert (pool, bpool) == (J.int4_pool(cap, k), J.int4_batch_pool(cap, k))
        assert T.int4_supported(cap, dim) == J.int4_supported(cap, dim)
        assert T.exact_scan_model_ms(cap, dim) == J.exact_scan_model_ms(cap, dim)
        assert T.int4_model_ms(cap, dim, pool) == J.int4_model_ms(cap, dim, pool)
        assert T.exact_batch_model_ms(cap, dim, q) == J.exact_batch_model_ms(cap, dim, q)
        assert (T.int4_batch_model_ms(cap, dim, q, bpool)
                == J.int4_batch_model_ms(cap, dim, q, bpool))
        for fused in (True, False):
            assert (T.int4_beats_exact(cap, dim, pool, fused)
                    == J.int4_beats_exact(cap, dim, pool, fused))
        assert (T.int4_batch_beats_exact(cap, dim, q, bpool)
                == J.int4_batch_beats_exact(cap, dim, q, bpool))
    assert T.INT4_MIN_POOL == J.INT4_MIN_POOL and T.INT4_BATCH_QB == J.INT4_BATCH_QB
    assert {k: T._cost_const(k) for k in T._COST_DEFAULTS} == {
        k: J._cost_const(k) for k in T._COST_DEFAULTS}
