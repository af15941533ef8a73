"""The port's packed-int2 tier (ucfp_tpu_torch.ops.knn, .int2_scan) against
ucfp_tpu's (ops/knn.py, ops/pallas_int2.py in interpret mode) on the CPU.

The scans are integer arithmetic plus one correctly rounded float32
product per score (and its round-to-nearest-even bf16), and the rescore
adds integers below 2^24, so the three plain kernels, fed the reference's
own packed arrays, give EQUAL scores and rows, and the pipelines return
the same ids in the same order with bit-equal scores — no tolerance.

The pack is the one place with a stated tolerance: the reference scales
each row by a float32 std (jnp.std), whose last bit depends on XLA's
summation order, and the port takes the std from exact integer sums (so
the pack on the card equals the pack on the CPU). A field may then differ
only where its f / s - 0.5 lies within an ulp of a rounding boundary, and
only by one level; test_pack_int2_cols_counted counts and checks them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import knn as J
from ucfp_tpu.ops import pallas_int2
from ucfp_tpu_torch.ops import int2_scan
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


def _fields(packed_t):
    """[D/4, C] packed bytes -> [C, D] int2 codes v in [-2, 1]."""
    p = np.asarray(packed_t).astype(np.int8)
    a = (p & -64) >> 6
    parts = [a] + [((p >> s) & 3).astype(np.int8) - 2 for s in (4, 2, 0)]
    return np.concatenate(parts).T


def _packed_case(c, d, seed):
    """The reference's packed columns from random rows, with a zero row,
    constant rows (every field -2 / 1) and a column of every byte value."""
    rng = np.random.default_rng(seed)
    rows = _rows(rng, c, d)
    rows[3] = 0.0
    rows[5] = -1.0
    rows[6] = 1.0
    q8, rn = _q8(rows)
    packed_t, inv_n2 = (np.array(x) for x in J.pack_int2_cols(jnp.asarray(q8)))
    packed_t[:, 7] = np.resize(np.arange(-128, 128), d // 4)
    return q8, rn, packed_t, inv_n2


# -- packing ------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 64, 772])
def test_pack_int2_cols_counted(d):
    rng = np.random.default_rng(d)
    rows = _rows(rng, 4096, d)
    rows[3] = 0.0  # zero row: inv_n2 == 0
    rows[5] = -1.0  # constant rows: std 0, scale 1
    rows[6] = 1.0
    rows[8, ::3] = 0.0
    q8, _ = _q8(rows)
    p_ref, i_ref = (np.asarray(x) for x in J.pack_int2_cols(jnp.asarray(q8)))
    p, inv = T.pack_int2_cols(torch.from_numpy(q8))
    assert p.dtype == torch.int8 and p.shape == (d // 4, 4096) and p.is_contiguous()
    assert inv[3] == 0.0 and (p[:, 5] == -128).all() and (p[:, 6] == 127).all()
    v_ref, v = _fields(p_ref), _fields(p.numpy())
    diff = np.argwhere(v_ref != v)
    # every differing field is one level off, at a rounding boundary of
    # f / s - 0.5 (s the port's exact scale), and such fields are rare
    assert len(diff) <= v.size // 1000, len(diff)
    s = T._int2_scale(torch.from_numpy(q8)).numpy()[:, 0].astype(np.float64)
    for r, col in diff:
        assert abs(int(v_ref[r, col]) - int(v[r, col])) == 1
        x = q8[r, col] / s[r] - 0.5
        assert abs(x - (np.floor(x) + 0.5)) < 1e-5, (r, col, x)
    same_rows = ~np.isin(np.arange(4096), diff[:, 0])
    np.testing.assert_array_equal(_bits(inv)[same_rows], _bits(i_ref)[same_rows])
    # chunked (with a tail) == one-shot, on the port
    pc, ic = T.pack_int2_cols_chunked(torch.from_numpy(q8), chunk=1000)
    assert torch.equal(pc, p) and torch.equal(ic.view(torch.int32), inv.view(torch.int32))


def test_pack_from_padded_device_matrix():
    """The backend packs q8m[:, :D] out of its D8-wide device matrix."""
    q8, _ = _q8(_rows(np.random.default_rng(1), 300, 20))
    wide = torch.zeros((300, T.padded_dim(20) + 8), dtype=torch.int8)
    wide[:, :20] = torch.from_numpy(q8)
    p, inv = T.pack_int2_cols_chunked(wide[:, :20], chunk=128)
    p1, i1 = T.pack_int2_cols(torch.from_numpy(q8))
    assert torch.equal(p, p1) and torch.equal(inv.view(torch.int32), i1.view(torch.int32))


def test_zero_rows_and_query_parts():
    q8 = np.zeros((256, 16), np.int8)
    q8[1] = 3
    _, inv = T.pack_int2_cols(torch.from_numpy(q8))
    assert inv[0] == 0.0 and inv[1] > 0.0
    qq = np.random.default_rng(2).integers(-127, 128, 16).astype(np.int8)
    ref = J._int2_query_parts(jnp.asarray(qq), 4)
    got = T._int2_query_parts(torch.from_numpy(qq))
    for w_ref, w in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(np.asarray(w_ref)[0], w.numpy())
    assert float(ref[4]) == float(got[4])


# -- the three kernels' plain versions against their Pallas kernels ---------------


def _sub_quarters(qs, dq):
    """The reference's [8k, D/4] weight blocks with qs's quarters on top."""
    qb = max(pallas_int2.SUB, -(-len(qs) // 8) * 8)
    out = []
    for i in range(4):
        w = np.zeros((qb, dq), np.int8)
        w[: len(qs)] = qs[:, i * dq:(i + 1) * dq]
        out.append(jnp.asarray(w))
    return out


def _quarters(qs, dq):
    return [torch.from_numpy(np.ascontiguousarray(qs[:, i * dq:(i + 1) * dq]))
            for i in range(4)]


@pytest.mark.parametrize("d", [64, 772])
def test_int2_masked_scores_plain_matches_pallas(d):
    c, dq = 2048, d // 4
    _, _, packed_t, inv_n2 = _packed_case(c, d, seed=d)
    inv_n2[9] = 0.0
    qq = np.array(J._quantize_query(jnp.asarray(_rows(np.random.default_rng(2), 1, d)[0])))
    corr = np.float32(2 * int(qq[dq:].astype(np.int32).sum())
                      - 0.5 * int(qq.astype(np.int32).sum()))
    for n in (c, c - 1, 1000, 1):
        ref = np.asarray(pallas_int2.int2_masked_scores(
            jnp.asarray(packed_t), *_sub_quarters(qq[None], dq), pallas_int2.pick_rpt(c),
            jnp.float32(corr), jnp.asarray(inv_n2), jnp.int32(n)))
        args = (torch.from_numpy(packed_t), *[w[0] for w in _quarters(qq[None], dq)],
                float(corr), torch.from_numpy(inv_n2), n)
        got = int2_scan.int2_masked_scores(*args)
        assert got.dtype == torch.float32 and got.shape == (c,)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert np.isneginf(got.numpy()[n:]).all() and np.isneginf(got.numpy()[[3, 9]]).all()
        assert torch.equal(int2_scan.int2_masked_scores_plain(*args).view(torch.int32),
                           got.view(torch.int32))


@pytest.mark.parametrize("q", [1, 5, 70])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int2_masked_scores_batched_plain_matches_pallas(q, dtype):
    c, d = 1024, 64
    dq = d // 4
    _, _, packed_t, inv_n2 = _packed_case(c, d, seed=q)
    rng = np.random.default_rng(q)
    qs = rng.integers(-127, 128, (q, d)).astype(np.int8)
    qs[0] = 127  # queries of all +-127
    if q > 2:
        qs[1] = -127
    qi = qs.astype(np.int32)
    corrs = ((2 * qi[:, dq:].sum(1)).astype(np.float32)
             - np.float32(0.5) * qi.sum(1).astype(np.float32))
    corrs[0] += 3.5  # any corr is subtracted as given
    wq = _sub_quarters(qs, dq)
    corr_pad = np.zeros(wq[0].shape[0], np.float32)
    corr_pad[:q] = corrs
    n = c - 77
    ref = np.asarray(pallas_int2.int2_masked_scores_batched(
        jnp.asarray(packed_t), *wq, jnp.asarray(corr_pad), jnp.asarray(inv_n2),
        pallas_int2.pick_rpt(c), jnp.int32(n), out_dtype=getattr(jnp, dtype)))[:q]
    args = (torch.from_numpy(packed_t), *_quarters(qs, dq), torch.from_numpy(corrs),
            torch.from_numpy(inv_n2), n)
    got = int2_scan.int2_masked_scores_batched(*args, out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (q, c)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    plain = int2_scan.int2_masked_scores_batched_plain(*args, out_dtype=getattr(torch, dtype))
    assert torch.equal(plain.float().view(torch.int32), got.float().view(torch.int32))


def test_int2_topq_plain_matches_pallas():
    """#14 at 32,768 rows: values and rows equal, with duplicate scores
    inside a segment, a segment of 5 live rows, a fully masked segment
    (inv_n2 == 0) and the segments past a mid-segment n."""
    c, d = 32768, 64
    dq = d // 4
    _, _, packed_t, inv_n2 = _packed_case(c, d, seed=11)
    packed_t[:, 1000:1010] = packed_t[:, 1000:1001]  # ties inside segment 1
    inv_n2[1000:1010] = inv_n2[1000]
    inv_n2[2048 + 5:2048 + 512] = 0.0  # segment 4: 5 live rows
    inv_n2[4096:4608] = 0.0  # segment 8: none
    rng = np.random.default_rng(5)
    for qq in (rng.integers(-127, 128, d).astype(np.int8), np.full(d, 127, np.int8)):
        qi = qq.astype(np.int32)
        corr = np.float32(2 * int(qi[dq:].sum()) - 0.5 * int(qi.sum()))
        for n in (c, c - 700, 20000 + 3):
            tv, tg = pallas_int2.int2_topq_scores(
                jnp.asarray(packed_t), *_sub_quarters(qq[None], dq), pallas_int2.pick_rpt(c),
                jnp.float32(corr), jnp.asarray(inv_n2), jnp.int32(n))
            args = (torch.from_numpy(packed_t), *[w[0] for w in _quarters(qq[None], dq)],
                    float(corr), torch.from_numpy(inv_n2), n)
            gv, gg = int2_scan.int2_topq_scores(*args)
            assert gv.shape == gg.shape == (c // 512 * 8,) and gg.dtype == torch.int32
            np.testing.assert_array_equal(_bits(gv), _bits(tv))
            np.testing.assert_array_equal(gg.numpy(), np.asarray(tg))
            pv, pg = int2_scan.int2_topq_scores_plain(*args)
            assert torch.equal(pv.view(torch.int32), gv.view(torch.int32))
            assert torch.equal(pg, gg)
    assert np.isneginf(gv.numpy()[8 * 8:9 * 8]).all()  # the masked segment
    assert (gg.numpy()[8 * 8:9 * 8] == 4096).all()  # repeats its lowest row


def test_kernel_error_cases():
    p = torch.zeros((4, 512), dtype=torch.int8)
    h = torch.zeros(4, dtype=torch.int8)
    inv = torch.ones(512)
    with pytest.raises(ValueError, match="C % 128"):
        int2_scan.int2_masked_scores(torch.zeros((4, 192), dtype=torch.int8),
                                     h, h, h, h, 0.0, torch.ones(192), 10)
    with pytest.raises(ValueError, match="int8"):
        int2_scan.int2_masked_scores(p, h.int(), h, h, h, 0.0, inv, 10)
    with pytest.raises(ValueError, match="inv_n2"):
        int2_scan.int2_masked_scores(p, h, h, h, h, 0.0, torch.ones(511), 10)
    with pytest.raises(ValueError, match="one corr per query"):
        int2_scan.int2_masked_scores_batched(p, *[h.expand(3, 4)] * 4, torch.zeros(2), inv, 10)
    with pytest.raises(ValueError, match="out_dtype"):
        int2_scan.int2_masked_scores_batched(p, *[h[None]] * 4, torch.zeros(1), inv, 10,
                                             out_dtype=torch.float16)
    with pytest.raises(ValueError, match="C % 512"):
        int2_scan.int2_topq_scores(torch.zeros((4, 256), dtype=torch.int8), h, h, h, h, 0.0,
                                   torch.ones(256), 10)


def test_cpu_wrappers_count_no_launch():
    before = dict(int2_scan.LAUNCHES)
    p = torch.zeros((4, 512), dtype=torch.int8)
    h = torch.ones(4, dtype=torch.int8)
    int2_scan.int2_masked_scores(p, h, h, h, h, 0.0, torch.ones(512), 10)
    int2_scan.int2_masked_scores_batched(p, *[h[None]] * 4, torch.zeros(1), torch.ones(512), 10)
    int2_scan.int2_topq_scores(p, h, h, h, h, 0.0, torch.ones(512), 10)
    assert int2_scan.LAUNCHES == before
    assert set(before) == {"int2_masked_scores", "int2_masked_scores_batched",
                           "int2_topq_scores"}


# -- the pipelines ------------------------------------------------------------------


def _pipeline_case(c, d, seed, q=1, plant=()):
    rng = np.random.default_rng(seed)
    rows = _rows(rng, c, d)
    rows[11] = 0.0  # zero row
    qs = _rows(rng, q, d)
    for i, r in enumerate(plant[:q]):
        qs[i] = rows[r] + 0.02 * rng.normal(size=d).astype(np.float32)
    q8, rn = _q8(rows)
    p_ref, i_ref = J.pack_int2_cols_chunked(jnp.asarray(q8), chunk=1 << 18)
    return rows, qs, q8, rn, np.array(p_ref), np.array(i_ref)


def _port_args(q8, rn, packed_t, inv_n2, pad=8):
    """The port's device layout: q8 with zero columns past D."""
    c, d = q8.shape
    wide = np.zeros((c, d + pad), np.int8)
    wide[:, :d] = q8
    return (torch.from_numpy(wide), torch.from_numpy(rn), torch.from_numpy(packed_t),
            torch.from_numpy(inv_n2))


@pytest.mark.parametrize("c,d,k,pool", [
    (32768, 32, 10, 8192),    # the served pool: segment quotas, no shrink
    (32768, 32, 10, 200),     # quota floor 8: the stage-2 shrink
    (32768, 32, 10, 20000),   # pool * 2 >= C: exhaustive rescore
    (4096 + 128, 16, 5, 300),  # C not a multiple of 512: -inf padding
])
def test_cosine_int2_topk_equal(c, d, k, pool):
    rows, qs, q8, rn, packed_t, inv_n2 = _pipeline_case(c, d, seed=c + d + pool,
                                                        plant=(777,))
    n = c - 300
    valid = np.arange(c) < n
    fvalid = valid.copy()
    fvalid[::3] = False  # a filter: non-prefix validity
    fvalid[777] = True
    args = _port_args(q8, rn, packed_t, inv_n2)
    for vv, n_valid in ((valid, n), (fvalid, None)):
        s_ref, i_ref = J.cosine_int2_topk(
            jnp.asarray(qs[0]), jnp.asarray(q8), jnp.asarray(rn), jnp.asarray(packed_t),
            jnp.asarray(inv_n2), jnp.asarray(vv), k, pool,
            n_valid=None if n_valid is None else jnp.int32(n_valid))
        s, i = T.cosine_int2_topk(torch.from_numpy(qs[0]), *args, torch.from_numpy(vv),
                                  k, pool, n_valid=n_valid)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(_bits(s), _bits(s_ref))
        assert int(i[0]) == 777


@pytest.mark.parametrize("pool", [4096, 8192])
def test_int2_topq_branch_equal(monkeypatch, pool):
    """UCFP_INT2_TOPQ=1 at 2^20 rows (the branch needs C/512 * 8 >= 1.3 *
    pool): the same ids and scores as the reference's branch and as the
    default path's (quota 8: both keep each segment's exact top 8)."""
    c, d, k = 1 << 20, 16, 10
    rows, qs, q8, rn, packed_t, inv_n2 = _pipeline_case(c, d, seed=pool, plant=(4321,))
    n = c - 1000
    args = _port_args(q8, rn, packed_t, inv_n2)
    valid = torch.arange(c) < n
    default = T.cosine_int2_topk(torch.from_numpy(qs[0]), *args, valid, k, pool, n_valid=n)
    monkeypatch.setenv("UCFP_INT2_TOPQ", "1")
    calls = []
    orig = int2_scan.int2_topq_scores
    monkeypatch.setattr(int2_scan, "int2_topq_scores",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    s_ref, i_ref = J.cosine_int2_topk(
        jnp.asarray(qs[0]), jnp.asarray(q8), jnp.asarray(rn), jnp.asarray(packed_t),
        jnp.asarray(inv_n2), jnp.asarray(valid.numpy()), k, pool, n_valid=jnp.int32(n))
    s, i = T.cosine_int2_topk(torch.from_numpy(qs[0]), *args, valid, k, pool, n_valid=n)
    assert calls == [1]
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(_bits(s), _bits(s_ref))
    assert torch.equal(i, default[1]) and torch.equal(s, default[0])
    assert int(i[0]) == 4321


@pytest.mark.parametrize("c,d,q,k,pool", [
    (32768, 32, 6, 10, 4096),   # the served batch pool
    (32768, 32, 3, 10, 200),    # the per-row stage-2 shrink
    (8192, 32, 3, 10, 4096),    # pool * 2 >= C: the exhaustive int8 product
    (4096, 16, 70, 5, 300),     # across the 64-query chunk edge
])
def test_cosine_int2_topk_batched_equal(c, d, q, k, pool):
    rows, qs, q8, rn, packed_t, inv_n2 = _pipeline_case(
        c, d, seed=c + q, q=q, plant=(123, 3100 % c, 100, 200))
    if q == 70:
        qs[63] = rows[100] + 0.02
        qs[64] = rows[200] + 0.02
    qs[-1] = 0.0  # a zero query
    n = c - 50
    s_ref, i_ref = J.cosine_int2_topk_batched(
        jnp.asarray(qs), jnp.asarray(q8), jnp.asarray(rn), jnp.asarray(packed_t),
        jnp.asarray(inv_n2), n, k, pool)
    s, i = T.cosine_int2_topk_batched(torch.from_numpy(qs), *_port_args(q8, rn, packed_t,
                                                                        inv_n2), n, k, pool)
    np.testing.assert_array_equal(_bits(s), _bits(s_ref))
    # the zero query scores every row 0: the reference's approx_max_k (an
    # unstable sort on the CPU) orders such ties its own way, the port by
    # row, so only its scores compare (the backend answers it with [])
    rows_cmp = slice(None) if pool * 2 >= c else slice(0, q - 1)
    np.testing.assert_array_equal(i.numpy()[rows_cmp], np.asarray(i_ref)[rows_cmp])
    assert int(i[0, 0]) == 123


def test_segment_select_ties_and_padding():
    """Each segment's quota in value order, ties to the lower row, -inf
    rows taken lowest first, gidx clamped and masked past C."""
    s = torch.tensor([1.0, 3.0, 3.0, 2.0] * 128 + [5.0, float("-inf")] * 64)
    vals, gidx, ok = T._segment_select(s, pool=10)
    assert vals.shape == (16,)  # 2 segments x quota 8
    assert gidx[:8].tolist() == [1, 2, 5, 6, 9, 10, 13, 14]
    assert gidx[8:].tolist() == [512 + 2 * i for i in range(8)]
    assert ok.all()
    s2 = torch.full((515,), float("-inf"))  # segment 1: rows 512-514 + padding
    s2[513] = 1.0
    vals, gidx, ok = T._segment_select(s2, pool=10)
    assert ok.tolist() == [False] * 8 + [True] + [False] * 7
    assert gidx[8:].tolist() == [513, 512, 514, 514, 514, 514, 514, 514]


# -- the dispatch cost model -----------------------------------------------------


_GRID = [(cap, dim, q, k) for cap in (1024, 8192, 16384, 32768, 1 << 17, 1 << 20, 1 << 21,
                                      1 << 22, 1 << 23, 1 << 24)
         for dim in (16, 18, 64, 768, 1536) for q in (1, 2, 5, 32, 64)
         for k in (1, 10, 200)]


@pytest.mark.parametrize("env", [
    {},
    {"UCFP_SKETCH_COST_MODEL": "0"},
    {"UCFP_COST_HBM_GBPS": "3350", "UCFP_COST_INT2_GBPS": "2000",
     "UCFP_COST_INT2B_GBPS": "1500", "UCFP_COST_GATHER_NS": "2",
     "UCFP_COST_SELECT_US": "3", "UCFP_COST_INT2_FLAT_MS": "0.1",
     "UCFP_COST_INT2B_FLAT_MS": "0.3", "UCFP_COST_INT2B_SELECT_US": "10",
     "UCFP_COST_BASE_MS": "0.5", "UCFP_SKETCH_POOL_FRAC": "0.01"},
])
def test_cost_model_equal(monkeypatch, env):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    for cap, dim, q, k in _GRID:
        pool, bpool = T.int2_pool(cap, k), T.int2_batch_pool(cap, k)
        assert (pool, bpool) == (J.int2_pool(cap, k), J.int2_batch_pool(cap, k))
        assert T.int2_supported(cap, dim) == J.int2_supported(cap, dim)
        assert T.int2_model_ms(cap, dim, pool) == J.int2_model_ms(cap, dim, pool)
        assert (T.int2_batch_model_ms(cap, dim, q, bpool)
                == J.int2_batch_model_ms(cap, dim, q, bpool))
        for fused in (True, False):
            assert (T.int2_beats_exact(cap, dim, pool, fused)
                    == J.int2_beats_exact(cap, dim, pool, fused))
        assert (T.int2_batch_beats_exact(cap, dim, q, bpool)
                == J.int2_batch_beats_exact(cap, dim, q, bpool))
        for frac in (None, 0.0066, 0.021, 0.042):
            sp = T.sketch_pool(cap, k, frac)
            assert sp == J.sketch_pool(cap, k, frac)
            assert T.sketch_model_ms(cap, dim, sp) == J.sketch_model_ms(cap, dim, sp)
            assert T.sketch_beats_exact(cap, dim, sp) == J.sketch_beats_exact(cap, dim, sp)
    assert (T.INT2_MIN_POOL, T.INT2_BATCH_MIN_POOL) == (J.INT2_MIN_POOL, J.INT2_BATCH_MIN_POOL)
    assert (int2_scan.TOPQ, int2_scan.TOPQ_SEG) == (pallas_int2.TOPQ, pallas_int2.TOPQ_SEG)
    assert set(T._COST_DEFAULTS) == set(J._COST_DEFAULTS)
    assert {k: T._cost_const(k) for k in T._COST_DEFAULTS} == {
        k: J._cost_const(k) for k in T._COST_DEFAULTS}
