"""Exact k-NN kernels (port of the exact part of ucfp_tpu/ops/knn.py).

  * cosine_topk       — one [Q, D] x [D, C] f32 product + top-k;
  * hamming_topk      — XOR + popcount over packed u32 words, top-k
    smallest;
  * cosine_topk_fused — the f32 cosine scores fed to the fused
    per-(tile, lane) candidate scan (ops.fused_scan), for catalogs of
    32,768 rows or more;
  * the int8 tier: quantize_rows_int8 (host, numpy), the query
    quantization _quantize_query_rows, the exact int8 product int8_dots
    and the exhaustive cosine_topk_int8;
  * the packed-int4 tier: pack_int4_cols{,_chunked} (on the device, from
    the resident int8 rows), the prefilter pipelines cosine_int4_topk
    and cosine_int4_topk_batched (packed scan in ops.int4_scan, candidate
    selection, exact int8 rescore of the pool);
  * the packed-int2 tier: pack_int2_cols{,_chunked}, cosine_int2_topk and
    cosine_int2_topk_batched (packed scans in ops.int2_scan, the
    per-512-row-segment quota selection, a stage-2 shrink to the pool,
    exact int8 rescore);
  * the sketch tier: sketch_planes, sketch_rows_int8,
    build_sketch_chunked, tile_sketch, sketch_query_plan and
    cosine_sketch_topk (the asymmetric sketch scan in ops.sketch_scan,
    the same segment quota selection, exact int8 rescore);
  * the dispatch cost model that decides where each approximate tier
    serves.

Semantics match the reference: score = dot / (|q| * |v|); invalid and
zero-norm rows score -inf; invalid Hamming rows score 0x7fffffff; ties
keep the lower row (a stable sort stands in for lax.top_k, which keeps
the lower index on ties).

int8 scores are bit-equal to the reference's for D <= 1040: every dot is
an int8 x int8 sum of at most 127^2 * D < 2^24, every squared norm too,
so float32 holds each exactly whatever the summation order; what is left
is one sqrt, one division and one multiplication, each correctly rounded
on the CPU and on CUDA (the kernels build without --use_fast_math; the
sqrt goes through float64, _sqrt_f32). On CUDA, PyTorch divides by a CPU
scalar as a multiplication by its reciprocal, so every division here has
a tensor divisor. The int4 tier's scores are int8 cosines of the same
kind.

Storage: catalogs are int32 tensors holding the u32 bit patterns (PyTorch's
uint32 supports few operations); bitwise ops on the patterns are the same.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import fused_scan, int2_scan, int4_scan, sketch_scan
from .fused_scan import _popcount32

NEG_INF = float("-inf")

# The cosine products run in full float32, the counterpart of the
# reference's precision=Precision.HIGHEST (knn.py:58 and 110): TF32 is
# turned off for CUDA matmuls once, when this module is imported.
torch.backends.cuda.matmul.allow_tf32 = False


def _f32_matmul_bt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [Q, D] @ b[C, D]^T in full float32 (TF32 off, set above)."""
    return a @ b.T


def _topk_stable(scores: torch.Tensor, k: int, largest: bool):
    order = torch.sort(scores, dim=1, descending=largest, stable=True).indices[:, :k]
    return torch.gather(scores, 1, order), order


def _cosine_scores(query: torch.Tensor, matrix: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    row_norm = torch.linalg.vector_norm(matrix, dim=1)  # [C]
    q_norm = torch.linalg.vector_norm(query, dim=1, keepdim=True)  # [Q, 1]
    dots = _f32_matmul_bt(query, matrix)  # [Q, C]
    denom = q_norm * row_norm[None, :]
    ok = valid[None, :] & (row_norm[None, :] > 0.0) & (q_norm > 0.0)
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.where(ok, dots / safe, NEG_INF)


def cosine_topk(query: torch.Tensor, matrix: torch.Tensor,
                valid: torch.Tensor, k: int):
    """query [Q, D] f32, matrix [C, D] f32, valid [C] bool ->
    ([Q, k] scores, [Q, k] int64 row indices), best first."""
    return _topk_stable(_cosine_scores(query, matrix, valid), k, largest=True)


def hamming_topk(query: torch.Tensor, matrix: torch.Tensor,
                 valid: torch.Tensor, k: int):
    """query [Q, W] int32 (u32 bits), matrix [C, W] int32, valid [C] bool
    -> ([Q, k] int32 distances, [Q, k] int64 row indices), smallest first.
    One word at a time, so the live intermediate stays [Q, C]."""
    dist = torch.zeros((query.shape[0], matrix.shape[0]), dtype=torch.int64,
                       device=matrix.device)
    for w in range(matrix.shape[1]):
        dist += _popcount32(torch.bitwise_xor(query[:, w, None], matrix[None, :, w]))
    dist = torch.where(valid[None, :], dist, 0x7FFFFFFF).to(torch.int32)
    return _topk_stable(dist, k, largest=False)


def cosine_topk_fused(query: torch.Tensor, matrix: torch.Tensor,
                      valid: torch.Tensor, k: int):
    """Exact f32 cosine scores + the fused partial-reduce candidate top-k
    (near-exact for k <= 16, exact top-1; callers mark responses
    approximate). matrix rows C % 32768 == 0."""
    return fused_scan.scores_topk_fused_batched(
        _cosine_scores(query, matrix, valid), k)


def quantize_rows_int8(matrix) -> tuple:
    """Symmetric per-row int8 quantization of the host matrix: returns
    (q8 [C, D] int8, row_norm [C] f32 = |q8 row|). Per-row scales cancel
    in the cosine, so the int8 row over its own norm is the row's unit
    direction up to quantization noise. Copied from ucfp_tpu/ops/knn.py.
    """
    m = np.asarray(matrix, np.float32)
    # value-identical to abs().max()/round()/clip()/astype with one
    # temporary: max(max, -min) == abs().max(); rint == round (both half
    # to even); the rounded, clipped f32 buffer IS q8 cast back
    absmax = np.maximum(m.max(axis=1), -m.min(axis=1))[:, None]
    scale = np.where(absmax == 0.0, 1.0, absmax / 127.0)
    q = m / scale
    np.rint(q, out=q)
    np.clip(q, -127, 127, out=q)
    q8 = q.astype(np.int8)
    row_norm = np.sqrt(np.einsum("ij,ij->i", q, q, dtype=np.float32))
    return q8, row_norm.astype(np.float32)


def _quantize_query_rows(qm: torch.Tensor) -> torch.Tensor:
    """[Q, D] f32 -> [Q, D] int8, the reference's per-row symmetric rule
    (torch.round, like jnp.round, rounds half to even)."""
    qa = qm.abs().amax(dim=1, keepdim=True)
    qs = torch.where(qa == 0.0, torch.ones_like(qa), qa / torch.full_like(qa, 127.0))
    return torch.clamp(torch.round(qm / qs), -127, 127).to(torch.int8)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's and CUDA's are. PyTorch's
    vectorized float32 sqrt on the CPU can miss by an ulp; a float64 sqrt
    rounded to float32 is the correctly rounded result."""
    return torch.sqrt(x.double()).float()


def int8_norms(qq: torch.Tensor) -> torch.Tensor:
    """[Q, D] int8 -> [Q] f32 |row|: an exact integer sum, then sqrt."""
    f = qq.float()
    return _sqrt_f32((f * f).sum(dim=1))


#: the smallest row count torch._int_mm takes on CUDA (checked on the
#: card by chip_smoke.py); smaller query blocks get zero rows
INT_MM_MIN_M = 17
#: torch._int_mm wants the depth and the output width to be multiples of 8
INT_MM_ALIGN = 8


def padded_dim(d: int) -> int:
    """The device width of an int8 catalog of width d: zero columns up
    to a multiple of INT_MM_ALIGN, which change no dot."""
    return -(-d // INT_MM_ALIGN) * INT_MM_ALIGN


def int8_dots(qq: torch.Tensor, q8m: torch.Tensor) -> torch.Tensor:
    """qq [Q, D] int8 x q8m [C, D8] int8 (D8 >= D; the extra columns are
    zero) -> [Q, C] int32 exact dots.

    The reference leaves this product to XLA (lax.dot_general with an
    int32 result), outside any Pallas kernel, and the port leaves it to
    the library: torch._int_mm on CUDA, which takes at least
    INT_MM_MIN_M rows (the block gets zero rows, sliced off after). No
    float copy of the catalog on the card: it would undo the tier. On
    the CPU, a float64 product of the same integers, exact because every
    partial sum is an integer of magnitude at most D * 2^14 < 2^53, and
    an order of magnitude faster there than an int32 matmul."""
    q, d = qq.shape
    c, d8 = q8m.shape
    if qq.dtype != torch.int8 or q8m.dtype != torch.int8 or d > d8:
        raise ValueError(
            f"int8_dots takes int8 [Q, D] x [C, D8 >= D], got {qq.dtype} "
            f"{tuple(qq.shape)} and {q8m.dtype} {tuple(q8m.shape)}"
        )
    if q8m.device.type == "cpu":
        return (qq.double() @ q8m[:, :d].double().T).to(torch.int32)
    if d8 % INT_MM_ALIGN or c % INT_MM_ALIGN:
        raise ValueError(
            f"torch._int_mm needs D8 and C to be multiples of "
            f"{INT_MM_ALIGN}, got {d8} and {c}"
        )
    m = max(q, INT_MM_MIN_M)
    a = torch.zeros((m, d8), dtype=torch.int8, device=q8m.device)
    a[:q, :d] = qq
    return torch._int_mm(a, q8m.T)[:q]


def cosine_topk_int8(query: torch.Tensor, q8: torch.Tensor,
                     row_norm: torch.Tensor, valid: torch.Tensor, k: int):
    """Exhaustive quantized cosine top-k: query [Q, D] f32, q8 [C, D8]
    int8, row_norm [C] f32 (|int8 row|), valid [C] bool -> ([Q, k] f32
    scores, [Q, k] int64 rows), best first. Scores are exact cosines of
    the quantized vectors."""
    qq = _quantize_query_rows(query)
    dots = int8_dots(qq, q8).float()
    q_norm = int8_norms(qq)[:, None]
    denom = q_norm * row_norm[None, :]
    ok = valid[None, :] & (row_norm[None, :] > 0.0) & (q_norm > 0.0)
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return _topk_stable(torch.where(ok, dots / safe, NEG_INF), k, largest=True)


# -- packed-int4 prefilter + exact int8 rescore -------------------------------
#
# UCFP_KNN_QUANT=int4: each int8 row is re-quantized to int4 and packed two
# dims per byte, column-major ([D/2, C] int8: dim j in byte j's high nibble,
# two's complement; dim j + D/2 in its low nibble, biased +8). The packed
# scan (ops.int4_scan) reads half the int8 catalog's bytes; its top `pool`
# candidates are rescored exactly over the int8 rows. The rescore's float32
# sums are sums of integers below 2^24, so they are exact in any order
# (TF32 stays off), and the scores equal the reference's bit for bit.

INT4_MIN_POOL = 2048
INT4_BATCH_QB = 64  # the reference's batched weight-block height (cost model)


def int4_pool(n: int, k: int) -> int:
    """Rescore-pool size of the single-query int4 prefilter."""
    return min(n, max(INT4_MIN_POOL, 64 * k))


def int4_batch_pool(n: int, k: int) -> int:
    """Rescore-pool size of the batched int4 prefilter."""
    return min(n, max(512, 64 * k))


def int4_supported(cap: int, dim: int) -> bool:
    """Even dim (nibble pairs) and a 128-multiple capacity."""
    return dim % 2 == 0 and cap >= 128 and cap % 128 == 0


def _quantize_query(query: torch.Tensor) -> torch.Tensor:
    """[D] f32 -> [D] int8, the reference's single-query rule (the scale
    is a tensor: see the module doc on CUDA division)."""
    qa = query.abs().amax()
    qs = torch.where(qa == 0.0, torch.ones_like(qa), qa / torch.full_like(qa, 127.0))
    return torch.clamp(torch.round(query / qs), -127, 127).to(torch.int8)


def _pack_int4_rows(q8m: torch.Tensor):
    f = q8m.float()
    absmax = f.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, 7.0))
    q4 = torch.clamp(torch.round(f / scale), -7, 7).to(torch.int32)
    dp = q8m.shape[1] // 2
    packed_t = ((q4[:, :dp] << 4) | (q4[:, dp:] + 8)).to(torch.int8).T
    n4 = _sqrt_f32((q4.float() ** 2).sum(dim=1))
    inv_n4 = torch.where(n4 > 0.0, torch.ones_like(n4) / torch.clamp(n4, min=1e-9),
                         torch.zeros_like(n4))
    return packed_t, inv_n4


def pack_int4_cols(q8m: torch.Tensor):
    """[C, D] int8 rows (D even) -> (packed_t [D/2, C] int8, inv_n4 [C] f32
    = 1/|int4 row|, 0 for zero rows). Per-row symmetric int4
    re-quantization (scale absmax/7; it cancels in the cosine). Runs on
    the rows' device."""
    packed_t, inv_n4 = _pack_int4_rows(q8m)
    return packed_t.contiguous(), inv_n4


def _pack_chunked(pack_rows, q8m: torch.Tensor, dims_per_byte: int, chunk: int):
    """pack_rows over `chunk`-row blocks written into the outputs in place,
    so the float temporaries stay one block, not a catalog copy. Row-wise
    math: bit-identical to the one-shot pack."""
    n, d = q8m.shape
    if n <= chunk:
        packed_t, inv_n = pack_rows(q8m)
        return packed_t.contiguous(), inv_n
    packed_t = torch.empty((d // dims_per_byte, n), dtype=torch.int8, device=q8m.device)
    inv_n = torch.empty(n, dtype=torch.float32, device=q8m.device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        packed_t[:, lo:hi], inv_n[lo:hi] = pack_rows(q8m[lo:hi])
    return packed_t, inv_n


def pack_int4_cols_chunked(q8m: torch.Tensor, chunk: int = 1 << 18):
    """pack_int4_cols in `chunk`-row blocks (_pack_chunked)."""
    return _pack_chunked(_pack_int4_rows, q8m, 2, chunk)


def _exact_topk_flat(scores: torch.Tensor, k: int):
    """Exact top-k over a flat [P] vector: the reference's segmented
    top-k returns what one stable top-k over all P returns."""
    v, i = _topk_stable(scores[None], min(k, scores.shape[0]), largest=True)
    return v[0], i[0]


def _exact_topk_rows(scores: torch.Tensor, k: int):
    """Per-row exact top-k over [Q, P] (the batched _exact_topk_flat)."""
    return _topk_stable(scores, min(k, scores.shape[1]), largest=True)


def _rescore_exact(q8: torch.Tensor, cidx: torch.Tensor, slot_ok: torch.Tensor,
                   query: torch.Tensor, k: int):
    """Exact int8 cosine over the gathered pool rows, in pool order (ties
    go to the lower pool position, as in the reference); row norms are
    recomputed from the gathered rows. q8 may carry zero columns past the
    query's width."""
    d = query.shape[0]
    rows = q8[cidx.long(), :d].float()  # [P, D]
    qq = _quantize_query(query).float()
    dots = rows @ qq
    qn = _sqrt_f32((qq * qq).sum())
    rn = _sqrt_f32((rows * rows).sum(dim=1))
    denom = torch.clamp(qn, min=1e-9) * torch.clamp(rn, min=1e-9)
    ok = slot_ok & (rn > 0.0)
    s, p = _exact_topk_flat(torch.where(ok, dots / denom, NEG_INF), k)
    return s, cidx[p]


def _rescore_exact_batched(q8: torch.Tensor, cidx: torch.Tensor,
                           slot_ok: torch.Tensor, qq_f32: torch.Tensor, k: int):
    """Per-query exact int8 cosine over [Q, P] gathered pools (the rules
    of _rescore_exact); qq_f32 holds the already-quantized queries."""
    q, p = cidx.shape
    d = qq_f32.shape[1]
    rows = q8[cidx.reshape(-1).long(), :d].float().reshape(q, p, d)
    dots = torch.bmm(rows, qq_f32[:, :, None])[:, :, 0]  # [Q, P]
    qn = _sqrt_f32((qq_f32 * qq_f32).sum(dim=1, keepdim=True))
    rn = _sqrt_f32((rows * rows).sum(dim=2))
    denom = torch.clamp(qn, min=1e-9) * torch.clamp(rn, min=1e-9)
    ok = slot_ok & (rn > 0.0)
    s, pos = _topk_stable(torch.where(ok, dots / denom, NEG_INF), min(k, p), largest=True)
    return s, torch.gather(cidx, 1, pos)


def _fused_candidates_ok(c: int, pool: int) -> bool:
    """Whether the per-(tile, lane) candidate scan can feed a pool: whole
    tiles and at least two candidates per pool slot."""
    tile_rows = fused_scan.ROWS_PER_TILE * fused_scan.LANES
    return c % tile_rows == 0 and (c // tile_rows) * fused_scan.LANES >= 2 * pool


def cosine_int4_topk(query: torch.Tensor, q8: torch.Tensor, row_norm: torch.Tensor,
                     packed_t: torch.Tensor, inv_n4: torch.Tensor,
                     valid: torch.Tensor, k: int, pool: int,
                     n_valid: int | None = None):
    """Packed-int4-prefilter cosine top-k: query [D] f32, q8 [C, D8 >= D]
    int8, row_norm [C], packed_t [D/2, C] int8, inv_n4 [C] f32, valid [C]
    bool (validity AND any filter) -> ([k] exact int8 cosines of the
    rescored pool, [k] rows). n_valid asserts valid == arange < n_valid
    and selects the fused masked-scores kernel; without it, the
    uncorrected dots kernel plus a mask pass."""
    c = q8.shape[0]
    if pool * 2 >= c:
        # the pool covers (most of) the catalog: exhaustive exact rescore
        ok = valid & (row_norm > 0.0)
        return _rescore_exact(q8, torch.arange(c, device=q8.device), ok, query, k)
    qq = _quantize_query(query)
    dp = query.shape[0] // 2
    qh, ql = qq[:dp], qq[dp:]
    corr = 8 * ql.to(torch.int32).sum(dtype=torch.int32)
    if n_valid is not None:
        s4 = int4_scan.int4_masked_scores(packed_t, qh, ql, inv_n4, corr, n_valid)
    else:
        ok = valid & (row_norm > 0.0)
        dots = int4_scan.int4_dots(packed_t, qh, ql)
        s4 = torch.where(ok, (dots - corr).float() * inv_n4, NEG_INF)
    if _fused_candidates_ok(c, pool):
        vals, gidx = fused_scan.scores_topk_fused(s4, pool)
    else:
        vals, gidx = _exact_topk_flat(s4, pool)
    return _rescore_exact(q8, gidx, vals > NEG_INF, query, k)


def cosine_int4_topk_batched(queries: torch.Tensor, q8: torch.Tensor,
                             row_norm: torch.Tensor, packed_t: torch.Tensor,
                             inv_n4: torch.Tensor, n_valid: int, k: int, pool: int):
    """Batched packed-int4-prefilter cosine top-k over prefix validity
    (valid == arange < n_valid; filtered batches take the int8 path):
    one packed scan for the whole block with bf16 scores, per-query
    candidate selection and one batched exact rescore -> ([Q, k], [Q, k]),
    per row what cosine_int4_topk's contract gives."""
    c = q8.shape[0]
    qq = _quantize_query_rows(queries)
    if pool * 2 >= c:
        # the exhaustive int8 product is cheaper than scan + full rescore
        valid = torch.arange(c, device=q8.device) < n_valid
        return cosine_topk_int8(queries, q8, row_norm, valid, k)
    dp = queries.shape[1] // 2
    wh, wl = qq[:, :dp], qq[:, dp:]
    corrs = 8 * wl.to(torch.int32).sum(dim=1, dtype=torch.int32)
    s4 = int4_scan.int4_masked_scores_batched(packed_t, wh, wl, corrs, inv_n4,
                                              n_valid, out_dtype=torch.bfloat16)
    if _fused_candidates_ok(c, pool):
        # approx=True is an exact selection in the port (fused_scan doc)
        vals, gidx = fused_scan.scores_topk_fused_batched(s4, pool, approx=True)
    else:
        vals, gidx = _exact_topk_rows(s4.float(), pool)
    return _rescore_exact_batched(q8, gidx, vals.float() > NEG_INF, qq.float(), k)


# -- segment quota selection (int2 and sketch) ----------------------------------
#
# Both prefilters keep, per 512-row segment, the top `quota` rows, quota *
# nseg ~= 1.3 * pool, instead of per-(tile, lane) cells: their true top-k
# rows rank in the thousands, where cells would drop them to collisions.
# The reference selects with lax.approx_max_k, which on the CPU is an
# exact top-k (ROADMAP ground rules) whose order among EQUAL values is an
# unstable sort's; the port selects exactly with lax.top_k's rule: a
# stable sort keeps each segment's rows in value order with ties to the
# lower row, -inf rows included.

SKETCH_SEG = 512


def segment_quota(c: int, pool: int) -> tuple[int, int]:
    """(segments, per-segment quota) of the selection over c rows."""
    nseg = -(-c // SKETCH_SEG)
    return nseg, min(SKETCH_SEG, max(8, -(-int(pool * 1.3) // nseg)))


def _segment_select(scores: torch.Tensor, pool: int):
    """scores [..., C] -> (vals, gidx, slot_ok), each [..., nseg * quota],
    segment-major and in value order within a segment; gidx is clamped to
    C - 1 and slot_ok marks live rows (value > -inf, inside the catalog)."""
    c = scores.shape[-1]
    nseg, quota = segment_quota(c, pool)
    pad = nseg * SKETCH_SEG - c
    if pad:
        scores = torch.cat([scores, torch.full((*scores.shape[:-1], pad), NEG_INF,
                                               dtype=scores.dtype, device=scores.device)],
                           dim=-1)
    seg = scores.reshape(*scores.shape[:-1], nseg, SKETCH_SEG)
    order = torch.sort(seg, dim=-1, descending=True, stable=True).indices[..., :quota]
    vals = torch.gather(seg, -1, order)
    base = torch.arange(nseg, device=scores.device)[:, None] * SKETCH_SEG
    gidx = (order + base).reshape(*scores.shape[:-1], -1)
    vals = vals.reshape(gidx.shape)
    slot_ok = (vals > NEG_INF) & (gidx < c)
    return vals, torch.clamp(gidx, max=c - 1), slot_ok


# -- packed-int2 prefilter + exact int8 rescore ---------------------------------
#
# UCFP_KNN_QUANT=int2: each int8 row is re-quantized to 2-bit fields v in
# [-2, 1] (level v + 0.5, per-row scale 0.9957 * std, which cancels in the
# cosine) and packed four dims per byte, column-major ([D/4, C] int8: dim j
# in bits 6-7 as a signed field, dims j + D/4, j + D/2, j + 3D/4 in bits
# 4-5, 2-3, 0-1 biased +2). The packed scan (ops.int2_scan) reads a
# quarter of the int8 catalog's bytes; per-segment quotas, a stage-2
# shrink and the exact int8 rescore give the answer. The scan's score is
# exact up to one float32 product, so scores equal the reference's.

INT2_MIN_POOL = 8192
INT2_BATCH_MIN_POOL = 4096
INT2_STD_SCALE = 0.9957


def int2_pool(n: int, k: int) -> int:
    """Rescore-pool size of the single-query int2 prefilter."""
    return min(n, max(INT2_MIN_POOL, 64 * k))


def int2_batch_pool(n: int, k: int) -> int:
    """Rescore-pool size of the batched int2 prefilter."""
    return min(n, max(INT2_BATCH_MIN_POOL, 64 * k))


def int2_supported(cap: int, dim: int) -> bool:
    """dim divisible by 4 (four fields per byte) and a 128-multiple capacity."""
    return dim % 4 == 0 and cap >= 128 and cap % 128 == 0


def _int2_scale(q8m: torch.Tensor) -> torch.Tensor:
    """[C, D] int8 -> [C, 1] f32 0.9957 * (population std of the row), 1
    for constant rows. The reference takes the std as a float32 reduction
    (jnp.std), whose last bit depends on its summation order; the port
    takes it from exact integer sums (float64 divide and sqrt, rounded
    once to float32), so the pack on the card equals the pack on the CPU.
    The two can differ only where a field's f / s - 0.5 lies within an
    ulp of a rounding boundary (tests/test_torch_int2.py counts them)."""
    d = q8m.shape[1]
    xi = q8m.to(torch.int32)
    s1 = xi.sum(dim=1, dtype=torch.int64)
    s2 = (xi * xi).sum(dim=1, dtype=torch.int64)
    var = (d * s2 - s1 * s1).double()
    std = torch.sqrt(var / torch.full_like(var, float(d * d))).float()
    s = std * torch.tensor(INT2_STD_SCALE, dtype=torch.float32, device=q8m.device)
    return torch.where(s == 0.0, torch.ones_like(s), s)[:, None]


def _pack_int2_rows(q8m: torch.Tensor):
    f = q8m.float()
    v = torch.clamp(torch.round(f / _int2_scale(q8m) - 0.5), -2, 1).to(torch.int32)
    dq = q8m.shape[1] // 4
    # the signed top field times 64 plus the three biased fields is the
    # byte's two's-complement value, in [-128, 127]
    byte = (64 * v[:, :dq] + ((v[:, dq:2 * dq] + 2) << 4)
            + ((v[:, 2 * dq:3 * dq] + 2) << 2) + (v[:, 3 * dq:] + 2))
    packed_t = byte.to(torch.int8).T
    deq = v.float() + 0.5
    n2 = _sqrt_f32((deq * deq).sum(dim=1))
    nz = f.abs().amax(dim=1) > 0.0
    inv_n2 = torch.where(nz, torch.ones_like(n2) / torch.clamp(n2, min=1e-9),
                         torch.zeros_like(n2))
    return packed_t, inv_n2


def pack_int2_cols(q8m: torch.Tensor):
    """[C, D] int8 rows (D % 4 == 0) -> (packed_t [D/4, C] int8, inv_n2
    [C] f32 = 1/|dequantized row|, 0 for all-zero rows). Runs on the rows'
    device."""
    packed_t, inv_n2 = _pack_int2_rows(q8m)
    return packed_t.contiguous(), inv_n2


def pack_int2_cols_chunked(q8m: torch.Tensor, chunk: int = 1 << 18):
    """pack_int2_cols in `chunk`-row blocks (_pack_chunked)."""
    return _pack_chunked(_pack_int2_rows, q8m, 4, chunk)


def _int2_query_parts(qq: torch.Tensor):
    """int8 queries [..., D] -> the four dim quarters [..., D/4] and the
    float32 correction 2 * (sum of the last three quarters) - 0.5 * sum
    (the +2 field biases and the +0.5 level offset), one per query."""
    dq = qq.shape[-1] // 4
    parts = [qq[..., i * dq:(i + 1) * dq].contiguous() for i in range(4)]
    qi = qq.to(torch.int32)
    corr = ((2 * qi[..., dq:].sum(dim=-1)).float()
            - 0.5 * qi.sum(dim=-1).float())
    return (*parts, corr)


def _shrink_to_pool(vals, gidx, slot_ok, pool: int):
    """The int2 stage-2 shrink: the top `pool` of the live candidates by
    their int2 score (per row for [Q, P] inputs), ties to the lower
    candidate position."""
    flat_v = torch.where(slot_ok, vals.float(), NEG_INF)
    v2, p2 = _topk_stable(flat_v.reshape(-1, flat_v.shape[-1]), pool, largest=True)
    g2 = torch.gather(gidx.reshape(p2.shape[0], -1), 1, p2)
    return g2.reshape(*gidx.shape[:-1], pool), (v2 > NEG_INF).reshape(*gidx.shape[:-1], pool)


def cosine_int2_topk(query: torch.Tensor, q8: torch.Tensor, row_norm: torch.Tensor,
                     packed_t: torch.Tensor, inv_n2: torch.Tensor,
                     valid: torch.Tensor, k: int, pool: int,
                     n_valid: int | None = None):
    """Packed-int2-prefilter cosine top-k: query [D] f32, q8 [C, D8 >= D]
    int8, row_norm [C], packed_t [D/4, C] int8, inv_n2 [C] f32, valid [C]
    bool (validity AND any filter) -> ([k] exact int8 cosines of the
    rescored pool, [k] rows). n_valid asserts valid == arange < n_valid
    and fuses the prefix mask into the scan; without it a mask pass runs
    over the scores. UCFP_INT2_TOPQ=1 selects the reference's in-kernel
    per-segment top-8 scan for unfiltered queries on large catalogs."""
    c = q8.shape[0]
    if pool * 2 >= c:
        ok = valid & (row_norm > 0.0)
        return _rescore_exact(q8, torch.arange(c, device=q8.device), ok, query, k)
    qa, qb, qc, qd, corr = _int2_query_parts(_quantize_query(query))
    nseg_512 = c // int2_scan.TOPQ_SEG
    if (os.environ.get("UCFP_INT2_TOPQ") == "1" and n_valid is not None
            and c % int2_scan.TOPQ_SEG == 0
            and nseg_512 * int2_scan.TOPQ >= int(pool * 1.3)):
        tv, gidx = int2_scan.int2_topq_scores(packed_t, qa, qb, qc, qd, corr, inv_n2,
                                              n_valid)
        slot_ok = tv > NEG_INF
        if nseg_512 * int2_scan.TOPQ > 2 * pool:
            gidx, slot_ok = _shrink_to_pool(tv, gidx, slot_ok, pool)
        return _rescore_exact(q8, gidx, slot_ok, query, k)
    s2 = int2_scan.int2_masked_scores(packed_t, qa, qb, qc, qd, corr, inv_n2,
                                      c if n_valid is None else n_valid)
    if n_valid is None:
        s2 = torch.where(valid & (row_norm > 0.0), s2, NEG_INF)
    vals, gidx, slot_ok = _segment_select(s2, pool)
    if vals.shape[0] > 2 * pool:
        gidx, slot_ok = _shrink_to_pool(vals, gidx, slot_ok, pool)
    return _rescore_exact(q8, gidx, slot_ok, query, k)


def cosine_int2_topk_batched(queries: torch.Tensor, q8: torch.Tensor,
                             row_norm: torch.Tensor, packed_t: torch.Tensor,
                             inv_n2: torch.Tensor, n_valid: int, k: int, pool: int):
    """Batched packed-int2-prefilter cosine top-k over prefix validity
    (filtered batches take the int8 path): one packed scan per 64-query
    chunk with bf16 scores, per-query segment quotas and stage-2 shrink,
    one batched exact rescore -> ([Q, k], [Q, k])."""
    c = q8.shape[0]
    qq = _quantize_query_rows(queries)
    if pool * 2 >= c:
        valid = torch.arange(c, device=q8.device) < n_valid
        return cosine_topk_int8(queries, q8, row_norm, valid, k)
    chunks = []
    for lo in range(0, qq.shape[0], INT4_BATCH_QB):
        wa, wb, wc, wd, corrs = _int2_query_parts(qq[lo:lo + INT4_BATCH_QB])
        chunks.append(int2_scan.int2_masked_scores_batched(
            packed_t, wa, wb, wc, wd, corrs, inv_n2, n_valid, out_dtype=torch.bfloat16))
    s2 = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
    vals, gidx, slot_ok = _segment_select(s2, pool)
    if vals.shape[1] > 2 * pool:
        gidx, slot_ok = _shrink_to_pool(vals, gidx, slot_ok, pool)
    return _rescore_exact_batched(q8, gidx, slot_ok, qq.float(), k)


# -- asymmetric sketch prefilter + exact int8 rescore ---------------------------
#
# UCFP_KNN_QUANT=sketch: each int8 row keeps the sign bits of its
# projection onto SKETCH_BITS seeded +-1 hyperplanes (96 B per row); a
# query keeps its projection magnitudes, cut into SKETCH_LEVELS quantile
# levels, and scores a row by sum_l w_l * (n_l - 2 * disagreements_l), four
# masked popcounts per word (ops.sketch_scan). The per-segment quota
# selection and the exact int8 rescore follow; the pool fraction is the
# recall knob (UCFP_SKETCH_POOL_FRAC, or a request's recall_tier). The
# sketch build is exact (q8 @ planes sums integers below 2^24); the query
# plan is a float32 product whose last bits depend on the summation
# order, so its weights agree with the reference's to a tolerance, while
# its sign bits, level masks and counts agree exactly (tests state both).

SKETCH_BITS = 768
SKETCH_WORDS = SKETCH_BITS // 32
SKETCH_LEVELS = 4
DEFAULT_POOL_FRAC = 0.042
SKETCH_LANES = 128


def sketch_planes(dim: int, seed: int = 0x5EED):
    """Deterministic Rademacher (+-1) hyperplane matrix [dim, SKETCH_BITS],
    seeded by (seed, dim) only. Copied verbatim from ucfp_tpu/ops/knn.py
    (numpy; the same planes bit for bit)."""
    rng = np.random.default_rng([seed, dim])
    return rng.choice(
        np.asarray([-1.0, 1.0], np.float32), size=(dim, SKETCH_BITS)
    )


def _pack_bit_rows(bits: torch.Tensor) -> torch.Tensor:
    """[N, SKETCH_BITS] bool -> [N, SKETCH_WORDS] int32 holding the
    little-endian u32 words (bit b of word w = bits[32 w + b])."""
    n = bits.shape[0]
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
    b8 = bits.reshape(n, SKETCH_BITS // 8, 8).to(torch.uint8) * weights
    return b8.sum(dim=2, dtype=torch.uint8).view(torch.int32)


def sketch_rows_int8(q8_rows: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """[N, D] int8 rows -> [N, SKETCH_WORDS] int32 sign bits of the float32
    projection (exact: integer sums below 2^24, TF32 off)."""
    return _pack_bit_rows(q8_rows.float() @ planes >= 0.0)


def build_sketch_chunked(q8: torch.Tensor, planes: torch.Tensor,
                         chunk: int = 1 << 18) -> torch.Tensor:
    """Sketch a [C, D] int8 matrix in row chunks written into the output,
    so the float32 temporaries stay one chunk."""
    c = q8.shape[0]
    if c <= chunk:
        return sketch_rows_int8(q8, planes)
    out = torch.empty((c, SKETCH_WORDS), dtype=torch.int32, device=q8.device)
    for lo in range(0, c, chunk):
        out[lo:lo + chunk] = sketch_rows_int8(q8[lo:lo + chunk], planes)
    return out


def tile_sketch(packed: torch.Tensor) -> torch.Tensor:
    """[C, W] row-major -> [C/128, W, 128] lane-tiled (row g*128 + lane at
    [g, :, lane]): a warp's 32 rows read one word as 128 contiguous bytes."""
    c = packed.shape[0]
    return packed.reshape(c // SKETCH_LANES, SKETCH_LANES, SKETCH_WORDS).transpose(1, 2) \
        .contiguous()


def sketch_query_plan(query: torch.Tensor, planes: torch.Tensor):
    """Per-query asymmetric scoring plan -> (qsign [W] int32, masks [L, W]
    int32, wts [L] f32, cnt [L] f32, sigma f32): the projection's sign
    bits, one bit mask per magnitude-quantile level, each level's mean
    |projection| and plane count, and sqrt(sum_l w_l^2 n_l)."""
    qp = query @ planes  # [B]
    qsign = _pack_bit_rows((qp >= 0.0)[None])[0]
    mag = qp.abs()
    qs = torch.quantile(mag, torch.linspace(0.0, 1.0, SKETCH_LEVELS + 1,
                                            device=mag.device))
    lvl = (mag[:, None] >= qs[None, 1:SKETCH_LEVELS]).sum(dim=1)
    onehot = lvl[:, None] == torch.arange(SKETCH_LEVELS, device=mag.device)[None, :]
    cnt = onehot.sum(dim=0).float()
    wts = (mag[:, None] * onehot).sum(dim=0) / torch.clamp(cnt, min=1.0)
    masks = _pack_bit_rows(onehot.T.contiguous())
    sigma = torch.sqrt((wts * wts * cnt).sum())
    return qsign, masks, wts, cnt, sigma


def sketch_pool(n: int, k: int, frac: float | None = None) -> int:
    """Rescore-pool size (the recall knob): max(2048, 64k, frac*n), capped
    at n; frac defaults to UCFP_SKETCH_POOL_FRAC or DEFAULT_POOL_FRAC."""
    if frac is None:
        frac = float(os.environ.get("UCFP_SKETCH_POOL_FRAC", "") or DEFAULT_POOL_FRAC)
    return min(n, max(2048, 64 * k, int(frac * n)))


def cosine_sketch_topk(query: torch.Tensor, planes: torch.Tensor, q8: torch.Tensor,
                       row_norm: torch.Tensor, sketch: torch.Tensor,
                       valid: torch.Tensor, k: int, pool: int):
    """Asymmetric-sketch-prefilter cosine top-k: query [D] f32, planes [D,
    SKETCH_BITS] f32, q8 [C, D8 >= D] int8, row_norm [C], sketch lane-tiled
    [C/128, W, 128] (tile_sketch), valid [C] bool (validity AND any filter)
    -> ([k] exact int8 cosines, [k] rows)."""
    c = q8.shape[0]
    ok = valid & (row_norm > 0.0)
    if pool * 2 >= c:
        return _rescore_exact(q8, torch.arange(c, device=q8.device), ok, query, k)
    qsign, masks, wts, cnt, _sigma = sketch_query_plan(query, planes)
    raw = sketch_scan.asym_sketch_scores_tiled(sketch, qsign, masks, wts, cnt)
    _vals, gidx, slot_ok = _segment_select(torch.where(ok, raw, NEG_INF), pool)
    return _rescore_exact(q8, gidx, slot_ok, query, k)


# -- dispatch cost model --------------------------------------------------------
#
# The reference's dispatch constants and formulas, value for value: the
# int4, int2 and sketch tiers serve only where this model says they beat
# the exact int8 path, and the port keeps the reference's numbers so that
# it serves the same tier, and so gives the same hits and the same
# `approximate` mark, as the reference. They were fitted to the reference's hardware, not to
# this port's; refitting them changes answers and is separate work.
# UCFP_COST_<NAME> overrides a constant; UCFP_SKETCH_COST_MODEL=0 turns
# the model off (the tier then serves wherever its kernels apply).

_COST_DEFAULTS = {
    "hbm_gbps": 819.0,
    "gather_ns": 13.0,
    "select_us": 16.0,  # segment quota selection, per quota unit
    "int4b_gbps": 600.0,
    "int4b_flat_ms": 1.5,
    "int4_gbps": 730.0,
    "int4_flat_ms": 0.15,
    "int2_gbps": 730.0,
    "int2_flat_ms": 0.3,
    "int2b_gbps": 600.0,
    "int2b_flat_ms": 1.5,
    "int2b_select_us": 130.0,  # batched segment selection, per (query x quota unit)
    "base_ms": 2.4,  # the sketch pipeline's fixed cost
}


def _cost_const(name: str) -> float:
    return float(os.environ.get(f"UCFP_COST_{name.upper()}", "") or _COST_DEFAULTS[name])


def _cost_model_on() -> bool:
    return os.environ.get("UCFP_SKETCH_COST_MODEL", "1") != "0"


def exact_scan_model_ms(cap: int, dim: int) -> float:
    """Modeled time of the exhaustive single-query int8 scan."""
    return cap * dim / (_cost_const("hbm_gbps") * 1e6) + 1.0


def int4_model_ms(cap: int, dim: int, pool: int) -> float:
    """Modeled time of the single-query int4 pipeline at (cap, pool)."""
    stream = cap * (dim // 2 + 8) / (_cost_const("int4_gbps") * 1e6)
    gather = pool * _cost_const("gather_ns") / 1e6
    rescore = pool * dim / (_cost_const("hbm_gbps") * 1e6)
    return stream + gather + rescore + _cost_const("int4_flat_ms")


def exact_batch_model_ms(cap: int, dim: int, q: int) -> float:
    """Modeled time of the exhaustive batched int8 path for q queries."""
    hbm = _cost_const("hbm_gbps") * 1e6
    return (cap * dim + 8.0 * cap * q) / hbm + 1.0


def int4_batch_model_ms(cap: int, dim: int, q: int, pool: int) -> float:
    """Modeled time of the batched int4 pipeline for q queries."""
    qb = -(-max(1, q) // 8) * 8
    bw = _cost_const("int4b_gbps") * 1e6
    stream = cap * (dim // 2) / bw * -(-qb // INT4_BATCH_QB)
    bounce = 2 * 2.0 * cap * qb / bw
    gather = q * pool * _cost_const("gather_ns") / 1e6
    rescore = q * pool * dim / (_cost_const("hbm_gbps") * 1e6)
    return stream + bounce + gather + rescore + _cost_const("int4b_flat_ms")


def int4_batch_beats_exact(cap: int, dim: int, q: int, pool: int) -> bool:
    """Whether a batch of q queries takes the batched int4 pipeline."""
    if not int4_supported(cap, dim):
        return False
    if not _cost_model_on():
        return True
    if pool * 2 >= cap:
        return False
    return int4_batch_model_ms(cap, dim, q, pool) < exact_batch_model_ms(cap, dim, q)


def int4_beats_exact(cap: int, dim: int, pool: int, fused: bool = True) -> bool:
    """Whether a single query takes the int4 pipeline; fused=False models
    the filtered (dots + mask pass) form, 1.2 times the fused one."""
    if not int4_supported(cap, dim):
        return False
    if not _cost_model_on():
        return True
    if pool * 2 >= cap:
        return False
    est = int4_model_ms(cap, dim, pool)
    if not fused:
        est *= 1.2
    return est < exact_scan_model_ms(cap, dim)


def int2_model_ms(cap: int, dim: int, pool: int) -> float:
    """Modeled time of the single-query int2 pipeline at (cap, pool)."""
    stream = cap * (dim // 4 + 8) / (_cost_const("int2_gbps") * 1e6)
    select = segment_quota(cap, pool)[1] * _cost_const("select_us") / 1e3
    gather = pool * _cost_const("gather_ns") / 1e6
    rescore = pool * dim / (_cost_const("hbm_gbps") * 1e6)
    return stream + select + gather + rescore + _cost_const("int2_flat_ms")


def int2_beats_exact(cap: int, dim: int, pool: int, fused: bool = True) -> bool:
    """Whether a single query takes the int2 pipeline; fused=False adds the
    filtered form's mask pass over the [C] f32 scores."""
    if not int2_supported(cap, dim):
        return False
    if not _cost_model_on():
        return True
    if pool * 2 >= cap:
        return False
    est = int2_model_ms(cap, dim, pool)
    if not fused:
        est += 2 * 4.0 * cap / (_cost_const("hbm_gbps") * 1e6)
    return est < exact_scan_model_ms(cap, dim)


def int2_batch_model_ms(cap: int, dim: int, q: int, pool: int) -> float:
    """Modeled time of the batched int2 pipeline for q queries."""
    qb = -(-max(1, q) // 8) * 8
    bw = _cost_const("int2b_gbps") * 1e6
    stream = cap * (dim // 4) / bw * -(-qb // INT4_BATCH_QB)
    bounce = 2 * 2.0 * cap * qb / bw
    select = q * segment_quota(cap, pool)[1] * _cost_const("int2b_select_us") / 1e3
    gather = q * pool * _cost_const("gather_ns") / 1e6
    rescore = q * pool * dim / (_cost_const("hbm_gbps") * 1e6)
    return (stream + bounce + select + gather + rescore
            + _cost_const("int2b_flat_ms"))


def int2_batch_beats_exact(cap: int, dim: int, q: int, pool: int) -> bool:
    """Whether a batch of q queries takes the batched int2 pipeline."""
    if not int2_supported(cap, dim):
        return False
    if not _cost_model_on():
        return True
    if pool * 2 >= cap:
        return False
    return int2_batch_model_ms(cap, dim, q, pool) < exact_batch_model_ms(cap, dim, q)


def sketch_model_ms(cap: int, dim: int, pool: int) -> float:
    """Modeled time of the sketch pipeline at (cap, pool)."""
    scan = cap * (SKETCH_BITS // 8) / (_cost_const("hbm_gbps") * 1e6)
    select = segment_quota(cap, pool)[1] * _cost_const("select_us") / 1e3
    gather = pool * _cost_const("gather_ns") / 1e6
    rescore = pool * dim / (_cost_const("hbm_gbps") * 1e6)
    return scan + select + gather + rescore + _cost_const("base_ms")


def sketch_beats_exact(cap: int, dim: int, pool: int) -> bool:
    """Whether a single query takes the sketch pipeline (the default: the
    exact int8 path, unmarked)."""
    if not _cost_model_on():
        return True
    if pool * 2 >= cap:
        return False
    return sketch_model_ms(cap, dim, pool) < exact_scan_model_ms(cap, dim)


def pack_bits_to_u32(fp: bytes) -> np.ndarray:
    """Fingerprint bytes -> little-endian uint32 words (zero-padded).
    Copied from ucfp_tpu/ops/knn.py."""
    pad = (-len(fp)) % 4
    if pad:
        fp = fp + b"\x00" * pad
    return np.frombuffer(fp, dtype="<u4")
