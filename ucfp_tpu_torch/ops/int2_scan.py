"""Packed-int2 prefilter scans (port of ucfp_tpu/ops/pallas_int2.py).

The catalog is packed column-major, [D/4, C] int8 (ops.knn.pack_int2_cols):
byte (j, c) holds four 2-bit fields of row c, dim j in bits 6-7 as a
signed value a in [-2, 1], dims j + D/4, j + D/2, j + 3D/4 in bits 4-5,
2-3, 0-1 biased by +2. A query's int8 dims split into four quarters qa,
qb, qc, qd (dims [0, D/4), [D/4, D/2), ...). Every kernel computes the
integer dot

    dot[q, c] = sum_j a * qa[j] + (b + 2) * qb[j] + (c + 2) * qc[j] + (d + 2) * qd[j]

(the fields as stored; the biases and the +0.5 level offset fold into the
caller's float32 correction corr = 2 * (sum qb + qc + qd) - 0.5 * sum q),
and the masked score (float32(dot) - corr) * inv_n2, -inf where row >= n
or inv_n2 == 0. float32(dot) - corr is exact (integers and half-integers
below 2^23); only the product rounds, once.

Kernels (CUDA C++ for sm_90a, csrc/int2_scan.cu):
  * int2_masked_scores — one query's [C] float32 scores;
  * int2_masked_scores_batched — a [Q, D/4] block with one corr per
    query, float32 or bfloat16 out (round to nearest even). Q >= 2 runs
    on the int8 tensor cores (the scan csrc/mma_scan.cuh shares with the
    batched int4 kernel): each 2-bit field becomes an exact signed byte
    scaled by 64 (64a = byte & 0xC0; 64*(f - 2) = ((byte << s) & 0xC0) ^
    0x80 for the biased fields, s = 2, 4, 6), so a catalog row is the
    K = D vector [64a | 64b | 64c | 64d] against [qa | qb | qc | qd] and
    one s32 sum holds 64*(dot - bias), bias = 2*(sum qb + sum qc + sum qd);
    the kernel adds the bias back after >> 6. `mma_operands` builds those
    operands in the kernel's K order, and `mma_scores_plain` multiplies
    them on any device, so the CPU tests hold the identity the kernel
    relies on. Q = 1 runs the single-query kernel;
  * int2_topq_scores — one query's masked scores, then per 512-row
    segment the top TOPQ = 8 inside the kernel (the reference's rule:
    each pass takes the largest value and the lowest row holding it, then
    sets that row to -inf, so a segment with fewer than 8 live rows
    repeats the lowest -inf row) -> ([C/512 * 8] f32, [C/512 * 8] int32
    global rows).

Beside each kernel sits its plain PyTorch version (`*_plain`): the CPU
path, and the yardstick the card's kernel is held bit-equal to. A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. The TPU tiling (rows per tile, pick_rpt,
the SUB=8 weight padding) is not part of the contract and is gone.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .fused_scan import _check, _stream_ptr

NEG_INF = float("-inf")
ROW_ALIGN = 128  # the kernels take whole 128-row blocks of the catalog
MAX_DQ = 8192  # the widest D/4 the kernels take (csrc/int2_scan.cu)
TOPQ = 8  # survivors per segment (int2_topq_scores)
TOPQ_SEG = 512  # rows per selection segment
MMA_KSTEP_QUARTERS = 16  # dim quarters per chunk (two k32 steps) of the batched kernel

# the plain versions' float32 products on CUDA must not round to TF32
torch.backends.cuda.matmul.allow_tf32 = False

#: kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"int2_masked_scores": 0, "int2_masked_scores_batched": 0,
            "int2_topq_scores": 0}
_count_lock = threading.Lock()

# output kinds of ucfp_int2_scan
_OUT_F32, _OUT_BF16, _OUT_TOPQ = 1, 2, 3


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


_lib = None


def _kernels():
    """The built kernel library with the int2 entry point's signature."""
    global _lib
    if _lib is None:
        from .._build import kernel_library

        lib = kernel_library()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ucfp_int2_scan.restype = i
        lib.ucfp_int2_scan.argtypes = [p, i, ll, p, i, i, p, p, p, ll, i, p, p, p]
        lib.ucfp_int2_batched_blocks_per_sm.restype = i
        lib.ucfp_int2_batched_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def _fields(blk: torch.Tensor):
    """[dq, R] packed bytes -> the four stored fields a, b + 2, c + 2, d + 2."""
    a = torch.bitwise_right_shift(torch.bitwise_and(blk, -64), 6)  # arithmetic
    return (a, torch.bitwise_and(torch.bitwise_right_shift(blk, 4), 3),
            torch.bitwise_and(torch.bitwise_right_shift(blk, 2), 3),
            torch.bitwise_and(blk, 3))


def _int2_dots_plain(packed_t: torch.Tensor, quarters, rows: int = 1 << 20) -> torch.Tensor:
    """[dq, C] packed x four [nq, dq] quarters -> [nq, C] int32 dots of the
    stored fields, in catalog chunks of `rows`. int32 products on the CPU;
    on CUDA, where an int32 matmul does not run, float32 products, exact
    because every partial sum is an integer below 127 * 11 * dq < 2^24."""
    dq, c = packed_t.shape
    dev = packed_t.device
    kind = torch.int32 if dev.type == "cpu" else torch.float32
    if kind == torch.float32 and 127 * 11 * dq >= 1 << 24:
        raise ValueError(f"plain int2 dots are exact on CUDA for D/4 < 12008, got {dq}")
    ws = [w.to(kind) for w in quarters]
    out = torch.empty((quarters[0].shape[0], c), dtype=torch.int32, device=dev)
    for lo in range(0, c, rows):
        fs = _fields(packed_t[:, lo:lo + rows])
        acc = ws[0] @ fs[0].to(kind)
        for w, f in zip(ws[1:], fs[1:]):
            acc = acc + w @ f.to(kind)
        out[:, lo:lo + rows] = acc.to(torch.int32)
    return out


def _masked_plain(packed_t, quarters, corrs, inv_n2, n_valid: int, out_dtype):
    """_int2_scores_kernel / _int2_batched_kernel literally: float32(dot) -
    corr, times inv_n2, -inf where row >= n or inv_n2 == 0."""
    dots = _int2_dots_plain(packed_t, quarters)
    c = dots.shape[1]
    ok = (torch.arange(c, device=dots.device) < n_valid) & (inv_n2 > 0.0)
    sc = (dots.float() - corrs[:, None]) * inv_n2[None, :]
    return torch.where(ok[None, :], sc, NEG_INF).to(out_dtype)


def _topq_plain(scores: torch.Tensor):
    """_int2_topq_kernel's selection literally, on one query's [C] scores:
    TOPQ passes of (max, lowest row equal to it, set it to -inf) per
    512-row segment -> ([C/512 * TOPQ] f32, [C/512 * TOPQ] int32)."""
    s = scores.reshape(-1, TOPQ_SEG).clone()
    nseg = s.shape[0]
    lane = torch.arange(TOPQ_SEG, device=s.device)[None, :]
    rows = torch.arange(nseg, device=s.device)
    vals, hits = [], []
    for _ in range(TOPQ):
        m = s.amax(dim=1, keepdim=True)
        hit = torch.where(s == m, lane, TOPQ_SEG).amin(dim=1)
        s[rows, hit] = NEG_INF
        vals.append(m[:, 0])
        hits.append(hit)
    gidx = torch.stack(hits, dim=1) + rows[:, None] * TOPQ_SEG
    return torch.stack(vals, dim=1).reshape(-1), gidx.to(torch.int32).reshape(-1)


def _unbias(q8: torch.Tensor) -> torch.Tensor:
    """The batched kernel's per-query bias, 2 * (sum qb + sum qc + sum qd),
    from the four stacked quarters [4, nq, >= D/4] int8 (zero padded): what
    its exact signed fields (b, c, d in [-2, 1] instead of the stored b + 2,
    c + 2, d + 2) leave out of the dot. [nq] int32."""
    return 2 * q8[1:].sum(dim=(0, 2), dtype=torch.int32)


def mma_operands(packed_t: torch.Tensor, quarters):
    """The s8 operands of the batched kernel's tensor-core product, in its
    K order: ([C, K] int8 catalog rows, [N, K] int8 queries), K = 64 *
    ceil(D/4 / 16), N = 8 * ceil(nq / 8). Chunk s of 16 quarters holds, in
    slots 64s.. of K, 64a (byte & 0xC0), then 64b (((byte << 2) & 0xC0) ^
    0x80), 64c (shift 4) and 64d (shift 6) of quarters 16s..16s+15: two k32
    steps, [A | B] then [C | D]; the queries hold qa, qb, qc, qd there.
    Past D/4 the catalog side is a zero byte's unpack (0 and three -128, as
    the kernel's shared memory may hold anything there) and the query side
    0; queries past nq are 0."""
    dq, c = packed_t.shape
    nq = quarters[0].shape[0]
    ks = -(-dq // MMA_KSTEP_QUARTERS)
    padded = torch.zeros((ks * MMA_KSTEP_QUARTERS, c), dtype=torch.int8, device=packed_t.device)
    padded[:dq] = packed_t
    u = padded.view(torch.uint8).to(torch.int16)
    fields = [u & 0xC0] + [((u << s) & 0xC0) ^ 0x80 for s in (2, 4, 6)]
    a = torch.stack([f.to(torch.uint8).view(torch.int8).view(ks, MMA_KSTEP_QUARTERS, c)
                     for f in fields], dim=1).reshape(4 * ks * MMA_KSTEP_QUARTERS, c)
    qw = torch.zeros((4, -(-nq // 8) * 8, ks * MMA_KSTEP_QUARTERS), dtype=torch.int8,
                     device=packed_t.device)
    for i, w in enumerate(quarters):
        qw[i, :nq, :dq] = w
    b = qw.view(4, -1, ks, MMA_KSTEP_QUARTERS).permute(1, 2, 0, 3).reshape(qw.shape[1], -1)
    return a.T.contiguous(), b


def mma_scores_plain(packed_t, quarters, corrs, inv_n2, n_valid: int, out_dtype):
    """The batched kernel's arithmetic on any device: the [C, K] x [K, N]
    product of mma_operands in int64 (the kernel's s32 sums stay below
    2^30), then its epilogue: >> 6, + _unbias, float32(dot) - corr (exact),
    the one float32 product by inv_n2 with -inf past n_valid and where
    inv_n2 == 0, rounded to out_dtype. -> [nq, C]."""
    a, b = mma_operands(packed_t, quarters)
    acc = (a.to(torch.int64) @ b.to(torch.int64).T)[:, :quarters[0].shape[0]].T  # [nq, C]
    bias = _unbias(torch.stack(quarters)).to(torch.int64)
    dots = ((acc >> 6) + bias[:, None]).to(torch.int32)
    c = packed_t.shape[1]
    ok = (torch.arange(c, device=dots.device) < n_valid) & (inv_n2 > 0.0)
    sc = (dots.float() - corrs[:, None]) * inv_n2[None, :]
    return torch.where(ok[None, :], sc, NEG_INF).to(out_dtype)


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------


def _query_words(quarters) -> torch.Tensor:
    """Four [nq, dq] int8 quarters -> [4, nq, ceil(dq/4)] int32: four dims
    per word, byte b of word g = dim 4g + b, zero past dq."""
    q8 = torch.stack(quarters)
    dq = q8.shape[2]
    if dq % 4:
        q8 = torch.nn.functional.pad(q8, (0, -dq % 4))
    return q8.view(torch.int32)


def _launch(name: str, packed_t, quarters, corrs, inv_n2, n_valid: int, kind: int,
            out_dtype):
    dq, c = packed_t.shape
    nq = quarters[0].shape[0]
    dev = packed_t.device
    for arg, t in (("quarters", quarters[0]), ("corr", corrs), ("inv_n2", inv_n2)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} must be on {dev}")
    if dq > MAX_DQ:
        raise ValueError(f"{name}: the kernel takes D/4 <= {MAX_DQ}, got {dq}")
    align = 4 if nq == 1 else 16  # word loads; cp.async of 16 bytes
    if not packed_t.is_contiguous() or packed_t.data_ptr() % align:
        raise ValueError(f"{name}: packed_t must be contiguous and {align}-byte aligned")
    if not inv_n2.is_contiguous() or inv_n2.data_ptr() % 16:
        raise ValueError(f"{name}: inv_n2 must be contiguous and 16-byte aligned")
    words = _query_words(quarters)
    corrs = corrs.to(torch.float32).contiguous()
    bias = _unbias(words.view(torch.int8)) if nq > 1 else None
    idx = None
    if kind == _OUT_TOPQ:
        nout = c // TOPQ_SEG * TOPQ
        out = torch.empty(nout, dtype=torch.float32, device=dev)
        idx = torch.empty(nout, dtype=torch.int32, device=dev)
    else:
        out = torch.empty((nq, c), dtype=out_dtype, device=dev)
    rc = _kernels().ucfp_int2_scan(
        packed_t.data_ptr(), dq, c, words.data_ptr(), nq, words.shape[2],
        None if bias is None else bias.data_ptr(), corrs.data_ptr(), inv_n2.data_ptr(),
        int(n_valid), kind, out.data_ptr(), None if idx is None else idx.data_ptr(),
        _stream_ptr(packed_t),
    )
    _check(rc, name)
    _count(name)
    return out if idx is None else (out, idx)


def batched_blocks_per_sm(dq: int, nq: int, out_dtype=torch.bfloat16) -> int:
    """Blocks per SM of the card's batched (tensor-core) kernel for nq >= 2
    queries at D/4 = dq, by cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    per_sm = ctypes.c_int(0)
    kind = _OUT_BF16 if out_dtype == torch.bfloat16 else _OUT_F32
    _check(_kernels().ucfp_int2_batched_blocks_per_sm(dq, nq, kind, ctypes.byref(per_sm)),
           "int2_batched_blocks_per_sm")
    return per_sm.value


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def _check_args(name: str, packed_t: torch.Tensor, quarters, inv_n2: torch.Tensor,
                single: bool):
    if packed_t.dim() != 2 or packed_t.dtype != torch.int8:
        raise ValueError(f"{name}: packed_t must be [D/4, C] int8, got "
                         f"{packed_t.dtype} {tuple(packed_t.shape)}")
    dq, c = packed_t.shape
    if c % ROW_ALIGN:
        raise ValueError(f"{name} requires C % {ROW_ALIGN} == 0, got {c}")
    want = (dq,) if single else (quarters[0].shape[0], dq)
    if len(quarters) != 4 or any(w.dtype != torch.int8 or tuple(w.shape) != want
                                 for w in quarters):
        raise ValueError(f"{name}: the four query quarters must be int8 {list(want)}")
    if not single and want[0] < 1:
        raise ValueError(f"{name}: at least one query")
    if inv_n2.dtype != torch.float32 or inv_n2.shape != (c,):
        raise ValueError(f"{name}: inv_n2 must be a [C={c}] float32 vector")


def _corrs(name: str, corr, nq: int, dev) -> torch.Tensor:
    corrs = torch.as_tensor(corr, device=dev).to(torch.float32).reshape(-1)
    if corrs.shape != (nq,):
        raise ValueError(f"{name}: one corr per query, got {tuple(corrs.shape)}")
    return corrs


def _masked_single(packed_t, qa, qb, qc, qd, corr, inv_n2, n_valid, plain: bool):
    name = "int2_masked_scores"
    quarters = (qa, qb, qc, qd)
    _check_args(name, packed_t, quarters, inv_n2, single=True)
    quarters = tuple(w[None] for w in quarters)
    corrs = _corrs(name, corr, 1, packed_t.device)
    if plain or packed_t.device.type == "cpu":
        out = _masked_plain(packed_t, quarters, corrs, inv_n2, int(n_valid), torch.float32)
    else:
        out = _launch(name, packed_t, quarters, corrs, inv_n2, n_valid, _OUT_F32,
                      torch.float32)
    return out[0]


def int2_masked_scores(packed_t: torch.Tensor, qa: torch.Tensor, qb: torch.Tensor,
                       qc: torch.Tensor, qd: torch.Tensor, corr, inv_n2: torch.Tensor,
                       n_valid: int) -> torch.Tensor:
    """One query's fused prefilter scores: packed_t [D/4, C] int8 (C % 128
    == 0), qa..qd [D/4] int8, corr float32, inv_n2 [C] f32, n_valid the
    prefix length -> [C] f32 (dot - corr) * inv_n2, -inf for rows >= n or
    with inv_n2 == 0."""
    return _masked_single(packed_t, qa, qb, qc, qd, corr, inv_n2, n_valid, plain=False)


def int2_masked_scores_plain(packed_t: torch.Tensor, qa: torch.Tensor, qb: torch.Tensor,
                             qc: torch.Tensor, qd: torch.Tensor, corr,
                             inv_n2: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version of int2_masked_scores on any device."""
    return _masked_single(packed_t, qa, qb, qc, qd, corr, inv_n2, n_valid, plain=True)


def _masked_batched(packed_t, wa, wb, wc, wd, corrs, inv_n2, n_valid, out_dtype,
                    plain: bool):
    name = "int2_masked_scores_batched"
    quarters = (wa, wb, wc, wd)
    if wa.dim() != 2:
        raise ValueError(f"{name}: the quarters are [Q, D/4] blocks")
    _check_args(name, packed_t, quarters, inv_n2, single=False)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16")
    corrs = _corrs(name, corrs, wa.shape[0], packed_t.device)
    if plain or packed_t.device.type == "cpu":
        return _masked_plain(packed_t, quarters, corrs, inv_n2, int(n_valid), out_dtype)
    kind = _OUT_BF16 if out_dtype == torch.bfloat16 else _OUT_F32
    return _launch(name, packed_t, quarters, corrs, inv_n2, n_valid, kind, out_dtype)


def int2_masked_scores_batched(packed_t: torch.Tensor, wa: torch.Tensor,
                               wb: torch.Tensor, wc: torch.Tensor, wd: torch.Tensor,
                               corrs: torch.Tensor, inv_n2: torch.Tensor, n_valid: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Batched masked prefilter scores: wa..wd [Q, D/4] int8, corrs [Q]
    float32 -> [Q, C] in out_dtype (float32 or bfloat16, rounded to
    nearest even from the float32 score). The batched kernel (int8 tensor
    cores) reads each catalog tile once for up to 64 queries; one query
    (Q = 1) runs the single-query kernel with the same stores."""
    return _masked_batched(packed_t, wa, wb, wc, wd, corrs, inv_n2, n_valid, out_dtype,
                           plain=False)


def int2_masked_scores_batched_plain(packed_t: torch.Tensor, wa: torch.Tensor,
                                     wb: torch.Tensor, wc: torch.Tensor,
                                     wd: torch.Tensor, corrs: torch.Tensor,
                                     inv_n2: torch.Tensor, n_valid: int,
                                     out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of int2_masked_scores_batched on any device."""
    return _masked_batched(packed_t, wa, wb, wc, wd, corrs, inv_n2, n_valid, out_dtype,
                           plain=True)


def _topq(packed_t, qa, qb, qc, qd, corr, inv_n2, n_valid, plain: bool):
    name = "int2_topq_scores"
    quarters = (qa, qb, qc, qd)
    _check_args(name, packed_t, quarters, inv_n2, single=True)
    if packed_t.shape[1] % TOPQ_SEG:
        raise ValueError(f"{name} requires C % {TOPQ_SEG} == 0")
    quarters = tuple(w[None] for w in quarters)
    corrs = _corrs(name, corr, 1, packed_t.device)
    if plain or packed_t.device.type == "cpu":
        return _topq_plain(_masked_plain(packed_t, quarters, corrs, inv_n2, int(n_valid),
                                         torch.float32)[0])
    return _launch(name, packed_t, quarters, corrs, inv_n2, n_valid, _OUT_TOPQ,
                   torch.float32)


def int2_topq_scores(packed_t: torch.Tensor, qa: torch.Tensor, qb: torch.Tensor,
                     qc: torch.Tensor, qd: torch.Tensor, corr, inv_n2: torch.Tensor,
                     n_valid: int):
    """int2_masked_scores, then the top TOPQ of every 512-row segment inside
    the kernel -> (vals [C/512 * 8] f32 in descending order per segment,
    rows [C/512 * 8] int32, global). C % 512 == 0. A -inf value is an
    empty slot (see the module doc for the rows such slots carry)."""
    return _topq(packed_t, qa, qb, qc, qd, corr, inv_n2, n_valid, plain=False)


def int2_topq_scores_plain(packed_t: torch.Tensor, qa: torch.Tensor, qb: torch.Tensor,
                           qc: torch.Tensor, qd: torch.Tensor, corr,
                           inv_n2: torch.Tensor, n_valid: int):
    """Plain PyTorch version of int2_topq_scores on any device."""
    return _topq(packed_t, qa, qb, qc, qd, corr, inv_n2, n_valid, plain=True)
