"""Packed-int4 prefilter scans (port of ucfp_tpu/ops/pallas_int4.py).

The catalog is packed column-major, [D/2, C] int8 (ops.knn.pack_int4_cols):
byte (j, c) = 16*hi + lo_b, hi = dim j of row c in [-7, 7] in place, lo_b =
dim j + D/2 biased by +8. A query's int8 dims split the same way into a
high half qh = q[:D/2] and a low half ql = q[D/2:]. Every kernel computes
the integer dot

    dot[q, c] = sum_j (byte >> 4) * qh[j] + (byte & 15) * ql[j]

which is the int4 dot UNCORRECTED for the bias: the true dot is dot - 8*sum(ql).

Kernels (CUDA C++ for sm_90a, csrc/int4_scan.cu):
  * int4_dots — [nq, C] int32 uncorrected dots ([C] for one query); the
    filtered single query masks them outside the kernel;
  * int4_masked_scores — one query: (dot - corr) * inv_n4 as float32, -inf
    where row >= n or inv_n4 == 0;
  * int4_masked_scores_batched — the same for a [Q, D/2] block with one
    corr per query, float32 or bfloat16 out (round to nearest even), on
    the int8 tensor cores (mma.sync s8): each catalog row is the K = D
    vector of exact signed bytes [16*hi | 16*(lo_b - 8)] and each query
    [qh | ql], so one s32 sum holds 16*(dot - 8*sum(ql)); int4_dots at
    nq > 1 runs the same kernel. `mma_operands` builds those operands in
    the kernel's K order, and `mma_scores_plain` multiplies them on any
    device, so the CPU tests hold the identity the kernel relies on.

Beside each kernel sits its plain PyTorch version (`*_plain`): the CPU
path, and the yardstick the card's kernel is held bit-equal to. A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. The TPU tiling (rows per tile, the SUB=8
weight padding) is not part of the contract and is gone.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .fused_scan import _check, _stream_ptr

NEG_INF = float("-inf")
ROW_ALIGN = 128  # the kernels take whole 128-row blocks of the catalog
MAX_DP = 16384  # the widest D/2 the kernels take (csrc/int4_scan.cu)
MMA_KSTEP_PAIRS = 16  # dim pairs per k32 step of the batched kernel

# the plain versions' float32 products on CUDA must not round to TF32
torch.backends.cuda.matmul.allow_tf32 = False

#: kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"int4_dots": 0, "int4_masked_scores": 0,
            "int4_masked_scores_batched": 0}
_count_lock = threading.Lock()

# output kinds of ucfp_int4_scan
_OUT_DOTS, _OUT_F32, _OUT_BF16 = 0, 1, 2


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


_lib = None


def _kernels():
    """The built kernel library with the int4 entry point's signature."""
    global _lib
    if _lib is None:
        from .._build import kernel_library

        lib = kernel_library()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ucfp_int4_scan.restype = i
        lib.ucfp_int4_scan.argtypes = [p, i, ll, p, p, i, i, p, p, ll, i, p, p]
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def _int4_dots_plain(packed_t: torch.Tensor, wh: torch.Tensor, wl: torch.Tensor,
                     rows: int = 1 << 20) -> torch.Tensor:
    """[dp, C] packed x [nq, dp] halves -> [nq, C] int32 uncorrected dots,
    in catalog chunks of `rows`. int32 products on the CPU; on CUDA, where
    an int32 matmul does not run, float32 products, exact because every
    partial sum is an integer of magnitude below 23 * 127 * dp < 2^24."""
    dp, c = packed_t.shape
    dev = packed_t.device
    kind = torch.int32 if dev.type == "cpu" else torch.float32
    if kind == torch.float32 and 23 * 127 * dp >= 1 << 24:
        raise ValueError(f"plain int4 dots are exact on CUDA for D/2 < 5744, got {dp}")
    whm, wlm = wh.to(kind), wl.to(kind)
    out = torch.empty((wh.shape[0], c), dtype=torch.int32, device=dev)
    for lo in range(0, c, rows):
        blk = packed_t[:, lo:lo + rows]
        hi = torch.bitwise_right_shift(blk, 4).to(kind)  # arithmetic: [-8, 7]
        lob = torch.bitwise_and(blk, 15).to(kind)  # biased low nibble
        out[:, lo:lo + rows] = (whm @ hi + wlm @ lob).to(torch.int32)
    return out


def _masked_plain(packed_t, wh, wl, corrs, inv_n4, n_valid: int, out_dtype):
    """_int4_scores_kernel / _int4_batched_kernel literally: (dots - corr)
    as float32 times inv_n4, -inf where row >= n or inv_n4 == 0."""
    dots = _int4_dots_plain(packed_t, wh, wl)
    c = dots.shape[1]
    ok = (torch.arange(c, device=dots.device) < n_valid) & (inv_n4 > 0.0)
    sc = (dots - corrs[:, None]).float() * inv_n4[None, :]
    return torch.where(ok[None, :], sc, NEG_INF).to(out_dtype)


def mma_operands(packed_t: torch.Tensor, wh: torch.Tensor, wl: torch.Tensor):
    """The s8 operands of the batched kernel's tensor-core product, in its
    K order: ([C, K] int8 catalog rows, [N, K] int8 queries), K = 32 *
    ceil(D/2 / 16), N = 8 * ceil(nq / 8). K step s holds 16*hi (the byte &
    0xF0) of dim pairs 16s..16s+15, then 16*(lo_b - 8) (((byte << 4) &
    0xF0) ^ 0x80) of the same pairs; the queries hold qh and ql there. Past
    D/2 the catalog side is a zero byte's unpack (0 and -128, as the
    kernel's shared memory may hold anything there) and the query side 0;
    queries past nq are 0."""
    dp, c = packed_t.shape
    nq = wh.shape[0]
    ks = -(-dp // MMA_KSTEP_PAIRS)
    padded = torch.zeros((ks * MMA_KSTEP_PAIRS, c), dtype=torch.int8, device=packed_t.device)
    padded[:dp] = packed_t
    u = padded.view(torch.uint8).to(torch.int16)
    hi16 = (u & 0xF0).to(torch.uint8).view(torch.int8)
    lo16 = (((u << 4) & 0xF0) ^ 0x80).to(torch.uint8).view(torch.int8)
    a = torch.stack([hi16.view(ks, MMA_KSTEP_PAIRS, c), lo16.view(ks, MMA_KSTEP_PAIRS, c)],
                    dim=1).reshape(2 * ks * MMA_KSTEP_PAIRS, c).T.contiguous()
    qw = torch.zeros((2, -(-nq // 8) * 8, ks * MMA_KSTEP_PAIRS), dtype=torch.int8,
                     device=wh.device)
    qw[0, :nq, :dp] = wh
    qw[1, :nq, :dp] = wl
    b = qw.view(2, -1, ks, MMA_KSTEP_PAIRS).permute(1, 2, 0, 3).reshape(qw.shape[1], -1)
    return a, b


def mma_scores_plain(packed_t, wh, wl, bias, inv_n4, n_valid: int, out_dtype):
    """The batched kernel's arithmetic on any device: the [C, K] x [K, N]
    product of mma_operands in int64 (the kernel's s32 sums never exceed
    2^24), then its epilogue: >> 4, + bias (8*sum(ql), less corr for the
    scores), and for scores the one float32 product by inv_n4 with -inf
    past n_valid and where inv_n4 == 0, rounded to out_dtype. out_dtype
    torch.int32 gives the dots. -> [nq, C]."""
    a, b = mma_operands(packed_t, wh, wl)
    acc = (a.to(torch.int64) @ b.to(torch.int64).T)[:, :wh.shape[0]].T  # [nq, C]
    v = ((acc >> 4) + bias.to(torch.int64)[:, None]).to(torch.int32)
    if out_dtype == torch.int32:
        return v
    c = packed_t.shape[1]
    ok = (torch.arange(c, device=v.device) < n_valid) & (inv_n4 > 0.0)
    return torch.where(ok[None, :], v.float() * inv_n4[None, :], NEG_INF).to(out_dtype)


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------


def _query_words(w: torch.Tensor) -> torch.Tensor:
    """[nq, dp] int8 -> [nq, ceil(dp/4)] int32: four dims per word, byte b
    of word g = dim 4g + b, zero past dp."""
    nq, dp = w.shape
    groups = -(-dp // 4)
    out = torch.zeros((nq, 4 * groups), dtype=torch.int8, device=w.device)
    out[:, :dp] = w
    return out.view(torch.int32)


def _launch(name: str, packed_t, wh, wl, bias, inv_n4, n_valid: int,
            kind: int, out_dtype) -> torch.Tensor:
    dp, c = packed_t.shape
    nq = wh.shape[0]
    dev = packed_t.device
    for arg, t in (("wh", wh), ("wl", wl), ("bias", bias), ("inv_n4", inv_n4)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: {arg} must be on {dev}")
    if dp > MAX_DP:
        raise ValueError(f"{name}: the kernel takes D/2 <= {MAX_DP}, got {dp}")
    align = 4 if nq == 1 else 16  # word loads; cp.async of 16 bytes
    if not packed_t.is_contiguous() or packed_t.data_ptr() % align:
        raise ValueError(f"{name}: packed_t must be contiguous and {align}-byte aligned")
    if inv_n4 is not None and (not inv_n4.is_contiguous() or inv_n4.data_ptr() % 16):
        raise ValueError(f"{name}: inv_n4 must be contiguous and 16-byte aligned")
    qh, ql = _query_words(wh), _query_words(wl)
    bias = bias.to(torch.int32).contiguous()
    out = torch.empty((nq, c), dtype=out_dtype, device=dev)
    rc = _kernels().ucfp_int4_scan(
        packed_t.data_ptr(), dp, c, qh.data_ptr(), ql.data_ptr(), nq, qh.shape[1],
        bias.data_ptr(), None if inv_n4 is None else inv_n4.data_ptr(),
        int(n_valid), kind, out.data_ptr(), _stream_ptr(packed_t),
    )
    _check(rc, name)
    _count(name)
    return out


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def _check_packed(name: str, packed_t: torch.Tensor, *halves: torch.Tensor) -> None:
    if packed_t.dim() != 2 or packed_t.dtype != torch.int8:
        raise ValueError(f"{name}: packed_t must be [D/2, C] int8, got "
                         f"{packed_t.dtype} {tuple(packed_t.shape)}")
    dp, c = packed_t.shape
    if c % ROW_ALIGN:
        raise ValueError(f"{name} requires C % {ROW_ALIGN} == 0, got {c}")
    for h in halves:
        if h.dtype != torch.int8 or h.shape[-1] != dp:
            raise ValueError(f"{name}: query halves must be int8 [..., {dp}], got "
                             f"{h.dtype} {tuple(h.shape)}")


def _check_inv(name: str, inv_n4: torch.Tensor, c: int) -> None:
    if inv_n4.dtype != torch.float32 or inv_n4.shape != (c,):
        raise ValueError(f"{name}: inv_n4 must be a [C={c}] float32 vector")


def _halves_2d(name: str, wh: torch.Tensor, wl: torch.Tensor):
    if wh.shape != wl.shape or wh.dim() != 2 or wh.shape[0] < 1:
        raise ValueError(f"{name}: wh and wl must both be [nq >= 1, D/2], got "
                         f"{tuple(wh.shape)} and {tuple(wl.shape)}")
    return wh, wl


def _dots(packed_t, wh, wl, plain: bool) -> torch.Tensor:
    _check_packed("int4_dots", packed_t, wh, wl)
    single = wh.dim() == 1
    if single:
        wh, wl = wh[None], wl[None]
    wh, wl = _halves_2d("int4_dots", wh, wl)
    if plain or packed_t.device.type == "cpu":
        out = _int4_dots_plain(packed_t, wh, wl)
    else:
        # the kernel corrects internally; adding 8*sum(ql) back gives the
        # uncorrected contract
        bias = 8 * wl.to(torch.int32).sum(dim=1, dtype=torch.int32)
        out = _launch("int4_dots", packed_t, wh, wl, bias, None, 0,
                      _OUT_DOTS, torch.int32)
    return out[0] if single else out


def int4_dots(packed_t: torch.Tensor, wh: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """packed_t [D/2, C] int8 (C % 128 == 0), wh / wl [nq, D/2] int8 (the
    queries' high and low halves) -> [nq, C] int32 UNCORRECTED dots (true
    int4 dot = out - 8 * sum(wl row)); 1-D halves [D/2] -> [C]."""
    return _dots(packed_t, wh, wl, plain=False)


def int4_dots_plain(packed_t: torch.Tensor, wh: torch.Tensor,
                    wl: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of int4_dots on any device."""
    return _dots(packed_t, wh, wl, plain=True)


def _masked_single(packed_t, qh, ql, inv_n4, corr, n_valid, plain: bool):
    name = "int4_masked_scores"
    _check_packed(name, packed_t, qh, ql)
    if qh.dim() != 1 or ql.dim() != 1:
        raise ValueError(f"{name}: qh and ql are one query's [D/2] halves")
    _check_inv(name, inv_n4, packed_t.shape[1])
    corr = torch.as_tensor(corr, dtype=torch.int32, device=packed_t.device).reshape(1)
    if plain or packed_t.device.type == "cpu":
        out = _masked_plain(packed_t, qh[None], ql[None], corr, inv_n4, int(n_valid),
                            torch.float32)
    else:
        bias = 8 * ql.to(torch.int32).sum(dtype=torch.int32) - corr
        out = _launch(name, packed_t, qh[None], ql[None], bias, inv_n4, int(n_valid),
                      _OUT_F32, torch.float32)
    return out[0]


def int4_masked_scores(packed_t: torch.Tensor, qh: torch.Tensor, ql: torch.Tensor,
                       inv_n4: torch.Tensor, corr, n_valid: int) -> torch.Tensor:
    """One query's fused prefilter scores: packed_t [D/2, C] int8, qh / ql
    [D/2] int8, inv_n4 [C] f32, corr int32 (8 * sum(ql)), n_valid the
    prefix length -> [C] f32 (dot - corr) * inv_n4, -inf for rows >= n or
    with inv_n4 == 0."""
    return _masked_single(packed_t, qh, ql, inv_n4, corr, n_valid, plain=False)


def int4_masked_scores_plain(packed_t: torch.Tensor, qh: torch.Tensor,
                             ql: torch.Tensor, inv_n4: torch.Tensor, corr,
                             n_valid: int) -> torch.Tensor:
    """Plain PyTorch version of int4_masked_scores on any device."""
    return _masked_single(packed_t, qh, ql, inv_n4, corr, n_valid, plain=True)


def _masked_batched(packed_t, wh, wl, corrs, inv_n4, n_valid, out_dtype, plain: bool):
    name = "int4_masked_scores_batched"
    _check_packed(name, packed_t, wh, wl)
    wh, wl = _halves_2d(name, wh, wl)
    _check_inv(name, inv_n4, packed_t.shape[1])
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16")
    corrs = torch.as_tensor(corrs, device=packed_t.device)
    if corrs.shape != (wh.shape[0],):
        raise ValueError(f"{name}: one corr per query, got {tuple(corrs.shape)}")
    corrs = corrs.to(torch.int32)
    if plain or packed_t.device.type == "cpu":
        return _masked_plain(packed_t, wh, wl, corrs, inv_n4, int(n_valid), out_dtype)
    bias = 8 * wl.to(torch.int32).sum(dim=1, dtype=torch.int32) - corrs
    kind = _OUT_BF16 if out_dtype == torch.bfloat16 else _OUT_F32
    return _launch(name, packed_t, wh, wl, bias, inv_n4, int(n_valid), kind, out_dtype)


def int4_masked_scores_batched(packed_t: torch.Tensor, wh: torch.Tensor,
                               wl: torch.Tensor, corrs: torch.Tensor,
                               inv_n4: torch.Tensor, n_valid: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Batched masked prefilter scores: wh / wl [Q, D/2] int8, corrs [Q]
    int32 -> [Q, C] in out_dtype (float32 or bfloat16, rounded to nearest
    even from the float32 score). The kernel (int8 tensor cores) reads
    each catalog tile once for up to 64 queries."""
    return _masked_batched(packed_t, wh, wl, corrs, inv_n4, n_valid, out_dtype,
                           plain=False)


def int4_masked_scores_batched_plain(packed_t: torch.Tensor, wh: torch.Tensor,
                                     wl: torch.Tensor, corrs: torch.Tensor,
                                     inv_n4: torch.Tensor, n_valid: int,
                                     out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of int4_masked_scores_batched on any device."""
    return _masked_batched(packed_t, wh, wl, corrs, inv_n4, n_valid, out_dtype,
                           plain=True)
