"""Exact k-NN kernels (port of the exact part of ucfp_tpu/ops/knn.py).

  * cosine_topk       — one [Q, D] x [D, C] f32 product + top-k;
  * hamming_topk      — XOR + popcount over packed u32 words, top-k
    smallest;
  * cosine_topk_fused — the f32 cosine scores fed to the fused
    per-(tile, lane) candidate scan (ops.fused_scan), for catalogs of
    32,768 rows or more;
  * the int8 tier: quantize_rows_int8 (host, numpy), the query
    quantization _quantize_query_rows, the exact int8 product int8_dots
    and the exhaustive cosine_topk_int8.

Semantics match the reference: score = dot / (|q| * |v|); invalid and
zero-norm rows score -inf; invalid Hamming rows score 0x7fffffff; ties
keep the lower row (a stable sort stands in for lax.top_k, which keeps
the lower index on ties).

int8 scores are bit-equal to the reference's for D <= 1040: every dot is
an int8 x int8 sum of at most 127^2 * D < 2^24, every squared norm too,
so float32 holds each exactly whatever the summation order; what is left
is one sqrt, one division and one multiplication, each correctly rounded
on the CPU and on CUDA (the kernels build without --use_fast_math). On
CUDA, PyTorch divides by a CPU scalar as a multiplication by its
reciprocal, so every division here has a tensor divisor.

Storage: catalogs are int32 tensors holding the u32 bit patterns (PyTorch's
uint32 supports few operations); bitwise ops on the patterns are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused_scan
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


def int8_norms(qq: torch.Tensor) -> torch.Tensor:
    """[Q, D] int8 -> [Q] f32 |row|: an exact integer sum, then sqrt."""
    f = qq.float()
    return torch.sqrt((f * f).sum(dim=1))


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
    INT_MM_MIN_M rows (the block gets zero rows, sliced off after), and
    an int32 matmul on the CPU. Never a float product: a float copy of
    the catalog would undo the tier."""
    q, d = qq.shape
    c, d8 = q8m.shape
    if qq.dtype != torch.int8 or q8m.dtype != torch.int8 or d > d8:
        raise ValueError(
            f"int8_dots takes int8 [Q, D] x [C, D8 >= D], got {qq.dtype} "
            f"{tuple(qq.shape)} and {q8m.dtype} {tuple(q8m.shape)}"
        )
    if q8m.device.type == "cpu":
        return qq.to(torch.int32) @ q8m[:, :d].to(torch.int32).T
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


def pack_bits_to_u32(fp: bytes) -> np.ndarray:
    """Fingerprint bytes -> little-endian uint32 words (zero-padded).
    Copied from ucfp_tpu/ops/knn.py."""
    pad = (-len(fp)) % 4
    if pad:
        fp = fp + b"\x00" * pad
    return np.frombuffer(fp, dtype="<u4")
