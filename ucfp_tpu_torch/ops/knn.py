"""Exact k-NN kernels (port of the exact part of ucfp_tpu/ops/knn.py).

  * cosine_topk       — one [Q, D] x [D, C] f32 product + top-k;
  * hamming_topk      — XOR + popcount over packed u32 words, top-k
    smallest;
  * cosine_topk_fused — the f32 cosine scores fed to the fused
    per-(tile, lane) candidate scan (ops.fused_scan), for catalogs of
    32,768 rows or more.

Semantics match the reference: score = dot / (|q| * |v|); invalid and
zero-norm rows score -inf; invalid Hamming rows score 0x7fffffff; ties
keep the lower row (a stable sort stands in for lax.top_k, which keeps
the lower index on ties).

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


def pack_bits_to_u32(fp: bytes) -> np.ndarray:
    """Fingerprint bytes -> little-endian uint32 words (zero-padded).
    Copied from ucfp_tpu/ops/knn.py."""
    pad = (-len(fp)) % 4
    if pad:
        fp = fp + b"\x00" * pad
    return np.frombuffer(fp, dtype="<u4")
