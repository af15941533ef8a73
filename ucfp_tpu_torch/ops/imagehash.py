"""Batched perceptual image hashes (port of ucfp_tpu/ops/imagehash.py).

The same canonically exact integer pipeline, batched over B images:

    u8 luma [B,H,W]
      -> fixed-point tent-filter resize      (two products per target size)
      -> 9-bit fixed-point 8x32 DCT          (two products)
      -> median threshold / gradient / mean  (sort + compare)
      -> packed u8 hash bytes

Every stage is integer arithmetic, so the port produces the reference's
bytes on any device (tests/goldens/conformance.json locks them).

Integer products on CUDA: PyTorch has no integer matmul on the card, so
the resize and DCT products run as float64 matmuls whose results convert
back to int64 before the `>> 15` rounding. This is exact: every term is
an integer, resize partial sums stay below 255 * 2^15 and DCT partial sums
below 2^36, far under float64's 2^53 integer range. float32 would not do:
the DCT's second stage exceeds 2^24.

Fixed-point tables and the numpy oracle are copied unchanged from the
reference module (they are part of the wire contract).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from .fused_scan import _popcount32

# ---------------------------------------------------------------------------
# Fixed-point constants (the canonical spec) — copied from the reference
# ---------------------------------------------------------------------------

RESIZE_SHIFT = 15  # tent-filter weights in units of 2^-15
RESIZE_ONE = 1 << RESIZE_SHIFT
RESIZE_ROUND = 1 << (RESIZE_SHIFT - 1)
DCT_SHIFT = 9  # DCT basis in units of 2^-9


@functools.lru_cache(maxsize=None)
def dct_matrix_q(n: int = 32) -> np.ndarray:
    """Orthonormal DCT-II basis quantized to int32 at 2^-9 resolution.

    D[u, x] = s(u) * cos(pi * (2x + 1) * u / (2n)),
    s(0) = sqrt(1/n), s(u>0) = sqrt(2/n).
    """
    d = np.zeros((n, n), dtype=np.float64)
    for u in range(n):
        s = math.sqrt(1.0 / n) if u == 0 else math.sqrt(2.0 / n)
        for x in range(n):
            d[u, x] = s * math.cos(math.pi * (2 * x + 1) * u / (2 * n))
    return np.round(d * (1 << DCT_SHIFT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def resize_matrix_q(n_in: int, n_out: int) -> np.ndarray:
    """Tent-filter (triangle/bilinear) resampling matrix, fixed point.

    Output pixel i's center maps to (i + 0.5) * (n_in / n_out) - 0.5 in
    input coordinates; filter radius = max(1, scale). Rows are
    L1-normalized then rounded to 2^-15 with the largest weight adjusted
    so each row sums to exactly 2^15.
    """
    scale = n_in / n_out
    radius = max(1.0, scale)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale - 0.5
        lo = int(math.floor(center - radius))
        hi = int(math.ceil(center + radius))
        for j in range(lo, hi + 1):
            jj = min(max(j, 0), n_in - 1)  # clamp-to-edge
            t = abs(j - center) / radius
            if t < 1.0:
                w[i, jj] += 1.0 - t
    w /= w.sum(axis=1, keepdims=True)
    q = np.round(w * RESIZE_ONE).astype(np.int64)
    # force exact row sums of 2^15 by adjusting the largest weight
    for i in range(n_out):
        q[i, int(np.argmax(q[i]))] += RESIZE_ONE - q[i].sum()
    return q.astype(np.int32)


# ---------------------------------------------------------------------------
# Device stages (torch, batched over B)
# ---------------------------------------------------------------------------


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b (batched) through float64 (see module doc)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


def luma_u8(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 integer luma: (299R + 587G + 114B + 500) // 1000.

    [..., 3] uint8 -> int64 [...] in [0, 255]. Exact.
    """
    r = rgb[..., 0].to(torch.int64)
    g = rgb[..., 1].to(torch.int64)
    b = rgb[..., 2].to(torch.int64)
    return (299 * r + 587 * g + 114 * b + 500) // 1000


def resize_exact(gray: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """Fixed-point separable tent resize. gray [B,H,W] int -> [B,h,w] int64,
    per-stage rounding; values stay in [0, 255]."""
    t = (_int_matmul(wh, gray) + RESIZE_ROUND) >> RESIZE_SHIFT  # [B, h, W]
    o = _int_matmul(t, ww.T)  # [B, h, w]
    return (o + RESIZE_ROUND) >> RESIZE_SHIFT


def _pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """bits [B, 64] {0,1}, LSB-first -> [B, 8] uint8 (u64 LE bytes)."""
    b = bits.reshape(bits.shape[0], 8, 8).to(torch.int64)
    shifts = torch.arange(8, device=bits.device)
    return (b << shifts).sum(dim=2).to(torch.uint8)


def phash_bits(gray32: torch.Tensor) -> torch.Tensor:
    """pHash: [B, 32, 32] int luma -> [B, 64] bits (bit 63 always 0).

    Top-left 8x8 of the 2D DCT, DC excluded, median threshold over the
    63 remaining coefficients, on mean-128-centered input."""
    d8 = torch.as_tensor(dct_matrix_q(32)[:8], device=gray32.device)  # [8, 32]
    x = gray32.to(torch.int64) - 128
    t = _int_matmul(d8, x)  # [B, 8, 32]
    p = _int_matmul(t, d8.T)  # [B, 8, 8]
    flat = p.reshape(p.shape[0], 64)
    vals = flat[:, 1:]  # exclude DC -> 63 values
    med = torch.sort(vals, dim=1).values[:, 31:32]  # middle order statistic
    bits63 = (vals > med).to(torch.int64)
    return torch.cat(
        [bits63, torch.zeros((p.shape[0], 1), dtype=torch.int64, device=p.device)],
        dim=1,
    )


def dhash_bits(gray9x8: torch.Tensor) -> torch.Tensor:
    """dHash: [B, 8, 9] (8 tall, 9 wide) -> [B, 64] bits, row-major
    bit = resized[row, col] > resized[row, col + 1]."""
    bits = (gray9x8[:, :, :8] > gray9x8[:, :, 1:]).to(torch.int64)
    return bits.reshape(bits.shape[0], 64)


def ahash_bits(gray8: torch.Tensor) -> torch.Tensor:
    """aHash: [B, 8, 8] -> [B, 64] bits; integer mean, bit = pixel > mean."""
    flat = gray8.reshape(gray8.shape[0], 64).to(torch.int64)
    mean = flat.sum(dim=1, keepdim=True) // 64
    return (flat > mean).to(torch.int64)


def global_hist64(gray32: torch.Tensor) -> torch.Tensor:
    """64-bin luma histogram over the 32x32 grid, L1-normalized f32 (counts
    are multiples of 1/1024, exact in f32)."""
    bins = gray32.reshape(gray32.shape[0], 1024).to(torch.int64) >> 2  # 0..63
    counts = torch.zeros((gray32.shape[0], 64), dtype=torch.int64,
                         device=gray32.device)
    counts.scatter_add_(1, bins, torch.ones_like(bins))
    return counts.to(torch.float32) / 1024.0


def block_means(gray64: torch.Tensor) -> torch.Tensor:
    """16x16 grid of 4x4-block integer means over a 64x64 resize -> [B,256] u8."""
    b = gray64.reshape(gray64.shape[0], 16, 4, 16, 4).to(torch.int64)
    sums = b.sum(dim=(2, 4))
    return (sums >> 4).to(torch.uint8).reshape(gray64.shape[0], 256)


def _resize_q(gray: torch.Tensor, n_in: tuple[int, int], n_out: tuple[int, int]):
    dev = gray.device
    wh = torch.as_tensor(resize_matrix_q(n_in[0], n_out[0]), device=dev)
    ww = torch.as_tensor(resize_matrix_q(n_in[1], n_out[1]), device=dev)
    return resize_exact(gray, wh, ww)


def _multihash_from_gray(gray: torch.Tensor, in_h: int, in_w: int) -> dict:
    """Shared bundle body over integer luma [B, H, W]."""
    g32 = _resize_q(gray, (in_h, in_w), (32, 32))
    g8 = _resize_q(gray, (in_h, in_w), (8, 8))
    g9x8 = _resize_q(gray, (in_h, in_w), (8, 9))  # 8 tall, 9 wide
    g64 = _resize_q(gray, (in_h, in_w), (64, 64))
    return {
        "phash": _pack_bits_u8(phash_bits(g32)),
        "dhash": _pack_bits_u8(dhash_bits(g9x8)),
        "ahash": _pack_bits_u8(ahash_bits(g8)),
        "hist": global_hist64(g32),
        "block": block_means(g64),
    }


def multihash_kernel(rgb, in_h: int, in_w: int, device=None) -> dict:
    """Full multi-hash bundle for a batch of same-shape RGB uint8
    [B, H, W, 3] -> dict of tensors on `device` (serialize_multihash
    packs one row into the 536-byte wire layout)."""
    dev = resolve_device(device)
    return _multihash_from_gray(luma_u8(_as_tensor(rgb, dev)), in_h, in_w)


def multihash_kernel_gray(gray_u8, in_h: int, in_w: int, device=None) -> dict:
    """Bundle from host-computed BT.601 luma [B, H, W] uint8 (identical
    bytes: the luma formula is pure integer math)."""
    dev = resolve_device(device)
    return _multihash_from_gray(_as_tensor(gray_u8, dev).to(torch.int64), in_h, in_w)


def multihash_kernel_pre(g32, g9x8, g8, g64, device=None) -> dict:
    """Bundle from host-pre-resized planes [B,32,32] / [B,8,9] / [B,8,8] /
    [B,64,64] uint8 (modality.image.multi_pre_planes: the exact
    fixed-point tent, byte-identical to the device resize)."""
    dev = resolve_device(device)
    g32 = _as_tensor(g32, dev).to(torch.int64)
    return {
        "phash": _pack_bits_u8(phash_bits(g32)),
        "dhash": _pack_bits_u8(dhash_bits(_as_tensor(g9x8, dev).to(torch.int64))),
        "ahash": _pack_bits_u8(ahash_bits(_as_tensor(g8, dev).to(torch.int64))),
        "hist": global_hist64(g32),
        "block": block_means(_as_tensor(g64, dev).to(torch.int64)),
    }


_SINGLE_TARGET = {"phash": (32, 32), "dhash": (8, 9), "ahash": (8, 8)}
_SINGLE_BITS = {"phash": phash_bits, "dhash": dhash_bits, "ahash": ahash_bits}


def _single_from_gray(gray: torch.Tensor, in_h: int, in_w: int, algo: str):
    if algo not in _SINGLE_TARGET:
        raise ValueError(f"unknown algorithm {algo!r}")
    g = _resize_q(gray, (in_h, in_w), _SINGLE_TARGET[algo])
    return _pack_bits_u8(_SINGLE_BITS[algo](g))


def single_hash_kernel(rgb, in_h: int, in_w: int, algo: str, device=None):
    """One 64-bit hash per image: algo in {phash, dhash, ahash} -> [B,8] u8."""
    dev = resolve_device(device)
    return _single_from_gray(luma_u8(_as_tensor(rgb, dev)), in_h, in_w, algo)


def single_hash_kernel_gray(gray_u8, in_h: int, in_w: int, algo: str,
                            device=None):
    """Single hash from host-computed luma [B, H, W] uint8."""
    dev = resolve_device(device)
    return _single_from_gray(_as_tensor(gray_u8, dev).to(torch.int64),
                             in_h, in_w, algo)


# ---------------------------------------------------------------------------
# Weighted multi-hash comparison (query time)
# ---------------------------------------------------------------------------
#
# Packed u32 catalog rows ([C, 134] words, int32 storage) hold
#   words [0:2) phash  [2:4) dhash  [4:6) ahash
#   words [6:70)  histogram, 64 f32 (read with .view(torch.float32))
#   words [70:134) block means, 4 u8 per word (256 blocks)
# and score
#   score = wp*(1-hd_p/64) + wd*(1-hd_d/64) + wa*(1-hd_a/64)
#         + wg*max(0, 1 - L1(hist)/2) + wb*mean(|block diff| <= thresh)

MULTIHASH_WORDS = 134


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 a * b + c on any device: the product is
    exact in float64, TwoSum gives the float64 sum's rounding error, and
    rounding that sum to odd before the final float64 -> float32 rounding
    makes the double rounding exact (float64 has more than 24 + 2 bits)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def multihash_weighted_topk(qm: torch.Tensor, db: torch.Tensor,
                            valid: torch.Tensor, params: torch.Tensor, k: int):
    """qm [Q, 134] int32, db [C, 134] int32, valid [C] bool, params [6] f32
    (wp, wd, wa, wg, wb, block_thresh) -> (scores [Q, k] f32 descending,
    idx [Q, k] int64).

    Float order is the reference's (imagehash.py:344-388): the histogram
    L1 adds its 64 terms one at a time in order j = 0..63, the block-match
    count adds its 256 terms in order, then the weighted sum runs left to
    right. Instead of the reference's unpacked [C, 256] block bytes (1 GiB
    at 2^20 rows) each step unpacks one word's four bytes, in the same
    order; the histogram and block words are transposed once per call so
    each step reads one contiguous column."""
    qn, c = qm.shape[0], db.shape[0]
    dev = db.device

    def ham64(a, b):  # a [Q, 2], b [C, 2] -> [Q, C] f32 similarity
        d = torch.zeros((qn, c), dtype=torch.int64, device=dev)
        for w in range(2):
            d += _popcount32(torch.bitwise_xor(a[:, w, None], b[None, :, w]))
        return 1.0 - d.to(torch.float32) / 64.0

    psim = ham64(qm[:, 0:2], db[:, 0:2])
    dsim = ham64(qm[:, 2:4], db[:, 2:4])
    asim = ham64(qm[:, 4:6], db[:, 4:6])

    qh = qm[:, 6:70].contiguous().view(torch.float32)  # [Q, 64]
    dh = db[:, 6:70].T.contiguous().view(torch.float32)  # [64, C]
    l1 = torch.zeros((qn, c), dtype=torch.float32, device=dev)
    for j in range(64):
        l1 = l1 + torch.abs(qh[:, j, None] - dh[None, j, :])
    gsim = torch.clamp(1.0 - 0.5 * l1, 0.0, 1.0)

    qb = qm[:, 70:134]
    dbw = db[:, 70:134].T.contiguous()  # [64, C]
    thresh = params[5]
    nmatch = torch.zeros((qn, c), dtype=torch.float32, device=dev)
    for jw in range(64):
        for s in range(4):  # block j = 4 * jw + s, little-endian bytes
            qv = (qb[:, jw, None] >> (8 * s)) & 0xFF
            dv = (dbw[None, jw, :] >> (8 * s)) & 0xFF
            diff = torch.abs(qv - dv).to(torch.float32)
            nmatch = nmatch + (diff <= thresh).to(torch.float32)
    bsim = nmatch / 256.0

    # the reference's weighted sum as XLA compiles it on the CPU: the
    # second product is rounded, every other "w * sim" contracts into a
    # fused multiply-add onto the running sum
    score = params[1] * dsim
    for w, sim in ((params[0], psim), (params[2], asim), (params[3], gsim),
                   (params[4], bsim)):
        score = _fma_f32(w, sim, score)
    score = torch.where(valid[None, :], score, float("-inf"))
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(score, 1, order), order


# reference MultiHashConfigDto defaults (dto.rs:465-480)
MULTIHASH_DEFAULT_WEIGHTS = {
    "phash_weight": 0.4,
    "dhash_weight": 0.3,
    "ahash_weight": 0.1,
    "global_weight": 0.1,
    "block_weight": 0.1,
    "block_distance_threshold": 12,
}


def multihash_params(weights: dict | None) -> "np.ndarray":
    """[6] f32 param vector from a MultiHashConfigDto-shaped dict."""
    w = dict(MULTIHASH_DEFAULT_WEIGHTS)
    if weights:
        for key in w:
            if key in weights:
                w[key] = float(weights[key])
    return np.asarray(
        [w["phash_weight"], w["dhash_weight"], w["ahash_weight"],
         w["global_weight"], w["block_weight"],
         w["block_distance_threshold"]],
        np.float32,
    )


# ---------------------------------------------------------------------------
# Wire serialization (host)
# ---------------------------------------------------------------------------

MULTIHASH_BYTES = 536  # 3*u64 + 64*f32 + 256*u8, matching the reference size


def serialize_multihash(out: dict, i: int) -> bytes:
    """Pack one image's bundle (host numpy arrays, see modality.image
    device_get) into the 536-byte MultiHashV1 layout:
      [0:8) phash u64  [8:16) dhash u64  [16:24) ahash u64
      [24:280) global_hist 64 x f32   [280:536) block_means 256 x u8
    """
    buf = bytearray()
    buf += bytes(np.asarray(out["phash"][i]))
    buf += bytes(np.asarray(out["dhash"][i]))
    buf += bytes(np.asarray(out["ahash"][i]))
    buf += np.asarray(out["hist"][i], dtype="<f4").tobytes()
    buf += bytes(np.asarray(out["block"][i]))
    if len(buf) != MULTIHASH_BYTES:
        raise ValueError(f"multihash bundle is {len(buf)} bytes, not {MULTIHASH_BYTES}")
    return bytes(buf)


# ---------------------------------------------------------------------------
# Pure-numpy oracle — copied from the reference (must match the device
# stages bit for bit: both are the same exact integer math)
# ---------------------------------------------------------------------------


def np_luma(rgb: np.ndarray) -> np.ndarray:
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(np.int64)


def np_luma_u8(rgb: np.ndarray) -> np.ndarray:
    """Vectorized host luma for the serving path: [..., 3] u8 -> u8."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(np.uint8)


def np_resize(gray: np.ndarray, h: int, w: int) -> np.ndarray:
    wh = resize_matrix_q(gray.shape[0], h).astype(np.int64)
    ww = resize_matrix_q(gray.shape[1], w).astype(np.int64)
    t = (wh @ gray + RESIZE_ROUND) >> RESIZE_SHIFT
    return (t @ ww.T + RESIZE_ROUND) >> RESIZE_SHIFT


def np_phash(gray32: np.ndarray) -> int:
    d8 = dct_matrix_q(32)[:8].astype(np.int64)
    p = d8 @ (gray32 - 128) @ d8.T
    vals = p.reshape(64)[1:]
    med = np.sort(vals)[31]
    h = 0
    for i, v in enumerate(vals):
        if v > med:
            h |= 1 << i
    return h


def np_dhash(g9x8: np.ndarray) -> int:
    h = 0
    bit = 0
    for r in range(8):
        for c in range(8):
            if g9x8[r, c] > g9x8[r, c + 1]:
                h |= 1 << bit
            bit += 1
    return h


def np_ahash(g8: np.ndarray) -> int:
    flat = g8.reshape(64)
    mean = int(flat.sum()) // 64
    h = 0
    for i, v in enumerate(flat):
        if v > mean:
            h |= 1 << i
    return h
