"""Integer Cooley-Tukey FFT power spectrogram, "ucfp-int-fft-v1".

Port of ucfp_tpu/ops/audio/intfft.py: the flagged alternative to
dsp.stft_power_int for the Haitsma path (HaitsmaConfig(fft=True)), the
same exactness spec and so the same bits. N = N1 * N2 with N1 = 64:

  stage 1:  C[t,q,r] = (sum_p xw[t, N2 p + q] * A_q[r,p]) >> s1, the
            twiddle folded into a per-q basis A_q; a different basis for
            each q, and torch._int_mm has no batched form, so the port
            loops over the N2 bases: one exact int8-limb product
            (ops.knn.int8_dots) of [2T, N1] frame limbs against
            [4 * N1, N1] basis columns per q;
  stage 2:  D[t,r,s] = (C_re @ c2 +- C_im @ s2) >> 14 packed into one real
            product, one basis for every r: ONE 2-D limb product of
            [N1 * T, 2 * N2] rows;
  power:    re^2 + im^2 in int64.

s1 = max(14, bit_length(max |xw| over the clip) + 6) is the per-clip block
exponent, computed on the device by integer compares (per clip for a
batch). The bases are the reference's host tables (copied), and
stft_power_int_fft_mirror is its plain-int64 numpy rendering of the spec.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import knn
from . import dsp

N1 = 64  # fixed radix of stage 1 (bounds below assume it)
Q = 16383  # basis quantization (matches dsp.BASIS_Q)


@functools.lru_cache(maxsize=None)
def _window_q(n_fft: int) -> np.ndarray:
    return np.round(
        dsp.hann_periodic(n_fft).astype(np.float64) * Q
    ).astype(np.int32)


def _limbs(b: np.ndarray) -> list[np.ndarray]:
    """int matrix (|b| <= 16383) -> [high, low] int8 limbs, b = 128*h + l,
    l in [0, 127] (the dsp.dft_basis_int_limbs split)."""
    h = np.floor_divide(b, 128)
    l = b - 128 * h
    assert h.min() >= -128 and h.max() <= 127
    return [h.astype(np.int8), l.astype(np.int8)]


def _stage1_angles(n_fft: int) -> np.ndarray:
    """[N2, N1(r), N1(p)] f64 angles of A_q[r,p] = W_N1^{pr} W_N^{qr}."""
    n2 = n_fft // N1
    r = np.arange(N1, dtype=np.float64)
    p = np.arange(N1, dtype=np.float64)
    q = np.arange(n2, dtype=np.float64)
    return (2.0 * math.pi / N1) * np.einsum("r,p->rp", r, p)[None] + (
        2.0 * math.pi / n_fft) * np.einsum("q,r->qr", q, r)[:, :, None]


@functools.lru_cache(maxsize=None)
def _stage1_basis(n_fft: int) -> np.ndarray:
    """[N2, N1(p), 4*N1] int8 batched twiddle-folded basis:
    per q, [Ch | Sh | Cl | Sl] columns over r, transposed to contract p;
    C = round(cos * Q), S = round(-sin * Q)."""
    ang = _stage1_angles(n_fft)
    c = np.round(np.cos(ang) * Q).astype(np.int64)
    s = np.round(-np.sin(ang) * Q).astype(np.int64)
    ch, cl = _limbs(c)  # each [N2, r, p]
    sh, sl = _limbs(s)
    return np.concatenate(
        [b.transpose(0, 2, 1) for b in (ch, sh, cl, sl)],
        axis=2)  # [N2, p, 4*N1]


@functools.lru_cache(maxsize=None)
def _stage2_basis(n_fft: int) -> np.ndarray:
    """[2*N2, 2*2*N2] int8: limbs of B2 = [[c2, -s2], [s2, c2]] where
    c2/s2 = round(cos/sin(2 pi q s / N2) * Q) — U @ B2 = [D_re | D_im]."""
    n2 = n_fft // N1
    qs = np.outer(np.arange(n2, dtype=np.float64), np.arange(n2))
    ang = 2.0 * math.pi * qs / n2
    c2 = np.round(np.cos(ang) * Q).astype(np.int64)
    s2 = np.round(np.sin(ang) * Q).astype(np.int64)
    b2 = np.block([[c2, -s2], [s2, c2]])  # [2*N2, 2*N2]
    return np.concatenate(_limbs(b2), axis=1)  # [2*N2, 4*N2]


def _combine14(hh, mid, ll):
    """Exact floor(full / 2^14) of full = hh*2^14 + mid*2^7 + ll in int32
    (the dsp.stft_power_int combine32 identity; ll >= 0 required)."""
    return hh + ((mid + (ll >> 7)) >> 7)


def _limb_matmul14(v: torch.Tensor, basis_cols: torch.Tensor, k: int) -> torch.Tensor:
    """Exact (v @ B) >> 14 for v [M, n] int32 (|v| < 2^14) and B given as
    side-by-side limb columns [Bh | Bl] transposed to rows ([2k, n] int8):
    one product of the stacked frame limbs [vh; vl]."""
    m = v.shape[0]
    vh, vl = dsp._split_i8(v)
    both = knn.int8_dots(torch.cat([vh, vl]), basis_cols)
    hq, lq = both[:m], both[m:]
    return _combine14(hq[:, :k], hq[:, k:] + lq[:, :k], lq[:, k:])


def stft_power_int_fft(samples: torch.Tensor, n_fft: int = 2048, hop: int = 64,
                       center: bool = False) -> torch.Tensor:
    """ucfp-int-fft-v1 power spectrogram [T, K] int64 (K = n_fft//2+1;
    [B, T, K] for a [B, n] batch, each clip with its own block exponent).

    Accepts pre-quantized i16 (dsp.quantize_samples_i16) or f32 samples,
    exactly like dsp.stft_power_int. Requires n_fft % 64 == 0 and
    n_fft//64 <= 128 (limb accumulator bounds)."""
    n2 = n_fft // N1
    assert n_fft % N1 == 0 and 1 < n2 <= 128, n_fft
    dev = samples.device
    xq = dsp.quantize_device(samples)
    single = xq.dim() == 1
    if single:
        xq = xq[None]
    if center:
        xq = dsp.reflect_pad(xq, n_fft // 2)
    frames = dsp.frames_of(xq, n_fft, hop)  # [B, T, n_fft] int32 view
    b, t = frames.shape[0], frames.shape[1]
    wq = dsp.device_const(("window_q", n_fft), lambda: _window_q(n_fft), dev)
    xw = (frames * wq) >> 14

    # per-clip block exponent: s1 = max(14, bit_length(max|xw|) + 6)
    m = xw.abs().amax(dim=(1, 2))  # [B]
    pows = torch.ones(15, dtype=torch.int32, device=dev) << torch.arange(
        15, dtype=torch.int32, device=dev)
    amp_bits = (m[:, None] >= pows[None]).sum(dim=1)
    s1 = torch.clamp(amp_bits + 6, min=14).to(torch.int32)
    sh1 = (s1 - 14).view(b, 1, 1)

    # stage 1 (+ folded twiddle), one basis per q: xw[b, t, N2 p + q]
    xt = xw.reshape(b * t, N1, n2)
    basis1 = dsp.device_const(
        ("ifft_b1", n_fft),
        lambda: np.ascontiguousarray(_stage1_basis(n_fft).transpose(0, 2, 1)), dev)
    c_parts = [
        _limb_matmul14(xt[:, :, q].contiguous(), basis1[q], 2 * N1).view(b, t, 2 * N1)
        for q in range(n2)
    ]
    cq = torch.stack(c_parts, dim=2)  # [B, T, N2(q), 2*N1]
    c_re = cq[..., :N1] >> sh1[..., None]  # floor(full / 2^s1); |C| <= 16380
    c_im = cq[..., N1:] >> sh1[..., None]

    # stage 2: one basis for every r, packed contraction [C_re | C_im]
    v = torch.cat([c_re.permute(0, 3, 1, 2), c_im.permute(0, 3, 1, 2)],
                  dim=3)  # [B, N1(r), T, 2*N2]
    basis2 = dsp.device_const(
        ("ifft_b2", n_fft), lambda: np.ascontiguousarray(_stage2_basis(n_fft).T), dev)
    d = _limb_matmul14(v.reshape(-1, 2 * n2), basis2, 2 * n2).view(b, N1, t, 2 * n2)
    d_re, d_im = d[..., :n2], d[..., n2:]

    # D[r, t, s] -> X[t, N1 s + r]; keep bins [0, K)
    k = n_fft // 2 + 1
    re64 = d_re.permute(0, 2, 3, 1).reshape(b, t, n_fft)[:, :, :k].to(torch.int64)
    im64 = d_im.permute(0, 2, 3, 1).reshape(b, t, n_fft)[:, :, :k].to(torch.int64)
    power = re64 * re64 + im64 * im64
    return power[0] if single else power


def stft_power_int_fft_mirror(samples: np.ndarray, n_fft: int = 2048,
                              hop: int = 64, center: bool = False
                              ) -> np.ndarray:
    """Plain-int64 numpy rendering of the EXACT same spec — no limb
    splitting (copied from the reference)."""
    n2 = n_fft // N1
    x = np.asarray(samples)
    if np.issubdtype(x.dtype, np.integer):
        xq = x.astype(np.int64)
    else:
        xq = np.round(
            np.clip(np.nan_to_num(x.astype(np.float32)), -1.0, 1.0)
            * dsp.SAMPLE_Q
        ).astype(np.int64)
    if center:
        pad = n_fft // 2
        xq = np.pad(xq, (pad, pad), mode="reflect")
    t = (len(xq) - n_fft) // hop + 1
    idx = np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :]
    xw = (xq[idx] * _window_q(n_fft)[None, :].astype(np.int64)) >> 14

    m = int(np.max(np.abs(xw))) if xw.size else 0
    s1 = max(14, m.bit_length() + 6)

    ang = _stage1_angles(n_fft)
    a_re = np.round(np.cos(ang) * Q).astype(np.int64)  # [N2, r, p]
    a_im = np.round(-np.sin(ang) * Q).astype(np.int64)
    xmat = xw.reshape(t, N1, n2)  # [t, p, q]
    c_re = np.einsum("tpq,qrp->tqr", xmat, a_re) >> s1
    c_im = np.einsum("tpq,qrp->tqr", xmat, a_im) >> s1

    qs = np.outer(np.arange(n2, dtype=np.float64), np.arange(n2))
    c2 = np.round(np.cos(2.0 * math.pi * qs / n2) * Q).astype(np.int64)
    s2 = np.round(np.sin(2.0 * math.pi * qs / n2) * Q).astype(np.int64)
    d_re = (np.einsum("tqr,qs->trs", c_re, c2)
            + np.einsum("tqr,qs->trs", c_im, s2)) >> 14
    d_im = (np.einsum("tqr,qs->trs", c_im, c2)
            - np.einsum("tqr,qs->trs", c_re, s2)) >> 14

    k = n_fft // 2 + 1
    d_re = d_re.transpose(0, 2, 1).reshape(t, n_fft)[:, :k]
    d_im = d_im.transpose(0, 2, 1).reshape(t, n_fft)[:, :k]
    return d_re * d_re + d_im * d_im
