"""Audio DSP on the device: framing, the integer matmul-DFT spectrogram,
the float spectrogram, the Slaney mel bank, the linear resampler.

Port of ucfp_tpu/ops/audio/dsp.py. The host helpers (the Hann window, the
DFT bases and their int8 limbs, the i16 sample quantizer, the mel bank,
the linear resampler) are copies of the reference's numpy code. The device
functions take [n] or [B, n] tensors (a batch of equal-length clips is the
reference's vmap written out) and run where their input lies.

stft_power_int is the fingerprint path's spectrogram and is exact integer
arithmetic, so the card, the CPU and the reference agree to the bit:
  1. samples quantize to 14-bit ints (x_q = round(clip(x, -1, 1) * 16383));
  2. the window-combined DFT basis quantizes to 15-bit ints;
  3. both split into int8 limbs (B = 128 * hi + lo, lo in [0, 127]); the
     two frame limbs, stacked into one [2T, n_fft] operand, meet the four
     basis limbs side by side ([n_fft, 4K], zero columns up to a multiple
     of 8) in ONE int8 x int8 -> int32 product, exact since
     |partial dot| <= n_fft * 128^2 < 2^31 (ops.knn.int8_dots:
     torch._int_mm on the card; on the CPU a float64 product of the same
     integers, exact);
  4. the limbs recombine in int64 and re / im truncate by `shift`
     (>= 14: the int32 combine32 identity, as the reference writes it);
  5. power = re^2 + im^2 in int64.
Framing is Tensor.unfold, a view (the reference's _frame_rows).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import knn


@functools.lru_cache(maxsize=None)
def hann_periodic(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * math.pi * i / n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases: cos[n_fft, K], -sin[n_fft, K] with K = n_fft//2 + 1."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * math.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


SAMPLE_Q = 16383  # 14-bit sample quantization
BASIS_Q = 16383  # 15-bit (signed) basis quantization


@functools.lru_cache(maxsize=None)
def dft_basis_int_limbs(n_fft: int):
    """Window-combined quantized DFT bases split into int8 limbs.

    Returns (ch, cl, sh, sl), each [n_fft, K] int8 with
    B_q = 128*bh + bl, bl in [0, 127]."""
    c, s = dft_matrices(n_fft)  # f32 from f64 angles
    w = hann_periodic(n_fft).astype(np.float64)[:, None]
    out = []
    for b in (c.astype(np.float64) * w, s.astype(np.float64) * w):
        bq = np.round(b * BASIS_Q).astype(np.int32)
        bh = np.floor_divide(bq, 128)
        bl = bq - 128 * bh
        assert bh.min() >= -128 and bh.max() <= 127
        out.append((bh.astype(np.int8), bl.astype(np.int8)))
    (ch, cl), (sh, sl) = out
    return ch, cl, sh, sl


@functools.lru_cache(maxsize=None)
def dft_basis_int_combined(n_fft: int):
    """[n_fft, 4K] int8: the four limb bases side by side ([ch | cl | sh | sl])."""
    return np.concatenate(dft_basis_int_limbs(n_fft), axis=1)


@functools.lru_cache(maxsize=None)
def _basis_cols(n_fft: int) -> np.ndarray:
    """The combined basis transposed to [4K padded to a multiple of 8,
    n_fft] int8 rows (zero rows change no dot): torch._int_mm's second
    operand is its transpose, the layout ops.knn.int8_dots uses."""
    b = dft_basis_int_combined(n_fft)
    n = knn.padded_dim(b.shape[1])
    out = np.zeros((n, n_fft), np.int8)
    out[: b.shape[1]] = b.T
    return out


_device_consts: dict = {}


def device_const(key, build, device) -> torch.Tensor:
    """A host constant (build() -> numpy array) as a tensor on `device`,
    uploaded once per (key, device)."""
    full = (key, str(torch.device(device)))
    t = _device_consts.get(full)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(build())).to(device)
        _device_consts[full] = t
    return t


def quantize_samples_i16(x: np.ndarray) -> np.ndarray:
    """Host-side copy of stft_power_int's sample quantization (14-bit
    values in an i16). int16 input is the s16 wire's sample at full scale
    (value = i / 32768): one multiply and round, bit-identical to decoding
    first; float input: nan_to_num, clip to [-1, 1], round half to even."""
    x = np.asarray(x)
    if x.dtype == np.int16:
        return np.round(
            x.astype(np.float32) * np.float32(SAMPLE_Q / 32768.0)
        ).astype(np.int16)
    xf = np.clip(np.nan_to_num(np.asarray(x, np.float32)), -1.0, 1.0)
    return np.round(xf * np.float32(SAMPLE_Q)).astype(np.int16)


def quantize_device(samples: torch.Tensor) -> torch.Tensor:
    """The device quantizer: integer input is the quantized x_q already;
    float input rounds clip(nan_to_num(x), -1, 1) * SAMPLE_Q half to even
    in float32 (the reference's jnp order) -> int32."""
    if not samples.dtype.is_floating_point:
        return samples.to(torch.int32)
    x = torch.clamp(torch.nan_to_num(samples.to(torch.float32)), -1.0, 1.0)
    q = torch.full((), SAMPLE_Q, dtype=torch.float32, device=x.device)
    return torch.round(x * q).to(torch.int32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's mode="reflect" padding of the last axis by `pad` on both
    sides, as an index map (the edge sample is not repeated; a signal
    shorter than pad + 1 reflects back and forth, as numpy does)."""
    n = x.shape[-1]
    if pad == 0:
        return x
    idx = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (n - 1)
        idx = torch.remainder(idx, period)
        idx = torch.where(idx < n, idx, period - idx)
    return x.index_select(-1, idx)


def frames_of(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., n] -> [..., T, n_fft] frames, frames[i] = x[i*hop : i*hop + n_fft]
    (a view; T = (n - n_fft) // hop + 1)."""
    return x.unfold(-1, n_fft, hop)


def _split_i8(v: torch.Tensor):
    """int32 (|v| < 2^14) -> (high, low) int8 limbs, v = 128 * high + low,
    low in [0, 127]."""
    return (v >> 7).to(torch.int8), (v & 127).to(torch.int8)


def stft_power_int(samples: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                   center: bool = True, shift: int = 8) -> torch.Tensor:
    """Bit-exact integer power spectrogram [T, K] int64 ([B, T, K] for a
    [B, n] batch of equal-length clips).

    `shift` is the canonical re/im truncation (8 at n_fft 1024, the
    fingerprint default; Haitsma's 2048-point frames pass 14). Integer
    input (the i16 of quantize_samples_i16) is the quantized x_q; float
    input quantizes here, value-identically."""
    xq = quantize_device(samples)
    if center:
        xq = reflect_pad(xq, n_fft // 2)
    frames = frames_of(xq, n_fft, hop)  # [..., T, n_fft] int32 view
    lead = frames.shape[:-1]
    f2 = frames.reshape(-1, n_fft)
    rows = f2.shape[0]
    fh, fl = _split_i8(f2)
    k = n_fft // 2 + 1
    bcols = device_const(("dft_cols", n_fft), lambda: _basis_cols(n_fft), f2.device)
    # ONE product for both frame limbs: rows [fh; fl] x [ch | cl | sh | sl]
    both = knn.int8_dots(torch.cat([fh, fl]), bcols)
    hq, lq = both[:rows], both[rows:]
    # re limbs: hh = fh@ch, mid = fh@cl + fl@ch, ll = fl@cl
    re_hh, re_mid, re_ll = hq[:, :k], hq[:, k:2 * k] + lq[:, :k], lq[:, k:2 * k]
    # im limbs: hh = fh@sh, mid = fh@sl + fl@sh, ll = fl@sl
    im_hh, im_mid, im_ll = (hq[:, 2 * k:3 * k], hq[:, 3 * k:4 * k] + lq[:, 2 * k:3 * k],
                            lq[:, 3 * k:4 * k])

    if shift >= 14:
        # the reference's int32-exact recombine: full >> 14 == hh +
        # ((mid + (ll >> 7)) >> 7) for ll >= 0, and arithmetic shifts compose
        def combine32(hh, mid, ll):
            return (hh + ((mid + (ll >> 7)) >> 7)) >> (shift - 14)

        re = combine32(re_hh, re_mid, re_ll).to(torch.int64)
        im = combine32(im_hh, im_mid, im_ll).to(torch.int64)
    else:
        def combine(hh, mid, ll):
            full = ((hh.to(torch.int64) << 14) + (mid.to(torch.int64) << 7)
                    + ll.to(torch.int64))
            return full >> shift

        re = combine(re_hh, re_mid, re_ll)
        im = combine(im_hh, im_mid, im_ll)
    return (re * re + im * im).reshape(*lead, k)


def stft_power(samples: torch.Tensor, n_fft: int = 1024, hop: int = 256,
               center: bool = True) -> torch.Tensor:
    """Power spectrogram [T, K] float32 from mono f32 samples (the float
    matmul-DFT of the inspect and neural paths, not the fingerprint path;
    float32 products in full precision, TF32 off)."""
    x = samples.to(torch.float32)
    if center:
        x = reflect_pad(x, n_fft // 2)
    win = device_const(("hann", n_fft), lambda: hann_periodic(n_fft), x.device)
    frames = frames_of(x, n_fft, hop) * win
    c, s = dft_matrices(n_fft)
    cd = device_const(("dft_c", n_fft), lambda: c, x.device)
    sd = device_const(("dft_s", n_fft), lambda: s, x.device)
    re = frames @ cd
    im = frames @ sd
    return re * re + im * im


# ---------------------------------------------------------------------------
# Slaney mel filter bank (host numpy, copied)
# ---------------------------------------------------------------------------


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    mel = np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )
    return mel


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_mels: int, n_fft: int, sr: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-style triangular mel bank [K, n_mels], area-normalized."""
    k = n_fft // 2 + 1
    fft_freqs = np.arange(k, dtype=np.float64) * sr / n_fft
    mels = np.linspace(
        _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2
    )
    hz = _mel_to_hz_slaney(mels)
    bank = np.zeros((k, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz[m], hz[m + 1], hz[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        tri = np.maximum(0.0, np.minimum(up, down))
        bank[:, m] = tri * (2.0 / max(hi - lo, 1e-9))  # slaney norm
    return bank.astype(np.float32)


def mel_spectrogram(power: torch.Tensor, n_mels: int, n_fft: int, sr: int,
                    fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    fmax = fmax if fmax is not None else sr / 2
    bank = device_const(("mel", n_mels, n_fft, sr, float(fmin), float(fmax)),
                        lambda: mel_filterbank(n_mels, n_fft, sr, float(fmin),
                                               float(fmax)), power.device)
    return power.to(torch.float32) @ bank


# ---------------------------------------------------------------------------
# Linear resample (host numpy, copied)
# ---------------------------------------------------------------------------


def resample_linear(samples: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """audiofp::dsp::resample::linear equivalent (audio.rs:193-201)."""
    if sr_in == sr_out:
        return np.asarray(samples, np.float32)
    x = np.asarray(samples, np.float64)
    n_out = int(round(len(x) * sr_out / sr_in))
    if n_out <= 0:
        return np.zeros(0, np.float32)
    pos = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    i0 = np.minimum(pos.astype(np.int64), len(x) - 1)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    frac = pos - i0
    return ((1.0 - frac) * x[i0] + frac * x[i1]).astype(np.float32)
