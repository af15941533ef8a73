"""Haitsma-Kalker (Philips) robust hash and its minimum-BER search.

Port of ucfp_tpu/ops/audio/haitsma.py. 5 kHz mono, 2048-sample frames at
hop 64, 33 log-spaced bands between fmin and fmax; bit[n, m] = 1 iff
(E[n,m] - E[n,m+1]) - (E[n-1,m] - E[n-1,m+1]) > 0, one word per frame
after the first. haitsma_words is exact integer arithmetic (the int64
band sums of dsp.stft_power_int, or of intfft.stft_power_int_fft with
fft=True), so its words equal the reference's on any device; it returns
them as int64 holding the u32 values (torch's uint32 has no shifts).

min_ber_batch slides a query block over every stored stream and keeps
each row's minimum bit-error rate and its first offset. The reference
runs it as a lax.fori_loop over offsets; on the card it is the kernel
csrc/min_ber.cu (ucfp_min_ber: errs = S + Pq - 2 D, D a product on the
binary AND-popcount tensor cores against the query shifted a word a
column, S a prefix sum; _min_ber_mma_plain mirrors that formulation for
the tests), on the CPU min_ber_batch_plain: chunks of offsets as an
unfold of the rows, XOR and the SWAR popcount of ops.fused_scan. The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from .. import fused_scan
from . import dsp

HAITSMA_SR = 5_000
FRAME = 2048
HOP = 64
N_BANDS = 33
#: the longest query (words) min_ber_batch takes: its errs stay below 2^22,
#: where one float32 division per row keeps distinct errs distinct, so the
#: kernel's integer order is the reference's order of BERs
MAX_QUERY_WORDS = 1 << 17
#: offsets x words per chunk of the plain version's unfold
PLAIN_CHUNK_ELEMS = 1 << 25
#: the kernel's layout (csrc/min_ber.cu), which _min_ber_mma_plain mirrors:
#: 8-shift tiles a warp (MB_T), so a warp covers 16 rows x 64 shifts, and
#: query words a pass (MB_QCHUNK)
MMA_SHIFT_TILES = 8
MMA_QCHUNK = 512
#: a k-step's 8 words in the fragments' register slots: slot l (a0 / b0 of
#: thread l) holds word 2l, slot 4 + l (a2 / b1) word 2l + 1
MMA_SLOT_WORDS = (0, 2, 4, 6, 1, 3, 5, 7)

#: kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"min_ber_batch": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


@dataclass(frozen=True)
class HaitsmaConfig:
    fmin: float = 300.0
    fmax: float = 2000.0
    # ucfp-int-fft-v1 spectrogram (ops/audio/intfft.py): a different
    # exactness spec, so the config_hash forks when enabled
    fft: bool = False


@functools.lru_cache(maxsize=None)
def band_matrix(fmin: float, fmax: float) -> np.ndarray:
    """[K, 33] 0/1 rectangular log-spaced band selectors."""
    k = FRAME // 2 + 1
    freqs = np.arange(k, dtype=np.float64) * HAITSMA_SR / FRAME
    edges = fmin * (fmax / fmin) ** (np.arange(N_BANDS + 1) / N_BANDS)
    m = np.zeros((k, N_BANDS), dtype=np.float32)
    for b in range(N_BANDS):
        m[:, b] = ((freqs >= edges[b]) & (freqs < edges[b + 1])).astype(np.float32)
    return m


@functools.lru_cache(maxsize=None)
def band_ranges(fmin: float, fmax: float) -> tuple:
    """Each log-spaced band as its contiguous bin interval [k0, k1)."""
    m = band_matrix(fmin, fmax)  # [K, N_BANDS]
    out = []
    for b in range(N_BANDS):
        nz = np.nonzero(m[:, b])[0]
        if len(nz) == 0:
            out.append((0, 0))
            continue
        k0, k1 = int(nz[0]), int(nz[-1]) + 1
        assert len(nz) == k1 - k0, "haitsma band must be contiguous"
        out.append((k0, k1))
    return tuple(out)


def _band_edges(fmin: float, fmax: float) -> np.ndarray:
    """[2, 33] int64 (start, end) columns of each band in a prefix sum
    with a leading zero column (an empty band reads 0 - 0)."""
    return np.asarray(band_ranges(fmin, fmax), np.int64).T.copy()


def haitsma_words(samples: torch.Tensor, fmin: float, fmax: float,
                  fft: bool = False) -> torch.Tensor:
    """5 kHz mono samples ([n] or [B, n]; i16 quantized or f32) ->
    [T-1] (or [B, T-1]) sub-fingerprints, int64 holding u32 values.

    Band energies are exact int64 sums of the integer spectrogram: one
    prefix sum over the bins (every value below 2^62: power <= 2^51 at
    shift 14, times 1,025 bins) read at each band's two ends, the same
    integers as the reference's per-band slice sums."""
    if fft:
        from . import intfft

        power = intfft.stft_power_int_fft(samples, FRAME, HOP, center=False)
    else:
        power = dsp.stft_power_int(samples, FRAME, HOP, center=False, shift=14)
    edges = dsp.device_const(("haitsma_edges", fmin, fmax),
                             lambda: _band_edges(fmin, fmax), power.device)
    csum = torch.nn.functional.pad(torch.cumsum(power, dim=-1), (1, 0))
    e = csum[..., edges[1]] - csum[..., edges[0]]  # [..., T, 33] int64
    d = e[..., :-1] - e[..., 1:]  # [..., T, 32] band differentials
    dd = d[..., 1:, :] - d[..., :-1, :]  # [..., T-1, 32] time differential
    weights = torch.ones(32, dtype=torch.int64, device=power.device) << torch.arange(
        32, dtype=torch.int64, device=power.device)
    return ((dd > 0).to(torch.int64) * weights).sum(dim=-1)


def fingerprint_frames(samples: np.ndarray, sr: int, cfg: HaitsmaConfig,
                       device=None) -> np.ndarray:
    """Resample to 5 kHz and compute the u32 frame sequence."""
    x = dsp.resample_linear(np.asarray(samples, np.float32), sr, HAITSMA_SR)
    if len(x) < FRAME + HOP:
        return np.zeros(0, np.uint32)
    xq = torch.from_numpy(dsp.quantize_samples_i16(x)).to(resolve_device(device))
    return haitsma_words(xq, cfg.fmin, cfg.fmax, cfg.fft).cpu().numpy().astype(np.uint32)


def fingerprint_frames_batch(stack_5k: np.ndarray, cfg: HaitsmaConfig,
                             device=None) -> list[np.ndarray]:
    """Batched fingerprint_frames over already-5 kHz equal-length clips
    ([B, T] f32): one device pass for the group; each row equals the
    single form. Short clips (T < FRAME + HOP) yield empty arrays."""
    b, t = stack_5k.shape
    if t < FRAME + HOP:
        return [np.zeros(0, np.uint32) for _ in range(b)]
    xq = torch.from_numpy(dsp.quantize_samples_i16(stack_5k)).to(resolve_device(device))
    words = haitsma_words(xq, cfg.fmin, cfg.fmax, cfg.fft).cpu().numpy().astype(np.uint32)
    return [words[i] for i in range(b)]


# ---------------------------------------------------------------------------
# minimum bit-error-rate search
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    c = 64
    while c < n:
        c *= 2
    return c


def _check_min_ber(db: torch.Tensor, lens: torch.Tensor, q_pad: torch.Tensor,
                   q_true: int) -> None:
    if db.dim() != 2 or lens.dim() != 1 or q_pad.dim() != 1 or lens.shape[0] != db.shape[0]:
        raise ValueError(f"min_ber_batch takes db [R, Tb], lens [R] and q_pad [Qb], got "
                         f"{tuple(db.shape)}, {tuple(lens.shape)} and {tuple(q_pad.shape)}")
    if db.dtype != torch.int32 or q_pad.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("db and q_pad hold u32 words as int32; lens is int32")
    if not 0 <= q_true <= q_pad.shape[0] <= db.shape[1]:
        raise ValueError(f"min_ber_batch needs 0 <= q_true <= Qb <= Tb, got q_true="
                         f"{q_true}, Qb={q_pad.shape[0]}, Tb={db.shape[1]}")
    if q_true > MAX_QUERY_WORDS:
        raise ValueError(f"min_ber_batch takes at most {MAX_QUERY_WORDS} query words, "
                         f"got {q_true}")


def _finish(best: torch.Tensor, q_true: int):
    """Best keys (errs << 32 | offset, -1 for none) -> (ber f32, offset
    int32): ber = errs / (32 * max(q_true, 1)), a float32 division by a
    tensor (IEEE on both devices)."""
    none = best < 0
    errs = (best >> 32).to(torch.float32)
    denom = torch.full_like(errs, 32.0 * max(q_true, 1))  # exact: below 2^24
    ber = torch.where(none, torch.full_like(errs, float("inf")), errs / denom)
    off = torch.where(none, torch.full_like(best, -1), best & 0xFFFFFFFF).to(torch.int32)
    return ber, off


def min_ber_batch_plain(db: torch.Tensor, lens: torch.Tensor, q_pad: torch.Tensor,
                        q_true: int):
    """min_ber_batch in plain PyTorch: chunks of offsets, each an unfold
    of the rows ([R, chunk, q_true] windows) XORed with the query and
    popcounted (fused_scan._popcount32), errs summed per offset; each
    row keeps the least (errs << 32 | offset), so ties go to the first
    offset."""
    _check_min_ber(db, lens, q_pad, q_true)
    r, tb = db.shape
    n_off = tb - q_pad.shape[0] + 1
    last = torch.clamp(lens.to(torch.int64) - q_true, max=n_off - 1)  # [R]
    best = torch.full((r,), -1, dtype=torch.int64, device=db.device)
    if r == 0:
        return _finish(best, q_true)
    big = torch.full((r,), 1 << 62, dtype=torch.int64, device=db.device)
    best_key = big.clone()
    q = q_pad[:q_true]
    chunk = max(1, PLAIN_CHUNK_ELEMS // max(1, r * max(q_true, 1)))
    for o0 in range(0, n_off, chunk):
        o1 = min(n_off, o0 + chunk)
        if q_true:
            win = db[:, o0:o1 - 1 + q_true].unfold(1, q_true, 1)  # [R, o1-o0, q_true]
            errs = fused_scan._popcount32(torch.bitwise_xor(win, q)).sum(dim=2)
        else:
            errs = torch.zeros((r, o1 - o0), dtype=torch.int64, device=db.device)
        offs = torch.arange(o0, o1, dtype=torch.int64, device=db.device)
        key = torch.where(offs[None, :] <= last[:, None], (errs << 32) | offs[None, :],
                          big[:, None])
        best_key = torch.minimum(best_key, key.amin(dim=1))
    best = torch.where(best_key == big, best, best_key)
    return _finish(best, q_true)


def _min_ber_mma_plain(db: torch.Tensor, lens: torch.Tensor, q_pad: torch.Tensor,
                      q_true: int):
    """The kernel's formulation in plain PyTorch, for the tests (the card
    never runs it): errs(o) = S(o) + Pq - 2 D(o) in int64. Offsets go in
    warp tiles of 16 rows m x 8 * MMA_SHIFT_TILES shifts, o = o_w + 64 m +
    8 t + n; per query pass of MMA_QCHUNK words, D's tile t is the product
    of A[m][i] = b[o_w + 64 m + i] (row words at or past min(lens, Tb) read
    as 0) with B_t[i][n] = q[i - 8 t - n] (zero outside the pass's live
    words), over 8-word k-steps in the kernel's register slot order; S
    comes from a prefix sum of the words' popcounts and Pq from the query's.
    Each row keeps the least (errs << 32 | offset) over o <= min(lens -
    q_true, Tb - Qb)."""
    _check_min_ber(db, lens, q_pad, q_true)
    r, tb = db.shape
    n_off = tb - q_pad.shape[0] + 1
    dev = db.device
    rw = 8 * MMA_SHIFT_TILES  # words between A's rows
    tiles = -(-n_off // (16 * rw))
    lim = torch.clamp(lens.to(torch.int64), max=tb)
    last = torch.clamp(lens.to(torch.int64) - q_true, max=n_off - 1)
    words = torch.where(torch.arange(tb, device=dev)[None, :] < lim[:, None],
                        db.to(torch.int64) & 0xFFFFFFFF, 0)
    q = q_pad.to(torch.int64) & 0xFFFFFFFF
    slots = torch.tensor(MMA_SLOT_WORDS, device=dev)
    o = torch.arange(tiles * 16 * rw, device=dev)
    errs = torch.zeros((r, len(o)), dtype=torch.int64, device=dev)
    for j0 in range(0, q_true, MMA_QCHUNK):
        qn = min(MMA_QCHUNK, q_true - j0)
        ksteps = (qn + rw + 6) // 8
        seg_n = (tiles * 16 - 1) * rw + 8 * ksteps
        seg = torch.zeros((r, seg_n), dtype=torch.int64, device=dev)
        part = words[:, j0:j0 + seg_n]
        seg[:, :part.shape[1]] = part
        qext = torch.zeros(8 * ksteps + 8, dtype=torch.int64, device=dev)
        qext[7:7 + qn] = q[j0:j0 + qn]
        i = torch.arange(8 * ksteps, device=dev)
        # B_0[c, slot, n] = q[8c + word - n]; B_t is B_0 t k-steps earlier
        b0 = qext[7 + i[:, None] - torch.arange(8, device=dev)[None, :]]
        b0 = b0.view(ksteps, 8, 8)[:, slots]
        # A[tile, m, c, slot] = b[16 rw tile + rw m + 8c + word]
        a_idx = (16 * rw * torch.arange(tiles, device=dev)[:, None, None]
                 + rw * torch.arange(16, device=dev)[None, :, None] + i[None, None, :])
        a = seg[:, a_idx].view(r, tiles, 16, ksteps, 8)[..., slots]
        d = torch.empty((r, tiles, 16, MMA_SHIFT_TILES, 8), dtype=torch.int64, device=dev)
        for t in range(MMA_SHIFT_TILES):
            bt = torch.zeros_like(b0)
            bt[t:] = b0[:ksteps - t]
            d[:, :, :, t] = fused_scan._popcount32(
                a[..., None] & bt[None, None, None]).sum(dim=(3, 4))
        pre = torch.nn.functional.pad(torch.cumsum(fused_scan._popcount32(seg), dim=1),
                                      (1, 0))
        pq = int(fused_scan._popcount32(qext).sum())
        errs += pre[:, o + qn] - pre[:, o] + pq - 2 * d.reshape(r, -1)
    big = torch.full((r,), 1 << 62, dtype=torch.int64, device=dev)
    key = torch.where(o[None, :] <= last[:, None], (errs << 32) | o[None, :], big[:, None])
    best_key = key.amin(dim=1)
    return _finish(torch.where(best_key == big, torch.full_like(best_key, -1), best_key),
                   q_true)


_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from ..._build import kernel_library

        lib = kernel_library()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ucfp_min_ber.restype = i
        lib.ucfp_min_ber.argtypes = [p, i, ll, p, p, i, i, p, p]
        _lib = lib
    return _lib


def _min_ber_cuda(db: torch.Tensor, lens: torch.Tensor, q_pad: torch.Tensor,
                  q_true: int):
    _check_min_ber(db, lens, q_pad, q_true)
    for name, t in (("db", db), ("lens", lens), ("q_pad", q_pad)):
        if not t.is_contiguous() or t.device != db.device:
            raise ValueError(f"{name} must be contiguous and on {db.device}")
    r, tb = db.shape
    best = torch.empty(r, dtype=torch.int64, device=db.device)
    rc = _kernels().ucfp_min_ber(
        db.data_ptr(), r, tb, lens.data_ptr(), q_pad.data_ptr(), q_pad.shape[0], q_true,
        best.data_ptr(), fused_scan._stream_ptr(db))
    fused_scan._check(rc, "min_ber_batch")
    _count("min_ber_batch")
    return _finish(best, q_true)


def min_ber_batch(db: torch.Tensor, lens: torch.Tensor, q_pad: torch.Tensor,
                  q_true: int):
    """Batched Philips lookup: db [R, Tb] int32 (u32 words, zero padded
    rows), lens [R] int32 true lengths (0 = dead row), q_pad [Qb] int32
    (zero padded), q_true live query words -> (ber [R] float32, offset
    [R] int32). Offsets run over 0..Tb-Qb, those past lens - q_true
    masked; a row with none gives (inf, -1)."""
    if db.device.type == "cpu":
        return min_ber_batch_plain(db, lens, q_pad, q_true)
    return _min_ber_cuda(db, lens, q_pad, q_true)


def min_ber(db_frames: np.ndarray, q_frames: np.ndarray, device=None) -> tuple[float, int]:
    """Host wrapper over one stored stream (the reference pads both to
    power-of-two buckets); returns (1.0, -1) when the query is longer than
    the stored stream."""
    t, q = len(db_frames), len(q_frames)
    if q == 0 or t < q:
        return 1.0, -1
    tb, qb = _next_pow2(t), _next_pow2(q)
    tb = max(tb, qb)
    db_pad = np.zeros((1, tb), np.uint32)
    db_pad[0, :t] = db_frames
    q_pad = np.zeros(qb, np.uint32)
    q_pad[:q] = q_frames
    dev = resolve_device(device)
    ber, off = min_ber_batch(
        torch.from_numpy(db_pad.view(np.int32)).to(dev),
        torch.tensor([t], dtype=torch.int32, device=dev),
        torch.from_numpy(q_pad.view(np.int32)).to(dev), q)
    return float(ber[0]), int(off[0])
