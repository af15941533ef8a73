"""Peak constellation + Wang / Panako landmark hashing on the device.

Port of ucfp_tpu/ops/audio/constellation.py: the same peak picker, pairing
rule and hash layouts (see the reference's module doc), computed where the
input lies. Every device function takes the reference's single-clip shapes
or a leading batch dimension (the reference's vmap written out); each
batch row equals the single form.

  * pick_peaks: frequency-axis local maxima (strictly above f-1, >= f+1)
    that are >= their time neighbours, above a dB floor (global, or per
    one-second slab); per slab the top peaks_per_sec by magnitude, ties to
    the lower (t, f). That selection is lax.top_k in the reference; here
    it is the port's shared top-k selection (ops.fused_scan: the
    selection kernel csrc/select.cu on the card, _select_plain, a stable
    sort, on the CPU), with the slabs as its queries. Then the peaks sort
    by (t, f) with a stable sort, invalid ones last.
  * wang_pairs / panako_triplets over the W = 256 forward-successor
    window (Tensor.unfold of an edge-padded copy).
  * peaks_and_landmarks: one spectrogram and one peak pick for the audio
    inspector's overlays and its Wang fingerprint.

Hashes come back as int64 holding the reference's uint32 values (torch's
uint32 has no shifts): the pairing fields are masked to 32 bits, so every
entry, masked ones too, equals the reference's uint32 bit pattern.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from .. import fused_scan
from . import dsp

PAIR_WINDOW = 256  # successor-scan cap per anchor
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class WangConfig:
    """Defaults from the reference manifest (algorithms_manifest.rs:546-600).

    local_floor=True applies min_anchor_mag_db relative to each time
    slab's own maximum instead of the clip-global maximum."""

    fan_out: int = 10
    target_zone_t: int = 63
    target_zone_f: int = 64
    peaks_per_sec: int = 30
    min_anchor_mag_db: float = -50.0
    local_floor: bool = False


@dataclass(frozen=True)
class PanakoConfig:
    """Defaults from the reference manifest (algorithms_manifest.rs:601-650)."""

    fan_out: int = 5
    target_zone_t: int = 96
    target_zone_f: int = 96
    peaks_per_sec: int = 30
    min_anchor_mag_db: float = -50.0


def select_top(mag: torch.Tensor, k: int):
    """Top k of each row of [S, N] float32 magnitudes, largest first, ties
    to the lower column (lax.top_k's order) -> (values, columns int32)."""
    s, n = mag.shape
    cols = torch.arange(n, dtype=torch.int32, device=mag.device).expand(s, n)
    if mag.device.type == "cpu":
        return fused_scan._select_plain(mag, cols, k, True)
    return fused_scan._select_cuda(mag.contiguous(), cols.contiguous(), k, True)


def pick_peaks(power: torch.Tensor, slab_frames: int, peaks_per_sec: int,
               min_mag_db: float, local_floor: bool = False):
    """power [T, K] (or [B, T, K]) float32 -> (t [P], f [P], valid [P])
    sorted by (t, f), P = n_slabs * cap (a leading [B] for a batch)."""
    single = power.dim() == 2
    if single:
        power = power[None]
    b, t_dim, k_dim = power.shape
    dev = power.device
    neg = -1.0
    p = torch.nn.functional.pad(power, (1, 1, 1, 1), value=neg)

    def sh(dt, df):
        return p[:, 1 + dt: 1 + dt + t_dim, 1 + df: 1 + df + k_dim]

    center = power
    is_max = ((center > sh(0, -1)) & (center >= sh(0, 1))
              & (center >= sh(-1, 0)) & (center >= sh(1, 0)))
    gmax = power.amax(dim=(1, 2)).view(b, 1, 1)
    # magnitude threshold of m dB == power threshold of 10^(m/10)
    rel = torch.tensor(np.float32(10.0 ** (min_mag_db / 10.0)), device=dev)
    n_slabs = -(-t_dim // slab_frames)
    pad_t = n_slabs * slab_frames - t_dim
    if local_floor:
        pmax = torch.nn.functional.pad(power, (0, 0, 0, pad_t), value=0.0)
        slab_max = pmax.reshape(b, n_slabs, slab_frames * k_dim).amax(dim=2)
        floor2d = torch.repeat_interleave(slab_max * rel, slab_frames, dim=1)
        floor2d = floor2d[:, :t_dim, None]
        is_max = is_max & (center >= floor2d) & (gmax > 0.0)
    else:
        is_max = is_max & (center >= gmax * rel) & (gmax > 0.0)

    # per-slab top-k by magnitude
    mag = torch.where(is_max, power, torch.full_like(power, neg))
    mag = torch.nn.functional.pad(mag, (0, 0, 0, pad_t), value=neg)
    mag = mag.reshape(b * n_slabs, slab_frames * k_dim)
    top_mag, top_idx = select_top(mag, peaks_per_sec)  # [B*S, cap]
    top_mag = top_mag.view(b, n_slabs, peaks_per_sec)
    top_idx = top_idx.view(b, n_slabs, peaks_per_sec)
    t_local = torch.div(top_idx, k_dim, rounding_mode="floor")
    f_idx = top_idx - t_local * k_dim
    slab0 = (torch.arange(n_slabs, dtype=torch.int32, device=dev) * slab_frames)
    t_idx = t_local + slab0.view(1, -1, 1)
    valid = (top_mag > 0.0).reshape(b, -1)
    t_flat = t_idx.reshape(b, -1).to(torch.int32)
    f_flat = f_idx.reshape(b, -1).to(torch.int32)
    # sort by (t, f); invalid entries to the end (a stable sort, as jnp's)
    key = torch.where(valid, t_flat * k_dim + f_flat,
                      torch.full_like(t_flat, 0x7FFFFFF0))
    order = torch.sort(key, dim=1, stable=True).indices
    out = (torch.gather(t_flat, 1, order), torch.gather(f_flat, 1, order),
           torch.gather(valid, 1, order))
    return tuple(x[0] for x in out) if single else out


def _successor_window(a: torch.Tensor, w: int) -> torch.Tensor:
    """[..., P] -> [..., P, W] whose column j-1 holds a[min(i+j, P-1)]: an
    unfold of the edge-padded copy (the reference's shifted slices)."""
    ap = torch.cat([a, a[..., -1:].expand(*a.shape[:-1], w)], dim=-1)
    return ap[..., 1:].unfold(-1, w, 1)


def _pair_mask(t, f, valid, fan, zone_t: int, zone_f: int):
    """The shared target-zone scan: (W, successor windows, ok, rank)."""
    p = t.shape[-1]
    w = min(PAIR_WINDOW, p - 1) if p > 1 else 1
    dev = t.device
    idx = torch.arange(p, dtype=torch.int32, device=dev)
    succ = idx[:, None] + torch.arange(1, w + 1, dtype=torch.int32, device=dev)[None, :]
    in_range = succ < p
    t_s = _successor_window(t, w)
    f_s = _successor_window(f, w)
    v_s = _successor_window(valid, w)
    dt = t_s - t[..., None]
    df = (f_s - f[..., None]).abs()
    ok = (in_range & valid[..., None] & v_s & (dt > 0) & (dt <= zone_t)
          & (df <= zone_f))
    # rank among valid targets per anchor, in time order
    rank = torch.cumsum(ok.to(torch.int32), dim=-1) - 1
    ok = ok & (rank < fan)
    return w, t_s, f_s, dt, ok, rank


def wang_pairs(t: torch.Tensor, f: torch.Tensor, valid: torch.Tensor,
               fan_out: int, zone_t: int, zone_f: int):
    """Pair anchors with forward-in-time targets (audio.rs:965-1003).

    Returns (hash [P, W], t1 [P, W], mask [P, W]), hash and t1 int64
    holding the reference's uint32 values; the host packs the valid
    entries in (anchor, rank) order."""
    _w, _t_s, f_s, dt, ok, _rank = _pair_mask(t, f, valid, fan_out, zone_t, zone_f)
    h = ((f[..., None].to(torch.int64) << 22) | (f_s.to(torch.int64) << 12)
         | dt.to(torch.int64)) & _U32
    t1 = (t[..., None].to(torch.int64) & _U32).expand(h.shape)
    return h, t1, ok


PANAKO_BANDS_PER_OCTAVE = 12  # semitones
PANAKO_FREF_HZ = 32.7  # C1
_BAND_TABLE_BINS = 4096  # covers any n_fft <= 8190


@functools.lru_cache(maxsize=None)
def _band_table_np(bin_hz: float):
    """Semitone band of each STFT bin, precomputed on the host in f64 (a
    device log2 would differ in the last ulp between backends)."""
    hz = np.maximum(
        np.arange(_BAND_TABLE_BINS, dtype=np.float64) * bin_hz, 1.0
    )
    return np.round(
        PANAKO_BANDS_PER_OCTAVE * np.log2(hz / PANAKO_FREF_HZ)
    ).astype(np.int32)


def _log_band(f_bin: torch.Tensor, bin_hz: float) -> torch.Tensor:
    """Linear STFT bin -> semitone band above C1 (int32 table gather)."""
    table = dsp.device_const(("band_table", bin_hz), lambda: _band_table_np(bin_hz),
                             f_bin.device)
    return table[f_bin.long()]


def panako_triplets(t: torch.Tensor, f: torch.Tensor, valid: torch.Tensor,
                    fan_out: int, zone_t: int, zone_f: int, bin_hz: float = 7.8125):
    """Pitch/tempo-invariant triplets: anchor + every PAIR of its first
    fan_out+1 targets (the reference's one-hot masked selection, no sort
    and no gather). Returns (hash [P, S2], aux [P, S2], pair_ok [P, S2]),
    S2 = C(fan_out + 1, 2), hash and aux int64 holding uint32 values."""
    w, t_s, f_s, _dt, ok, rank = _pair_mask(t, f, valid, fan_out + 1, zone_t, zone_f)
    dev = t.device
    slots = torch.arange(fan_out + 1, dtype=torch.int32, device=dev)
    sel = ok[..., None] & (rank[..., None] == slots)
    seli = sel.to(torch.int32)  # [..., P, W, S]
    gv = sel.any(dim=-2)  # [..., P, S]
    t2 = (t_s[..., None] * seli).sum(dim=-2, dtype=torch.int32)
    lbf = _log_band(f, bin_hz)  # [..., P]
    lb_s = _successor_window(lbf, w)
    lb2s = (lb_s[..., None] * seli).sum(dim=-2, dtype=torch.int32)
    i1, i2 = np.triu_indices(fan_out + 1, k=1)
    i1 = torch.as_tensor(i1, dtype=torch.long, device=dev)
    i2 = torch.as_tensor(i2, dtype=torch.long, device=dev)
    t2a, t3a = t2[..., i1], t2[..., i2]
    pair_ok = gv[..., i1] & gv[..., i2]
    tt = t[..., None]
    denom = torch.clamp(t3a - tt, min=1)
    ratio = torch.clamp(
        torch.div(15 * (t2a - tt) + torch.div(denom, 2, rounding_mode="floor"), denom,
                  rounding_mode="floor"), 0, 15).to(torch.int64)
    lb1 = lbf[..., None]
    lb2 = lb2s[..., i1]
    lb3 = lb2s[..., i2]
    db12 = torch.clamp(lb2 - lb1 + 128, 0, 255).to(torch.int64)
    db23 = torch.clamp(lb3 - lb2 + 128, 0, 255).to(torch.int64)
    b1coarse = torch.clamp(lb1 >> 3, 0, 255).to(torch.int64)
    h = (db12 << 24) | (db23 << 16) | (ratio << 12) | (b1coarse << 4)
    aux = (tt.to(torch.int64) & _U32).expand(h.shape)
    return h, aux, pair_ok


# ---------------------------------------------------------------------------
# Host assembly
# ---------------------------------------------------------------------------


def _power_f32(stack_q: np.ndarray, n_fft: int, hop: int, device) -> torch.Tensor:
    """i16 samples ([n] or [B, n]) -> the exact integer spectrogram on the
    device, converted once to float32 (round to nearest even) for the
    selection code."""
    xq = torch.from_numpy(np.ascontiguousarray(stack_q)).to(resolve_device(device))
    return dsp.stft_power_int(xq, n_fft, hop, True).to(torch.float32)


def _extract(samples, sr, cfg, pair_fn, n_fft, hop, device):
    """The shared single/batch pipeline -> per clip (hash, aux) uint32."""
    power = _power_f32(dsp.quantize_samples_i16(samples), n_fft, hop, device)
    slab = max(1, sr // hop)
    t, f, valid = pick_peaks(power, slab, cfg.peaks_per_sec, cfg.min_anchor_mag_db,
                             getattr(cfg, "local_floor", False))
    h, aux, ok = pair_fn(t, f, valid, cfg.fan_out, cfg.target_zone_t,
                         cfg.target_zone_f)
    h, aux, ok = h.cpu().numpy(), aux.cpu().numpy(), ok.cpu().numpy()
    if h.ndim == 2:
        return h[ok].astype(np.uint32), aux[ok].astype(np.uint32)
    return [(h[b][ok[b]].astype(np.uint32), aux[b][ok[b]].astype(np.uint32))
            for b in range(h.shape[0])]


def extract_landmarks(samples: np.ndarray, sr: int, cfg: WangConfig, n_fft: int = 1024,
                      hop: int = 256, device=None) -> tuple[np.ndarray, np.ndarray]:
    """-> (hashes u32 [L], t1 u32 [L]) in (anchor, rank) order."""
    return _extract(samples, sr, cfg, wang_pairs, n_fft, hop, device)


def extract_panako(samples: np.ndarray, sr: int, cfg: PanakoConfig, n_fft: int = 1024,
                   hop: int = 256, device=None) -> tuple[np.ndarray, np.ndarray]:
    return _extract(samples, sr, cfg, panako_triplets, n_fft, hop, device)


def extract_landmarks_batch(stack: np.ndarray, sr: int, cfg: WangConfig,
                            n_fft: int = 1024, hop: int = 256, device=None) -> list:
    """Batched extract_landmarks over equal-length clips [B, n]: one device
    pass per stage for the group; each row equals the single form."""
    return _extract(stack, sr, cfg, wang_pairs, n_fft, hop, device)


def extract_panako_batch(stack: np.ndarray, sr: int, cfg: PanakoConfig,
                         n_fft: int = 1024, hop: int = 256, device=None) -> list:
    """Batched extract_panako (see extract_landmarks_batch)."""
    return _extract(stack, sr, cfg, panako_triplets, n_fft, hop, device)


def peaks_and_landmarks(
    samples: np.ndarray, sr: int, cfg: WangConfig,
    n_fft: int = 1024, hop: int = 256, device=None,
) -> tuple:
    """One STFT + one peak pick serving both the inspector overlays and
    the wang fingerprint: -> (t, f, mag_power, power, hashes, t1), host
    numpy. The exact integer spectrogram (int8 products: torch._int_mm
    on the card) and the per-slab selection (csrc/select.cu on the card)
    run on `device`; power comes back as the float32 grid."""
    power = _power_f32(dsp.quantize_samples_i16(samples), n_fft, hop, device)
    slab = max(1, sr // hop)
    t, f, valid = pick_peaks(
        power, slab, cfg.peaks_per_sec, cfg.min_anchor_mag_db,
        getattr(cfg, "local_floor", False),
    )
    h, t1, ok = wang_pairs(
        t, f, valid, cfg.fan_out, cfg.target_zone_t, cfg.target_zone_f
    )
    ok = ok.cpu().numpy()
    tv, fv, validv = t.cpu().numpy(), f.cpu().numpy(), valid.cpu().numpy()
    pw = power.cpu().numpy()
    sel_t, sel_f = tv[validv], fv[validv]
    return (sel_t, sel_f, pw[sel_t, sel_f], pw,
            h.cpu().numpy()[ok].astype(np.uint32),
            t1.cpu().numpy()[ok].astype(np.uint32))
