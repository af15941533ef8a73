"""Audio modality pipeline: raw f32 PCM -> device DSP -> Records.

Port of ucfp_tpu/modality/audio.py:
  * fingerprint_wang     "audiofp-wang-v1"     landmark (hash,t) u32 pairs
  * fingerprint_panako   "audiofp-panako-v1"   triplet (hash,aux) u32 pairs
  * fingerprint_haitsma  "audiofp-haitsma-v1"  u32 frame sequence (5 kHz)
  * fingerprint_audio_batch                    the three over many clips
  * fingerprint_neural   "audiofp-neural-v1"   per-window 128-d embeddings
  * StreamingWangSession                       chunked 8 kHz PCM -> one
                                               Record per segment
  * detect_watermark     "audiofp-watermark-v1" WatermarkReport, no Record

Input validation, decoding, resampling, the Record layouts and the
watermark pair are host code copied from the reference (only the imports
differ); the spectral work runs in ops.audio on the device named by
`device` (the CUDA card unless the caller asks for the CPU). Records are
byte-identical to the reference's. The neural path's log-mel windows
and its stand-in MLP (models.encoders) run on the same device.
  * inspect_audio                              the inspector's stages:
                                               envelope, spectrograms,
                                               peaks, landmarks and the
                                               chosen fingerprint
"""

from __future__ import annotations

import io
import math
from dataclasses import dataclass

import numpy as np

from ..core import Modality, ModalityError, Record
from ..ops.audio import constellation, dsp
from ..ops.audio import haitsma as haitsma_ops
from ..ops.audio.constellation import PanakoConfig, WangConfig
from ..ops.audio.haitsma import HaitsmaConfig
from .confighash import config_hash64

ALGORITHM_WANG = "audiofp-wang-v1"
ALGORITHM_PANAKO = "audiofp-panako-v1"
ALGORITHM_HAITSMA = "audiofp-haitsma-v1"
ALGORITHM_NEURAL = "audiofp-neural-v1"
ALGORITHM_WATERMARK = "audiofp-watermark-v1"

CANONICAL_SR = 8_000  # Wang/Panako canonical rate (audio.rs:425-429)
MAX_SAMPLE_RATE = 192_000


def _check_input(samples: np.ndarray, sample_rate: int) -> np.ndarray:
    if sample_rate <= 0 or sample_rate > MAX_SAMPLE_RATE:
        raise ModalityError(f"invalid sample rate {sample_rate}")
    x = np.asarray(samples, np.float32)
    if x.ndim != 1:
        raise ModalityError("audio must be mono f32")
    if x.size == 0:
        raise ModalityError("empty sample buffer")
    return x


def decode_f32le(body: bytes) -> np.ndarray:
    """Raw little-endian f32 body, 4-byte aligned (handlers.rs:737-750)."""
    if len(body) == 0:
        raise ModalityError("empty audio body")
    if len(body) % 4 != 0:
        raise ModalityError("audio body length must be a multiple of 4 (f32 LE)")
    return np.frombuffer(body, dtype="<f4").astype(np.float32)


def decode_s16le(body: bytes) -> np.ndarray:
    """Raw little-endian signed-16-bit PCM body, 2-byte aligned.

    Half the wire bytes of the f32 contract for 16-bit-sourced audio
    (the common case), and EXACTLY value-identical to shipping the f32
    conversion: every int16 is representable in f32 and the 2^-15 scale
    is a power of two, so `i16 -> f32 * (1/32768)` matches wav_to_f32's
    width-2 path bit for bit. An extension over the reference's raw-f32
    contract (handlers.rs:737-750); selected with ?encoding=s16."""
    if len(body) == 0:
        raise ModalityError("empty audio body")
    if len(body) % 2 != 0:
        raise ModalityError(
            "audio body length must be a multiple of 2 (s16 LE)")
    vals = np.frombuffer(body, dtype="<i2").astype(np.float32)
    scale = 1.0 / 32768.0
    return (vals * scale).astype(np.float32)


def wav_to_f32(data: bytes) -> tuple[bytes, int]:
    """RIFF/WAVE container -> (mono f32-LE PCM bytes, sample rate).

    Stdlib-only decode for server-side bulk loaders (the HTTP routes
    take raw f32 per the reference contract; clients decode containers
    themselves — the Python SDK ships its own standalone copy of this
    logic in clients/python/ucfp/_common.py:decode_wav). Supports PCM
    8/16/32-bit, channels averaged to mono. Python's `wave` module
    rejects IEEE-float WAVs (format 3), so 4-byte samples are always
    int32 PCM here — sniffing for float32 would misfire on int32 files
    with quiet openings and decode the whole file as bitcast garbage."""
    import wave

    with wave.open(io.BytesIO(data), "rb") as w:
        n, ch, width, sr = (
            w.getnframes(), w.getnchannels(), w.getsampwidth(),
            w.getframerate(),
        )
        raw = w.readframes(n)
    if width == 1:
        vals = np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0
        scale = 1.0 / 128.0
    elif width == 2:
        vals = np.frombuffer(raw, "<i2").astype(np.float32)
        scale = 1.0 / 32768.0
    elif width == 4:
        vals = np.frombuffer(raw, "<i4").astype(np.float32)
        scale = 1.0 / 2147483648.0
    else:
        raise ModalityError(f"unsupported WAV sample width {width}")
    mono = vals.reshape(n, ch).mean(axis=1) * scale if ch > 1 else vals * scale
    return mono.astype("<f4").tobytes(), sr


def _wang_cfg_hash(cfg: WangConfig, algorithm: str) -> int:
    return config_hash64(
        algorithm,
        fan_out=cfg.fan_out,
        target_zone_t=cfg.target_zone_t,
        target_zone_f=cfg.target_zone_f,
        peaks_per_sec=cfg.peaks_per_sec,
        min_anchor_mag_db=cfg.min_anchor_mag_db,
        local_floor=cfg.local_floor,
    )


def _wang_record(tenant_id: int, record_id: int, hashes, t1,
                 cfg: WangConfig) -> Record:
    """(hash u32, t1 u32) LE pairs, cast straight to bytes — the ONE
    place the wang wire layout + config_hash live (single and batch
    paths both assemble here, so the hash field list cannot drift)."""
    buf = np.empty((len(hashes), 2), dtype="<u4")
    buf[:, 0] = hashes
    buf[:, 1] = t1
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.AUDIO,
        algorithm=ALGORITHM_WANG,
        fingerprint=buf.tobytes(),
        config_hash=_wang_cfg_hash(cfg, ALGORITHM_WANG),
    )


def _panako_record(tenant_id: int, record_id: int, hashes, aux,
                   cfg: PanakoConfig) -> Record:
    buf = np.empty((len(hashes), 2), dtype="<u4")
    buf[:, 0] = hashes
    buf[:, 1] = aux
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.AUDIO,
        algorithm=ALGORITHM_PANAKO,
        fingerprint=buf.tobytes(),
        config_hash=config_hash64(
            ALGORITHM_PANAKO,
            fan_out=cfg.fan_out,
            target_zone_t=cfg.target_zone_t,
            target_zone_f=cfg.target_zone_f,
            peaks_per_sec=cfg.peaks_per_sec,
            min_anchor_mag_db=cfg.min_anchor_mag_db,
        ),
    )


def _haitsma_record(tenant_id: int, record_id: int, frames,
                    cfg: HaitsmaConfig) -> Record:
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.AUDIO,
        algorithm=ALGORITHM_HAITSMA,
        fingerprint=frames.astype("<u4").tobytes(),
        # the fft flag selects a different exactness spec (intfft.py), so
        # its words must never collide with default-path words in one
        # catalog; default-path hashes are unchanged (kwarg only added
        # when the flag is on).
        config_hash=config_hash64(
            ALGORITHM_HAITSMA, fmin=cfg.fmin, fmax=cfg.fmax,
            **({"spectrogram": "ucfp-int-fft-v1"} if cfg.fft else {}),
        ),
    )


def fingerprint_wang(
    samples: np.ndarray,
    sample_rate: int,
    tenant_id: int,
    record_id: int,
    cfg: WangConfig | None = None,
    device=None,
) -> Record:
    cfg = cfg or WangConfig()
    x = _check_input(samples, sample_rate)
    if sample_rate != CANONICAL_SR:
        x = dsp.resample_linear(x, sample_rate, CANONICAL_SR)
    if len(x) < 1024:  # one STFT frame at the canonical rate
        raise ModalityError(
            f"audio too short for wang after resampling to {CANONICAL_SR} Hz "
            f"({len(x)} samples; need >= 1024)"
        )
    hashes, t1 = constellation.extract_landmarks(x, CANONICAL_SR, cfg, device=device)
    return _wang_record(tenant_id, record_id, hashes, t1, cfg)


def fingerprint_panako(
    samples: np.ndarray,
    sample_rate: int,
    tenant_id: int,
    record_id: int,
    cfg: PanakoConfig | None = None,
    device=None,
) -> Record:
    cfg = cfg or PanakoConfig()
    x = _check_input(samples, sample_rate)
    if sample_rate != CANONICAL_SR:
        raise ModalityError(
            f"panako requires {CANONICAL_SR} Hz input, got {sample_rate}"
        )
    hashes, aux = constellation.extract_panako(x, CANONICAL_SR, cfg, device=device)
    return _panako_record(tenant_id, record_id, hashes, aux, cfg)


def fingerprint_haitsma(
    samples: np.ndarray,
    sample_rate: int,
    tenant_id: int,
    record_id: int,
    cfg: HaitsmaConfig | None = None,
    device=None,
) -> Record:
    """Resamples to 5 kHz internally (audio.rs:193-201)."""
    cfg = cfg or HaitsmaConfig()
    x = _check_input(samples, sample_rate)
    frames = haitsma_ops.fingerprint_frames(x, sample_rate, cfg, device=device)
    return _haitsma_record(tenant_id, record_id, frames, cfg)


def fingerprint_audio_batch(
    algorithm: str,
    clips: list[np.ndarray],
    sample_rate: int,
    tenant_id: int,
    record_ids: list[int],
    cfg=None,
    device=None,
) -> list[Record]:
    """Batched classical audio fingerprints: equal-length clips are grouped
    and each group runs one device pass per pipeline stage. Rows equal the
    single-clip functions' (the batch dimension applies the same per-clip
    math). Length grouping keeps that exact: zero-padding a clip would add
    STFT frames and change its hashes, so unequal lengths never share a
    group. Unlike the reference, the batch is not padded to a power of two
    (that bounds JAX recompiles; PyTorch compiles nothing).

    algorithm: wang | panako | haitsma. Validation and Record layout
    match the corresponding single-clip function exactly. Clips may be
    np.int16 arrays (s16 wire samples, value = i / 32768): at the
    canonical rate they go straight to the sample quantizer, bit-identical
    to decoding to f32 first."""
    if algorithm == "wang":
        cfg = cfg or WangConfig()
    elif algorithm == "panako":
        cfg = cfg or PanakoConfig()
        if sample_rate != CANONICAL_SR:
            raise ModalityError(
                f"panako requires {CANONICAL_SR} Hz input, got {sample_rate}"
            )
    elif algorithm == "haitsma":
        cfg = cfg or HaitsmaConfig()
    else:
        raise ModalityError(
            f"batch ingest supports wang|panako|haitsma, not {algorithm!r}"
        )

    # host-side prepare (validate + resample), exactly the single path's
    prepared: list[np.ndarray] = []
    for samples in clips:
        arr = np.asarray(samples)
        if (arr.dtype == np.int16 and algorithm != "haitsma"
                and sample_rate == CANONICAL_SR):
            # s16-wire fast path (ship the smallest exact form): keep
            # the raw integers when no f32 math is needed — the
            # quantizer (dsp.quantize_samples_i16) consumes them
            # directly with bit-identical results, so the 4 MB f32
            # detour (decode + re-quantize) disappears from the hot
            # batch route. The canonical rate needs no range check.
            if arr.ndim != 1:
                raise ModalityError("audio must be mono f32")
            if arr.size == 0:
                raise ModalityError("empty sample buffer")
            x = arr
        else:
            if arr.dtype == np.int16:
                # resampling is f32 math (haitsma's 5 kHz, non-canonical
                # rates): decode exactly per the wire contract
                # (value = i / 32768, a power-of-two scale — exact)
                arr = arr.astype(np.float32) * np.float32(1.0 / 32768.0)
            x = _check_input(arr, sample_rate)
            if algorithm == "haitsma":
                x = dsp.resample_linear(
                    np.asarray(x, np.float32), sample_rate,
                    haitsma_ops.HAITSMA_SR
                )
            elif sample_rate != CANONICAL_SR:
                x = dsp.resample_linear(x, sample_rate, CANONICAL_SR)
        # the minimum-length gate is WANG-ONLY, exactly like the single
        # path: fingerprint_panako accepts sub-1024 clips (centered
        # STFT pads them) and haitsma yields empty frames below
        # FRAME + HOP — a batch must not reject what the single route
        # accepts
        if algorithm == "wang" and len(x) < 1024:
            raise ModalityError(
                f"audio too short for wang after resampling to "
                f"{CANONICAL_SR} Hz ({len(x)} samples; need >= 1024)"
            )
        prepared.append(x)

    groups: dict[int, list[int]] = {}
    for i, x in enumerate(prepared):
        groups.setdefault(len(x), []).append(i)

    pairs: list[tuple[np.ndarray, np.ndarray] | np.ndarray] = [None] * len(
        prepared
    )
    for _ln, idxs in groups.items():
        stack = np.stack([prepared[i] for i in idxs])
        if algorithm == "wang":
            out = constellation.extract_landmarks_batch(
                stack, CANONICAL_SR, cfg, device=device
            )
        elif algorithm == "panako":
            out = constellation.extract_panako_batch(
                stack, CANONICAL_SR, cfg, device=device
            )
        else:
            out = haitsma_ops.fingerprint_frames_batch(stack, cfg, device=device)
        for j, i in enumerate(idxs):
            pairs[i] = out[j]

    recs = []
    for i, rid in enumerate(record_ids):
        if algorithm == "haitsma":
            recs.append(_haitsma_record(tenant_id, rid, pairs[i], cfg))
        elif algorithm == "wang":
            hashes, t1 = pairs[i]
            recs.append(_wang_record(tenant_id, rid, hashes, t1, cfg))
        else:
            hashes, aux = pairs[i]
            recs.append(_panako_record(tenant_id, rid, hashes, aux, cfg))
    return recs


# ---------------------------------------------------------------------------
# Neural log-mel embedder (device model with fixed seeded weights)
# ---------------------------------------------------------------------------

from ..models import AUDIO_MODEL_ID as NEURAL_MODEL_ID
from ..models.encoders import AUDIO_DIM as NEURAL_DIM
from ..models.encoders import AUDIO_HOP as _NEURAL_HOP
from ..models.encoders import AUDIO_MELS as _NEURAL_MELS
from ..models.encoders import AUDIO_WIN as _NEURAL_WIN
from ..models.encoders import audio_logmel_encode


def _neural_embed_windows(x: np.ndarray, sr: int, device) -> np.ndarray:
    """Log-mel windowing on the device, then the stand-in audio MLP
    (models.encoders; the reference's ONNX log-mel embedder,
    audio.rs:268-321)."""
    import torch

    power = dsp.stft_power(torch.as_tensor(np.asarray(x, np.float32)).to(device),
                           1024, 256, True)
    mel = dsp.mel_spectrogram(power, _NEURAL_MELS, 1024, sr)
    logmel = torch.log(mel + 1e-6)
    t = logmel.shape[0]
    if t < _NEURAL_WIN:
        logmel = torch.nn.functional.pad(logmel, (0, 0, 0, _NEURAL_WIN - t))
        t = _NEURAL_WIN
    n_win = 1 + (t - _NEURAL_WIN) // _NEURAL_HOP
    wins = logmel.unfold(0, _NEURAL_WIN, _NEURAL_HOP)  # [n_win, MELS, WIN]
    wins = wins[:n_win].transpose(1, 2).reshape(n_win, -1)  # [n_win, WIN*MELS]
    return audio_logmel_encode(wins, device)


def fingerprint_neural(
    samples: np.ndarray, sample_rate: int, tenant_id: int, record_id: int,
    device=None,
) -> Record:
    """Per-window embeddings packed into the fingerprint; the first window
    is lifted to the embedding slot (audio.rs:268-321).

    With UCFP_MODEL_DIR/audio mounted, a real HF waveform encoder
    (wav2vec2/HuBERT/AST class) replaces the seeded stand-in — records
    then carry the real model_id and a config_hash bound to it, exactly
    like the text/image local-weights paths."""
    from ..device import resolve_device
    from ..models import hf_local

    device = resolve_device(device)
    x = _check_input(samples, sample_rate)
    if hf_local.available("audio"):
        emb, model_id = hf_local.audio_embed(x, sample_rate, device=device)
        cfg = config_hash64(
            ALGORITHM_NEURAL, model_id=model_id, dim=int(emb.shape[1]),
            win_secs=2.0, hop_secs=1.0, sample_rate=sample_rate,
        )
    else:
        emb = _neural_embed_windows(x, sample_rate, device)
        model_id = NEURAL_MODEL_ID
        cfg = config_hash64(
            ALGORITHM_NEURAL, model_id=NEURAL_MODEL_ID, dim=NEURAL_DIM,
            win=_NEURAL_WIN, hop=_NEURAL_HOP, mels=_NEURAL_MELS,
            # the mel bank spans 0..sr/2 and frames last hop/sr seconds,
            # so embeddings from different rates are NOT comparable —
            # the config hash must refuse the comparison
            sample_rate=sample_rate,
        )
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.AUDIO,
        algorithm=ALGORITHM_NEURAL,
        fingerprint=np.asarray(emb).astype("<f4").tobytes(),
        embedding=[float(v) for v in emb[0]],
        model_id=model_id,
        config_hash=cfg,
    )


# ---------------------------------------------------------------------------
# Watermark (spread-spectrum embed/detect pair)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WatermarkConfig:
    """key is the REQUIRED per-tenant secret: the PN sequence is seeded
    from BLAKE2b(key), so embedding, detection, stripping, and forging
    all require knowing it.

    Threat model: this spread-spectrum pair resists a *keyless*
    adversary — without the key the mark is (empirically) inaudible
    pseudo-noise at -26 dB that cannot be detected, removed without
    audible damage, or forged. It does NOT resist a key-holder (who can
    do all three) or an adversary who can difference the original and
    marked audio. The reference wraps AudioSeal (audio.rs:333-400),
    whose learned detector additionally survives re-encoding; this is
    the honest classical stand-in with the same report shape.

    Channel-robustness design (tested in tests/test_audio.py, attack
    envelope documented in docs/api-reference.md):
      * amplitude scale / additive noise — detection is a per-bit
        z-score (correlation over the segment's own norm), so gain
        changes cancel and noise only shrinks the z proportionally to
        the SNR; survives 0 dB additive noise and any linear gain.
      * time shift — a keyed PILOT PN (independent of the payload PN)
        rides with the mark; detection cross-correlates the pilot's
        head block over a lag window (FFT matched filter) and decodes
        at the found offset; survives shifts up to max_shift samples.
      * linear resample — a rate search (coarse grid over
        ±rate_search_pct, refined by the lag slope between the pilot's
        head and tail blocks) undoes the time-base change before
        decoding; survives ~±4% linear resampling.
      * clipping — PN chips are sign-coded, so moderate peak clipping
        only trims correlation magnitude.
      * codec-lossy channels — 8-bit mu-law / linear requantization
        barely dent the correlation (quantization noise is uniform and
        uncorrelated with the PN); a half-band decimation round trip
        (8->4->8 kHz, the telephony-chain proxy) kills the PN's upper
        band, and the detector recovers it with a half-band-matched
        template retry (_lowpass_pn) when the full-band decode is
        marginal. Small pitch shift (resample without length
        correction) rides the same rate search as linear resample.
    Marks embedded by older builds (no pilot) still detect at lag 0;
    this build's marks decode under the old detector too (the pilot is
    just more keyed noise at the same strength)."""

    key: str  # per-tenant secret; never logged, never stored in records
    threshold: float = 0.5  # detection threshold (dto.rs:320-323)
    # 0.05 keeps the per-chip matched-filter SNR ~6x above typical host
    # audio leakage (host dot-product sigma ~ amp*sqrt(chip_len))
    strength: float = 0.05
    payload_bits: int = 16
    chip_len: int = 2048  # samples per payload bit
    # sync/pilot channel (set sync=False to skip the search and decode
    # at lag 0 — cheaper, old-mark behavior)
    sync: bool = True
    pilot_gain: float = 0.7  # pilot amplitude = strength * pilot_gain
    max_shift: int = 4096  # lag search window (samples)
    rate_search_pct: float = 4.0  # resample search half-range (%)
    rate_step: float = 5e-4  # coarse rate grid step


@dataclass
class WatermarkReport:
    """Matches the reference report shape (audio.rs:333-400)."""

    detected: bool
    payload: int | None
    confidence: float


def _keyed_pn(key: str, label: str, n: int) -> np.ndarray:
    import hashlib

    if not key:
        raise ModalityError("watermark requires a non-empty key")
    digest = hashlib.blake2b(
        f"{key}|{label}".encode() if label else key.encode(),
        digest_size=32,
    ).digest()
    rng = np.random.default_rng(list(digest))
    return rng.choice(np.array([-1.0, 1.0], np.float32), size=n)


def _pn_sequence(cfg: WatermarkConfig, n: int) -> np.ndarray:
    # label-free: byte-identical to the pre-pilot builds' payload PN,
    # so marks embedded by them keep detecting
    return _keyed_pn(cfg.key, "", n)


def _pilot_sequence(cfg: WatermarkConfig, n: int) -> np.ndarray:
    """Payload-independent sync PN (distinct keyed stream): enables
    shift/rate estimation without knowing the payload bits."""
    return _keyed_pn(cfg.key, "sync", n)


def _lowpass_pn(pn: np.ndarray) -> np.ndarray:
    """Half-band-matched PN template for codec-lossy channels.

    A lossy codec / decimation round trip (u-law+downsample telephony,
    8->4->8 kHz) strips the PN's upper band; correlating what survives
    against the FULL-band template wastes the dead chips' variance in
    the z denominator. Brickwalling the keyed PN at half Nyquist and
    renormalizing to unit RMS matches the template to the channel:
    measured on the half-band round trip it lifts per-bit confidence
    0.54 -> 0.75 while unmarked audio stays ~0.17 (threshold 0.5)."""
    spec = np.fft.rfft(pn.astype(np.float64))
    spec[len(spec) // 2:] = 0.0
    lp = np.fft.irfft(spec, len(pn))
    return (lp / np.sqrt(np.mean(lp * lp) + 1e-12)).astype(np.float32)


def embed_watermark(
    samples: np.ndarray, sample_rate: int, payload: int,
    cfg: WatermarkConfig,
) -> np.ndarray:
    """ucfp-native spread-spectrum watermark: each payload bit modulates a
    keyed PN chip sequence added at `strength` amplitude. The companion
    of detect_watermark — a self-consistent pair standing in for the
    reference's AudioSeal model (which cannot be reproduced offline).
    See WatermarkConfig for the key requirement and threat model."""
    if not (0 <= payload < (1 << cfg.payload_bits)):
        raise ModalityError(
            f"payload must fit {cfg.payload_bits} bits, got {payload:#x}"
        )
    x = _check_input(samples, sample_rate).copy()
    need = cfg.payload_bits * cfg.chip_len
    if len(x) < need:
        raise ModalityError(
            f"watermark needs >= {need} samples, got {len(x)}"
        )
    pn = _pn_sequence(cfg, need)
    for b in range(cfg.payload_bits):
        bit = 1.0 if (payload >> b) & 1 else -1.0
        sl = slice(b * cfg.chip_len, (b + 1) * cfg.chip_len)
        x[sl] += cfg.strength * bit * pn[sl]
    if cfg.sync:
        # payload-independent pilot rides the same span: the detector's
        # shift/rate search matched-filters against it
        x[:need] += cfg.strength * cfg.pilot_gain * _pilot_sequence(cfg, need)
    return x


# detection z-score that maps to confidence 1.0: a clean -26 dB mark on
# typical program audio correlates at ~7 sigma per bit, so 6 sigma is
# "definitely present" while wrong-key/unmarked audio sits at |z|~0.8
_Z_FULL_CONFIDENCE = 6.0

# below this confidence the detector retries with the half-band-matched
# template (_lowpass_pn); above it the full-band decode is already
# unambiguous and the retry would never win
_LOWPASS_RETRY_CONF = 0.75


def _decode_bits(seg: np.ndarray, pn: np.ndarray,
                 cfg: WatermarkConfig) -> tuple[int, float]:
    """Per-bit correlation decode with scale-invariant z-scores: under
    no-mark, dot(seg, pn_chip) ~ N(0, ||seg_chip||) (PN chips are unit
    variance), so z = |dot| / ||seg_chip|| is a detection statistic
    that survives any linear gain and degrades smoothly with noise."""
    payload = 0
    zs = []
    for b in range(cfg.payload_bits):
        sl = slice(b * cfg.chip_len, (b + 1) * cfg.chip_len)
        chunk = seg[sl]
        c = float(np.dot(chunk, pn[sl]))
        sigma = float(np.linalg.norm(chunk))
        z = abs(c) / sigma if sigma > 0 else 0.0
        zs.append(min(z / _Z_FULL_CONFIDENCE, 1.0))
        if c > 0:
            payload |= 1 << b
    return payload, float(np.mean(zs))


def _resample_by(x: np.ndarray, rate: float) -> np.ndarray:
    """Linear resample evaluating x at stride `rate` (rate > 1 shrinks
    the signal: undoes an attacker's slow-down, and vice versa)."""
    if rate == 1.0:
        return x
    pos = np.arange(int(len(x) / rate), dtype=np.float64) * rate
    pos = pos[pos <= len(x) - 1]
    return np.interp(pos, np.arange(len(x), dtype=np.float64), x).astype(
        np.float32
    )


def _xcorr_peak(sig: np.ndarray, template: np.ndarray,
                max_lag: int) -> tuple[int, float]:
    """FFT matched filter: best (lag, z) of `template` inside `sig`
    over lag in [0, max_lag]; z normalizes each candidate window by its
    own energy (scale-invariant, same statistic as _decode_bits)."""
    n = len(template)
    m = min(len(sig), max_lag + n)
    if m < n:
        return 0, 0.0
    sigw = sig[:m]
    size = 1 << int(np.ceil(np.log2(m + n)))
    corr = np.fft.irfft(
        np.fft.rfft(sigw, size) * np.conj(np.fft.rfft(template, size)), size
    )[: m - n + 1]
    # sliding window energy via cumsum
    c2 = np.concatenate([[0.0], np.cumsum(sigw.astype(np.float64) ** 2)])
    energy = c2[n:] - c2[: m - n + 1]
    z = np.abs(corr) / np.sqrt(np.maximum(energy, 1e-12))
    lag = int(np.argmax(z))
    return lag, float(z[lag])


def _sync_candidates(x: np.ndarray, cfg: WatermarkConfig,
                     need: int, top: int = 5) -> list:
    """Candidate (rate, lag) alignments from the pilot PN.

    Coarse pass: grid over ±rate_search_pct; at each candidate rate the
    pilot's HEAD block (one chip_len) is matched-filtered over the lag
    window. A head block only correlates when the residual rate error
    keeps intra-block drift under ~1 sample (chip_len * step/2 ≈ 0.5),
    which pins the coarse step. The TRUE rate can still lose the peak
    contest to a grid neighbor — a shift that lands on a fractional lag
    after resampling halves the interpolated PN's correlation — so the
    top N candidates are all returned and the DECODER arbitrates by
    final per-bit confidence (false candidates decode to noise ~0.13
    and are harmless). The z gate is a cheap sanity floor, not the
    detector."""
    pilot = _pilot_sequence(cfg, need)
    head = pilot[: cfg.chip_len]
    span = cfg.rate_search_pct / 100.0
    n_steps = max(1, int(round(span / cfg.rate_step)))
    rates = 1.0 + np.arange(-n_steps, n_steps + 1) * cfg.rate_step
    scored = []
    for r in rates:
        xr = _resample_by(x, float(r))
        lag, z = _xcorr_peak(xr, head, cfg.max_shift)
        if z >= 3.0:
            scored.append((z, float(r), lag))
    scored.sort(reverse=True)
    return scored[:top]


def _decode_at(x: np.ndarray, pn: np.ndarray, cfg: WatermarkConfig,
               rate: float, lag: int) -> tuple[int, float]:
    """Decode at a candidate (rate, lag) with residual-drift tracking:
    the pilot's TAIL block measured at this rate gives the remaining
    lag-vs-position slope (grid residual + fractional-phase effects),
    and each bit's chip block is re-anchored along that slope — so
    within-bit drift stays sub-sample without a second resample at a
    refined rate."""
    need = cfg.payload_bits * cfg.chip_len
    xr = _resample_by(x, rate)
    # measure residual slope from the pilot tail
    pilot = _pilot_sequence(cfg, need)
    tail_pos = need - cfg.chip_len
    slope = 0.0
    start = lag + tail_pos - cfg.chip_len
    if 0 <= start < len(xr):
        lag_rel, z_b = _xcorr_peak(xr[start:], pilot[tail_pos:need],
                                   2 * cfg.chip_len)
        if z_b >= 3.0:
            slope = (lag_rel - cfg.chip_len) / tail_pos
    best = (0, 0.0)
    for dl in (0, -1, 1):
        payload = 0
        zs = []
        ok = True
        for b in range(cfg.payload_bits):
            pos = b * cfg.chip_len
            s = lag + dl + pos + int(round(slope * pos))
            chunk = xr[s : s + cfg.chip_len]
            if len(chunk) < cfg.chip_len:
                ok = False
                break
            c = float(np.dot(chunk, pn[pos : pos + cfg.chip_len]))
            sigma = float(np.linalg.norm(chunk))
            z = abs(c) / sigma if sigma > 0 else 0.0
            zs.append(min(z / _Z_FULL_CONFIDENCE, 1.0))
            if c > 0:
                payload |= 1 << b
        if ok and zs:
            conf = float(np.mean(zs))
            if conf > best[1]:
                best = (payload, conf)
    return best


def detect_watermark(
    samples: np.ndarray, sample_rate: int, cfg: WatermarkConfig
) -> WatermarkReport:
    """Correlation detector; confidence = mean per-bit z-score capped at
    1.0 (6 sigma). Detection REQUIRES the embedding key (cfg.key) — the
    wrong key correlates to noise and reports not-detected. With
    cfg.sync (default) the keyed pilot proposes shift + resample-rate
    alignments (see WatermarkConfig threat model / attack envelope) and
    the best per-bit decode wins; the lag-0 decode always runs too, so
    pre-pilot marks still detect."""
    x = _check_input(samples, sample_rate)
    need = cfg.payload_bits * cfg.chip_len
    if len(x) < need:
        return WatermarkReport(detected=False, payload=None, confidence=0.0)
    pn = _pn_sequence(cfg, need)
    payload, confidence = _decode_bits(x[:need], pn, cfg)
    cands = _sync_candidates(x, cfg, need) if cfg.sync else []
    for _z, rate, lag in cands:
        p2, c2 = _decode_at(x, pn, cfg, rate, lag)
        if c2 > confidence:
            payload, confidence = p2, c2
        if confidence >= 0.9:
            break  # unambiguous; skip the remaining candidates
    if confidence < _LOWPASS_RETRY_CONF:
        # marginal decode: the channel may have lowpassed the mark
        # (codec / decimation round trip). Retry the same alignments
        # with the half-band-matched template; unmarked/wrong-key audio
        # stays far below threshold either way (tests pin both sides).
        pnl = _lowpass_pn(pn)
        p2, c2 = _decode_bits(x[:need], pnl, cfg)
        if c2 > confidence:
            payload, confidence = p2, c2
        for _z, rate, lag in cands:
            if confidence >= 0.9:
                break
            p2, c2 = _decode_at(x, pnl, cfg, rate, lag)
            if c2 > confidence:
                payload, confidence = p2, c2
    detected = confidence >= cfg.threshold
    return WatermarkReport(
        detected=detected, payload=payload if detected else None, confidence=confidence
    )


# ---------------------------------------------------------------------------
# Streaming Wang session (requires exactly 8 kHz, audio.rs:414-480)
# ---------------------------------------------------------------------------


class StreamingWangSession:
    """Push chunked 8 kHz PCM; emits one Record per completed segment.

    Segments are `segment_secs` long with a `zone + n_fft` tail carried
    into the next segment so landmarks spanning the boundary aren't lost.
    Segment N is stored as record_id = base record_id + N (metadata
    "segment=N"), so callers should leave id headroom between streamed
    records. Each segment is fingerprinted on `device`.

    algorithm="panako" streams tempo-invariant triplets instead (beyond
    the reference, whose streaming is Wang-only) — live recognition of
    pitch/tempo-shifted audio.
    """

    def __init__(
        self,
        tenant_id: int,
        record_id: int,
        sample_rate: int,
        cfg: WangConfig | None = None,
        segment_secs: float = 10.0,
        algorithm: str = "wang",
        device=None,
    ):
        if sample_rate != CANONICAL_SR:
            raise ModalityError(
                f"streaming wang requires exactly {CANONICAL_SR} Hz, got {sample_rate}"
            )
        if algorithm not in ("wang", "panako"):
            raise ModalityError(
                f"streaming supports wang|panako, got {algorithm!r}"
            )
        self.algorithm = algorithm
        self.tenant_id = tenant_id
        self.record_id = record_id
        self.device = device
        if cfg is None:
            cfg = WangConfig() if algorithm == "wang" else None
        self.cfg = cfg
        # panako's wider default zone needs the matching halo
        zone_t = (cfg.target_zone_t if cfg is not None
                  else PanakoConfig().target_zone_t)
        self.segment = int(segment_secs * CANONICAL_SR)
        self.halo = (zone_t + 4) * 256  # zone frames * hop
        self._buf = np.zeros(0, np.float32)
        self._seg_index = 0
        self._closed = False
        # samples at the buffer head already covered by the previous
        # segment (the carried halo); finalize must measure NEW material
        # beyond it, or a stream ending exactly at a segment boundary
        # would emit a record made entirely of re-hashed old samples
        self._carry = 0

    def push(self, chunk: np.ndarray) -> list[Record]:
        if self._closed:
            raise ModalityError("session closed")
        self._buf = np.concatenate([self._buf, np.asarray(chunk, np.float32)])
        out = []
        while len(self._buf) >= self.segment + self.halo:
            seg = self._buf[: self.segment + self.halo]
            out.append(self._emit(seg))
            self._buf = self._buf[self.segment :]
            self._carry = self.halo
        return out

    def finalize(self) -> list[Record]:
        if self._closed:
            raise ModalityError("session closed")
        self._closed = True
        fresh = len(self._buf) - self._carry
        if fresh >= CANONICAL_SR // 2:  # at least half a second NEW audio
            return [self._emit(self._buf)]
        return []

    def _emit(self, seg: np.ndarray) -> Record:
        # each segment gets its own record identity (base id + index) —
        # re-using one id would make every upsert overwrite the previous
        # segment's landmarks
        rid = self.record_id + self._seg_index
        if self.algorithm == "panako":
            rec = fingerprint_panako(seg, CANONICAL_SR, self.tenant_id, rid,
                                     self.cfg, device=self.device)
        else:
            rec = fingerprint_wang(seg, CANONICAL_SR, self.tenant_id, rid,
                                   self.cfg, device=self.device)
        rec.metadata = f"segment={self._seg_index}".encode()
        self._seg_index += 1
        return rec


# ---------------------------------------------------------------------------
# Inspect (audio.rs:600-699)
# ---------------------------------------------------------------------------


_VIRIDIS_STOPS = np.array(
    # (r, g, b) anchors of the viridis colormap, interpolated linearly
    [(68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98), (253, 231, 37)],
    dtype=np.float32,
)


def _spec_png_b64(grid: np.ndarray, target_w: int = 256) -> str:
    """Magnitude grid [T, F] -> viridis PNG (freq up, time right), b64.

    Mirrors the reference inspector's spectrogram rendering
    (audio.rs:648-652: linear grid downsampled by time-axis peak pooling,
    painted viridis). Log-compressed for visibility.
    """
    import base64

    from PIL import Image

    t_dim, f_dim = grid.shape
    w = min(target_w, max(t_dim, 1))
    # peak-pool the time axis down to w columns
    edges = (np.arange(w + 1) * t_dim / w).astype(int)
    pooled = np.stack(
        [grid[edges[i]:max(edges[i + 1], edges[i] + 1)].max(axis=0)
         for i in range(w)]
    )  # [w, F]
    db = np.log10(pooled + 1e-9)
    lo, hi = db.min(), db.max()
    norm = (db - lo) / max(hi - lo, 1e-9)  # [w, F] in 0..1
    pos = norm * (len(_VIRIDIS_STOPS) - 1)
    i0 = np.clip(pos.astype(int), 0, len(_VIRIDIS_STOPS) - 2)
    frac = (pos - i0)[..., None]
    rgb = (_VIRIDIS_STOPS[i0] * (1 - frac) + _VIRIDIS_STOPS[i0 + 1] * frac)
    img = rgb.transpose(1, 0, 2)[::-1].astype(np.uint8)  # freq up, time right
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _downsample_envelope(x: np.ndarray, buckets: int) -> list[float]:
    n = len(x)
    out = []
    for i in range(buckets):
        lo = i * n // buckets
        hi = max(lo + 1, (i + 1) * n // buckets)
        out.append(float(np.max(np.abs(x[lo:hi]))))
    return out


def inspect_audio(
    samples: np.ndarray,
    sample_rate: int,
    algorithm: str = "wang",
    cfg: WangConfig | None = None,
    device=None,
) -> dict:
    """Shared DSP stages (envelope, spectrograms, peaks, landmark pairs)
    plus the selected algorithm's fingerprint. The spectrogram, the peak
    pick and the fingerprints run on `device`; the mel grid is computed
    on the host from the exact power grid (float64 products rounded to
    float32), so it is the same wherever the spectrogram ran."""
    x = _check_input(samples, sample_rate)
    cfg = cfg or WangConfig()
    duration_secs = len(x) / sample_rate
    if algorithm in ("wang", "panako") and sample_rate != CANONICAL_SR:
        # the stored fingerprint is computed at the canonical rate; the
        # overlay must show the same constellation the hash actually uses
        x = dsp.resample_linear(x, sample_rate, CANONICAL_SR)
        sample_rate = CANONICAL_SR

    envelope = _downsample_envelope(x, 256)

    # ONE STFT + peak pick serves the peak list, the landmark overlay,
    # AND (for wang) the fingerprint itself
    t, f, mags, power, hashes, t1 = constellation.peaks_and_landmarks(
        x, sample_rate, cfg, device=device
    )
    n_frames, n_bins = power.shape
    max_mag = max(float(power.max()), 1e-9)
    bin_hz = sample_rate / 1024.0
    frame_ms = 1000.0 * 256.0 / sample_rate

    peaks = [
        {
            "t_ms": float(tt) * frame_ms,
            "freq_hz": float(ff) * bin_hz,
            "db": 10.0 * math.log10(max(float(m), 1e-9) / max_mag),
        }
        for tt, ff, m in list(zip(t, f, mags))[:256]
    ]

    # landmark pairs for the overlay (capped at 256)
    landmarks = []
    for h, a in list(zip(hashes, t1))[:256]:
        f1 = (int(h) >> 22) & 0x3FF
        f2 = (int(h) >> 12) & 0x3FF
        dt = int(h) & 0xFFF
        landmarks.append(
            {
                "t1_ms": float(a) * frame_ms,
                "f1_hz": f1 * bin_hz,
                "t2_ms": (float(a) + dt) * frame_ms,
                "f2_hz": f2 * bin_hz,
            }
        )

    # mel spectrogram (64 Slaney bands over full range, audio.rs:656-665)
    bank = dsp.mel_filterbank(64, 1024, sample_rate, 0.0, sample_rate / 2)
    mel = (power.astype(np.float64) @ bank.astype(np.float64)).astype(np.float32)
    lin_spec_png = _spec_png_b64(power)
    mel_spec_png = _spec_png_b64(mel)

    if algorithm == "wang":
        # assemble the Record from the landmarks already computed above —
        # identical packing to fingerprint_wang, zero extra device work
        buf = np.empty((len(hashes), 2), dtype="<u4")
        buf[:, 0] = hashes
        buf[:, 1] = t1
        fp = Record(
            tenant_id=0, record_id=0, modality=Modality.AUDIO,
            algorithm=ALGORITHM_WANG, fingerprint=buf.tobytes(),
            config_hash=_wang_cfg_hash(cfg, ALGORITHM_WANG),
        )
    elif algorithm == "panako":
        fp = fingerprint_panako(x, sample_rate, 0, 0, device=device)
    elif algorithm == "haitsma":
        fp = fingerprint_haitsma(x, sample_rate, 0, 0, device=device)
    elif algorithm == "neural":
        fp = fingerprint_neural(x, sample_rate, 0, 0, device)
    else:
        raise ModalityError(f"unknown inspect algorithm {algorithm!r}")

    return {
        "algorithm": fp.algorithm,
        "duration_secs": duration_secs,
        "sample_rate": sample_rate,
        "envelope": envelope,
        "n_frames": int(n_frames),
        "n_bins": int(n_bins),
        "mel_bands": int(mel.shape[1]),
        "lin_spec_png_b64": lin_spec_png,
        "mel_spec_png_b64": mel_spec_png,
        "peaks": peaks,
        "total_peaks": int(len(t)),
        "landmarks": landmarks,
        "total_landmarks": int(len(hashes)),
        "fingerprint_hex": fp.fingerprint.hex()[:4096],
        "fingerprint_bytes": len(fp.fingerprint),
        "config_hash": fp.config_hash,
    }
