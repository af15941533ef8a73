"""Deterministic stand-in encoders (port of ucfp_tpu/models/encoders.py).

  * image_encode        512-d, 2-layer MLP over the exact-int 32x32 RGB
  * audio_logmel_encode 128-d per log-mel window (96 frames x 64 mels)
  * text_hash_embed     384-d signed feature hashing (words + bigrams)

The two MLPs are `StandinMLP` modules on the caller's device:
tanh(x @ w1) @ w2, L2-normalized with a floor of 1e-9, in float32 with
TF32 off (the reference's Precision.HIGHEST). Their weights are the
reference's: drawn from the same jax PRNG keys by models/jaxrand.py, a
numpy regeneration of jax.random that is bit-equal to it, or handed over
from the reference's arrays with `StandinMLP.from_jax_params`. The
products are plain matrix products, which the reference also leaves to
XLA outside any Pallas kernel. text_hash_embed is host numpy and xxhash,
copied.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import jaxrand

# The "standin-" prefix is a contract: these are seeded random-weight
# encoders, deterministic and device-batched but NOT semantically
# meaningful. Every record/response carries the prefix so a
# default-config user cannot mistake random projections for a real
# embedding model (mount one via UCFP_MODEL_DIR — models/hf_local.py —
# and the prefix disappears with it). model_id does not feed
# config_hash, so the stamp costs nothing in fingerprint compatibility.
IMAGE_MODEL_ID = "standin-ucfp-image-embed-512-v2"  # v2: jitted forward (fused f32 order)
AUDIO_MODEL_ID = "standin-ucfp-audio-logmel-mlp-v2"  # v2: jitted forward (fused f32 order)
TEXT_MODEL_ID = "standin-ucfp-hash-embed-384-v1"

IMAGE_DIM = 512
AUDIO_DIM = 128
TEXT_DIM = 384

AUDIO_MELS = 64
AUDIO_WIN = 96  # frames per window
AUDIO_HOP = 48

IMAGE_KEY = 0x1A6E
AUDIO_KEY = 0xA0D10


class StandinMLP(torch.nn.Module):
    """tanh(x @ w1) @ w2, rows L2-normalized (norm floored at 1e-9)."""

    def __init__(self, w1: np.ndarray, w2: np.ndarray):
        super().__init__()
        self.register_buffer("w1", torch.tensor(np.asarray(w1, np.float32)))
        self.register_buffer("w2", torch.tensor(np.asarray(w2, np.float32)))

    @classmethod
    def from_jax_params(cls, w1, w2) -> "StandinMLP":
        """The reference's (w1, w2) arrays (jax or numpy) as a module."""
        return cls(np.asarray(w1, np.float32), np.asarray(w2, np.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        h = torch.tanh(torch.matmul(x.to(torch.float32), self.w1))
        e = torch.matmul(h, self.w2)
        return e / torch.linalg.vector_norm(e, dim=1, keepdim=True).clamp_min(1e-9)


def _standin_params(seed: int, d_in: int, d_hidden: int, d_out: int,
                    s1: float, s2: float) -> tuple[np.ndarray, np.ndarray]:
    k1, k2 = jaxrand.split(jaxrand.prng_key(seed), 2)
    w1 = jaxrand.normal(k1, (d_in, d_hidden)) * np.float32(s1)
    w2 = jaxrand.normal(k2, (d_hidden, d_out)) * np.float32(s2)
    return w1, w2


@functools.lru_cache(maxsize=1)
def image_params() -> tuple[np.ndarray, np.ndarray]:
    """The reference's _image_params: PRNGKey(0x1A6E), 3072x1024, 1024x512."""
    d_in = 32 * 32 * 3
    return _standin_params(IMAGE_KEY, d_in, 1024, IMAGE_DIM,
                           1.0 / d_in**0.5, 1.0 / 32.0)


@functools.lru_cache(maxsize=1)
def audio_params() -> tuple[np.ndarray, np.ndarray]:
    """The reference's _audio_params: PRNGKey(0xA0D10), 6144x512, 512x128."""
    d_in = AUDIO_WIN * AUDIO_MELS
    return _standin_params(AUDIO_KEY, d_in, 512, AUDIO_DIM,
                           1.0 / math.sqrt(d_in), 1.0 / math.sqrt(512))


@functools.lru_cache(maxsize=8)
def _image_model(device: str) -> StandinMLP:
    return StandinMLP(*image_params()).to(device).eval()


@functools.lru_cache(maxsize=8)
def _audio_model(device: str) -> StandinMLP:
    return StandinMLP(*audio_params()).to(device).eval()


def _run(model: StandinMLP, x, device: torch.device) -> np.ndarray:
    with torch.no_grad():
        t = torch.as_tensor(x, dtype=torch.float32).to(device)
        return model(t).cpu().numpy().astype(np.float32)


def image_encode(x_flat, device) -> np.ndarray:
    """[B, 3072] f32 in [0,1] -> [B, 512] L2-normalized f32."""
    dev = torch.device(device)
    return _run(_image_model(str(dev)), x_flat, dev)


def audio_logmel_encode(windows, device) -> np.ndarray:
    """[n_win, 96*64] log-mel windows (tensor or numpy) -> [n_win, 128]
    L2-normalized f32."""
    dev = torch.device(device)
    return _run(_audio_model(str(dev)), windows, dev)


def text_hash_embed(tokens: list[str]) -> np.ndarray:
    """Signed feature hashing over words + word-bigrams -> [384] unit f32.

    Raises ValueError on empty/degenerate input (the modality layer maps
    it to a 400).
    """
    import xxhash

    if not tokens:
        raise ValueError("no tokens for semantic embedding")
    feats = tokens + [f"{a}\x1f{b}" for a, b in zip(tokens, tokens[1:])]
    v = np.zeros(TEXT_DIM, np.float64)
    for f in feats:
        h = xxhash.xxh3_64_intdigest(f.encode("utf-8"))
        idx = h % TEXT_DIM
        sign = 1.0 if (h >> 63) else -1.0
        v[idx] += sign
    n = np.linalg.norm(v)
    if n == 0:
        raise ValueError("degenerate semantic embedding")
    return (v / n).astype(np.float32)
