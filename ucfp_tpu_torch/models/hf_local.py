"""Real semantic encoders from local HuggingFace weights (optional).

Port of ucfp_tpu/models/hf_local.py, which already runs transformers
through torch: here the model and its inputs go to the caller's device
(the backend's: the CUDA card unless the caller asks for the CPU), one
loaded bundle per device.

The zero-egress build ships seeded stand-in encoders (encoders.py) so
"semantic" search always works mechanically. Deployments that place
real model weights on disk get real semantics with no code change
(the reference's local ONNX MiniLM/CLIP providers, text.rs:500-606,
image.rs:210-241 — here realized over torch transformers):

    UCFP_MODEL_DIR=/models        # containing text/, image/ and/or audio/
    /models/text/   -> any AutoModel+AutoTokenizer sentence encoder
                       (MiniLM, BGE, E5, ...); mean-pooled + L2-norm
    /models/image/  -> any AutoModel+AutoImageProcessor vision encoder
                       (CLIP vision tower, ViT, ...); pooled + L2-norm
    /models/audio/  -> any AutoModel+AutoFeatureExtractor waveform
                       encoder (wav2vec2, HuBERT, AST, ...); the
                       waveform is resampled to the extractor's rate,
                       windowed, and each window is mean-pooled +
                       L2-normalized (the reference's ONNX log-mel
                       per-window embedder, audio.rs:268-321)

When a directory is absent the seeded stand-in stays active and
`model_id` keeps its stand-in tag, so records always say which encoder
produced them (config-compat gating works across the switch).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

from ..device import resolve_device


def model_dir(kind: str) -> Optional[str]:
    base = os.environ.get("UCFP_MODEL_DIR")
    if not base:
        return None
    path = os.path.join(base, kind)
    if os.path.isfile(os.path.join(path, "config.json")):
        return path
    return None


def available(kind: str) -> bool:
    return model_dir(kind) is not None


def _model_id(path: str) -> str:
    """Stable id for records: the model's name_or_path when the config
    carries one, else the directory name."""
    import json

    try:
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        name = cfg.get("_name_or_path") or cfg.get("name_or_path")
        if name and not os.path.isabs(str(name)):
            return str(name)
    except (OSError, ValueError):
        pass
    return "local:" + os.path.basename(os.path.normpath(path))


@functools.lru_cache(maxsize=4)
def _text_bundle(device: str):
    import torch
    from transformers import AutoModel, AutoTokenizer

    path = model_dir("text")
    assert path is not None
    tok = AutoTokenizer.from_pretrained(path)
    model = AutoModel.from_pretrained(path)
    model.to(device).eval()
    torch.set_grad_enabled(False)
    return tok, model, _model_id(path)


def text_embed(text: str, max_length: int = 512,
               device=None) -> tuple[np.ndarray, str]:
    """-> (L2-normalized f32 embedding, model_id). Mean pooling over the
    attention mask — the standard sentence-encoder readout."""
    import torch

    device = resolve_device(device)
    tok, model, mid = _text_bundle(str(device))
    enc = tok(text, return_tensors="pt", truncation=True,
              max_length=max_length).to(device)
    with torch.no_grad():
        hidden = model(**enc).last_hidden_state[0]  # [T, H]
    mask = enc["attention_mask"][0].unsqueeze(-1).to(hidden.dtype)
    pooled = (hidden * mask).sum(0) / mask.sum().clamp(min=1.0)
    v = pooled.cpu().numpy().astype(np.float32)
    n = float(np.linalg.norm(v))
    if n == 0.0:
        raise ValueError("degenerate local-model embedding")
    return v / n, mid


@functools.lru_cache(maxsize=4)
def _image_bundle(device: str):
    import torch
    from transformers import AutoImageProcessor, AutoModel

    path = model_dir("image")
    assert path is not None
    proc = AutoImageProcessor.from_pretrained(path)
    model = AutoModel.from_pretrained(path)
    model.to(device).eval()
    torch.set_grad_enabled(False)
    return proc, model, _model_id(path)


def image_embed(rgb: np.ndarray, device=None) -> tuple[np.ndarray, str]:
    """uint8 [H, W, 3] -> (L2-normalized f32 embedding, model_id)."""
    import torch

    device = resolve_device(device)
    proc, model, mid = _image_bundle(str(device))
    enc = proc(images=rgb, return_tensors="pt").to(device)
    with torch.no_grad():
        out = model(**enc)
    pooled = getattr(out, "pooler_output", None)
    if pooled is not None:
        v = pooled[0]
    else:
        v = out.last_hidden_state[0].mean(0)
    v = v.cpu().numpy().astype(np.float32)
    n = float(np.linalg.norm(v))
    if n == 0.0:
        raise ValueError("degenerate local-model embedding")
    return v / n, mid


@functools.lru_cache(maxsize=4)
def _audio_bundle(device: str):
    import torch
    from transformers import AutoFeatureExtractor, AutoModel

    path = model_dir("audio")
    assert path is not None
    proc = AutoFeatureExtractor.from_pretrained(path)
    model = AutoModel.from_pretrained(path)
    model.to(device).eval()
    torch.set_grad_enabled(False)
    return proc, model, _model_id(path)


def audio_embed(
    samples: np.ndarray, sample_rate: int,
    win_secs: float = 2.0, hop_secs: float = 1.0, device=None,
) -> tuple[np.ndarray, str]:
    """f32 mono [N] -> ([n_win, H] per-window L2-normalized embeddings,
    model_id). Mirrors the reference's per-window neural path
    (audio.rs:268-321): resample to the extractor's rate, slide a
    win/hop window over the waveform, embed every window."""
    import torch

    device = resolve_device(device)
    proc, model, mid = _audio_bundle(str(device))
    target_sr = int(getattr(proc, "sampling_rate", 16000) or 16000)
    x = np.asarray(samples, np.float32)
    if sample_rate != target_sr:
        from ..ops.audio.dsp import resample_linear

        x = np.asarray(resample_linear(x, sample_rate, target_sr), np.float32)
    win = max(1, int(win_secs * target_sr))
    hop = max(1, int(hop_secs * target_sr))
    if len(x) < win:
        x = np.pad(x, (0, win - len(x)))
    windows = [x[i:i + win] for i in range(0, len(x) - win + 1, hop)]
    enc = proc(windows, sampling_rate=target_sr, return_tensors="pt",
               padding=True).to(device)
    with torch.no_grad():
        out = model(**enc)
    pooled = getattr(out, "pooler_output", None)
    if pooled is None:
        pooled = out.last_hidden_state.mean(1)  # [B, H]
    v = pooled.cpu().numpy().astype(np.float32)
    norms = np.linalg.norm(v, axis=1, keepdims=True)
    if not np.all(norms > 0.0):
        raise ValueError("degenerate local-model audio embedding")
    return v / norms, mid


def reset_cache() -> None:
    """Drop loaded models (tests switch UCFP_MODEL_DIR between cases)."""
    _text_bundle.cache_clear()
    _image_bundle.cache_clear()
    _audio_bundle.cache_clear()
