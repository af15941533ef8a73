"""Model families: the semantic/neural encoders behind the embedding
algorithms (port of ucfp_tpu/models/__init__.py).

The default models are the reference's deterministic stand-ins: fixed
weights from seeded PRNG keys, regenerated without jax (jaxrand.py), so
embeddings are reproducible with zero downloads; each carries a stable
model_id, and trained checkpoints slot in behind the same seam
(hf_local.py, UCFP_MODEL_DIR).
"""

from .encoders import (
    AUDIO_MODEL_ID,
    IMAGE_MODEL_ID,
    TEXT_MODEL_ID,
    audio_logmel_encode,
    image_encode,
    text_hash_embed,
)

__all__ = [
    "IMAGE_MODEL_ID",
    "AUDIO_MODEL_ID",
    "TEXT_MODEL_ID",
    "image_encode",
    "audio_logmel_encode",
    "text_hash_embed",
]
