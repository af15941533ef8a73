"""Core types and errors (layer 1).

Copied from ucfp_tpu/core/__init__.py; only its imports differ.
"""

from .errors import (
    ALL_ERRORS,
    ForbiddenError,
    IncompatibleError,
    IndexError_,
    IngestError,
    IoError,
    ModalityError,
    ProviderError,
    RecordNotFound,
    RerankError,
    UcfpError,
    UnsupportedError,
)
from .types import (
    FORMAT_VERSION,
    POOL_FRAC_TIERS,
    FingerprintMeta,
    Hit,
    HitSource,
    Modality,
    Query,
    Record,
    TermHit,
    quantize_pool_frac,
)

__all__ = [
    "FORMAT_VERSION",
    "POOL_FRAC_TIERS",
    "quantize_pool_frac",
    "FingerprintMeta",
    "Hit",
    "HitSource",
    "Modality",
    "Query",
    "Record",
    "TermHit",
    "UcfpError",
    "ModalityError",
    "ProviderError",
    "IncompatibleError",
    "IndexError_",
    "IngestError",
    "RerankError",
    "IoError",
    "RecordNotFound",
    "UnsupportedError",
    "ForbiddenError",
    "ALL_ERRORS",
]
