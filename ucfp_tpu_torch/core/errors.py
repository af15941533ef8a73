"""Error taxonomy with stable HTTP mappings.

Mirrors the reference's nine-variant error model and its HTTP code mapping
(reference: src/error.rs:9-61, src/server/error.rs:24-34):

    Modality        -> 400  bad input for the requested modality/algorithm
    Incompatible    -> 409  config_hash / format_version mismatch
    Index           -> 500  storage engine failure
    Ingest          -> 503  ingest source unavailable
    Rerank          -> 500  rerank stage failure
    Io              -> 500  host I/O failure
    RecordNotFound  -> 404
    Unsupported     -> 501  algorithm not enabled in this build
    Forbidden       -> 403  cross-tenant access

Copied from ucfp_tpu/core/errors.py; only its imports differ.
"""

from __future__ import annotations


class UcfpError(Exception):
    """Base error; `http_status` drives the server's error envelope."""

    http_status = 500
    code = "internal"

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message


class ModalityError(UcfpError):
    http_status = 400
    code = "modality"


class IncompatibleError(UcfpError):
    http_status = 409
    code = "incompatible"


class IndexError_(UcfpError):
    http_status = 500
    code = "index"


class IngestError(UcfpError):
    http_status = 503
    code = "ingest"


class RerankError(UcfpError):
    http_status = 500
    code = "rerank"


class IoError(UcfpError):
    http_status = 500
    code = "io"


class RecordNotFound(UcfpError):
    http_status = 404
    code = "record_not_found"


class UnsupportedError(UcfpError):
    http_status = 501
    code = "unsupported"


class ForbiddenError(UcfpError):
    http_status = 403
    code = "forbidden"


class ProviderError(UcfpError):
    """A remote embedding provider (OpenAI/Voyage/Cohere) failed or
    answered garbage — surfaced as 502 Bad Gateway (extension variant:
    the reference folds provider failures into Modality/400 because its
    SDK stringifies them; a gateway failure is not a client error)."""

    http_status = 502
    code = "provider"


ALL_ERRORS = [
    ModalityError,
    IncompatibleError,
    IndexError_,
    IngestError,
    RerankError,
    IoError,
    RecordNotFound,
    UnsupportedError,
    ForbiddenError,
    ProviderError,
]
