"""Core record / query / hit contract.

Modality-agnostic data model mirroring the reference wire semantics
(reference: src/core/mod.rs:19-205). These are plain Python dataclasses on
the host side; device code never sees them — kernels consume/produce dense
arrays and the host layer wraps them into Records.

Wire invariants kept identical to the reference:
  * Record identity is ``(tenant_id: u32, record_id: u64)``.
  * ``fingerprint`` is raw bytes whose layout is algorithm-defined.
  * ``embedding`` is an optional dense f32 vector used by cosine k-NN.
  * ``config_hash`` marks records for cross-config comparability:
    ``Record.compatible_with`` is the library-level guard. Like the
    reference (whose knn scan also never consults it), the query paths
    do NOT enforce it — use the query ``filter`` on algorithm/model_id
    to scope comparisons (src/core/mod.rs:43-55).
  * ``format_version`` gates resume compatibility.

Copied from ucfp_tpu/core/types.py; only its imports and one comment
differ (it no longer quotes the reference's measurements).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

FORMAT_VERSION = 1

U32_MAX = 0xFFFF_FFFF
U64_MAX = 0xFFFF_FFFF_FFFF_FFFF


class Modality(enum.Enum):
    """Content modality (reference: src/core/mod.rs Modality enum)."""

    TEXT = "text"
    IMAGE = "image"
    AUDIO = "audio"

    @classmethod
    def parse(cls, s: str) -> "Modality":
        try:
            return cls(s.lower())
        except ValueError:
            from .errors import ModalityError

            raise ModalityError(f"unknown modality: {s!r}")


def _check_u32(name: str, v: int) -> int:
    if not (0 <= v <= U32_MAX):
        raise ValueError(f"{name} out of u32 range: {v}")
    return v


def _check_u64(name: str, v: int) -> int:
    if not (0 <= v <= U64_MAX):
        raise ValueError(f"{name} out of u64 range: {v}")
    return v


@dataclass
class Record:
    """One stored fingerprint row (reference: src/core/mod.rs:34-72)."""

    tenant_id: int
    record_id: int
    modality: Modality
    algorithm: str
    fingerprint: bytes
    format_version: int = FORMAT_VERSION
    config_hash: int = 0
    embedding: Optional[list[float]] = None
    model_id: Optional[str] = None
    metadata: bytes = b""
    text: Optional[str] = None

    def __post_init__(self) -> None:
        _check_u32("tenant_id", self.tenant_id)
        _check_u64("record_id", self.record_id)
        _check_u64("config_hash", self.config_hash)
        if isinstance(self.modality, str):
            self.modality = Modality.parse(self.modality)

    def compatible_with(self, other: "Record") -> bool:
        """Two records are comparable only when algorithm + config match
        (reference: src/core/mod.rs:43-55)."""
        return (
            self.modality == other.modality
            and self.algorithm == other.algorithm
            and self.config_hash == other.config_hash
            and self.format_version == other.format_version
        )


@dataclass
class FingerprintMeta:
    """Catalog metadata for a stored record (src/core/mod.rs:81-104)."""

    tenant_id: int
    record_id: int
    modality: Modality
    algorithm: str
    config_hash: int
    format_version: int
    fingerprint_bytes: int
    has_embedding: bool
    model_id: Optional[str] = None


class HitSource(enum.Enum):
    """Which retrieval leg produced a hit (src/core/mod.rs HitSource)."""

    VECTOR = "vector"
    BM25 = "bm25"
    FUSED = "fused"


@dataclass
class TermHit:
    """Per-term BM25 contribution for explain mode (src/core/mod.rs:195-205)."""

    term: str
    tf: int
    idf: float
    contribution: float


@dataclass
class Hit:
    """One search result with optional RRF breakdown (src/core/mod.rs:107-131)."""

    record_id: int
    score: float
    source: HitSource = HitSource.VECTOR
    vector_score: Optional[float] = None
    bm25_score: Optional[float] = None
    vector_rank: Optional[int] = None
    bm25_rank: Optional[int] = None
    term_hits: Optional[list[TermHit]] = None


# The sketch rescore-pool ladder. Every entry point that accepts a
# per-request pool override (HTTP recall_tier, Query.pool_frac, direct
# EmbeddedBackend.knn calls) quantizes to THESE values: each distinct
# pool size compiles its own kernel in the reference build, so a free
# float would let any embedded/SDK caller
# force unbounded recompiles — the invariant must hold at the core
# type, not just at the HTTP layer. Values are re-tuned against
# captured benchmarks (see ucfp_tpu/ops/knn.py DEFAULT_POOL_FRAC).
POOL_FRAC_TIERS: tuple[float, ...] = (0.0066, 0.021, 0.042)


def quantize_pool_frac(frac: "Optional[float]") -> "Optional[float]":
    """Snap an arbitrary pool fraction onto POOL_FRAC_TIERS (nearest
    tier). None passes through (backend default)."""
    if frac is None:
        return None
    f = float(frac)
    if not (f > 0.0):  # rejects <=0 and NaN in one test
        raise ValueError("pool_frac must be a positive fraction")
    return min(POOL_FRAC_TIERS, key=lambda t: abs(t - f))


@dataclass
class Query:
    """Hybrid retrieval request (src/core/mod.rs:153-189)."""

    tenant_id: int
    modality: Modality
    k: int = 10
    vector: Optional[list[float]] = None
    terms: list[str] = field(default_factory=list)
    filter: Optional[dict] = None
    rrf_k: int = 60
    explain: bool = False
    # per-request sketch pool override (extension): None = the backend
    # default. Quantized to POOL_FRAC_TIERS in __post_init__ so distinct
    # values cannot force unbounded kernel recompiles — enforced here at
    # the core type, for every caller, not just the HTTP handler.
    pool_frac: Optional[float] = None
    # force the fully-exact vector scan (extension): skips the sketch
    # prefilter AND the fused partial-reduce candidate path, so the
    # response is never marked approximate. Costs the exhaustive-kernel
    # latency regardless of UCFP_KNN_QUANT.
    exact: bool = False

    def __post_init__(self) -> None:
        _check_u32("tenant_id", self.tenant_id)
        if isinstance(self.modality, str):
            self.modality = Modality.parse(self.modality)
        if self.k < 1:
            self.k = 1
        if self.rrf_k < 0:
            # rrf_k = -1 would divide by zero at rank 1 in the fusion;
            # other negatives silently invert the ranking
            raise ValueError("rrf_k must be >= 0")
        if self.exact and self.pool_frac is not None:
            # a pool override tunes the approximate prefilter; asking for
            # both is a contradiction, not a preference order
            raise ValueError("exact=True conflicts with pool_frac")
        self.pool_frac = quantize_pool_frac(self.pool_frac)
