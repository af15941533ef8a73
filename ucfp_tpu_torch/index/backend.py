"""IndexBackend trait: the storage + ANN abstraction (layer 3).

Same shape as the reference trait (src/index/mod.rs:18-78): async
upsert/delete/knn/bm25/bm25_explain/flush/get_record_metadata, with
bm25_explain defaulting to bm25-without-breakdown and
get_record_metadata defaulting to Unsupported.

Copied from ucfp_tpu/index/backend.py; only its imports differ.
"""

from __future__ import annotations

import abc
from typing import Optional

from ..core import FingerprintMeta, Hit, TermHit, UnsupportedError

# the filter shape this build supports (a capability beyond the
# reference's unimplemented Query.filter): restrict vector hits to
# records carrying a specific algorithm and/or model_id
FILTER_KEYS = frozenset(("algorithm", "model_id"))


def validate_filter(flt) -> None:
    """Raise Unsupported (501 at the HTTP layer) for any filter shape
    this build cannot honor — never silently drop a filter."""
    if flt is None:
        return
    if not isinstance(flt, dict) or not flt or not (
        set(flt) <= FILTER_KEYS
    ) or not all(isinstance(v, str) for v in flt.values()):
        raise UnsupportedError(
            'supported filter shape: {"algorithm": str, "model_id": str}'
        )


class IndexBackend(abc.ABC):
    @abc.abstractmethod
    async def upsert(self, records: list) -> None: ...

    async def upsert_fingerprint_batch(
        self,
        tenant_id: int,
        algorithm: str,
        record_ids: list[int],
        fingerprints: list[bytes],
        *,
        modality=None,
        config_hash: int = 0,
        format_version: int = 1,
    ) -> None:
        """Uniform fingerprint-only batch upsert. Semantically identical
        to upsert() of the corresponding Records; backends may override
        with a columnar fast path (EmbeddedBackend does)."""
        from ..core import Modality, Record

        if modality is None:
            modality = Modality.IMAGE
        await self.upsert([
            Record(tenant_id=tenant_id, record_id=rid, modality=modality,
                   algorithm=algorithm, fingerprint=fp,
                   config_hash=config_hash, format_version=format_version)
            for rid, fp in zip(record_ids, fingerprints)
        ])

    @abc.abstractmethod
    async def delete(self, tenant_id: int, record_ids: list[int]) -> None: ...

    @abc.abstractmethod
    async def knn(
        self,
        tenant_id: int,
        query: list[float],
        k: int,
        filter: Optional[dict] = None,
        pool_frac: Optional[float] = None,
        exact: bool = False,
    ) -> list[Hit]:
        """pool_frac: optional per-request sketch rescore-pool override
        (extension; ignored by backends without a sketch path).
        exact: force the fully-exact scan — no sketch prefilter, no
        fused partial-reduce (extension; a backend whose only path is
        exact may ignore it)."""
        ...

    @abc.abstractmethod
    async def bm25(self, tenant_id: int, terms: list[str], k: int) -> list[Hit]: ...

    async def bm25_explain(
        self, tenant_id: int, terms: list[str], k: int
    ) -> list[tuple[Hit, list[TermHit]]]:
        """Default: delegate to bm25 with empty breakdowns (src/index/mod.rs)."""
        return [(h, []) for h in await self.bm25(tenant_id, terms, k)]

    @abc.abstractmethod
    async def flush(self) -> None: ...

    async def get_record_metadata(
        self, tenant_id: int, record_id: int
    ) -> FingerprintMeta:
        raise UnsupportedError("get_record_metadata not supported by this backend")
