"""Optional second-stage reranking (reference: src/rerank/mod.rs:17-32).

Copied from ucfp_tpu/rerank/__init__.py; only its imports differ.
"""

from __future__ import annotations

import abc

from ..core import Hit, Query


class Reranker(abc.ABC):
    @abc.abstractmethod
    async def rerank(self, query: Query, hits: list[Hit]) -> list[Hit]: ...


class NoopReranker(Reranker):
    """Identity reranker."""

    async def rerank(self, query: Query, hits: list[Hit]) -> list[Hit]:
        return hits


__all__ = ["Reranker", "NoopReranker"]
