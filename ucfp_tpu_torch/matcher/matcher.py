"""Query-time orchestrator (reference: src/matcher/mod.rs:140-207).

Dispatch on query shape:
  * vector + terms -> hybrid: knn and bm25 run concurrently, fused by RRF,
    term_hits carried from the BM25 leg onto the fused hits
  * vector only    -> knn
  * terms only     -> bm25 (with explain breakdown when requested)
  * neither        -> empty

The optional reranker runs on the top-k after fusion.

Copied from ucfp_tpu/matcher/matcher.py; only its imports differ.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..core import Hit, HitSource, Query
from ..index.backend import IndexBackend
from ..rerank import Reranker
from .rrf import rrf_with_sources


class Matcher:
    def __init__(self, index: IndexBackend, reranker: Optional[Reranker] = None):
        self.index = index
        self.reranker = reranker

    async def _filter_bm25(self, q: Query, hits: list[Hit]) -> list[Hit]:
        """Apply q.filter to a BM25 leg by metadata lookup. The vector
        leg filters on device (exact filtered top-k); BM25's top-k is
        post-filtered, so fewer than k hits may remain."""
        if q.filter is None or not hits:
            return hits
        alg = q.filter.get("algorithm")
        mid = q.filter.get("model_id")
        from ..core import RecordNotFound

        kept = []
        for h in hits:
            try:
                m = await self.index.get_record_metadata(
                    q.tenant_id, h.record_id
                )
            except RecordNotFound:
                # record deleted between the BM25 scan and this filter
                # pass: drop the stale hit rather than failing the query
                continue
            if alg is not None and m.algorithm != alg:
                continue
            if mid is not None and m.model_id != mid:
                continue
            kept.append(h)
        return kept

    async def search(self, q: Query) -> list[Hit]:
        if q.filter is not None:
            # validated for EVERY query shape, not just the knn leg —
            # silently ignoring an unsupported filter would return hits
            # as if it matched everything (src/index/mod.rs:18-78)
            from ..index.backend import validate_filter

            validate_filter(q.filter)
        has_vec = q.vector is not None
        has_terms = bool(q.terms)
        if has_vec and has_terms:
            knn_task = asyncio.create_task(
                self.index.knn(q.tenant_id, q.vector, q.k, q.filter,
                               pool_frac=q.pool_frac, exact=q.exact)
            )
            try:
                if q.explain:
                    bm_pairs = await self.index.bm25_explain(
                        q.tenant_id, q.terms, q.k
                    )
                    bm_hits = []
                    term_by_id = {}
                    for hit, ths in bm_pairs:
                        hit.term_hits = ths
                        bm_hits.append(hit)
                        if ths:
                            term_by_id[hit.record_id] = ths
                else:
                    bm_hits = await self.index.bm25(q.tenant_id, q.terms, q.k)
                    term_by_id = {}
                bm_hits = await self._filter_bm25(q, bm_hits)
            except BaseException:
                # don't orphan the in-flight kNN when the bm25 leg fails —
                # and retrieve its result/exception so a completed task
                # doesn't log "exception was never retrieved"
                knn_task.cancel()
                try:
                    await knn_task
                except BaseException:
                    pass
                raise
            vec_hits = await knn_task
            fused = rrf_with_sources(
                [vec_hits, bm_hits], [HitSource.VECTOR, HitSource.BM25], q.rrf_k
            )
            if q.explain:
                for h in fused:
                    th = term_by_id.pop(h.record_id, None)
                    if th is not None:
                        h.term_hits = th
        elif has_vec:
            fused = await self.index.knn(q.tenant_id, q.vector, q.k, q.filter,
                                         pool_frac=q.pool_frac, exact=q.exact)
        elif has_terms:
            if q.explain:
                pairs = await self.index.bm25_explain(q.tenant_id, q.terms, q.k)
                fused = []
                for hit, ths in pairs:
                    hit.term_hits = ths
                    fused.append(hit)
            else:
                fused = await self.index.bm25(q.tenant_id, q.terms, q.k)
            fused = await self._filter_bm25(q, fused)
        else:
            fused = []

        fused = fused[: q.k]
        if self.reranker is not None:
            fused = await self.reranker.rerank(q, fused)
        return fused
