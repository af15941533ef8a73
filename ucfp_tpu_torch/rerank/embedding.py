"""Embedding reranker: second-stage re-scoring by stored-embedding cosine.

A concrete Reranker (the reference ships only the trait + Noop,
src/rerank/mod.rs; its cross-encoder stage is future work there too).
Re-scores the fused top-k by cosine between the query vector and each
hit's stored embedding — useful after a BM25-heavy fusion where lexical
rank ordered semantically-near items poorly. Hits without a stored
embedding keep their fused score but sort after re-scored ones.

Copied from ucfp_tpu/rerank/embedding.py; only its imports differ.
"""

from __future__ import annotations

import numpy as np

from ..core import Hit, HitSource, Query
from . import Reranker


class EmbeddingReranker(Reranker):
    def __init__(self, index):
        self.index = index  # needs get_record(tenant, rid) -> row dict

    async def rerank(self, query: Query, hits: list[Hit]) -> list[Hit]:
        if query.vector is None or not hits:
            return hits
        q = np.asarray(query.vector, np.float32)
        qn = float(np.linalg.norm(q))
        if qn == 0.0:
            return hits
        unscored: list[Hit] = []  # hits with no usable embedding keep
        rescored = []             # their fused score, sorted after
        for h in hits:
            try:
                row = self.index.get_record(query.tenant_id, h.record_id)
            except Exception:
                unscored.append(h)
                continue
            emb = row.get("embedding")
            if emb is None or len(emb) != len(q):
                unscored.append(h)
                continue
            e = np.asarray(emb, np.float32)
            en = float(np.linalg.norm(e))
            if en == 0.0:
                unscored.append(h)
                continue
            h.score = float(q @ e / (qn * en))
            h.source = HitSource.FUSED
            rescored.append(h)
        rescored.sort(key=lambda h: (-h.score, h.record_id))
        return rescored + unscored
