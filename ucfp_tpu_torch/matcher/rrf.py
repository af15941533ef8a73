"""Reciprocal Rank Fusion with per-source score breakdown.

Fusion math identical to the reference (src/matcher/mod.rs:32-98):
  * rank is 1-based within each input ranking
  * each appearance contributes 1 / (rrf_k + rank)
  * vector- and bm25-sourced contributions accumulate separately and the
    fused score is their sum; unknown sources fold into vector_score
  * the first rank seen per source is recorded for explain output
  * output sorts by descending fused score; ties break by ascending
    record id (the reference leaves tie order unspecified via HashMap
    iteration — we pin it for determinism)

Copied from ucfp_tpu/matcher/rrf.py; only its imports differ.
"""

from __future__ import annotations

from ..core import Hit, HitSource


def rrf_with_sources(
    rankings: list[list[Hit]],
    sources: list[HitSource],
    rrf_k: int = 60,
) -> list[Hit]:
    denom = float(rrf_k)
    # record_id -> [vec_score, bm25_score, vec_rank, bm25_rank]
    acc: dict[int, list] = {}
    for i, ranking in enumerate(rankings):
        if i < len(sources):
            src = sources[i]
        elif ranking:
            src = ranking[0].source
        else:
            src = HitSource.FUSED
        for rank0, hit in enumerate(ranking):
            rank1 = rank0 + 1
            inc = 1.0 / (denom + rank1)
            e = acc.setdefault(hit.record_id, [None, None, None, None])
            if src is HitSource.BM25:
                e[1] = (e[1] or 0.0) + inc
                if e[3] is None:
                    e[3] = rank1
            else:  # Vector and unknown sources fold into vector_score
                e[0] = (e[0] or 0.0) + inc
                if src is HitSource.VECTOR and e[2] is None:
                    e[2] = rank1
    out = [
        Hit(
            record_id=rid,
            score=(vs or 0.0) + (bs or 0.0),
            source=HitSource.FUSED,
            vector_score=vs,
            bm25_score=bs,
            vector_rank=vr,
            bm25_rank=br,
        )
        for rid, (vs, bs, vr, br) in acc.items()
    ]
    out.sort(key=lambda h: (-h.score, h.record_id))
    return out


def rrf(rankings: list[list[Hit]], rrf_k: int = 60) -> list[Hit]:
    return rrf_with_sources(rankings, [], rrf_k)
