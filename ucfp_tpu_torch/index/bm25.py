"""Host BM25 engine: inverted index with same-transaction semantics.

A copy of ucfp_tpu/index/bm25.py, both engines (the Python one and the
native bm25.cpp of this package); only its imports differ.

Rebuild of the reference's redb-backed BM25 (src/index/embedded/bm25.rs):
  * tokenizer: lowercase + split on non-alphanumeric (bm25.rs:88-97)
  * constants: k1 = 1.2, b = 0.75 (bm25.rs:79-80)
  * IDF: BM25+ form ln((N - n + 0.5) / (n + 0.5) + 1) (bm25.rs:551)
  * upsert is clear-then-reindex, idempotent (bm25.rs:333-401)
  * explain mode caps per-doc term contributions at 16 (bm25.rs:467,583-589)
  * per-tenant corpora are fully isolated

The reference keeps postings in redb tables (FST term dict + roaring
bitmaps) updated in the same write txn as the fingerprint tables so the
text index never lags the catalog. Here the engine is an in-process
structure owned by the embedded backend, mutated under the backend's
write lock in the same logical transaction, and rebuilt from the WAL on
boot — the same never-lags guarantee by construction.

Scoring stays on host: postings walks are pointer-chasing, not matmuls;
SURVEY.md section 7 explicitly defers device-scored postings.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from ..core import TermHit

K1 = 1.2
B = 0.75
MAX_EXPLAIN_TERMS_PER_DOC = 16


# runs of isalnum chars: Python's re defines \w as str.isalnum() plus
# underscore, so [^\W_]+ is exactly "maximal isalnum runs" — verified
# bit-identical to a per-char isalnum loop over the full BMP + astral
# planes and a 2000-string Unicode fuzz (incl. lowercase-expanding chars
# like İ, since lower() runs first either way)
_TOKEN_RE = re.compile(r"[^\W_]+")

# u16 length field in the native wire blob; BOTH engines drop larger
# tokens at tokenize time so searchability and corpus stats stay
# bit-identical across engines (a >64 KiB "token" is pathological input)
MAX_TERM_BYTES = 65535


def tokenize(text: str) -> list[str]:
    """Lowercase + split on non-alphanumeric (bm25.rs:88-97)."""
    out = _TOKEN_RE.findall(text.lower())
    if out and max(map(len, out)) > MAX_TERM_BYTES // 4:
        out = [t for t in out if len(t.encode("utf-8")) <= MAX_TERM_BYTES]
    return out


@dataclass
class _TenantCorpus:
    postings: dict[str, dict[int, int]] = field(default_factory=dict)  # term -> {doc: tf}
    doc_lens: dict[int, int] = field(default_factory=dict)  # doc -> token count
    doc_terms: dict[int, list[str]] = field(default_factory=dict)  # doc -> its terms
    total_doc_len: int = 0

    @property
    def doc_count(self) -> int:
        return len(self.doc_lens)


class Bm25Engine:
    """Per-tenant BM25 corpora."""

    def __init__(self) -> None:
        self._tenants: dict[int, _TenantCorpus] = defaultdict(_TenantCorpus)

    # -- writes (called under the backend's txn lock) ----------------------

    def upsert_one(self, tenant_id: int, record_id: int, text: str | None) -> None:
        """Clear-then-reindex one document; None/empty text removes it."""
        self.clear_one(tenant_id, record_id)
        if not text:
            return
        toks = tokenize(text)
        if not toks:
            return
        c = self._tenants[tenant_id]
        tf = Counter(toks)
        for term, n in tf.items():
            c.postings.setdefault(term, {})[record_id] = n
        c.doc_lens[record_id] = len(toks)
        c.doc_terms[record_id] = list(tf.keys())
        c.total_doc_len += len(toks)

    def clear_one(self, tenant_id: int, record_id: int) -> None:
        c = self._tenants.get(tenant_id)
        if c is None or record_id not in c.doc_lens:
            return
        for term in c.doc_terms.pop(record_id, []):
            docs = c.postings.get(term)
            if docs is not None:
                docs.pop(record_id, None)
                if not docs:
                    del c.postings[term]
        c.total_doc_len -= c.doc_lens.pop(record_id)

    # -- reads --------------------------------------------------------------

    def search_explain(
        self, tenant_id: int, terms: list[str], k: int
    ) -> list[tuple[int, float, list[TermHit]]]:
        """BM25 top-k with per-term contribution breakdown.

        Query terms are re-tokenized through the same tokenizer, matching
        the reference's behavior of normalizing query input identically
        to documents.
        """
        c = self._tenants.get(tenant_id)
        if c is None or c.doc_count == 0 or k == 0:
            return []
        qtoks: list[str] = []
        for t in terms:
            qtoks.extend(tokenize(t))
        if not qtoks:
            return []
        n_docs = c.doc_count
        avgdl = c.total_doc_len / n_docs if n_docs else 0.0

        scores: dict[int, float] = defaultdict(float)
        contribs: dict[int, list[TermHit]] = defaultdict(list)
        seen_terms = set()
        for term in qtoks:
            if term in seen_terms:  # each unique query term scores once
                continue
            seen_terms.add(term)
            docs = c.postings.get(term)
            if not docs:
                continue
            n_t = len(docs)
            idf = math.log((n_docs - n_t + 0.5) / (n_t + 0.5) + 1.0)
            for doc, tf in docs.items():
                dl = c.doc_lens[doc]
                denom = tf + K1 * (1.0 - B + B * dl / avgdl)
                contribution = idf * (tf * (K1 + 1.0)) / denom
                scores[doc] += contribution
                if len(contribs[doc]) < MAX_EXPLAIN_TERMS_PER_DOC:
                    contribs[doc].append(
                        TermHit(term=term, tf=tf, idf=idf, contribution=contribution)
                    )
        # descending score, ties by ascending record id (deterministic)
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [(doc, score, contribs[doc]) for doc, score in ranked]

    def search(self, tenant_id: int, terms: list[str], k: int) -> list[tuple[int, float]]:
        return [(d, s) for d, s, _ in self.search_explain(tenant_id, terms, k)]

    def idf_map(self, tenant_id: int, terms: list[str]) -> dict[str, float]:
        """IDF values for the SimHash-IDF weighting path (the reference
        feeds corpus stats from the BM25 tables, REPORT.md 4.1.2)."""
        c = self._tenants.get(tenant_id)
        if c is None or c.doc_count == 0:
            return {}
        n_docs = c.doc_count
        out = {}
        for t in terms:
            docs = c.postings.get(t)
            if docs:
                out[t] = math.log((n_docs - len(docs) + 0.5) / (len(docs) + 0.5) + 1.0)
        return out

    def stats(self, tenant_id: int) -> dict:
        c = self._tenants.get(tenant_id)
        if c is None:
            return {"doc_count": 0, "total_doc_len": 0, "terms": 0}
        return {
            "doc_count": c.doc_count,
            "total_doc_len": c.total_doc_len,
            "terms": len(c.postings),
        }


# ---------------------------------------------------------------------------
# Native C++ engine (native/bm25.cpp)
# ---------------------------------------------------------------------------




def _terms_blob(pairs: list[tuple[str, int]]) -> bytes:
    """[u32 n] then n x { u16 len, utf-8 bytes, u32 tf }.

    Terms longer than the u16 length field (pathological 64 KiB+ tokens)
    are skipped rather than crashing mid-upsert; such terms are
    unsearchable in either engine in practice.
    """
    import struct

    kept = [(t, tf) for t, tf in pairs
            if len(t.encode("utf-8")) <= MAX_TERM_BYTES]
    out = bytearray(struct.pack("<I", len(kept)))
    for term, tf in kept:
        b = term.encode("utf-8")
        out += struct.pack("<H", len(b)) + b + struct.pack("<I", tf)
    return bytes(out)


class NativeBm25Engine:
    """Same API and bit-identical scoring as Bm25Engine, postings and
    scoring in C++ (the reference's BM25 is native Rust; this is the
    equivalent host engine). Explain-mode contributions recompute on the
    top-k docs only, via the per-(term, doc) accessors."""

    def __init__(self, lib) -> None:
        self._lib = lib
        self._tenants: dict[int, int] = {}  # tenant -> handle

    def _h(self, tenant_id: int, create: bool = False):
        h = self._tenants.get(tenant_id)
        if h is None and create:
            h = self._lib.ucfp_bm25_new()
            self._tenants[tenant_id] = h
        return h

    def upsert_one(self, tenant_id: int, record_id: int, text: str | None) -> None:
        h = self._h(tenant_id, create=True)
        if not text:
            self._lib.ucfp_bm25_clear(h, record_id)
            return
        if text.isascii():
            # tokenize + count natively (exact ASCII subset of the
            # Python tokenizer); returns -1 only on a non-ASCII byte,
            # which isascii() already excludes
            b = text.encode()
            self._lib.ucfp_bm25_upsert_text(h, record_id, b, len(b))
            return
        toks = tokenize(text)
        if not toks:
            self._lib.ucfp_bm25_clear(h, record_id)
            return
        tf = Counter(toks)
        blob = _terms_blob(list(tf.items()))
        self._lib.ucfp_bm25_upsert(h, record_id, blob, len(blob), len(toks))

    def clear_one(self, tenant_id: int, record_id: int) -> None:
        h = self._h(tenant_id)
        if h is not None:
            self._lib.ucfp_bm25_clear(h, record_id)

    def _query_terms(self, terms: list[str]) -> list[str]:
        qtoks: list[str] = []
        for t in terms:
            qtoks.extend(tokenize(t))
        seen = set()
        uniq = []
        for t in qtoks:
            if t not in seen:
                seen.add(t)
                uniq.append(t)
        return uniq

    def search(self, tenant_id: int, terms: list[str], k: int) -> list[tuple[int, float]]:
        return self._search_uniq(tenant_id, self._query_terms(terms), k)

    def _search_uniq(self, tenant_id: int, uniq: list[str],
                     k: int) -> list[tuple[int, float]]:
        import ctypes

        h = self._h(tenant_id)
        if h is None or k == 0:
            return []
        if not uniq:
            return []
        blob = _terms_blob([(t, 1) for t in uniq])
        docs = (ctypes.c_uint64 * k)()
        scores = (ctypes.c_double * k)()
        n = self._lib.ucfp_bm25_search(h, blob, len(blob), k, docs, scores)
        if n < 0:
            return []
        return [(int(docs[i]), float(scores[i])) for i in range(n)]

    def search_explain(
        self, tenant_id: int, terms: list[str], k: int
    ) -> list[tuple[int, float, list[TermHit]]]:
        h = self._h(tenant_id)
        # tokenize + dedupe ONCE for both the ranked search and the
        # per-doc contribution loop below
        uniq = self._query_terms(terms)
        ranked = self._search_uniq(tenant_id, uniq, k)
        if not ranked or h is None:
            return []
        n_docs = self._lib.ucfp_bm25_doc_count(h)
        avgdl = self._lib.ucfp_bm25_total_doc_len(h) / n_docs if n_docs else 0.0
        out = []
        for doc, score in ranked:
            ths: list[TermHit] = []
            dl = self._lib.ucfp_bm25_doc_len(h, doc)
            for t in uniq:
                if len(ths) >= MAX_EXPLAIN_TERMS_PER_DOC:
                    break
                b = t.encode("utf-8")
                if len(b) > MAX_TERM_BYTES:
                    continue
                tf = self._lib.ucfp_bm25_tf(h, b, len(b), doc)
                if tf == 0:
                    continue
                df = self._lib.ucfp_bm25_df(h, b, len(b))
                idf = math.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
                denom = tf + K1 * (1.0 - B + B * dl / avgdl)
                ths.append(
                    TermHit(term=t, tf=tf, idf=idf,
                            contribution=idf * (tf * (K1 + 1.0)) / denom)
                )
            out.append((doc, score, ths))
        return out

    def idf_map(self, tenant_id: int, terms: list[str]) -> dict[str, float]:
        h = self._h(tenant_id)
        if h is None:
            return {}
        n_docs = self._lib.ucfp_bm25_doc_count(h)
        if n_docs == 0:
            return {}
        out = {}
        for t in terms:
            b = t.encode("utf-8")
            if len(b) > MAX_TERM_BYTES:
                continue
            df = self._lib.ucfp_bm25_df(h, b, len(b))
            if df:
                out[t] = math.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
        return out

    def stats(self, tenant_id: int) -> dict:
        h = self._h(tenant_id)
        if h is None:
            return {"doc_count": 0, "total_doc_len": 0, "terms": 0}
        return {
            "doc_count": int(self._lib.ucfp_bm25_doc_count(h)),
            "total_doc_len": int(self._lib.ucfp_bm25_total_doc_len(h)),
            "terms": int(self._lib.ucfp_bm25_term_count(h)),
        }

    def __del__(self):  # release native corpora
        lib = getattr(self, "_lib", None)
        if lib is not None:
            for h in self._tenants.values():
                try:
                    lib.ucfp_bm25_free(h)
                except Exception:
                    pass


def make_engine(prefer_native: bool = True):
    """Native engine when the toolchain is available, Python otherwise."""
    if prefer_native:
        try:
            from ..native import load_bm25

            lib = load_bm25()
            if lib is not None:
                return NativeBm25Engine(lib)
        except Exception:
            pass
    return Bm25Engine()
