"""The text side of the port's EmbeddedBackend against ucfp_tpu's, on the
same seeded documents: the LSH band buckets and knn_lsh, MinHash and TLSH
exact Hamming (wider than the fused scan's 16 words), BM25 kept in the
same transaction as every write, a reference data dir holding text, LSH,
semantic and neural records reopened by the port, and the hybrid
Matcher.search.

Tolerance: hits compare as (record_id, score) lists with ==, except the
semantic and neural embeddings (float encoders), held at cosine >=
0.999999 (PARITY.md's bar).
"""

import asyncio

import numpy as np
import pytest
from test_conformance import fixed_audio, fixed_png

from ucfp_tpu.core import Query as RQuery
from ucfp_tpu.index.embedded import EmbeddedBackend as RBackend
from ucfp_tpu.matcher import Matcher as RMatcher
from ucfp_tpu.modality import audio as raudio
from ucfp_tpu.modality import image as rimage
from ucfp_tpu.modality import text as rtext
from ucfp_tpu_torch.core import Query
from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.matcher import Matcher
from ucfp_tpu_torch.modality import text as ttext

WORDS = ("river stone cloud ember frost meadow thunder willow harbor lantern "
         "quartz falcon cedar dune glacier orchid canyon ripple summit tide").split()

run = asyncio.run


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


@pytest.fixture(autouse=True, scope="module")
def _reference_weights_outside_jit():
    """The reference draws its stand-in weights lazily inside the jitted
    forward, so its cache would hold tracers and a second input shape
    would fail (UnexpectedTracerError); drawing them once outside jit
    caches concrete arrays. Afterwards the caches are cleared, so that
    later tests on the same worker see the reference as it was."""
    from ucfp_tpu.models import encoders as renc

    for fn in (renc._image_params, renc._audio_params):
        fn.cache_clear()
        fn()
    yield
    for fn in (renc._image_params, renc._audio_params,
               renc._image_forward, renc._audio_forward):
        fn.cache_clear()


def docs(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        idx = np.minimum(rng.zipf(1.4, 80) - 1, len(WORDS) - 1)
        out.append(" ".join(WORDS[j] for j in idx))
    # near-duplicates, so LSH buckets hold more than one record
    for i in range(0, n // 4):
        out[n - 1 - i] = out[i] + " " + WORDS[i % len(WORDS)]
    return out


def hits(hs):
    if hs and isinstance(hs[0], tuple):  # bm25_explain: (hit, term hits)
        return [hits([h])[0] + ([(t.term, t.idf, t.tf, t.contribution)
                                 for t in th],) for h, th in hs]
    return [(h.record_id, h.score, h.source.value, h.vector_score, h.bm25_score,
             h.vector_rank, h.bm25_rank,
             [(t.term, t.idf, t.tf, t.contribution) for t in (h.term_hits or [])])
            for h in hs]


class Pair:
    def __init__(self, tmp_path):
        self.t = EmbeddedBackend(str(tmp_path / "t"), device="cpu")
        self.r = RBackend(str(tmp_path / "r"))

    def ingest(self, fn, texts, base, per_record=False):
        tr = [getattr(ttext, fn)(x, 0, base + i) for i, x in enumerate(texts)]
        rr = [getattr(rtext, fn)(x, 0, base + i) for i, x in enumerate(texts)]
        assert [a.fingerprint for a in tr] == [b.fingerprint for b in rr]
        if per_record:
            for a, b in zip(tr, rr):
                run(self.t.upsert([a]))
                run(self.r.upsert([b]))
        else:
            run(self.t.upsert(tr))
            run(self.r.upsert(rr))
        return tr

    def same(self, name, *args):
        a = run(getattr(self.t, name)(*args))
        b = run(getattr(self.r, name)(*args))
        if a and isinstance(a[0], list):
            assert [hits(x) for x in a] == [hits(x) for x in b]
        else:
            assert hits(a) == hits(b)
        return a

    def close(self):
        self.t.close()
        self.r.close()


def test_lsh_buckets_and_knn_lsh(tmp_path):
    texts = docs(200)
    p = Pair(tmp_path)
    try:
        recs = p.ingest("fingerprint_lsh", texts, 1000)
        assert p.t._lsh.keys() == p.r._lsh.keys()
        assert p.t._lsh[0] == p.r._lsh[0]
        for i in (0, 3, 17, 150, 199):
            res = p.same("knn_lsh", 0, recs[i].fingerprint, 10)
            assert res[0].record_id == 1000 + i or res[0].score == 1.0
        p.same("knn_lsh", 0, recs[0].fingerprint, 0)
        p.same("knn_lsh", 0, b"\x00" * 9, 5)
        p.same("knn_lsh", 5, recs[0].fingerprint, 5)
        # re-tag, delete: buckets follow
        run(p.t.upsert([ttext.fingerprint_minhash(texts[0], 0, 1000)]))
        run(p.r.upsert([rtext.fingerprint_minhash(texts[0], 0, 1000)]))
        run(p.t.delete(0, [1003, 1199]))
        run(p.r.delete(0, [1003, 1199]))
        assert p.t._lsh[0] == p.r._lsh[0]
        for i in (0, 3, 17, 150):
            p.same("knn_lsh", 0, recs[i].fingerprint, 10)
    finally:
        p.close()


@pytest.mark.parametrize("fn,width", [("fingerprint_minhash", 258),
                                      ("fingerprint_tlsh", 18),
                                      ("fingerprint_simhash", 2)])
def test_exact_hamming_text_fingerprints(tmp_path, fn, width):
    texts = docs(300, seed=1)
    p = Pair(tmp_path)
    try:
        recs = p.ingest(fn, texts, 0)
        alg = recs[0].algorithm
        assert p.t._ham[(0, alg)].width == width
        for i in (0, 5, 77, 299):
            res = p.same("knn_fingerprint", 0, alg, recs[i].fingerprint, 7)
            assert res[0].score == 1.0
        p.same("knn_fingerprint_batch", 0, alg, [r.fingerprint for r in recs[:9]], 4)
        assert p.t.fingerprint_is_approximate(0, alg, 7) == \
            p.r.fingerprint_is_approximate(0, alg, 7)
    finally:
        p.close()


def test_bm25_follows_every_write(tmp_path):
    texts = docs(120, seed=2)
    p = Pair(tmp_path)
    try:
        p.ingest("fingerprint_minhash", texts[:60], 0, per_record=True)
        p.ingest("fingerprint_simhash", texts[60:], 60)
        for terms in (["river"], ["tide", "ember", "zzz"], WORDS[:6], []):
            p.same("bm25", 0, terms, 15)
            p.same("bm25_explain", 0, terms, 15)
        # an update without text clears the document; deletes clear it too
        bare = dict(tenant_id=0, record_id=5, algorithm="x", fingerprint=b"\x01" * 8)
        from ucfp_tpu.core import Modality as RM, Record as RR
        from ucfp_tpu_torch.core import Modality as TM, Record as TR

        run(p.t.upsert([TR(modality=TM.TEXT, **bare)]))
        run(p.r.upsert([RR(modality=RM.TEXT, **bare)]))
        run(p.t.delete(0, [7, 70, 9999]))
        run(p.r.delete(0, [7, 70, 9999]))
        for terms in (["river"], WORDS[3:9]):
            p.same("bm25", 0, terms, 200)
        assert p.t._bm25.stats(0) == p.r._bm25.stats(0)
    finally:
        p.close()


def test_hybrid_matcher_search(tmp_path):
    texts = docs(80, seed=3)
    p = Pair(tmp_path)
    try:
        tr = [ttext.fingerprint_semantic(x, 0, i) for i, x in enumerate(texts)]
        rr = [rtext.fingerprint_semantic(x, 0, i) for i, x in enumerate(texts)]
        # small-integer embeddings keep the vector leg's cosines exact
        rng = np.random.default_rng(4)
        for a, b in zip(tr, rr):
            v = [float(x) for x in rng.integers(-3, 4, 8)]
            a.embedding, b.embedding = v, list(v)
        run(p.t.upsert(tr))
        run(p.r.upsert(rr))
        tm, rm = Matcher(p.t), RMatcher(p.r)
        for i, terms in ((0, ["river", "stone"]), (5, ["glacier"]), (9, ["zzz"]),
                         (11, [])):
            for explain in (False, True):
                for rrf_k in (60, 0):
                    kw = dict(tenant_id=0, k=10, vector=tr[i].embedding,
                              terms=terms, explain=explain, rrf_k=rrf_k)
                    a = run(tm.search(Query(modality=ttext.Modality.TEXT, **kw)))
                    b = run(rm.search(RQuery(modality=rtext.Modality.TEXT, **kw)))
                    assert hits(a) == hits(b)
            a = run(tm.search(Query(tenant_id=0, modality=ttext.Modality.TEXT,
                                    k=10, terms=terms)))
            b = run(rm.search(RQuery(tenant_id=0, modality=rtext.Modality.TEXT,
                                     k=10, terms=terms)))
            assert hits(a) == hits(b)
    finally:
        p.close()


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def test_reference_data_dir_reopens_with_text(tmp_path):
    texts = docs(60, seed=5)
    r = RBackend(str(tmp_path))
    recs = ([rtext.fingerprint_minhash(x, 0, i) for i, x in enumerate(texts[:20])]
            + [rtext.fingerprint_lsh(x, 0, 100 + i) for i, x in enumerate(texts[20:40])]
            + [rtext.fingerprint_tlsh(x, 0, 200 + i) for i, x in enumerate(texts[40:])]
            + [rtext.fingerprint_semantic(x, 0, 300 + i) for i, x in enumerate(texts[:5])]
            + [rimage.fingerprint_semantic(fixed_png(10, 64, 64), 0, 400),
               raudio.fingerprint_neural(fixed_audio(), 8000, 0, 401)])
    run(r.upsert(recs))
    run(r.delete(0, [3, 105]))
    r.close()
    r = RBackend(str(tmp_path))
    t = EmbeddedBackend(str(tmp_path), device="cpu")
    try:
        lsh = [x for x in recs if x.algorithm == "minhash-lsh-h128"]
        for x in lsh[:6]:
            assert hits(run(t.knn_lsh(0, x.fingerprint, 5))) == \
                hits(run(r.knn_lsh(0, x.fingerprint, 5)))
        for x in recs[:3] + recs[40:43]:
            assert hits(run(t.knn_fingerprint(0, x.algorithm, x.fingerprint, 5))) == \
                hits(run(r.knn_fingerprint(0, x.algorithm, x.fingerprint, 5)))
        for terms in (["river"], WORDS[:4]):
            assert hits(run(t.bm25(0, terms, 10))) == hits(run(r.bm25(0, terms, 10)))
        assert t.list_records(0, 0, 100) == r.list_records(0, 0, 100)
        for rid in (300, 400, 401):
            assert t.get_record(0, rid)["model_id"] == r.get_record(0, rid)["model_id"]
        # the stored float embeddings answer vector queries the same way
        for rid in (300, 400, 401):
            q = list(r.get_record(0, rid)["embedding"])
            a = run(t.knn(0, q, 3))
            b = run(r.knn(0, q, 3))
            assert [h.record_id for h in a] == [h.record_id for h in b]
            assert abs(a[0].score - b[0].score) < 1e-6
    finally:
        t.close()
        r.close()


def test_semantic_and_neural_embeddings_match_reference():
    from ucfp_tpu_torch.modality import audio as taudio
    from ucfp_tpu_torch.modality import image as timage

    png = fixed_png(10, 64, 64)
    a = timage.fingerprint_semantic(png, 0, 1, device="cpu")
    b = rimage.fingerprint_semantic(png, 0, 1)
    assert _cos(a.embedding, b.embedding) >= 0.999999
    assert (a.algorithm, a.config_hash, a.model_id) == (b.algorithm, b.config_hash,
                                                        b.model_id)
    for secs, sr in ((3.0, 8000), (9.0, 16000)):
        x = fixed_audio(secs, sr)
        a = taudio.fingerprint_neural(x, sr, 0, 1, device="cpu")
        b = raudio.fingerprint_neural(x, sr, 0, 1)
        ea = np.frombuffer(a.fingerprint, "<f4").reshape(-1, 128)
        eb = np.frombuffer(b.fingerprint, "<f4").reshape(-1, 128)
        assert ea.shape == eb.shape
        assert min(_cos(u, v) for u, v in zip(ea, eb)) >= 0.999999
        assert (a.config_hash, a.model_id) == (b.config_hash, b.model_id)
