"""The port's EmbeddedBackend and HTTP server under UCFP_KNN_QUANT=int4
against ucfp_tpu's, on the CPU.

Both backends get the same vectors and writes; every query form must
return the same hits — record ids and scores, bit for bit (the int4
pipeline's scores are exact int8 cosines, see test_torch_int4.py) — and
the same approximate markers. The int4 tier serves only where the
reference's cost model says it beats exact, so the tests run with the
model on (tiny catalogs then serve exact) and off
(UCFP_SKETCH_COST_MODEL=0: the tier serves wherever its kernels apply):
at capacity 2048 the packed cache is a zero-width placeholder and the
single query rescores the whole catalog; at 8192 the pools threshold.
"""

import asyncio

import numpy as np
import pytest

from test_torch_index import SEM, Pair, hits, run
from test_torch_server import Servers
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.ops import knn as T


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX side would shard over conftest's 8 virtual devices
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "int4")
    monkeypatch.delenv("UCFP_QUERY_BATCH_MS", raising=False)
    monkeypatch.delenv("UCFP_SKETCH_COST_MODEL", raising=False)


def _vectors(n, dim, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    emb[7] = emb[3]  # duplicate rows: score ties
    emb[20] = 0.0  # a zero row scores -inf
    return emb


def _load(p: Pair, emb):
    n = len(emb)
    half = n // 2
    p.both("upsert_embedding_batch", 0, SEM, list(range(half)), emb[:half],
           modality="image", model_id="m1")
    p.both("upsert_embedding_batch", 0, SEM, list(range(half, n)), emb[half:],
           modality="image", model_id="m2")


def _queries(emb, seed):
    rng = np.random.default_rng(seed)
    n, dim = emb.shape
    picks = (3, 40, n // 2 + 5, n - 1)
    return [[float(x) for x in emb[i] + 0.05 * rng.normal(size=dim)] for i in picks]


def _check(p: Pair, emb, seed, ks=(1, 10, 40)):
    qs = _queries(emb, seed)
    dim = emb.shape[1]
    for k in ks:
        for q in qs[:2]:
            p.same("knn", 0, q, k)
            p.same("knn", 0, q, k, filter={"model_id": "m2"})
            p.same("knn", 0, q, k, exact=True)
        p.same("knn_batch", 0, qs + [[0.0] * dim], k)
        p.same("knn_batch", 0, qs, k, filter={"model_id": "m1"})
        p.same("knn_batch", 0, qs, k, exact=True)
        _same_markers(p, dim, k)


def _same_markers(p: Pair, dim, k):
    for batch in (False, True):
        for batch_q in (1, 3, 64):
            for filtered in (False, True):
                for exact in (False, True):
                    kw = dict(batch=batch, batch_q=batch_q, filtered=filtered, exact=exact)
                    assert (p.j.knn_is_approximate(0, dim, k, **kw)
                            == p.t.knn_is_approximate(0, dim, k, **kw)), kw


def _count_pipelines(monkeypatch):
    """Calls of the port's two int4 pipelines, by name."""
    calls = {}
    for name in ("cosine_int4_topk", "cosine_int4_topk_batched"):
        calls[name] = 0

        def counted(*a, _name=name, _fn=getattr(T, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(T, name, counted)
    return calls


def _writes(p: Pair, emb, seed):
    """Writes after the device cache exists: an update, a new row, a
    delete (swap-with-last) — the int8 row patch and the packed column
    patch."""
    rng = np.random.default_rng(seed + 7919)  # not the rows' own seed
    dim = emb.shape[1]
    new = [float(x) for x in rng.normal(size=dim)]
    p.both("upsert", [
        dict(tenant_id=0, record_id=40, modality="image", algorithm=SEM,
             fingerprint=b"\x00" * 4, model_id="m1",
             embedding=[float(x) for x in rng.normal(size=dim)]),
        dict(tenant_id=0, record_id=10**6, modality="image", algorithm=SEM,
             fingerprint=b"\x00" * 4, model_id="m2", embedding=new),
    ])
    p.both("delete", 0, [5, len(emb) - 2])
    return new


@pytest.mark.parametrize("n,model", [(1500, True), (1500, False), (5000, False)])
def test_same_hits_int4(tmp_path, monkeypatch, n, model):
    if not model:
        monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant="int4")
    calls = _count_pipelines(monkeypatch)
    try:
        emb = _vectors(n, 16, seed=n)
        _load(p, emb)
        _check(p, emb, seed=1)  # builds the device caches
        cache = p.t._vec[(0, 16)]
        cap = cache.data.shape[0]
        # which tier served: the cost model keeps tiny catalogs exact, and
        # the batch gate refuses placeholder capacities
        assert bool(calls["cosine_int4_topk"]) == (not model)
        assert bool(calls["cosine_int4_topk_batched"]) == (not model and cap > 4096)
        packed_t, inv_n4 = cache.device[2], cache.device[3]
        if cap <= 4096:  # the zero-width placeholder
            assert packed_t.shape == (8, 0) and inv_n4.shape == (0,)
        else:
            assert packed_t.shape == (8, cap)
            assert np.array_equal(packed_t.numpy(), np.asarray(p.j._vec[(0, 16)].device[2]))
        assert p.t.knn_is_approximate(0, 16, 10) == (not model and cap > 4096)
        new = _writes(p, emb, seed=n)
        _check(p, emb, seed=2, ks=(1, 10))  # after the row patches
        assert hits(p.same("knn", 0, new, 1))[0][0] == 10**6
        if cap > 4096:
            assert np.array_equal(cache.device[2].numpy(),
                                  np.asarray(p.j._vec[(0, 16)].device[2]))
            assert np.array_equal(cache.device[3].numpy(),
                                  np.asarray(p.j._vec[(0, 16)].device[3]))
    finally:
        p.close()


def test_large_capacity_int8_fallbacks(tmp_path, monkeypatch):
    """At 32,768 rows the int8 fallbacks (exact tier, filtered batches)
    ride the fused candidate kernels, and the int4 pools threshold."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant="int4")
    try:
        emb = _vectors(32768, 16, seed=5)
        _load(p, emb)
        _check(p, emb, seed=3, ks=(10,))
        assert p.t._vec[(0, 16)].data.shape[0] == 32768
    finally:
        p.close()


def test_odd_dim_serves_exact(tmp_path, monkeypatch):
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant="int4")
    try:
        emb = _vectors(5000, 17, seed=6)
        _load(p, emb)
        _check(p, emb, seed=4, ks=(5,))
        assert len(p.t._vec[(0, 17)].device) == 3  # no packed parts
        assert not p.t.knn_is_approximate(0, 17, 5)
        _writes(p, emb, seed=6)
        _check(p, emb, seed=5, ks=(5,))
    finally:
        p.close()


def test_reference_data_dir_reopens_int4(tmp_path, monkeypatch):
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant="int4")
    emb = _vectors(5000, 16, seed=7)
    _load(p, emb)
    _writes(p, emb, seed=7)
    p.close()
    j = JBackend(str(tmp_path / "jax"), knn_quant="int4")
    t = EmbeddedBackend(str(tmp_path / "jax"), device="cpu", knn_quant="int4")
    try:
        qs = _queries(emb, seed=8)
        for k in (1, 10):
            assert hits(run(j.knn_batch(0, qs, k))) == hits(run(t.knn_batch(0, qs, k)))
            assert hits(run(j.knn(0, qs[1], k))) == hits(run(t.knn(0, qs[1], k)))
            assert hits(run(j.knn(0, qs[2], k, filter={"model_id": "m2"}))) == \
                hits(run(t.knn(0, qs[2], k, filter={"model_id": "m2"})))
    finally:
        j.close()
        t.close()


def _recording(cls, monkeypatch, seen):
    orig = cls._int4_batch_worth_it

    def rec(self, cap, dim, k, q):
        seen.append(q)
        return orig(self, cap, dim, k, q)

    monkeypatch.setattr(cls, "_int4_batch_worth_it", rec)


@pytest.mark.parametrize("pad", ["pow2", "max"])
def test_micro_batched_int4(tmp_path, monkeypatch, pad):
    """Coalesced single queries take the batched int4 path on both
    packages with the same answers as unbatched, and the port judges a
    flush at the reference's padded size (the dispatch depends on Q)."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    monkeypatch.setenv("UCFP_QUERY_BATCH_MS", "25")
    monkeypatch.setenv("UCFP_QBATCH_PAD", pad)
    monkeypatch.setenv("UCFP_QBATCH_MAX", "16")
    emb = _vectors(5000, 16, seed=9)
    both = [JBackend(str(tmp_path / "j"), knn_quant="int4"),
            EmbeddedBackend(str(tmp_path / "t"), device="cpu", knn_quant="int4")]
    monkeypatch.delenv("UCFP_QUERY_BATCH_MS")
    plain = EmbeddedBackend(str(tmp_path / "p"), device="cpu", knn_quant="int4")
    qs = _queries(emb, seed=10) + _queries(emb, seed=11)[:2]  # 6 queries
    try:
        for b in both + [plain]:
            run(b.upsert_embedding_batch(0, SEM, list(range(len(emb))), emb,
                                         model_id="m1"))
        for b in both:  # build the device caches outside the flushes
            run(b.knn(0, qs[0], 5, exact=True))
        assert both[0].knn_is_approximate(0, 16, 5) and both[1].knn_is_approximate(0, 16, 5)
        answers, seen = [], {}
        for b in both:
            seen[b] = []
            _recording(type(b), monkeypatch, seen[b])

            async def go(b=b):
                return await asyncio.gather(*[b.knn(0, q, 5) for q in qs])

            answers.append([hits(h) for h in run(go())])
            assert b._qbatch_flushes == 1 and b._qbatch_items == 6
        assert seen[both[0]] == seen[both[1]] == [8 if pad == "pow2" else 16]
        unbatched = [hits(run(plain.knn_batch(0, [q], 5))[0]) for q in qs]
        assert answers[0] == answers[1] == unbatched
        assert unbatched[0][0][0] == 3
    finally:
        for b in both + [plain]:
            b.close()


def test_markers_under_micro_batching(tmp_path, monkeypatch):
    """The worst-case rule: a single query that a flush may carry onto
    the batched path is marked as a 64-query flush would be."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    monkeypatch.setenv("UCFP_QUERY_BATCH_MS", "5")
    p = Pair(tmp_path, "auto", quant="int4")
    try:
        emb = _vectors(5000, 16, seed=12)
        _load(p, emb)
        for k in (1, 10, 40):
            _same_markers(p, 16, k)
            assert p.j.knn_is_approximate(0, 16, k, pool_frac=0.5) == \
                p.t.knn_is_approximate(0, 16, k, pool_frac=0.5)
    finally:
        p.close()


def test_server_bodies_int4(tmp_path, monkeypatch):
    """/v1/query vector(s) bodies byte-identical to the JAX server's,
    approximate mark included, single and batched, filtered and exact."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    s = Servers(tmp_path)
    try:
        assert s.t_index.knn_quant == "int4"
        emb = _vectors(5000, 16, seed=13)
        for b in (s.j_index, s.t_index):
            for lo, mid in ((0, "m1"), (2500, "m2")):
                run(b.upsert_embedding_batch(0, SEM, list(range(lo, lo + 2500)),
                                             emb[lo:lo + 2500], model_id=mid))
        vecs = _queries(emb, seed=14)
        queries = [{"vector": vecs[0]}, {"vectors": vecs + [[0.0] * 16]}]
        for q in list(queries):
            queries.append({**q, "filter": {"model_id": "m2"}})
            queries.append({**q, "recall_tier": "exact"})
        for k in (1, 10):
            for q in queries:
                st, res = s.call("POST", "/v1/query",
                                 {"tenant_id": 0, "modality": "image", "k": k, **q})
                assert st == 200
                if "recall_tier" in q:
                    assert "approximate" not in res
                elif "filter" not in q:
                    assert res["approximate"] is True
        rec = {"tenant_id": 0, "record_id": 10**6, "modality": "image",
               "algorithm": SEM, "fingerprint": [1, 2, 3, 4],
               "embedding": [9.0, -9.0] * 8, "model_id": "m1"}
        assert s.call("POST", "/v1/records", {"records": [rec]})[0] == 200
        st, res = s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "image",
                                               "k": 3, "vector": [9.0, -8.0] * 8})
        assert res["hits"][0]["record_id"] == 10**6
    finally:
        s.close()
