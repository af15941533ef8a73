"""The port's EmbeddedBackend and HTTP server under UCFP_KNN_QUANT=int2 and
sketch against ucfp_tpu's, on the CPU.

Both backends get the same vectors and writes; every query form must
return the same hits — record ids and scores, bit for bit (the pipelines'
scores are exact int8 cosines) — and the same approximate markers. Each
tier serves only where the reference's cost model says it beats exact,
so the tests run with the model on (small catalogs then serve exact) and
off (UCFP_SKETCH_COST_MODEL=0: the tier serves wherever its kernels
apply). int2: at capacity 2048 the packed cache is a zero-width
placeholder and a single query rescores the whole catalog; at 32,768 the
pools threshold. sketch: at 8192 the 2048-row pool thresholds, at every
recall tier.
"""

import asyncio

import numpy as np
import pytest

from test_torch_index import SEM, Pair, hits, run
from test_torch_server import Servers
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu_torch.core import POOL_FRAC_TIERS
from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.ops import knn as T

FRACS = (None, *POOL_FRAC_TIERS)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX side would shard over conftest's 8 virtual devices
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.delenv("UCFP_KNN_QUANT", raising=False)
    monkeypatch.delenv("UCFP_QUERY_BATCH_MS", raising=False)
    monkeypatch.delenv("UCFP_SKETCH_COST_MODEL", raising=False)
    monkeypatch.delenv("UCFP_INT2_TOPQ", raising=False)
    monkeypatch.delenv("UCFP_SKETCH_POOL_FRAC", raising=False)


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


def _same_markers(p: Pair, dim, k):
    for batch in (False, True):
        for batch_q in (1, 3, 64):
            for filtered in (False, True):
                for exact in (False, True):
                    for frac in FRACS:
                        kw = dict(batch=batch, batch_q=batch_q, filtered=filtered,
                                  exact=exact, pool_frac=frac)
                        assert (p.j.knn_is_approximate(0, dim, k, **kw)
                                == p.t.knn_is_approximate(0, dim, k, **kw)), kw


def _check(p: Pair, emb, seed, ks=(1, 10, 40)):
    qs = _queries(emb, seed)
    dim = emb.shape[1]
    for k in ks:
        p.same("knn", 0, qs[0], k)
        p.same("knn", 0, qs[1], k, filter={"model_id": "m2"})
        p.same("knn", 0, qs[2], k, exact=True)
        if p.t.knn_quant == "sketch":
            for frac in POOL_FRAC_TIERS[:2]:
                p.same("knn", 0, qs[3], k, pool_frac=frac)
                p.same("knn", 0, qs[1], k, pool_frac=frac, filter={"model_id": "m1"})
        p.same("knn_batch", 0, qs + [[0.0] * dim], k)
        p.same("knn_batch", 0, qs, k, filter={"model_id": "m1"})
        p.same("knn_batch", 0, qs[:2], k, exact=True)
        _same_markers(p, dim, k)


def _count_pipelines(monkeypatch):
    """Calls of the port's int2 and sketch pipelines, by name."""
    calls = {}
    for name in ("cosine_int2_topk", "cosine_int2_topk_batched", "cosine_sketch_topk"):
        calls[name] = 0

        def counted(*a, _name=name, _fn=getattr(T, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(T, name, counted)
    return calls


def _writes(p: Pair, emb, seed):
    """Writes after the device cache exists: an update, a new row, a
    delete (swap-with-last) — the int8 row patch and the packed column or
    tiled sketch patch."""
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


def _same_device_parts(p: Pair, dim, parts):
    tc, jc = p.t._vec[(0, dim)].device, p.j._vec[(0, dim)].device
    for i in parts:
        a, b = tc[i].numpy(), np.asarray(jc[i])
        assert a.shape == b.shape and np.array_equal(a.view(a.dtype), b.view(a.dtype)), i


@pytest.mark.parametrize("n,model", [(1500, True), (1500, False), (20000, False)])
def test_same_hits_int2(tmp_path, monkeypatch, n, model):
    if not model:
        monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant="int2")
    calls = _count_pipelines(monkeypatch)
    try:
        emb = _vectors(n, 16, seed=n)
        _load(p, emb)
        _check(p, emb, seed=1, ks=(1, 10, 40) if n < 5000 else (10,))
        cache = p.t._vec[(0, 16)]
        cap = cache.data.shape[0]
        # which tier served: the cost model keeps small catalogs exact, and
        # the batch gate refuses placeholder capacities
        assert bool(calls["cosine_int2_topk"]) == (not model)
        assert bool(calls["cosine_int2_topk_batched"]) == (not model and cap > 16384)
        packed_t, inv_n2 = cache.device[2], cache.device[3]
        if cap <= 16384:  # the zero-width placeholder
            assert packed_t.shape == (4, 0) and inv_n2.shape == (0,)
        else:
            _same_device_parts(p, 16, (2, 3))
        assert p.t.knn_is_approximate(0, 16, 10) == (not model and cap > 16384)
        new = _writes(p, emb, seed=n)
        _check(p, emb, seed=2, ks=(10,))  # after the row patches
        assert hits(p.same("knn", 0, new, 1))[0][0] == 10**6
        if cap > 16384:
            _same_device_parts(p, 16, (2, 3))
    finally:
        p.close()


@pytest.mark.parametrize("n,model", [(1500, True), (5000, True), (5000, False)])
def test_same_hits_sketch(tmp_path, monkeypatch, n, model):
    if not model:
        monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant="sketch")
    calls = _count_pipelines(monkeypatch)
    try:
        emb = _vectors(n, 16, seed=n + 1)
        _load(p, emb)
        _check(p, emb, seed=3)
        cache = p.t._vec[(0, 16)]
        cap = cache.data.shape[0]
        assert bool(calls["cosine_sketch_topk"]) == (not model)
        assert calls["cosine_int2_topk"] == calls["cosine_int2_topk_batched"] == 0
        assert cache.device[2].shape == (cap // 128, 24, 128)
        _same_device_parts(p, 16, (2,))
        assert p.t.knn_is_approximate(0, 16, 10) == (not model and cap > 4096)
        new = _writes(p, emb, seed=n)
        _check(p, emb, seed=4, ks=(10,))
        assert hits(p.same("knn", 0, new, 1))[0][0] == 10**6
        _same_device_parts(p, 16, (2,))
    finally:
        p.close()


def test_int2_topq_switch_backend(tmp_path, monkeypatch):
    """UCFP_INT2_TOPQ=1 reaches the backend's unfiltered single queries on
    both packages (at 32,768 rows its gate is off, so both serve the
    default path) with the same hits."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    monkeypatch.setenv("UCFP_INT2_TOPQ", "1")
    p = Pair(tmp_path, "auto", quant="int2")
    try:
        emb = _vectors(20000, 16, seed=5)
        _load(p, emb)
        for q in _queries(emb, seed=6)[:2]:
            p.same("knn", 0, q, 10)
    finally:
        p.close()


@pytest.mark.parametrize("quant", ["int2", "sketch"])
def test_odd_dim_serves_exact(tmp_path, monkeypatch, quant):
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant=quant)
    try:
        emb = _vectors(5000, 18, seed=6)  # 18 % 4 != 0
        _load(p, emb)
        _check(p, emb, seed=4, ks=(5,))
        # int2: no packed parts; sketch serves any width
        assert len(p.t._vec[(0, 18)].device) == (3 if quant == "int2" else 4)
        assert p.t.knn_is_approximate(0, 18, 5) == (quant == "sketch")
        _writes(p, emb, seed=6)
        _check(p, emb, seed=5, ks=(5,))
    finally:
        p.close()


@pytest.mark.parametrize("quant,n", [("int2", 20000), ("sketch", 5000)])
def test_reference_data_dir_reopens(tmp_path, monkeypatch, quant, n):
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = Pair(tmp_path, "auto", quant=quant)
    emb = _vectors(n, 16, seed=7)
    _load(p, emb)
    _writes(p, emb, seed=7)
    p.close()
    j = JBackend(str(tmp_path / "jax"), knn_quant=quant)
    t = EmbeddedBackend(str(tmp_path / "jax"), device="cpu", knn_quant=quant)
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


@pytest.mark.parametrize("quant,n", [("int2", 20000), ("sketch", 5000)])
def test_micro_batched(tmp_path, monkeypatch, quant, n):
    """Coalesced single queries: int2 flushes take the batched int2 path
    (judged at the padded size), sketch flushes the int8 path (sketch
    never batches); answers equal unbatched ones on both packages."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    monkeypatch.setenv("UCFP_QUERY_BATCH_MS", "25")
    monkeypatch.setenv("UCFP_QBATCH_MAX", "16")
    emb = _vectors(n, 16, seed=9)
    both = [JBackend(str(tmp_path / "j"), knn_quant=quant),
            EmbeddedBackend(str(tmp_path / "t"), device="cpu", knn_quant=quant)]
    monkeypatch.delenv("UCFP_QUERY_BATCH_MS")
    plain = EmbeddedBackend(str(tmp_path / "p"), device="cpu", knn_quant=quant)
    qs = _queries(emb, seed=10) + _queries(emb, seed=11)[:2]  # 6 queries
    calls = _count_pipelines(monkeypatch)
    try:
        for b in both + [plain]:
            run(b.upsert_embedding_batch(0, SEM, list(range(len(emb))), emb,
                                         model_id="m1"))
        for b in both:  # build the device caches outside the flushes
            run(b.knn(0, qs[0], 5, exact=True))
        assert both[0].knn_is_approximate(0, 16, 5) == both[1].knn_is_approximate(0, 16, 5)
        answers = []
        for b in both:
            async def go(b=b):
                return await asyncio.gather(*[b.knn(0, q, 5) for q in qs])

            answers.append([hits(h) for h in run(go())])
            assert b._qbatch_flushes == 1 and b._qbatch_items == 6
        assert calls["cosine_int2_topk_batched"] == (1 if quant == "int2" else 0)
        unbatched = [hits(run(plain.knn_batch(0, [q], 5))[0]) for q in qs]
        assert answers[0] == answers[1] == unbatched
        assert unbatched[0][0][0] == 3
    finally:
        for b in both + [plain]:
            b.close()


@pytest.mark.parametrize("quant", ["int2", "sketch"])
def test_markers_under_micro_batching(tmp_path, monkeypatch, quant):
    """The reference's marker rules with micro-batching on (int2: the
    64-query worst case; sketch: its single-query rule), with the cost
    model off and on, over pool fractions."""
    monkeypatch.setenv("UCFP_QUERY_BATCH_MS", "5")
    p = Pair(tmp_path, "auto", quant=quant)
    try:
        emb = _vectors(20000, 16, seed=12)
        _load(p, emb)
        for model in ("1", "0"):
            monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", model)
            for k in (1, 10, 40):
                _same_markers(p, 16, k)
    finally:
        p.close()


def test_markers_at_served_capacities(tmp_path, monkeypatch):
    """The markers at the capacities where the cost model serves each tier
    (2^20-2^23 rows) without storing them: the cache's capacity and count
    are what the rules read."""
    for quant in ("int2", "sketch"):
        p = Pair(tmp_path / quant, "auto", quant=quant)
        try:
            emb = _vectors(300, 768, seed=13)
            _load(p, emb)
            for b in (p.j, p.t):
                cache = b._vec[(0, 768)]
                cache.data = np.zeros((1 << 22, 1), np.float32)  # capacity only
            for cap_n in ((1 << 22) - 1024, 5):
                for b in (p.j, p.t):
                    b._vec[(0, 768)].n = cap_n
                for qb in ("0", "2"):
                    monkeypatch.setenv("UCFP_QUERY_BATCH_MS", qb)
                    for b in (p.j, p.t):
                        b._qbatch_ms = float(qb)
                    for k in (1, 10, 200):
                        _same_markers(p, 768, k)
        finally:
            p.close()


@pytest.mark.parametrize("quant", ["int2", "sketch"])
def test_server_bodies(tmp_path, monkeypatch, quant):
    """/v1/query vector(s) bodies byte-identical to the JAX server's,
    approximate mark included: single and batched, filtered, exact, and
    every recall_tier."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    monkeypatch.setenv("UCFP_KNN_QUANT", quant)
    n = 20000 if quant == "int2" else 5000
    s = Servers(tmp_path)
    try:
        assert s.t_index.knn_quant == quant
        emb = _vectors(n, 16, seed=13)
        for b in (s.j_index, s.t_index):
            for lo, mid in ((0, "m1"), (n // 2, "m2")):
                run(b.upsert_embedding_batch(0, SEM, list(range(lo, lo + n // 2)),
                                             emb[lo:lo + n // 2], model_id=mid))
        vecs = _queries(emb, seed=14)
        queries = [{"vector": vecs[0]}, {"vectors": vecs + [[0.0] * 16]}]
        for q in list(queries):
            queries.append({**q, "filter": {"model_id": "m2"}})
            for tier in ("fast", "balanced", "high", "exact"):
                queries.append({**q, "recall_tier": tier})
        for q in queries:
            st, res = s.call("POST", "/v1/query",
                             {"tenant_id": 0, "modality": "image", "k": 10, **q})
            assert st == 200
            if q.get("recall_tier") == "exact":
                assert "approximate" not in res
            elif "vector" in q and "filter" not in q:
                assert res["approximate"] is True
        rec = {"tenant_id": 0, "record_id": 10**6, "modality": "image",
               "algorithm": SEM, "fingerprint": [1, 2, 3, 4],
               "embedding": [9.0, -9.0] * 8, "model_id": "m1"}
        assert s.call("POST", "/v1/records", {"records": [rec]})[0] == 200
        for tier in (None, "fast"):
            body = {"tenant_id": 0, "modality": "image", "k": 3, "vector": [9.0, -8.0] * 8}
            if tier:
                body["recall_tier"] = tier
            st, res = s.call("POST", "/v1/query", body)
            assert res["hits"][0]["record_id"] == 10**6
    finally:
        s.close()
