"""ucfp_tpu_torch.index.embedded.EmbeddedBackend against the ucfp_tpu
backend, on the CPU.

Both backends get the same upserts, batch upserts and deletes through
both WAL engines, then every query form must return the same hits —
record ids, scores and approximate markers — below 32,768 rows (the
exact paths) and at 32,768 (the fused candidate paths). Embeddings are
small integers, so every f32 dot product and norm is exact in any
summation order and the cosine scores are bit-equal too. A data
directory written by ucfp_tpu reopens in the port with the same answers.
The same holds under the int8 tier (knn_quant="int8"), and under query
micro-batching (UCFP_QUERY_BATCH_MS > 0) coalesced answers equal
unbatched ones.
"""

import asyncio

import numpy as np
import pytest
import torch

from ucfp_tpu.core import Modality as JModality
from ucfp_tpu.core import Record as JRecord
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu_torch.core import Modality, Record, UnsupportedError
from ucfp_tpu_torch.index.embedded import EmbeddedBackend

PHASH = "imgfprint-phash-v1"
MULTI = "imgfprint-multi-v1"
SEM = "embedding-image-local"
DIM = 16


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX side would shard over conftest's 8 virtual devices and
    # never reach the Pallas path
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


def run(coro):
    return asyncio.run(coro)


def hits(res):
    """Hit lists (or lists of them) -> comparable tuples."""
    if res and isinstance(res[0], list):
        return [hits(r) for r in res]
    return [(h.record_id, h.score, h.source.value) for h in res]


def bundles(n, rng):
    """Synthetic 536-byte multi bundles: random hash words, a normalized
    histogram (finite floats), random block bytes."""
    words = np.zeros((n, 134), np.uint32)
    words[:, :6] = rng.integers(0, 2**32, (n, 6), dtype=np.uint32)
    hist = rng.random((n, 64)).astype(np.float32)
    hist /= hist.sum(axis=1, keepdims=True)
    words[:, 6:70] = hist.view(np.uint32)
    words[:, 70:] = rng.integers(0, 2**32, (n, 64), dtype=np.uint32)
    words[n // 2:, 70:] = words[: n - n // 2, 70:]  # shared blocks
    return [w.tobytes() for w in words]


class Pair:
    """The same operations on a ucfp_tpu backend and a port backend."""

    def __init__(self, tmp_path, engine, quant=None):
        self.j = JBackend(str(tmp_path / "jax"), wal_engine=engine,
                          knn_quant=quant)
        self.t = EmbeddedBackend(str(tmp_path / "torch"), wal_engine=engine,
                                 device="cpu", knn_quant=quant)

    def both(self, name, *a, **kw):
        out = []
        for b in (self.j, self.t):
            if name == "upsert":
                rec_cls, mod = ((JRecord, JModality) if b is self.j
                                else (Record, Modality))
                recs = [rec_cls(**{**r, "modality": mod(r["modality"])})
                        for r in a[0]]
                out.append(run(b.upsert(recs)))
            else:
                kw2 = dict(kw)
                if "modality" in kw2:
                    kw2["modality"] = (JModality if b is self.j
                                       else Modality)(kw2["modality"])
                res = getattr(b, name)(*a, **kw2)
                out.append(run(res) if asyncio.iscoroutine(res) else res)
        return out

    def same(self, name, *a, **kw):
        jr, tr = self.both(name, *a, **kw)
        if isinstance(jr, (bool, tuple)) or jr is None:
            assert jr == tr, name
        else:
            assert hits(jr) == hits(tr), name
        return tr

    def close(self):
        self.j.close()
        self.t.close()


def load(p: Pair, n: int, seed: int):
    rng = np.random.default_rng(seed)
    fps = [rng.integers(0, 256, 8, np.uint8).tobytes() for _ in range(n)]
    fps[n // 2] = fps[1]  # duplicate fingerprints: distance ties
    p.both("upsert_fingerprint_batch", 0, PHASH, list(range(n)), fps,
           modality="image")
    emb = rng.integers(-3, 4, (n, DIM)).astype(np.float32)
    emb[7] = emb[3]  # duplicate vectors: score ties
    p.both("upsert_embedding_batch", 0, SEM, list(range(10**6, 10**6 + n)),
           emb, modality="image", model_id="m1")
    nb = min(n, 600)
    p.both("upsert_fingerprint_batch", 0, MULTI,
           list(range(2 * 10**6, 2 * 10**6 + nb)), bundles(nb, rng),
           modality="image")
    # per-record path: mixed records, an update, a re-tag
    p.both("upsert", [
        dict(tenant_id=0, record_id=5, modality="image", algorithm=PHASH,
             fingerprint=fps[9]),
        dict(tenant_id=0, record_id=3 * 10**6, modality="image", algorithm=SEM,
             fingerprint=b"\x00" * 4, embedding=[1.0] * DIM, model_id="m2"),
        dict(tenant_id=1, record_id=1, modality="image", algorithm=PHASH,
             fingerprint=fps[2]),
    ])
    p.both("delete", 0, [11, 12, 10**6 + 4, 2 * 10**6 + 3, 424242])
    return fps, emb


def check_queries(p: Pair, fps, emb, n):
    rng = np.random.default_rng(n)
    q_fps = [fps[1], fps[20], fps[n - 1], rng.integers(0, 256, 8, np.uint8).tobytes()]
    for k in (1, 5, 16, 40):
        p.same("knn_fingerprint", 0, PHASH, q_fps[0], k)
        p.same("knn_fingerprint_batch", 0, PHASH, q_fps + [b"", b"\x01"], k)
        p.same("fingerprint_is_approximate", 0, PHASH, k)
        qv = [list(map(float, emb[30] + 1.0)), list(map(float, emb[3])),
              [float(x) for x in rng.integers(-3, 4, DIM)]]
        p.same("knn", 0, qv[0], k)
        p.same("knn", 0, qv[1], k, filter={"model_id": "m1"})
        p.same("knn", 0, qv[1], k, exact=True)
        p.same("knn_batch", 0, qv + [[0.0] * DIM], k)
        p.same("knn_batch", 0, qv, k, filter={"model_id": "m1"})
        p.same("knn_batch", 0, qv, k, exact=True)
        p.same("knn_is_approximate", 0, DIM, k)
        # the batched marker: the port's single form answers for batches
        assert (p.j.knn_is_approximate(0, DIM, k, batch=True, batch_q=4)
                == p.t.knn_is_approximate(0, DIM, k))
        p.same("knn_is_approximate", 0, DIM, k, exact=True)
    multi_q = [p.t.get_record(0, 2 * 10**6 + 10)["fingerprint"],
               p.t.get_record(0, 2 * 10**6 + 400)["fingerprint"], b"\x00" * 7]
    p.same("knn_multihash", 0, multi_q, 10)
    p.same("knn_multihash", 0, multi_q[:1], 10,
           {"phash_weight": 0.8, "block_distance_threshold": 3})
    assert p.same("list_records", 0, 5, 20) is not None
    for rid in (5, 2 * 10**6 + 10, 3 * 10**6):
        jm, tm = p.both("get_record_metadata", 0, rid)
        assert (jm.algorithm, jm.fingerprint_bytes, jm.has_embedding,
                jm.model_id, jm.modality.value) == (
            tm.algorithm, tm.fingerprint_bytes, tm.has_embedding,
            tm.model_id, tm.modality.value)


@pytest.mark.parametrize("engine", ["auto", "json"])
@pytest.mark.parametrize("n", [1500, 32768])
def test_same_hits(tmp_path, engine, n):
    p = Pair(tmp_path, engine)
    fps, emb = load(p, n, seed=n)
    if n == 32768:
        # the capacity that rides the fused candidate scans
        assert p.t.fingerprint_is_approximate(0, PHASH, 5)
        assert p.t.knn_is_approximate(0, DIM, 5)
    check_queries(p, fps, emb, n)
    p.close()


@pytest.mark.parametrize("engine", ["auto", "json"])
def test_reference_data_dir_reopens(tmp_path, engine):
    p = Pair(tmp_path, engine)
    fps, emb = load(p, 1200, seed=3)
    p.close()
    j = JBackend(str(tmp_path / "jax"))
    t = EmbeddedBackend(str(tmp_path / "jax"), device="cpu")
    try:
        for k in (1, 7):
            assert hits(run(j.knn_fingerprint_batch(0, PHASH, fps[:6], k))) == \
                hits(run(t.knn_fingerprint_batch(0, PHASH, fps[:6], k)))
            q = [list(map(float, emb[i])) for i in (0, 3, 99)]
            assert hits(run(j.knn_batch(0, q, k))) == hits(run(t.knn_batch(0, q, k)))
        assert j.list_records(0, 0, 2000) == t.list_records(0, 0, 2000)
    finally:
        j.close()
        t.close()


def test_reference_dir_with_text_records_refuses_to_open(tmp_path):
    """Text records are in the port's slice now: a reference data dir that
    holds them opens, and its BM25 index answers as the reference's."""
    j = JBackend(str(tmp_path))
    run(j.upsert([JRecord(tenant_id=0, record_id=1, modality=JModality.TEXT,
                          algorithm="minhash-h128", fingerprint=b"\x00" * 8,
                          text="hello world")]))
    j.close()
    j = JBackend(str(tmp_path))
    t = EmbeddedBackend(str(tmp_path), device="cpu")
    try:
        got = [(h.record_id, h.score) for h in run(t.bm25(0, ["hello"], 3))]
        assert got == [(h.record_id, h.score) for h in run(j.bm25(0, ["hello"], 3))]
        assert got and got[0][0] == 1
    finally:
        j.close()
        t.close()


def test_out_of_slice_writes_are_refused(tmp_path):
    """Every algorithm is in the slice now: an LSH record and a record with
    text are logged and indexed; a malformed record is still refused
    before anything reaches the log."""
    t = EmbeddedBackend(str(tmp_path), device="cpu")
    run(t.upsert([Record(tenant_id=0, record_id=1, modality=Modality.TEXT,
                         algorithm="minhash-lsh-h128", fingerprint=b"\x00" * 16),
                  Record(tenant_id=0, record_id=2, modality=Modality.TEXT,
                         algorithm="minhash-h128", fingerprint=b"\x00" * 8,
                         text="hello world")]))
    with pytest.raises(ValueError):
        run(t.upsert([Record(tenant_id=0, record_id=3, modality=Modality.TEXT,
                             algorithm="embedding-local", fingerprint=b"\x00" * 4,
                             embedding=[float("nan")])]))
    assert [h.record_id for h in run(t.bm25(0, ["hello"], 3))] == [2]
    t.close()
    # the two records reached the log, the malformed one did not
    t2 = EmbeddedBackend(str(tmp_path), device="cpu")
    assert t2.list_records(0)[1] == 2
    assert [h.record_id for h in run(t2.bm25(0, ["world"], 3))] == [2]
    t2.close()


def test_wal_bulk_copy_out():
    """The bulk replay copies the native buffer out through the buffer
    protocol, one memcpy with a 64-bit size (ctypes.string_at's C-int size
    cut a multi-GiB log short)."""
    import ctypes

    from ucfp_tpu_torch.index.wal import _copy_out

    src = (ctypes.c_uint8 * 1000)(*[i % 251 for i in range(1000)])
    ptr = ctypes.cast(src, ctypes.POINTER(ctypes.c_uint8))
    out = _copy_out(ptr, 1000)
    assert out.dtype == np.uint8 and out.tolist() == [i % 251 for i in range(1000)]
    src[0] = 200
    assert out[0] == 0  # a copy, not a view of the native buffer
    assert _copy_out(ptr, 0).shape == (0,)
    assert _copy_out(ptr, 16).view("<u8").shape == (2,)


def test_unknown_quant_serves_exact_f32(tmp_path, monkeypatch):
    """An unknown UCFP_KNN_QUANT is not checked, as in the reference: the
    backend opens and serves the exact f32 path, with the same hits."""
    monkeypatch.setenv("UCFP_KNN_QUANT", "Int3")
    p = Pair(tmp_path, "auto")
    try:
        assert p.j.knn_quant == p.t.knn_quant == "int3"
        rng = np.random.default_rng(3)
        emb = rng.integers(-3, 4, (300, DIM)).astype(np.float32)
        p.both("upsert_embedding_batch", 0, SEM, list(range(300)), emb,
               modality="image", model_id="m1")
        q = [float(x) for x in emb[7] + 0.25]
        for k in (1, 10):
            p.same("knn", 0, q, k)
            p.same("knn", 0, q, k, filter={"model_id": "m1"})
            p.same("knn_batch", 0, [q, [float(x) for x in emb[9]]], k)
            assert not p.t.knn_is_approximate(0, DIM, k)
        assert p.t._vec[(0, DIM)].device[0].dtype == torch.float32
    finally:
        p.close()


def test_int8_opens_and_serves(tmp_path, monkeypatch):
    monkeypatch.setenv("UCFP_KNN_QUANT", "int8")
    t = EmbeddedBackend(str(tmp_path), device="cpu")
    try:
        assert t.knn_quant == "int8"
        emb = np.eye(4, dtype=np.float32) * 3
        run(t.upsert_embedding_batch(0, SEM, [10, 11, 12, 13], emb))
        got = run(t.knn(0, [0.0, 0.1, 2.0, 0.0], 2))
        assert [h.record_id for h in got] == [12, 11]
        assert t._vec[(0, 4)].device[0].dtype == torch.int8
    finally:
        t.close()


def _int8_writes(p: Pair, n: int, seed: int):
    """Small writes after the device cache exists (the row-patch path):
    an update, new rows, deletes, then a batch that doubles capacity."""
    rng = np.random.default_rng(seed)
    p.both("upsert", [
        dict(tenant_id=0, record_id=10**6 + 30, modality="image", algorithm=SEM,
             fingerprint=b"\x00" * 4, model_id="m1",
             embedding=[float(x) for x in rng.integers(-3, 4, DIM)]),
        dict(tenant_id=0, record_id=4 * 10**6, modality="image", algorithm=SEM,
             fingerprint=b"\x00" * 4, model_id="m2",
             embedding=[float(x) for x in rng.integers(-3, 4, DIM)]),
    ])
    p.both("delete", 0, [10**6 + 8, 10**6 + n - 1])


@pytest.mark.parametrize("n", [1500, 32768])
def test_same_hits_int8(tmp_path, n):
    p = Pair(tmp_path, "auto", quant="int8")
    fps, emb = load(p, n, seed=n + 1)
    check_queries(p, fps, emb, n)  # builds the int8 device caches
    _int8_writes(p, n, seed=n)
    check_queries(p, fps, emb, n)  # after the row patches
    if n == 32768:
        assert p.t.knn_is_approximate(0, DIM, 5)
        # past the capacity: a full rebuild at twice the size
        grow = np.random.default_rng(2).integers(-3, 4, (40, DIM)).astype(np.float32)
        p.both("upsert_embedding_batch", 0, SEM,
               list(range(5 * 10**6, 5 * 10**6 + 40)), grow,
               modality="image", model_id="m1")
        assert p.t._vec[(0, DIM)].data.shape[0] == 2 * n
        check_queries(p, fps, emb, n)
    p.close()


def test_reference_data_dir_reopens_int8(tmp_path):
    p = Pair(tmp_path, "auto", quant="int8")
    fps, emb = load(p, 1200, seed=4)
    p.close()
    j = JBackend(str(tmp_path / "jax"), knn_quant="int8")
    t = EmbeddedBackend(str(tmp_path / "jax"), device="cpu", knn_quant="int8")
    try:
        for k in (1, 7):
            q = [list(map(float, emb[i] + 0.5)) for i in (0, 3, 99)]
            assert hits(run(j.knn_batch(0, q, k))) == hits(run(t.knn_batch(0, q, k)))
            assert hits(run(j.knn(0, q[2], k, filter={"model_id": "m1"}))) == \
                hits(run(t.knn(0, q[2], k, filter={"model_id": "m1"})))
    finally:
        j.close()
        t.close()


# -- query micro-batching ---------------------------------------------------


def _counting(b, name, sizes):
    orig = getattr(b, name)

    async def counting(tenant_id, *a, **kw):
        sizes.append(len(a[-2]))  # (queries, k) or (algorithm, fps, k)
        return await orig(tenant_id, *a, **kw)

    setattr(b, name, counting)


@pytest.mark.parametrize("quant,n", [("int8", 300), ("int8", 32768), ("none", 300)])
def test_vector_queries_coalesce(tmp_path, monkeypatch, quant, n):
    """Concurrent plain knn() calls share one knn_batch flush per
    (tenant, dim, k) on both packages, with the unbatched answers;
    filtered and exact queries bypass the batcher. The reference pads
    the flush to a power of two, the port does not."""
    monkeypatch.setenv("UCFP_QUERY_BATCH_MS", "25")
    rng = np.random.default_rng(50)
    vecs = rng.integers(-3, 4, (n, DIM)).astype(np.float32)
    both = [JBackend(str(tmp_path / "j"), knn_quant=quant),
            EmbeddedBackend(str(tmp_path / "t"), device="cpu", knn_quant=quant)]
    monkeypatch.delenv("UCFP_QUERY_BATCH_MS")
    plain = EmbeddedBackend(str(tmp_path / "p"), device="cpu", knn_quant=quant)
    qs = [[float(x) for x in vecs[i] + rng.integers(-1, 2, DIM)]
          for i in (3, 77, 150, 299, 8, 42)]
    qs.append([0.0] * DIM)  # zero norm: [] before the batcher
    answers, sizes = [], {}
    try:
        for b in both + [plain]:
            run(b.upsert_embedding_batch(0, SEM, list(range(n)), vecs,
                                         model_id="m1"))
        for b in both:
            assert b._qbatch_ms == 25.0
            sizes[b] = []
            _counting(b, "knn_batch", sizes[b])

            async def go(b=b):
                return await asyncio.gather(*[b.knn(0, q, 5) for q in qs])

            answers.append([hits(h) for h in run(go())])
            assert b._qbatch_flushes == 1 and b._qbatch_items == 6
        assert plain._qbatch_ms == 0.0
        unbatched = [hits(run(plain.knn(0, q, 5))) for q in qs]
        assert answers[0] == answers[1] == unbatched
        assert unbatched[-1] == [] and unbatched[0]
        assert sizes[both[0]] == [8] and sizes[both[1]] == [6]
        t = both[1]
        sizes[t].clear()
        assert hits(run(t.knn(0, qs[0], 5, exact=True))) == hits(
            run(plain.knn(0, qs[0], 5, exact=True)))
        assert hits(run(t.knn(0, qs[0], 5, filter={"model_id": "m1"}))) == hits(
            run(plain.knn(0, qs[0], 5, filter={"model_id": "m1"})))
        assert sizes[t] == [] and t._qbatch_flushes == 1
        # a later event loop gets its own batcher
        assert hits(run(t.knn(0, qs[1], 5))) == unbatched[1]
        assert t._qbatch_flushes == 2
    finally:
        for b in both + [plain]:
            b.close()


@pytest.mark.parametrize("n", [50, 32768])
def test_fingerprint_queries_coalesce(tmp_path, monkeypatch, n):
    monkeypatch.setenv("UCFP_QUERY_BATCH_MS", "25")
    rng = np.random.default_rng(51)
    fps = [rng.bytes(8) for _ in range(n)]
    both = [JBackend(str(tmp_path / "j")),
            EmbeddedBackend(str(tmp_path / "t"), device="cpu")]
    monkeypatch.delenv("UCFP_QUERY_BATCH_MS")
    plain = EmbeddedBackend(str(tmp_path / "p"), device="cpu")
    answers, sizes = [], {}
    try:
        for b in both + [plain]:
            run(b.upsert_fingerprint_batch(0, PHASH, list(range(n)), fps))
        for b in both:
            sizes[b] = []
            _counting(b, "knn_fingerprint_batch", sizes[b])

            async def go(b=b):
                return await asyncio.gather(*[
                    b.knn_fingerprint(0, PHASH, fps[i], 3) for i in (4, 17, 33)])

            answers.append([hits(h) for h in run(go())])
            assert b._qbatch_flushes == 1 and b._qbatch_items == 3
        unbatched = [hits(run(plain.knn_fingerprint(0, PHASH, fps[i], 3)))
                     for i in (4, 17, 33)]
        assert answers[0] == answers[1] == unbatched
        assert [h[0][:2] for h in unbatched] == [(4, 1.0), (17, 1.0), (33, 1.0)]
        assert sizes[both[0]] == [4] and sizes[both[1]] == [3]
    finally:
        for b in both + [plain]:
            b.close()


def test_no_gpu_and_no_device_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddedBackend(str(tmp_path))
