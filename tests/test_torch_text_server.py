"""The port's text routes and text query branches against the reference
server: the same requests through both apps in process must answer with
the same status and the same JSON bytes (test_torch_server.py's pattern).

Tolerance: bit-equal bodies. Text signatures are integers, BM25 scores
are the same doubles in both engines, RRF scores are rank functions, and
the hybrid's vector leg uses small-integer embeddings, whose cosines are
exact in any summation order.
"""

import json

import numpy as np
import pytest
from test_conformance import LONG_TEXT, PANGRAM
from test_torch_server import Servers

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


def doc(i: int, n: int = 60) -> str:
    rng = np.random.default_rng(1000 + i)
    # a Zipf-ish draw, so the terms have different document frequencies
    idx = np.minimum(rng.zipf(1.3, n) - 1, len(WORDS) - 1)
    return " ".join(WORDS[j] for j in idx)


def ndjson(rows) -> bytes:
    return "\n".join(json.dumps(r) for r in rows).encode()


def test_text_ingest_routes(tmp_path):
    s = Servers(tmp_path)
    try:
        for rid, algo in enumerate(("minhash", "simhash-tf", "simhash-idf",
                                    "lsh", "tlsh", "semantic"), 1):
            st, body = s.call("POST", f"/v1/ingest/text/0/{rid}",
                              LONG_TEXT.encode(), {"algorithm": algo})
            assert st == 201, body
        # tunables, the embedding echo, and the error paths
        s.call("POST", "/v1/ingest/text/0/20", PANGRAM.encode(),
               {"algorithm": "minhash", "k": "2", "h": "64",
                "tokenizer": "char", "canon_case_fold": "0"})
        s.call("POST", "/v1/ingest/text/0/21", PANGRAM.encode(),
               {"algorithm": "semantic", "return_embedding": "1"})
        s.call("POST", "/v1/ingest/text/0/22", PANGRAM.encode(), {"k": "99"})
        s.call("POST", "/v1/ingest/text/0/23", b"\xff\xfe", {})
        s.call("POST", "/v1/ingest/text/0/24", b"   ", {})
        s.call("POST", "/v1/ingest/text/0/25", PANGRAM.encode(),
               {"algorithm": "nope"})
        s.call("POST", "/v1/ingest/text/0/26", b"short", {"algorithm": "tlsh"})
        s.call("POST", "/v1/ingest/text/0/27", PANGRAM.encode(),
               {"algorithm": "semantic", "provider": "openai"})
        # the preprocess route and its query spelling
        html = f"<html><body><p>{LONG_TEXT}</p><script>x()</script></body></html>"
        for kind, body in (("html", html), ("markdown", "# Title\n\n*" + PANGRAM + "*"),
                           ("rtf", PANGRAM)):
            s.call("POST", f"/v1/ingest/text/0/30/preprocess/{kind}", body.encode())
        s.call("POST", "/v1/ingest/text/0/31", html.encode(), {"preprocess": "html"})
        # what the store now holds, through the records routes
        st, listing = s.call("GET", "/v1/records/0", query={"limit": "100"})
        assert st == 200 and listing["total"] >= 8
        s.call("GET", "/v1/records/0/5", query={"include": "fingerprint"})
    finally:
        s.close()


def test_text_batch_and_stream(tmp_path):
    s = Servers(tmp_path)
    try:
        rows = [{"record_id": 100 + i, "text": doc(i)} for i in range(12)]
        for algo in ("minhash", "simhash-tf", "lsh", "tlsh"):
            st, body = s.call("POST", "/v1/ingest/text/batch/0", ndjson(rows),
                              {"algorithm": algo})
            assert st == 201 and body["count"] == 12, body
        # SimHash-IDF reads the corpus the batches above built
        st, body = s.call("POST", "/v1/ingest/text/batch/0",
                          ndjson(rows[:4]), {"algorithm": "simhash-idf"})
        assert st == 201
        bad = ndjson(rows[:2]) + b"\nnot json\n" + ndjson(
            [{"record_id": 7, "text": "   "}, {"record_id": -1, "text": "x"},
             {"record_id": 8}])
        s.call("POST", "/v1/ingest/text/batch/0", bad, {"quiet": "1"})
        s.call("POST", "/v1/ingest/text/batch/0", b"\n\n")
        s.call("POST", "/v1/ingest/text/batch/0", b"garbage")
        s.call("POST", "/v1/ingest/text/batch/0", ndjson(rows[:1]),
               {"algorithm": "semantic"})
        s.call("POST", "/v1/ingest/text/batch/x", ndjson(rows[:1]))
        # the NDJSON stream route, one shot through handle_request
        chunks = [{"chunk": LONG_TEXT[i:i + 37]} for i in range(0, len(LONG_TEXT), 37)]
        st, body = s.call("POST", "/v1/ingest/text/0/500/stream", ndjson(chunks))
        assert st == 201, body
        s.call("POST", "/v1/ingest/text/0/501/stream", b'{"chunk": 3}')
        s.call("POST", "/v1/ingest/text/0/502/stream", b'[1, 2]\n')
        s.call("POST", "/v1/ingest/text/0/503/stream", b'{"chunk": "a"\n')
        s.call("POST", "/v1/ingest/text/0/504/stream", b"")
    finally:
        s.close()


def test_text_queries(tmp_path):
    s = Servers(tmp_path)
    try:
        n = 40
        rows = [{"record_id": 100 + i, "text": doc(i)} for i in range(n)]
        for algo, base in (("minhash", 0), ("simhash-tf", 1000), ("lsh", 2000),
                           ("tlsh", 3000)):
            s.call("POST", "/v1/ingest/text/batch/0",
                   ndjson([{"record_id": r["record_id"] + base, "text": r["text"]}
                           for r in rows]), {"algorithm": algo, "quiet": "1"})
        # records with text and small-integer embeddings: the hybrid's legs
        emb = np.random.default_rng(5).integers(-3, 4, (n, 8)).astype(float)
        recs = [{"tenant_id": 0, "record_id": 5000 + i, "modality": "text",
                 "algorithm": "embedding-local", "fingerprint": [1, 2, 3, 4],
                 "embedding": list(emb[i]), "model_id": "m", "text": rows[i]["text"]}
                for i in range(n)]
        assert s.call("POST", "/v1/records", {"records": recs})[0] == 200
        q = {"tenant_id": 0, "modality": "text", "k": 10}
        for terms in (["alpha"], ["gamma", "omega"], ["Beta", "beta", "zzz"], ["zzz"]):
            st, body = s.call("POST", "/v1/query", {**q, "terms": terms})
            assert st == 200
            s.call("POST", "/v1/query", {**q, "terms": terms}, {"explain": "1"})
        st, body = s.call("POST", "/v1/query", {**q, "terms": ["delta"],
                                                "vector": list(emb[3])})
        assert st == 200 and body["hits"], body
        s.call("POST", "/v1/query", {**q, "terms": ["delta", "pi"],
                                     "vector": list(emb[7]), "rrf_k": 5},
               {"explain": "1"})
        s.call("POST", "/v1/query", {**q, "terms": ["delta"],
                                     "filter": {"algorithm": "semantic"}})
        # fingerprint queries: MinHash, SimHash, LSH and TLSH, single and batched
        st, rec = s.call("GET", "/v1/records/0/105", query={"include": "fingerprint"})
        fp = {}
        for algo, base in (("minhash", 0), ("simhash-tf", 1000), ("lsh", 2000),
                           ("tlsh", 3000)):
            st, rec = s.call("GET", f"/v1/records/0/{105 + base}",
                             query={"include": "fingerprint"})
            fp[algo] = rec["fingerprint_hex"]
            st, body = s.call("POST", "/v1/query", {**q, "algorithm": algo,
                                                    "fingerprint_hex": fp[algo]})
            assert st == 200 and body["hits"][0]["record_id"] == 105 + base, body
        hexes = []
        for i in (1, 2, 3):
            st, rec = s.call("GET", f"/v1/records/0/{1100 + i}",
                             query={"include": "fingerprint"})
            hexes.append(rec["fingerprint_hex"])
        for algo, hx in (("simhash-tf", hexes), ("lsh", [fp["lsh"], fp["lsh"]]),
                         ("minhash", [fp["minhash"]])):
            s.call("POST", "/v1/query", {**q, "algorithm": algo,
                                         "fingerprints_hex": hx})
        s.call("POST", "/v1/query", {**q, "algorithm": "lsh", "fingerprint_hex": "00"})
        s.call("POST", "/v1/query", {**q, "terms": "alpha"})
        s.call("POST", "/v1/query", {**q, "terms": ["alpha"], "k": 0})
        # deletes leave the BM25 and LSH indexes
        s.call("DELETE", "/v1/records/0/2105")
        s.call("DELETE", "/v1/records/0/5003")
        s.call("POST", "/v1/query", {**q, "algorithm": "lsh",
                                     "fingerprint_hex": fp["lsh"]})
        s.call("POST", "/v1/query", {**q, "terms": ["delta"],
                                     "vector": list(emb[3])}, {"explain": "1"})
    finally:
        s.close()


def _both(s, path, body, query):
    """(status, json) from each server, without the byte check: the float
    encoders' outputs differ in their last bits between XLA and torch."""
    import asyncio

    from ucfp_tpu.server.http import Request as JRequest
    from ucfp_tpu_torch.server.http import Request as TRequest

    out = []
    for app, cls in ((s.j, JRequest), (s.t, TRequest)):
        req = cls("POST", path, dict(query), {"authorization": "Bearer t0k",
                                              "content-length": str(len(body))}, body)
        resp = asyncio.run(app.handle_request(req))[0]
        out.append((resp.status, json.loads(resp.body)))
    return out


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def test_semantic_image_and_neural_audio_routes(tmp_path):
    """The float routes: every field but the float bytes equal, the
    embeddings at cosine >= 0.999999, and queries by them find the same
    records."""
    from ucfp_tpu.models import encoders as renc
    from test_conformance import fixed_audio, fixed_png

    for fn in (renc._image_params, renc._audio_params):
        fn.cache_clear()
        fn()  # concrete weights outside the reference's jit
    s = Servers(tmp_path)
    try:
        for rid, (path, body, q) in enumerate((
                ("/v1/ingest/image/0/{}/semantic", fixed_png(10, 64, 64), {}),
                ("/v1/ingest/image/0/{}", fixed_png(11, 100, 37),
                 {"algorithm": "semantic"}),
                ("/v1/ingest/audio/0/{}", fixed_audio().tobytes(),
                 {"algorithm": "neural", "sample_rate": "8000"}),
                ("/v1/ingest/audio/0/{}", fixed_audio(9.0, 16000).tobytes(),
                 {"algorithm": "neural", "sample_rate": "16000"})), 1):
            (sj, bj), (st, bt) = _both(s, path.format(rid), body,
                                       {**q, "return_embedding": "1"})
            assert sj == st == 201, (bj, bt)
            ej, et = bj.pop("embedding"), bt.pop("embedding")
            assert _cos(ej, et) >= 0.999999
            fj = np.frombuffer(bytes.fromhex(bj.pop("fingerprint_hex")), "<f4")
            ft = np.frombuffer(bytes.fromhex(bt.pop("fingerprint_hex")), "<f4")
            w = 512 if "image" in path else 128
            assert min(_cos(a, b) for a, b in zip(fj.reshape(-1, w),
                                                   ft.reshape(-1, w))) >= 0.999999
            assert bj == bt
        for path, q in (("/v1/ingest/image/0/9/semantic", {"model_id": "clip"}),
                        ("/v1/ingest/audio/0/9", {"algorithm": "neural"})):
            (sj, bj), (st, bt) = _both(s, path, fixed_png(10, 64, 64), q)
            assert (sj, bj) == (st, bt)
        emb = list(s.j_index.get_record(0, 1)["embedding"])
        (sj, bj), (st, bt) = _both(s, "/v1/query", json.dumps(
            {"tenant_id": 0, "modality": "image", "k": 3,
             "vector": [float(v) for v in emb]}).encode(), {})
        assert [h["record_id"] for h in bj["hits"]] == [h["record_id"] for h in bt["hits"]]
    finally:
        s.close()
