"""The port's HTTP server against ucfp_tpu's, in process (build_server +
handle_request, no sockets), plus the port's import rules.

The same requests go to both servers; every status code and every JSON
body must be byte-for-byte equal. Embeddings are small integers, so the
cosine scores are exact in any summation order and the bodies match
without a tolerance.
"""

import asyncio
import io
import json
import pathlib
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

from test_conformance import fixed_png
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu.server.app import ServerState as JState
from ucfp_tpu.server.app import build_server as j_build
from ucfp_tpu.server.auth import StaticSingleKey as JKey
from ucfp_tpu.server.http import Request as JRequest
from ucfp_tpu.server.inputs_cache import InputsCache
from ucfp_tpu.server.ratelimit import NoopRateLimiter
from ucfp_tpu.server.usage import NoopUsageSink
from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.server.app import ServerState, build_server
from ucfp_tpu_torch.server.auth import StaticSingleKey
from ucfp_tpu_torch.server.http import Request

REPO = pathlib.Path(__file__).resolve().parent.parent
TOKEN = "t0k"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


class Servers:
    def __init__(self, tmp_path):
        self.j_index = JBackend(str(tmp_path / "jax"))
        self.j = j_build(JState(index=self.j_index, api_keys=JKey(TOKEN),
                                rate_limit=NoopRateLimiter(),
                                usage=NoopUsageSink(), inputs=InputsCache()),
                         timeout_secs=120.0)
        self.t_index = EmbeddedBackend(str(tmp_path / "torch"), device="cpu")
        self.t = build_server(ServerState(index=self.t_index,
                                          api_keys=StaticSingleKey(TOKEN)),
                              timeout_secs=120.0)

    def call(self, method, path, body=b"", query=None, token=TOKEN):
        """-> (status, body bytes) from both servers; asserts equal."""
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        h = {"content-length": str(len(body))}
        if token is not None:
            h["authorization"] = f"Bearer {token}"
        out = []
        for app, req_cls in ((self.j, JRequest), (self.t, Request)):
            req = req_cls(method, path, dict(query or {}), dict(h), body)

            async def go():
                resp, _ = await app.handle_request(req)
                return resp

            resp = asyncio.run(go())
            # PIL's decode errors name an object address, which differs
            # between any two calls (of the reference alone, too)
            out.append((resp.status, re.sub(rb"0x[0-9a-f]+", b"0x?", resp.body)))
        assert out[0] == out[1], (method, path, query, out)
        return out[1][0], json.loads(out[1][1]) if out[1][1] else None

    def close(self):
        self.j_index.close()
        self.t_index.close()


def bmp(seed, w=40, h=36):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="BMP")
    return buf.getvalue()


def frames(items):
    return b"".join(struct.pack("<QI", rid, len(b)) + b for rid, b in items)


def test_same_bodies(tmp_path):
    s = Servers(tmp_path)
    try:
        assert s.call("GET", "/healthz", token=None)[0] == 200
        # single image ingest, every algorithm
        png = fixed_png(10, 64, 64)
        for rid, algo in enumerate(("multi", "phash", "dhash", "ahash")):
            st, body = s.call("POST", f"/v1/ingest/image/0/{rid + 1}", png,
                              {"algorithm": algo})
            assert st == 201, body
        s.call("POST", "/v1/ingest/image/0/9", fixed_png(12, 256, 256))
        s.call("POST", "/v1/ingest/image/0/10", png, {"algorithm": "semantic-x"})
        # batch ingest: uniform BMPs (whole-batch decode) and mixed PNGs
        for algo in ("phash", "multi"):
            st, _ = s.call("POST", "/v1/ingest/image/batch/0",
                           frames([(100 + i, bmp(i)) for i in range(12)]),
                           {"algorithm": algo})
            assert st == 201
        s.call("POST", "/v1/ingest/image/batch/0",
               frames([(200, fixed_png(11, 100, 37)), (201, fixed_png(13, 48, 640)),
                       (202, bmp(3))]), {"algorithm": "dhash"})
        s.call("POST", "/v1/ingest/image/batch/0", frames([(300, b"junk")]))
        s.call("POST", "/v1/ingest/image/batch/0", b"\x01\x02")
        # records with embeddings (small integers: exact cosine)
        rng = np.random.default_rng(0)
        emb = rng.integers(-3, 4, (40, 8)).astype(np.float32)
        recs = [{"tenant_id": 0, "record_id": 1000 + i, "modality": "image",
                 "algorithm": "embedding-image-local", "fingerprint": [1, 2, 3, 4],
                 "embedding": [float(x) for x in emb[i]], "model_id": "m"}
                for i in range(20)]
        assert s.call("POST", "/v1/records", {"records": recs})[0] == 200
        body = b"".join(struct.pack("<QI", 2000 + i, 32) + emb[i].tobytes()
                        for i in range(20, 40))
        assert s.call("POST", "/v1/ingest/embedding/batch/0", body,
                      {"modality": "image", "algorithm": "embedding-image-local"})[0] == 201
        s.call("POST", "/v1/ingest/embedding/batch/0", body[:-3])
        # the four query forms
        phash = s.t_index.get_record(0, 2)["fingerprint"].hex()
        st, res = s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 5,
            "fingerprint_hex": phash, "algorithm": "phash"})
        assert res["hits"][0]["record_id"] == 2 and res["hits"][0]["score"] == 1.0
        s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 3, "algorithm": "phash",
            "fingerprints_hex": [phash, "00" * 8, "abcd"]})
        multi = s.t_index.get_record(0, 1)["fingerprint"].hex()
        st, res = s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 4,
            "fingerprint_hex": multi, "algorithm": "multi"})
        assert res["hits"][0]["record_id"] == 1
        s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 4, "algorithm": "multi",
            "fingerprints_hex": [multi, multi[:20]],
            "multihash": {"phash_weight": 0.9, "block_distance_threshold": 2}})
        vec = [float(x) for x in emb[5] + 1.0]
        st, res = s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 6, "vector": vec})
        assert st == 200 and res["hits"]
        s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 6, "vector": vec,
            "filter": {"algorithm": "semantic", "model_id": "m"}})
        s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 3, "recall_tier": "exact",
            "vectors": [vec, [float(x) for x in emb[30]], [0.0] * 8]})
        # errors answer alike
        s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "image",
                                     "k": 3, "fingerprint_hex": "zz",
                                     "algorithm": "phash"})
        s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "image",
                                     "k": 10**6, "vector": vec})
        s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "bogus"})
        s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "image"},
               token="wrong")
        # describe, list, delete, query again
        s.call("GET", "/v1/records/0/1000", query={"include": "fingerprint,embedding"})
        s.call("GET", "/v1/records/0/2")
        s.call("GET", "/v1/records/0/424242")
        s.call("GET", "/v1/records/0", query={"offset": "3", "limit": "7"})
        s.call("DELETE", "/v1/records/0/2")
        st, res = s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 5,
            "fingerprint_hex": phash, "algorithm": "phash"})
        assert all(h["record_id"] != 2 for h in res["hits"])
    finally:
        s.close()


def test_fused_capacity_marks_approximate(tmp_path):
    """At 32,768 rows both servers ride the fused candidate scans and
    mark the answer approximate."""
    s = Servers(tmp_path)
    try:
        rng = np.random.default_rng(1)
        n = 32768
        fps = [rng.integers(0, 256, 8, np.uint8).tobytes() for _ in range(n)]
        for b in (s.j_index, s.t_index):
            asyncio.run(b.upsert_fingerprint_batch(
                0, "imgfprint-phash-v1", list(range(n)), fps))
        st, res = s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "image", "k": 5,
            "fingerprints_hex": [fps[77].hex(), fps[n - 1].hex()],
            "algorithm": "phash"})
        assert res["approximate"] is True
        assert [r["hits"][0]["record_id"] for r in res["results"]] == [77, n - 1]
    finally:
        s.close()


@pytest.mark.parametrize("n", [300, 32768])
def test_same_bodies_int8(tmp_path, monkeypatch, n):
    """Under UCFP_KNN_QUANT=int8 the vector query forms answer alike:
    below 32,768 rows the exhaustive int8 scan, at 32,768 the int8
    product with the fused candidate kernels (marked approximate)."""
    monkeypatch.setenv("UCFP_KNN_QUANT", "int8")
    s = Servers(tmp_path)
    try:
        assert s.t_index.knn_quant == "int8"
        rng = np.random.default_rng(n)
        emb = rng.integers(-3, 4, (n, 8)).astype(np.float32)
        emb[9] = emb[4]  # score ties
        for b in (s.j_index, s.t_index):
            for lo, mid in ((0, "m1"), (n // 2, "m2")):
                asyncio.run(b.upsert_embedding_batch(
                    0, "embedding-image-local",
                    list(range(lo, lo + n // 2)), emb[lo:lo + n // 2], model_id=mid))
        vecs = [[float(x) for x in emb[i] + rng.integers(-1, 2, 8)]
                for i in (4, 77, n - 1)]
        queries = [{"vector": vecs[0]}, {"vectors": vecs + [[0.0] * 8]}]
        for q in list(queries):
            queries.append({**q, "filter": {"model_id": "m2"}})
            queries.append({**q, "recall_tier": "exact"})
        for k in (1, 10):
            for q in queries:
                st, res = s.call("POST", "/v1/query",
                                 {"tenant_id": 0, "modality": "image", "k": k, **q})
                assert st == 200
                if "recall_tier" not in q:
                    assert bool(res.get("approximate")) == (n == 32768)
        # a record written after the first query: the int8 row patch
        rec = {"tenant_id": 0, "record_id": 10**6, "modality": "image",
               "algorithm": "embedding-image-local", "fingerprint": [1, 2, 3, 4],
               "embedding": [9.0, -9.0] * 4, "model_id": "m1"}
        assert s.call("POST", "/v1/records", {"records": [rec]})[0] == 200
        st, res = s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "image",
                                               "k": 3, "vector": [9.0, -8.0] * 4})
        assert res["hits"][0]["record_id"] == 10**6
    finally:
        s.close()


def test_later_slice_routes_answer_501(tmp_path):
    """What is still left for a later slice (the embedding reranker and
    the inputs cache) answers 501; the text routes and query branches
    that once did are served now."""
    t = EmbeddedBackend(str(tmp_path), device="cpu")
    app = build_server(ServerState(index=t, api_keys=StaticSingleKey(TOKEN)))
    h = {"authorization": f"Bearer {TOKEN}"}

    def call(path, body, query=None):
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = Request("POST", path, query or {}, h, raw)
        return asyncio.run(app.handle_request(req))[0].status

    try:
        assert call("/v1/query", {"tenant_id": 0, "modality": "text",
                                  "terms": ["a"]}, {"rerank": "embedding"}) == 501
        for path in ("/v1/ingest/text/0/1", "/v1/ingest/image/0/1",
                     "/v1/ingest/audio/0/1"):
            assert call(path, b"x", {"input_id": "abc", "sample_rate": "8000"}) == 501
        assert call("/v1/query", {"tenant_id": 0, "modality": "text",
                                  "terms": ["a"]}) == 200
        assert call("/v1/query", {"tenant_id": 0, "modality": "text",
                                  "fingerprint_hex": "00", "algorithm": "lsh"}) == 200
        assert call("/v1/records", {"records": [{
            "tenant_id": 0, "record_id": 1, "modality": "text",
            "algorithm": "minhash-h128", "fingerprint": [0] * 8,
            "text": "hello"}]}) == 200
    finally:
        t.close()


def _port_files():
    return sorted((REPO / "ucfp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_imports_without_jax_or_reference():
    mods = sorted(
        "ucfp_tpu_torch." + ".".join(p.relative_to(REPO / "ucfp_tpu_torch")
                                     .with_suffix("").parts)
        for p in (REPO / "ucfp_tpu_torch").rglob("*.py")
        if p.name != "__init__.py" or p.parent != REPO / "ucfp_tpu_torch"
    )
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    assert {"ucfp_tpu_torch.parallel", "ucfp_tpu_torch.parallel.mesh",
            "ucfp_tpu_torch.parallel.sharded_knn"} <= set(mods)
    # the text, BM25 and encoder modules
    assert {"ucfp_tpu_torch.models", "ucfp_tpu_torch.models.encoders",
            "ucfp_tpu_torch.models.jaxrand", "ucfp_tpu_torch.models.hf_local",
            "ucfp_tpu_torch.ops.textsig", "ucfp_tpu_torch.index.bm25",
            "ucfp_tpu_torch.modality.text",
            "ucfp_tpu_torch.modality.providers"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ucfp_tpu'] = None\n"
        "import ucfp_tpu_torch.server\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_static_scan_finds_no_reference_imports():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ucfp_tpu\b(?!_torch)"
                     r"|from\s+ucfp_tpu\b(?!_torch))", re.M)
    files = _port_files()
    names = {p.relative_to(REPO).as_posix() for p in files}
    assert {"ucfp_tpu_torch/models/encoders.py", "ucfp_tpu_torch/models/jaxrand.py",
            "ucfp_tpu_torch/models/hf_local.py", "ucfp_tpu_torch/index/bm25.py",
            "ucfp_tpu_torch/ops/textsig.py", "ucfp_tpu_torch/modality/text.py",
            "ucfp_tpu_torch/modality/providers.py"} <= names
    offenders = [str(p) for p in files if bad.search(p.read_text())]
    assert not offenders
    # the native text sources build from the package alone: no include
    # reaches outside ucfp_tpu_torch/native
    for src in ("textsig.cpp", "bm25.cpp", "wb_table.h"):
        text = (REPO / "ucfp_tpu_torch" / "native" / src).read_text()
        assert not re.search(r'#include\s+"(arrow|\.\.)', text), src


def test_no_gpu_no_device_refuses_to_start(tmp_path, monkeypatch):
    import torch

    from ucfp_tpu_torch.server.app import state_from_env

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_env(data_dir=str(tmp_path), token="x")
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        state_from_env(data_dir=str(tmp_path), token="x", device="cuda")
