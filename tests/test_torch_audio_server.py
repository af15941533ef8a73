"""The port's audio routes against the reference server: the same requests
through both apps in process must answer with the same status and the
same JSON bytes (test_torch_server.py's pattern).

Tolerance: bit-equal bodies. Fingerprints are integers and the scores
are the same floats (vote ratios, 1 - BER), so the JSON bytes match.
"""

import json

import numpy as np
import pytest
from test_conformance import fixed_audio
from test_torch_server import TOKEN, Servers, frames

from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.server.app import ServerState, build_server
from ucfp_tpu_torch.server.auth import StaticSingleKey
from ucfp_tpu_torch.server.http import Request


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


def _clip(i: int, secs: float = 3.0) -> np.ndarray:
    t = np.arange(int(secs * 8000)) / 8000
    rng = np.random.default_rng(100 + i)
    return (0.3 * np.sin(2 * np.pi * (350 + 83 * i) * t)
            + 0.2 * np.sin(2 * np.pi * (1000 + 121 * i) * t)
            * (np.sin(2 * np.pi * (0.4 + 0.1 * i) * t) > 0)
            + rng.normal(0, 0.05, t.size)).astype(np.float32)


def _s16(x: np.ndarray) -> bytes:
    return np.round(x * 20000).astype("<i2").tobytes()


def test_audio_routes_same_bodies(tmp_path):
    s = Servers(tmp_path)
    try:
        clips = [_clip(i) for i in range(6)]
        # single ingest: every classical algorithm and the tunables
        for rid, (algo, q) in enumerate((
                ("wang", {}), ("panako", {}), ("haitsma", {}),
                ("haitsma", {"fft": "1"}), ("wang", {"local_floor": "1", "fan_out": "4"}),
                ("panako", {"panako_fan_out": "3"}),
                ("haitsma", {"haitsma_fmin": "250", "fmax": "1800"}))):
            st, body = s.call("POST", f"/v1/ingest/audio/0/{rid + 1}",
                              clips[rid % 6].tobytes(),
                              {"sample_rate": "8000", "algorithm": algo, **q})
            assert st == 201, body
        st, _ = s.call("POST", "/v1/ingest/audio/0/20", _s16(clips[1]),
                       {"sample_rate": "16000", "encoding": "s16"})
        assert st == 201
        # batch ingest, each algorithm, f32 and s16 (two lengths: two groups)
        for base, algo in ((100, "wang"), (200, "panako"), (300, "haitsma")):
            items = [(base + i, clips[i].tobytes()) for i in range(5)]
            items.append((base + 5, clips[5][:16000].tobytes()))
            st, body = s.call("POST", "/v1/ingest/audio/batch/0", frames(items),
                              {"sample_rate": "8000", "algorithm": algo})
            assert st == 201 and body["count"] == 6
            st, _ = s.call("POST", "/v1/ingest/audio/batch/1",
                           frames([(base + i, _s16(clips[i])) for i in range(3)]),
                           {"sample_rate": "8000", "algorithm": algo, "encoding": "s16",
                            "quiet": "1"})
            assert st == 201
        # watermark: a report, no record
        for route, q in (("/v1/ingest/audio/0/50", {"algorithm": "watermark"}),
                         ("/v1/ingest/audio/0/50/watermark", {})):
            st, body = s.call("POST", route, fixed_audio(secs=5.0).tobytes(),
                              {"sample_rate": "8000", "watermark_key": "k", **q})
            assert st == 200 and set(body) == {"detected", "payload", "confidence"}
        # queries: an excerpt of each stored clip finds it at rank 1
        for algo, rid in (("wang", 101), ("panako", 202), ("haitsma", 303)):
            i = rid % 100
            st, rec = s.call("POST", "/v1/ingest/audio/9/1", clips[i][4000:20000].tobytes(),
                             {"sample_rate": "8000", "algorithm": algo})
            st, res = s.call("POST", "/v1/query", {
                "tenant_id": 0, "modality": "audio", "k": 5, "algorithm": algo,
                "fingerprint_hex": rec["fingerprint_hex"]})
            assert st == 200 and res["hits"][0]["record_id"] == rid, res
            st, res = s.call("POST", "/v1/query", {
                "tenant_id": 0, "modality": "audio", "k": 3, "algorithm": algo,
                "fingerprints_hex": [rec["fingerprint_hex"], "", "00" * 12]})
            assert st == 200 and len(res["results"]) == 3
        # a haitsma upsert that a query then finds, and a delete
        st, rec = s.call("GET", "/v1/records/0/303", query={"include": "fingerprint"})
        s.call("DELETE", "/v1/records/0/303")
        st, res = s.call("POST", "/v1/query", {
            "tenant_id": 0, "modality": "audio", "k": 4, "algorithm": "haitsma",
            "fingerprint_hex": rec.get("fingerprint_hex", "")})
        assert st == 200
        s.call("GET", "/v1/records/0", query={"limit": "50"})
    finally:
        s.close()


def test_audio_errors_answer_alike(tmp_path):
    s = Servers(tmp_path)
    try:
        x = _clip(0, 1.0).tobytes()
        for path, body, q in (
                ("/v1/ingest/audio/0/1", x, {}),  # no sample_rate
                ("/v1/ingest/audio/0/1", x, {"sample_rate": "8000", "algorithm": "nope"}),
                ("/v1/ingest/audio/0/1", x[:-1], {"sample_rate": "8000"}),
                ("/v1/ingest/audio/0/1", b"", {"sample_rate": "8000"}),
                ("/v1/ingest/audio/0/1", x, {"sample_rate": "8000", "encoding": "u8"}),
                ("/v1/ingest/audio/0/1", x, {"sample_rate": "8000", "fan_out": "99"}),
                ("/v1/ingest/audio/0/1", x[:400], {"sample_rate": "8000"}),
                ("/v1/ingest/audio/0/1", x, {"sample_rate": "16000", "algorithm": "panako"}),
                ("/v1/ingest/audio/0/1", x, {"sample_rate": "0"}),
                ("/v1/ingest/audio/0/1", x, {"sample_rate": "8000",
                                              "algorithm": "watermark"}),
                ("/v1/ingest/audio/batch/0", frames([(1, x)]), {}),
                ("/v1/ingest/audio/batch/0", frames([(1, x)]),
                 {"sample_rate": "8000", "algorithm": "neural"}),
                ("/v1/ingest/audio/batch/0", b"\x01\x02", {"sample_rate": "8000"}),
                ("/v1/ingest/audio/batch/0", frames([(1, x[:6])]),
                 {"sample_rate": "8000"}),
                ("/v1/ingest/audio/batch/0", frames([(1, b"")]), {"sample_rate": "8000"}),
        ):
            st, _ = s.call("POST", path, body, q)
            assert st >= 400, (path, q)
        st, _ = s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "audio", "k": 3,
                                             "fingerprint_hex": "0011",
                                             "algorithm": "haitsma"})
        assert st == 200
    finally:
        s.close()


def test_neural_stream_and_inspect_answer_501(tmp_path):
    """The inspector is still a later slice's (501); the neural route and
    the stream route are served now (201)."""
    t = EmbeddedBackend(str(tmp_path), device="cpu")
    app = build_server(ServerState(index=t, api_keys=StaticSingleKey(TOKEN)))
    h = {"authorization": f"Bearer {TOKEN}"}
    body = _clip(1, 1.0).tobytes()

    def call(path, query):
        import asyncio

        req = Request("POST", path, query, dict(h, **{"content-length": str(len(body))}),
                      body)
        resp = asyncio.run(app.handle_request(req))[0]
        return resp.status, json.loads(resp.body)

    try:
        for path, q in (("/v1/pipeline/inspect/audio", {"sample_rate": "8000"}),
                        ("/v1/pipeline/inspect/audio/0", {"sample_rate": "8000"})):
            st, res = call(path, q)
            assert st == 501 and res["error"] == "unsupported", (path, res)
        st, res = call("/v1/ingest/audio/0/1", {"sample_rate": "8000",
                                                "algorithm": "neural"})
        assert st == 201 and res["algorithm"] == "audiofp-neural-v1", res
        st, res = call("/v1/ingest/audio/0/10/stream", {"sample_rate": "8000"})
        assert st == 201 and res["segments"] == 1, res
    finally:
        t.close()