"""The two streaming sessions and their routes, the port against ucfp_tpu:
StreamingWangSession (Wang and Panako segments with their halo) and
StreamingMinHashSession, pushed in chunks of several sizes, and the
/v1/ingest/audio/{tid}/{rid}/stream and /v1/ingest/text/{tid}/{rid}/stream
routes (raw f32, s16 and multipart bodies; NDJSON).

Tolerance: none. Segments, records and response bodies are byte-equal.
"""

import json

import numpy as np
import pytest
from test_conformance import LONG_TEXT
from test_torch_server import Servers

from ucfp_tpu.modality import audio as raudio
from ucfp_tpu.modality import text as rtext
from ucfp_tpu_torch.modality import audio as taudio
from ucfp_tpu_torch.modality import text as ttext


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


def clip(secs: float, seed: int = 0) -> np.ndarray:
    t = np.arange(int(secs * 8000)) / 8000
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.25 * np.sin(2 * np.pi * 1250 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0)
            + rng.normal(0, 0.05, t.size)).astype(np.float32)


def _rec(r):
    return (r.tenant_id, r.record_id, r.algorithm, r.config_hash, r.fingerprint,
            r.metadata)


def _stream(mod, x, chunk, **kw):
    extra = {"device": "cpu"} if mod is taudio else {}
    s = mod.StreamingWangSession(0, 100, 8000, **kw, **extra)
    out = []
    for i in range(0, len(x), chunk):
        out += s.push(x[i:i + chunk])
    out += s.finalize()
    return [_rec(r) for r in out]


@pytest.mark.parametrize("algorithm", ["wang", "panako"])
@pytest.mark.parametrize("chunk", [997, 8000, 40_000])
def test_streaming_wang_session(algorithm, chunk):
    x = clip(9.3, seed=1)
    a = _stream(taudio, x, chunk, segment_secs=3.0, algorithm=algorithm)
    b = _stream(raudio, x, chunk, segment_secs=3.0, algorithm=algorithm)
    assert a == b and len(a) >= 2
    assert [m for *_, m in a] == [f"segment={i}".encode() for i in range(len(a))]


def test_streaming_wang_session_edges():
    # a stream ending on a segment boundary emits no halo-only record,
    # and a closed session refuses more audio
    x = clip(6.0)
    a = _stream(taudio, x, 4000, segment_secs=2.0)
    assert a == _stream(raudio, x, 4000, segment_secs=2.0)
    with pytest.raises(Exception, match="8000"):
        taudio.StreamingWangSession(0, 1, 16000, device="cpu")
    s = taudio.StreamingWangSession(0, 1, 8000, device="cpu")
    s.finalize()
    with pytest.raises(Exception, match="closed"):
        s.push(x)


@pytest.mark.parametrize("chunk", [1, 50, 4096])
def test_streaming_minhash_session(chunk):
    opts = dict(k=3, h=64)
    a = ttext.StreamingMinHashSession(0, 3, ttext.TextOpts(**opts))
    b = rtext.StreamingMinHashSession(0, 3, rtext.TextOpts(**opts))
    for i in range(0, len(LONG_TEXT), chunk):
        a.push(LONG_TEXT[i:i + chunk])
        b.push(LONG_TEXT[i:i + chunk])
    assert _rec(a.finalize()) == _rec(b.finalize())


def _multipart(parts, boundary="XyZ"):
    body = b""
    for p in parts:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"c\"\r\n"
                 f"Content-Type: application/octet-stream\r\n\r\n").encode() + p + b"\r\n"
    return body + f"--{boundary}--\r\n".encode()


def test_stream_routes(tmp_path):
    s = Servers(tmp_path)
    x = clip(7.5, seed=2)
    try:
        q = {"sample_rate": "8000", "segment_secs": "2.5"}
        st, body = s.call("POST", "/v1/ingest/audio/0/1000/stream", x.tobytes(), q)
        assert st == 201 and body["segments"] >= 2, body
        s16 = np.round(x * 20000).astype("<i2").tobytes()
        s.call("POST", "/v1/ingest/audio/0/2000/stream", s16,
               {**q, "encoding": "s16", "algorithm": "panako"})
        # the multipart wire shape (one part per chunk), through the router
        from ucfp_tpu.server.http import Request as JRequest
        from ucfp_tpu_torch.server.http import Request as TRequest

        raw = x.tobytes()
        mp = _multipart([raw[i:i + 20_000] for i in range(0, len(raw), 20_000)])
        outs = []
        for app, cls in ((s.j, JRequest), (s.t, TRequest)):
            import asyncio

            req = cls("POST", "/v1/ingest/audio/0/3000/stream", dict(q),
                      {"authorization": "Bearer t0k",
                       "content-type": "multipart/form-data; boundary=XyZ",
                       "content-length": str(len(mp))}, mp)
            resp = asyncio.run(app.handle_request(req))[0]
            outs.append((resp.status, resp.body))
        assert outs[0] == outs[1] and outs[0][0] == 201
        # the error paths
        s.call("POST", "/v1/ingest/audio/0/4000/stream", raw[:-2], q)
        s.call("POST", "/v1/ingest/audio/0/4000/stream", b"", q)
        s.call("POST", "/v1/ingest/audio/0/4000/stream", raw, {"sample_rate": "16000"})
        s.call("POST", "/v1/ingest/audio/0/4000/stream", raw, {})
        s.call("POST", "/v1/ingest/audio/0/4000/stream", raw, {**q, "algorithm": "haitsma"})
        s.call("POST", "/v1/ingest/audio/0/4000/stream", raw, {**q, "encoding": "u8"})
        # what the stream stored answers queries the same way
        st, rec = s.call("GET", "/v1/records/0/1001", query={"include": "fingerprint"})
        st, body = s.call("POST", "/v1/query", {"tenant_id": 0, "modality": "audio",
                                                "k": 5, "algorithm": "wang",
                                                "fingerprint_hex": rec["fingerprint_hex"]})
        assert body["hits"][0]["record_id"] == 1001
        # the text stream route, NDJSON
        lines = "\n".join(json.dumps({"chunk": LONG_TEXT[i:i + 11]})
                          for i in range(0, len(LONG_TEXT), 11))
        st, body = s.call("POST", "/v1/ingest/text/0/5000/stream", lines.encode(),
                          {"k": "4"})
        assert st == 201, body
    finally:
        s.close()
