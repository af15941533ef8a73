"""The port's public routes and the anonymous demo route against the
reference's (test_torch_auth_keys.ProdServers: each package's own
state_from_env, the same requests, equal statuses and bodies).

Masked, as time-bound: /v1/info's `uptime_secs`, and /metrics' latency
histogram (its bucket counts and sums); the request counters and the
histogram's label sets must be equal.
"""

import re

import pytest

from test_conformance import PANGRAM, fixed_audio, fixed_png
from test_torch_auth_keys import ProdServers, _env  # noqa: F401 (autouse fixture)
from test_webhooks import WebhookEndpoint
from ucfp_tpu_torch.server.docsite import DOCS_DIR

UPTIME = ((rb'"uptime_secs": ?\d+', b'"uptime_secs":0'),)
LATENCY = ((rb'(ucfp_http_request_duration_seconds_(?:bucket|sum)\{.*?"\}) \S+', rb'\1 ?'),)


def test_pages_docs_info_algorithms(tmp_path, monkeypatch):
    """/, /docs, every /docs/{page}, /healthz, /v1/info and
    /v1/algorithms answer alike and need no key."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        out = s.raw("GET", "/", token=None)
        assert out[1][0] == 200 and out[1][3].content_type.startswith("text/html")
        assert out[0][1] == out[1][1] and len(out[1][1]) > 10_000
        st = s.raw("GET", "/docs", token=None)[1][0]
        assert st == 200
        pages = sorted(p.stem for p in DOCS_DIR.glob("*.md"))
        assert len(pages) >= 10
        for page in pages:
            assert s.raw("GET", f"/docs/{page}", token=None)[1][0] == 200, page
        assert s.call("GET", "/docs/no-such-page", token=None)[0] == 404
        assert s.call("GET", "/docs/..%2fREADME", token=None)[0] == 404
        assert s.call("GET", "/healthz", token=None) == (200, {"status": "ok"})
        st, info = s.call("GET", "/v1/info", token=None, masks=UPTIME)
        assert st == 200 and info["name"] == "ucfp-tpu"
        assert (info["ingest_coalesce_flushes"], info["ingest_coalesce_groups"]) == (0, 0)
        assert info["encoders"]["image"]["mode"] == "stand-in"
        st, algos = s.call("GET", "/v1/algorithms", token=None)
        assert st == 200 and algos
    finally:
        s.close()


def test_metrics(tmp_path, monkeypatch):
    """/metrics after the same requests: the same request counters, and
    a latency histogram for the same routes."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        s.call("GET", "/healthz", token=None)
        s.call("POST", "/v1/ingest/text/0/1", PANGRAM.encode())
        s.call("GET", "/v1/records/0/1")
        s.call("GET", "/v1/records/0/2")
        s.call("GET", "/nowhere", token=None)
        out = s.raw("GET", "/metrics", token=None, masks=LATENCY)
        assert out[1][0] == 200
        assert out[1][3].content_type == "text/plain; version=0.0.4"
        texts = [o[3].body.decode() for o in out]
        counters = [sorted(ln for ln in t.splitlines()
                           if ln.startswith("ucfp_http_requests_total")) for t in texts]
        assert counters[0] == counters[1] and len(counters[1]) == 5
        hist = [sorted(re.sub(r"\} \S+$", "}", ln) for ln in t.splitlines()
                       if ln.startswith("ucfp_http_request_duration")) for t in texts]
        assert hist[0] == hist[1] and hist[1]
    finally:
        s.close()


def test_demo_fingerprint(tmp_path, monkeypatch):
    """The demo route fingerprints an image, an audio clip and a text by
    their content type, stores nothing, and answers the errors alike."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        for body, ct, q, algo in (
                (fixed_png(10, 64, 64), "image/png", {}, "imgfprint-multi-v1"),
                (fixed_audio(3.0, 8000).tobytes(), "audio/f32", {}, "audiofp-wang-v1"),
                (fixed_audio(2.0, 16000).tobytes(), "application/octet-stream",
                 {"sample_rate": "16000"}, "audiofp-wang-v1"),
                (PANGRAM.encode(), "text/plain; charset=utf-8", {}, "minhash-h128")):
            st, res = s.call("POST", "/v1/demo/fingerprint", body, q, token=None,
                             headers={"content-type": ct})
            assert (st, res["algorithm"], res["stored"]) == (200, algo, False)
        assert s.call("GET", "/v1/records/0")[1]["records"] == []
        for body, ct, q in ((b"\xff\xfe", "text/plain", {}),
                            (b"junk", "image/png", {}),
                            (b"abc", "audio/f32", {}),
                            (b"\x00" * 64, "audio/f32", {"sample_rate": "10"})):
            assert s.call("POST", "/v1/demo/fingerprint", body, q, token=None,
                          headers={"content-type": ct})[0] == 400
    finally:
        s.close()
    monkeypatch.setenv("UCFP_DISABLED_ALGORITHMS", "minhash")
    s = ProdServers(tmp_path / "off", monkeypatch)
    try:
        assert s.call("POST", "/v1/demo/fingerprint", b"hello", token=None)[0] == 501
    finally:
        s.close()


@pytest.fixture()
def endpoint():
    ep = WebhookEndpoint()
    yield ep
    ep.stop()


def test_demo_challenge(tmp_path, monkeypatch, endpoint):
    """UCFP_DEMO_CHALLENGE_URL (a verifier served from a local socket):
    a missing token, a refused one and an accepted one answer alike."""
    endpoint.handlers["/verify"] = (200, {"success": True})
    s = ProdServers(tmp_path, monkeypatch,
                    env={"UCFP_DEMO_CHALLENGE_URL": endpoint.url("/verify"),
                         "UCFP_DEMO_CHALLENGE_SECRET": "sec"})
    try:
        st, res = s.call("POST", "/v1/demo/fingerprint", b"hello there", token=None)
        assert (st, res["error"]) == (403, "challenge_required")
        assert s.call("POST", "/v1/demo/fingerprint", b"hello there", token=None,
                      headers={"x-challenge-token": "tok"})[0] == 200
        assert endpoint.requests[-1] == ("/verify", {"secret": "sec", "response": "tok",
                                                     "remoteip": "10.0.0.1"})
        endpoint.handlers["/verify"] = (200, {"success": False})
        st, res = s.call("POST", "/v1/demo/fingerprint", b"hello there", token=None,
                         headers={"cf-turnstile-response": "bad"})
        assert (st, res["error"]) == (403, "challenge_failed")
    finally:
        s.close()
