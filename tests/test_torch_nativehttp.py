"""The port's native epoll HTTP front (native/httpfront.cpp through
server/nativehttp.py) end to end over real sockets (tests/test_nativehttp.py,
mirrored), and against the port's asyncio front: the same requests give
the same status and the same JSON on both fronts."""

import asyncio
import concurrent.futures as cf
import json
import socket
import threading
import urllib.error
import urllib.request

import pytest

from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.native import load_httpfront
from ucfp_tpu_torch.server import nativehttp as nh
from ucfp_tpu_torch.server.app import ServerState, build_server
from ucfp_tpu_torch.server.auth import StaticSingleKey
from ucfp_tpu_torch.server.inputs_cache import InputsCache
from ucfp_tpu_torch.server.nativehttp import NativeHttpBridge
from ucfp_tpu_torch.server.ratelimit import NoopRateLimiter
from ucfp_tpu_torch.server.usage import NoopUsageSink


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


def _server(path):
    state = ServerState(index=EmbeddedBackend(str(path), device="cpu"),
                        api_keys=StaticSingleKey("t"), rate_limit=NoopRateLimiter(),
                        usage=NoopUsageSink(), inputs=InputsCache())
    return build_server(state, timeout_secs=60.0), state


@pytest.fixture
def bridge_runner(tmp_path):
    srv, state = _server(tmp_path)

    def run_scenario(fn):
        async def go():
            bridge = NativeHttpBridge(srv, "127.0.0.1", 0)
            loop = asyncio.get_running_loop()
            t = threading.Thread(target=bridge._pull_loop, args=(loop,), daemon=True)
            t.start()
            try:
                return await asyncio.wait_for(asyncio.to_thread(fn, bridge.port),
                                              timeout=60)
            finally:
                bridge.stop()

        return asyncio.run(go())

    yield run_scenario
    state.index.close()


def http(port, method, path, body=None, token="t"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestNativeHttpFront:
    def test_lib_loads(self):
        assert load_httpfront() is not None

    def test_health_info_and_ingest(self, bridge_runner):
        def scenario(port):
            s1, b1 = http(port, "GET", "/healthz", token=None)
            s2, b2 = http(port, "GET", "/v1/info", token=None)
            s3, b3 = http(port, "POST", "/v1/ingest/text/0/1?algorithm=minhash",
                          body=b"the quick brown fox jumps over the lazy dog")
            return s1, b1, s2, b2, s3, json.loads(b3)

        s1, b1, s2, b2, s3, ing = bridge_runner(scenario)
        assert s1 == 200 and json.loads(b1)["status"] == "ok"
        assert s2 == 200 and json.loads(b2)["name"] == "ucfp-tpu"
        assert s3 == 201 and ing["fingerprint_bytes"] == 1032

    def test_auth_and_errors(self, bridge_runner):
        def scenario(port):
            s1, _ = http(port, "POST", "/v1/ingest/text/0/1", b"x", token=None)
            s2, _ = http(port, "GET", "/nope", token=None)
            return s1, s2

        assert bridge_runner(scenario) == (401, 404)

    def test_keepalive_sequential(self, bridge_runner):
        def scenario(port):
            with socket.create_connection(("127.0.0.1", port), timeout=5) as sk:
                for _ in range(3):
                    out = b""
                    sk.sendall(b"GET /healthz HTTP/1.1\r\nhost: x\r\n\r\n")
                    while b'{"status":"ok"}' not in out:
                        out += sk.recv(4096)
                return True

        assert bridge_runner(scenario)

    def test_native_413(self, bridge_runner):
        def scenario(port):
            with socket.create_connection(("127.0.0.1", port), timeout=5) as sk:
                sk.sendall(b"POST /v1/ingest/text/0/1 HTTP/1.1\r\n"
                           b"content-length: 999999999\r\n\r\n")
                return sk.recv(4096)

        assert b"413" in bridge_runner(scenario).split(b"\r\n")[0]

    def test_concurrent_clients(self, bridge_runner):
        def scenario(port):
            def one(i):
                return http(port, "POST", f"/v1/ingest/text/0/{i}",
                            body=f"document number {i} here".encode())[0]

            with cf.ThreadPoolExecutor(8) as ex:
                return list(ex.map(one, range(24)))

        assert bridge_runner(scenario) == [201] * 24

    def test_remote_addr_reaches_per_ip_limits(self, bridge_runner, monkeypatch):
        seen = []
        orig = nh.NativeHttpBridge._to_request

        def spy(self, raw):
            rid, req, close = orig(self, raw)
            seen.append(req.remote_addr)
            return rid, req, close

        monkeypatch.setattr(nh.NativeHttpBridge, "_to_request", spy)
        status, _ = bridge_runner(lambda port: http(port, "GET", "/healthz", token=None))
        assert status == 200 and seen and all(a == "127.0.0.1" for a in seen)


def _png(seed):
    import io

    import numpy as np
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (40, 48, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return buf.getvalue()


# (method, path, body, token): the same sequence on each front, against a
# store of its own
ROUTES = [
    ("GET", "/healthz", None, None),
    ("GET", "/v1/algorithms", None, None),
    ("POST", "/v1/ingest/text/0/1?algorithm=minhash", b"the quick brown fox", "t"),
    ("POST", "/v1/ingest/text/0/2?algorithm=simhash-tf", b"lazy dogs sleep all day", "t"),
    ("POST", "/v1/ingest/image/0/3?algorithm=phash", _png(1), "t"),
    ("POST", "/v1/ingest/image/0/4", _png(2), "t"),
    ("POST", "/v1/records", json.dumps({"records": [{
        "tenant_id": 0, "record_id": 5, "modality": "image",
        "algorithm": "embedding-image-local", "fingerprint": [1, 2],
        "embedding": [1.0, 2.0, 3.0, 4.0]}]}).encode(), "t"),
    ("POST", "/v1/query", json.dumps({"tenant_id": 0, "modality": "text", "k": 5,
                                      "terms": ["quick", "fox", "dogs"]}).encode(), "t"),
    ("POST", "/v1/query", json.dumps({"tenant_id": 0, "modality": "image", "k": 3,
                                      "vector": [1.0, 2.0, 3.0, 4.5]}).encode(), "t"),
    ("GET", "/v1/records/0", None, "t"),
    ("GET", "/v1/records/0/3", None, "t"),
    ("DELETE", "/v1/records/0/2", None, "t"),
    ("GET", "/v1/records/0/2", None, "t"),
    ("POST", "/v1/admin/compact", b"", "t"),
    ("POST", "/v1/ingest/text/0/9", b"x", None),
    ("POST", "/v1/ingest/text/0/9", b"x", "wrong"),
    ("GET", "/nope", None, None),
    ("POST", "/v1/query", b"{not json", "t"),
]


def _asyncio_front(tmp_path, fn):
    srv, state = _server(tmp_path)

    async def go():
        s = await srv.serve("127.0.0.1", 0)
        port = s.sockets[0].getsockname()[1]
        try:
            return await asyncio.wait_for(asyncio.to_thread(fn, port), timeout=60)
        finally:
            s.close()
            await srv.drain(5)

    try:
        return asyncio.run(go())
    finally:
        state.index.close()


def _normalized(body: bytes):
    doc = json.loads(body) if body else None
    if isinstance(doc, dict):
        doc.pop("uptime_secs", None)
    return doc


def test_same_status_and_json_as_the_asyncio_front(tmp_path, bridge_runner):
    def scenario(port):
        out = []
        for method, path, body, token in ROUTES:
            status, raw = http(port, method, path, body, token)
            out.append((method, path, status, _normalized(raw)))
        return out

    native = bridge_runner(scenario)
    plain = _asyncio_front(tmp_path / "asyncio", scenario)
    assert native == plain
    statuses = [s for _, _, s, _ in native]
    assert statuses.count(201) == 4 and 401 in statuses and 404 in statuses
