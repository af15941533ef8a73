"""The port's multi-worker front (server/multiworker.py + server/ipc.py)
on the CPU: one owner process (WAL, stores, the inputs cache; the card on
a GPU host, `--device cpu` here) and N SO_REUSEPORT HTTP workers started
with `--device cpu` and CUDA_VISIBLE_DEVICES="" (tests/test_multiworker.py,
mirrored).

Concurrent ingest / query / compact through two workers, an issued key on
every worker, a worker SIGKILL with a supervised restart, the owner's
SIGKILL answered by 5xx, and every acked write present when the data dir
is reopened by a single-process backend (the port's and the reference's,
with the same answers). One test for each fault the reference's copy
carried: a backend ConnectionError left the request without an answer; a
blocking call held one lock over its whole round trip, so a compaction
blocked every other one; UCFP_HTTP=native reached the workers (EADDRINUSE);
the inputs cache was per worker, so ?input_id= could 404. The record
routes, which called two methods the worker proxied as coroutines, are
held too.
"""

import asyncio
import concurrent.futures
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from test_imagehash import synthetic_png
from ucfp_tpu_torch.server import multiworker as mw
from ucfp_tpu_torch.server.ipc import (
    OwnerServer,
    RemoteBackend,
    RemoteInputs,
    _AsyncChannel,
    _SyncChannel,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(port, method, path, data=None, token="t", timeout=60,
         ctype="application/json"):
    headers = {}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    if ctype and data is not None:
        headers["content-type"] = ctype
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                               headers=headers, method=method)
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return resp.status, resp.read()


class _Stack:
    def __init__(self, data_dir: str, workers: int = 2, **env):
        self.port = _free_port()
        self.data_dir = data_dir
        self.seen: set[int] = set()  # every worker pid seen
        env = dict(os.environ, UCFP_WARMUP="0", UCFP_LOG="warn", UCFP_DRAIN_SECS="5",
                   UCFP_SHARD="off", **env)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ucfp_tpu_torch.server",
             "--bind", f"127.0.0.1:{self.port}", "--token", "t",
             "--data-dir", data_dir, "--workers", str(workers), "--device", "cpu"],
            env=env, cwd=REPO)
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if _req(self.port, "GET", "/healthz", token=None, timeout=3)[0] == 200:
                    self.worker_pids()
                    return
            except (OSError, urllib.error.URLError):
                time.sleep(0.4)
        self.stop()
        pytest.fail("multi-worker stack never became healthy")

    def worker_pids(self) -> list[int]:
        out = subprocess.run(["ps", "--ppid", str(self.proc.pid), "-o", "pid="],
                             capture_output=True, text=True)
        pids = [int(x) for x in out.stdout.split()]
        self.seen.update(pids)
        return pids

    def _orphans(self) -> list[int]:
        """Workers seen earlier that still run this stack's worker
        command (an owner's SIGKILL leaves them to init)."""
        out = []
        for pid in self.seen:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read()
            except OSError:
                continue
            if b"--worker-of" in cmd and self.data_dir.encode() in cmd:
                out.append(pid)
        return out

    def stop(self, sig=signal.SIGTERM, wait=30):
        pids = self.worker_pids()
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(wait)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
        for pid in pids + self._orphans():  # orphans of an owner SIGKILL
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    st = _Stack(str(tmp_path_factory.mktemp("mw-data")), workers=2)
    yield st
    st.stop()


def _query(port, body):
    st, raw = _req(port, "POST", "/v1/query", json.dumps(body).encode())
    assert st == 200
    return json.loads(raw)


class TestMultiWorkerServing:
    def test_two_workers_running(self, stack):
        assert len(stack.worker_pids()) == 2

    def test_routes_roundtrip(self, stack):
        port = stack.port
        st, body = _req(port, "POST", "/v1/ingest/text/1/1",
                        b"the quick brown fox jumps over the lazy dog", ctype="text/plain")
        assert st == 201 and b"minhash" in body
        hits = _query(port, {"tenant_id": 1, "modality": "text", "k": 5,
                             "terms": ["quick", "fox"]})["hits"]
        assert any(h["record_id"] == 1 for h in hits)
        emb = [float(i % 7 - 3) / 3.0 for i in range(16)]
        st, _ = _req(port, "POST", "/v1/records", json.dumps(
            {"tenant_id": 1, "record_id": 5, "modality": "image",
             "algorithm": "embedding-image-local", "fingerprint": [0, 0],
             "embedding": emb}).encode())
        assert st in (200, 201)
        res = _query(port, {"tenant_id": 1, "modality": "image", "k": 3, "vector": emb})
        assert res["hits"][0]["record_id"] == 5

    def test_record_routes_through_a_worker(self, stack):
        """get_record / list_records are synchronous on the backend: the
        worker's proxy calls them so (the reference's proxied them as
        coroutines, and the record routes failed under --workers)."""
        port = stack.port
        _req(port, "POST", "/v1/ingest/text/3/7", b"a record to describe",
             ctype="text/plain")
        for _ in range(4):  # SO_REUSEPORT spreads these over both workers
            st, raw = _req(port, "GET", "/v1/records/3")
            assert st == 200 and json.loads(raw)["total"] == 1
            st, raw = _req(port, "GET", "/v1/records/3/7")
            assert st == 200 and json.loads(raw)["record_id"] == 7

    def test_image_fingerprints_equal_the_reference(self, stack):
        """The workers hash on the CPU; their integer hashes are the
        reference's bit for bit (the parity contract the card keeps)."""
        from ucfp_tpu.modality import image as jimod

        png = synthetic_png(64, 64)
        for algo in ("phash", "dhash", "ahash", "multi"):
            st, raw = _req(stack.port, "POST", f"/v1/ingest/image/4/1?algorithm={algo}",
                           png, ctype="image/png")
            assert st == 201
            want = (jimod.fingerprint_multi(png, 4, 1) if algo == "multi"
                    else jimod.fingerprint_single(png, algo, 4, 1))
            assert json.loads(raw)["fingerprint_hex"] == want.fingerprint.hex(), algo

    def test_concurrent_ingest_query_compact(self, stack):
        port = stack.port
        n_threads, per = 8, 10

        def client(t):
            oks = 0
            for i in range(per):
                rid = 1000 + t * 100 + i
                st, _ = _req(port, "POST", f"/v1/ingest/text/1/{rid}",
                             f"concurrent doc {t}-{i} mixed load".encode(),
                             ctype="text/plain")
                assert st == 201
                _query(port, {"tenant_id": 1, "modality": "text", "k": 3,
                              "terms": ["concurrent", "doc"]})
                oks += 1
                if t == 0 and i == per // 2:
                    st, raw = _req(port, "POST", "/v1/admin/compact", b"")
                    assert st == 200 and json.loads(raw)["compacted"] is True
            return oks

        with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
            assert sum(ex.map(client, range(n_threads))) == n_threads * per
        hits = {h["record_id"] for h in _query(port, {
            "tenant_id": 1, "modality": "text", "k": 200,
            "terms": ["concurrent", "doc", "mixed", "load"]})["hits"]}
        assert {1000 + t * 100 + i for t in range(n_threads) for i in range(per)} <= hits

    def test_issued_key_works_via_any_worker(self, stack):
        port = stack.port
        st, body = _req(port, "POST", "/v1/admin/keys", json.dumps({"tenant_id": 7}).encode())
        assert st in (200, 201), body
        key = json.loads(body)["token"]
        for i in range(6):
            st, _ = _req(port, "POST", f"/v1/ingest/text/7/{i}", b"issued key doc",
                         token=key, ctype="text/plain")
            assert st == 201

    def test_input_id_resolves_on_every_worker(self, stack):
        """The inputs cache lives in the owner: an input put through one
        worker is read through either (it was per worker, and a request
        that reached the other one answered 404)."""
        port = stack.port
        st, raw = _req(port, "POST", "/v1/inputs/0", b"an input shared by the workers",
                       ctype="text/plain")
        assert st == 201
        iid = json.loads(raw)["input_id"]
        for rid in range(8):  # eight connections: both workers serve some
            st, raw = _req(port, "POST", f"/v1/ingest/text/0/{500 + rid}?input_id={iid}",
                           b"", ctype="text/plain")
            assert st == 201, raw
        st, _ = _req(port, "DELETE", f"/v1/inputs/0/{iid}")
        assert st == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(port, "POST", f"/v1/ingest/text/0/600?input_id={iid}", b"",
                 ctype="text/plain")
        assert e.value.code == 404

    def test_worker_sigkill_service_continues_and_restarts(self, stack):
        port = stack.port
        pids = stack.worker_pids()
        assert len(pids) == 2
        os.kill(pids[0], signal.SIGKILL)
        ok = 0
        for i in range(8):
            try:
                st, _ = _req(port, "POST", f"/v1/ingest/text/1/{9000 + i}",
                             b"after worker crash", ctype="text/plain", timeout=30)
                ok += st == 201
            except (OSError, urllib.error.URLError):
                pass
        assert ok >= 6
        deadline = time.time() + 60
        # the dead worker is reaped (no longer a child) and replaced
        while time.time() < deadline and (pids[0] in stack.worker_pids()
                                          or len(stack.worker_pids()) != 2):
            time.sleep(0.3)
        assert len(stack.worker_pids()) == 2 and pids[0] not in stack.worker_pids()


def _reopen_answers(data_dir):
    """BM25 hits over the durable docs from a single-process port backend
    and the reference's, on the same data dir."""
    from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
    from ucfp_tpu_torch.index.embedded import EmbeddedBackend

    out = []
    for b in (EmbeddedBackend(data_dir, device="cpu"), JBackend(data_dir)):
        try:
            out.append([(h.record_id, h.score)
                        for h in asyncio.run(b.bm25(1, ["durable", "doc"], 100))])
        finally:
            b.close()
    return out


class TestDurabilityAcrossStack:
    def test_sigterm_then_reopen_preserves_acked_writes(self, tmp_path):
        stack = _Stack(str(tmp_path / "d"), workers=2)
        try:
            for i in range(10):
                st, _ = _req(stack.port, "POST", f"/v1/ingest/text/1/{i}",
                             f"durable doc {i}".encode(), ctype="text/plain")
                assert st == 201
            served = _query(stack.port, {"tenant_id": 1, "modality": "text", "k": 100,
                                         "terms": ["durable", "doc"]})["hits"]
        finally:
            stack.stop()
        assert stack.proc.returncode == 0
        port_hits, ref_hits = _reopen_answers(str(tmp_path / "d"))
        assert {r for r, _ in port_hits} >= set(range(10))
        assert port_hits == ref_hits == [(h["record_id"], h["score"]) for h in served]

    def test_owner_sigkill_workers_5xx_and_wal_replays(self, tmp_path):
        stack = _Stack(str(tmp_path / "d"), workers=2)
        try:
            for i in range(5):
                st, _ = _req(stack.port, "POST", f"/v1/ingest/text/1/{i}",
                             f"durable doc {i}".encode(), ctype="text/plain")
                assert st == 201
            stack.worker_pids()  # remembered: the SIGKILL orphans them
            os.kill(stack.proc.pid, signal.SIGKILL)
            stack.proc.wait(10)
            got_5xx = False
            for _ in range(4):
                try:
                    st, _ = _req(stack.port, "POST", "/v1/ingest/text/1/99",
                                 b"after owner death", ctype="text/plain", timeout=15)
                    assert st >= 500
                    got_5xx = True
                except urllib.error.HTTPError as e:
                    assert e.code >= 500
                    got_5xx = True
                except (OSError, urllib.error.URLError):
                    pass
            assert got_5xx
        finally:
            stack.stop(sig=signal.SIGKILL)
        port_hits, ref_hits = _reopen_answers(str(tmp_path / "d"))
        assert set(range(5)) <= {r for r, _ in port_hits} and port_hits == ref_hits


def test_native_http_setting_does_not_reach_workers(tmp_path):
    """UCFP_HTTP=native with --workers: each worker must serve the shared
    port with SO_REUSEPORT (the asyncio front); a native front in each
    failed with EADDRINUSE."""
    env = mw._worker_env(2)
    assert "UCFP_HTTP" not in env and env["CUDA_VISIBLE_DEVICES"] == ""
    stack = _Stack(str(tmp_path / "d"), workers=2, UCFP_HTTP="native")
    try:
        time.sleep(1.0)  # a worker that fails to bind exits within this
        assert len(stack.worker_pids()) == 2
        for i in range(6):
            st, _ = _req(stack.port, "POST", f"/v1/ingest/text/1/{i}", b"native env doc",
                         ctype="text/plain")
            assert st == 201
    finally:
        stack.stop()


@pytest.mark.parametrize("env,want", [
    ({}, {"CUDA_VISIBLE_DEVICES": "", "UCFP_WARMUP": "0"}),
    ({"UCFP_HTTP": "native", "CUDA_VISIBLE_DEVICES": "0"},
     {"CUDA_VISIBLE_DEVICES": "", "UCFP_WARMUP": "0"}),
    ({"UCFP_RATELIMIT_RPS": "100", "UCFP_RATELIMIT_BURST": "200"},
     {"UCFP_RATELIMIT_RPS": "50.0", "UCFP_RATELIMIT_BURST": "100.0"}),
])
def test_worker_env_and_command(monkeypatch, env, want):
    """Workers: the CPU only, stated explicitly (--device cpu and an empty
    CUDA_VISIBLE_DEVICES), never UCFP_HTTP, the rate split over N."""
    for k in ("UCFP_HTTP", "CUDA_VISIBLE_DEVICES", "UCFP_RATELIMIT_URL",
              "UCFP_RATELIMIT_RPS", "UCFP_RATELIMIT_BURST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = mw._worker_env(2)
    assert "UCFP_HTTP" not in got
    assert {k: got[k] for k in want} == want
    args = SimpleNamespace(token="t", keys_file=None, usage_log=None, data_dir="d")
    cmd = mw._worker_cmd("127.0.0.1:1", "d/owner.sock", args)
    assert cmd[1:3] == ["-m", "ucfp_tpu_torch.server"]
    assert cmd[cmd.index("--device") + 1] == "cpu"


class TestIpcChannel:
    def test_write_after_pump_death_raises_connection_error(self, tmp_path):
        class _Obj:
            async def flush(self):
                return "ok"

        async def run():
            sock = str(tmp_path / "o.sock")
            owner = OwnerServer(_Obj(), path=sock)
            await owner.start()
            chan = _AsyncChannel(sock)
            assert await chan.call("ix.flush") == "ok"

            async def noop():
                return None

            chan._ensure = noop
            chan._writer.transport.abort()
            await asyncio.sleep(0.1)
            try:
                await chan.call("ix.flush")
                ok = False
            except ConnectionError:
                ok = True
            await asyncio.wait_for(owner.close(), timeout=5)
            return ok

        assert asyncio.run(run())

    def test_pump_death_fails_pending_futures(self, tmp_path):
        class _Slow:
            async def flush(self):
                await asyncio.sleep(30)

        async def run():
            sock = str(tmp_path / "o.sock")
            owner = OwnerServer(_Slow(), path=sock)
            await owner.start()
            chan = _AsyncChannel(sock)
            t = asyncio.create_task(chan.call("ix.flush"))
            await asyncio.sleep(0.1)
            chan._writer.transport.abort()
            try:
                await asyncio.wait_for(t, timeout=5)
                ok = False
            except ConnectionError:
                ok = True
            except asyncio.TimeoutError:
                ok = False
            await asyncio.wait_for(owner.close(), timeout=5)
            return ok

        assert asyncio.run(run())

    @pytest.mark.parametrize("method", ["flush", "compact"])
    def test_backend_connection_error_is_answered(self, tmp_path, method):
        """A ConnectionError the backend itself raises (a webhook down)
        goes back to the worker as the call's error: the request gets its
        503 instead of waiting forever."""

        class _Down:
            async def flush(self):
                raise ConnectionError("usage webhook down")

            def compact(self):
                raise ConnectionError("usage webhook down")

        async def run():
            sock = str(tmp_path / "o.sock")
            owner = OwnerServer(_Down(), path=sock)
            await owner.start()
            try:
                if method == "flush":
                    chan = _AsyncChannel(sock)
                    with pytest.raises(ConnectionError, match="webhook down"):
                        await asyncio.wait_for(chan.call("ix.flush"), timeout=10)
                    chan.close()
                else:
                    sync = _SyncChannel(sock)
                    with pytest.raises(ConnectionError, match="webhook down"):
                        await asyncio.to_thread(sync.call, "ix.compact", timeout=10)
                    sync.close()
            finally:
                await asyncio.wait_for(owner.close(), timeout=5)

        asyncio.run(run())

    def test_blocking_calls_do_not_queue_behind_a_compaction(self, tmp_path):
        """Two blocking calls from one worker in flight at once: a slow
        compaction on one connection, a marker lookup on another, which
        answers while the compaction runs (one lock over the whole round
        trip made it wait for the compaction)."""
        started, release = threading.Event(), threading.Event()

        class _Index:
            def compact(self):
                started.set()
                assert release.wait(30)
                return "compacted"

            def knn_is_approximate(self, *a, **kw):
                return False

        loop = asyncio.new_event_loop()
        sock = str(tmp_path / "o.sock")
        owner = OwnerServer(_Index(), path=sock)
        loop.run_until_complete(owner.start())
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        backend = RemoteBackend(sock)
        try:
            with concurrent.futures.ThreadPoolExecutor(2) as ex:
                slow = ex.submit(backend.compact)
                assert started.wait(10)
                t0 = time.monotonic()
                assert backend.knn_is_approximate(0, 8, 10) is False
                assert time.monotonic() - t0 < 5 and not slow.done()
                release.set()
                assert slow.result(30) == "compacted"
        finally:
            release.set()
            backend.close()
            asyncio.run_coroutine_threadsafe(owner.close(), loop).result(10)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(10)
            loop.close()

    def test_remote_inputs_against_the_owner_cache(self, tmp_path):
        from ucfp_tpu_torch.server.inputs_cache import InputsCache

        loop = asyncio.new_event_loop()
        sock = str(tmp_path / "o.sock")
        cache = InputsCache()
        owner = OwnerServer(None, path=sock, inputs=cache)
        loop.run_until_complete(owner.start())
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        a, b = RemoteInputs(sock), RemoteInputs(sock)
        try:
            iid = a.put(3, b"payload", content_type="text/plain", sample_rate=None)
            got = b.get(3, iid)
            assert got.data == b"payload" and got.content_type == "text/plain"
            assert cache.get(3, iid).data == b"payload"
            assert b.delete(3, iid) is True and a.get(3, iid) is None
        finally:
            a.close()
            b.close()
            asyncio.run_coroutine_threadsafe(owner.close(), loop).result(10)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(10)
            loop.close()
