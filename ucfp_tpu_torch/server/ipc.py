"""Single-writer multi-worker IPC: the ownership protocol (port of
ucfp_tpu/server/ipc.py).

The multi-worker front (``--workers N``) splits the server into

  * ONE OWNER process — the only process that opens the data
    directory and the only one that holds the CUDA card. It holds the
    EmbeddedBackend (group-commit WAL, host tables, BM25, device ANN
    caches on the card), the PersistentKeyStore, the AccountStore and
    the inputs cache, and serves them over a Unix-domain socket next to
    the data dir. The owner is the single WAL writer and the single
    device owner: a single-writer discipline made explicit as a process
    boundary instead of an in-process lock.

  * N WORKER processes — full HTTP fronts accepting on one shared
    port via SO_REUSEPORT (the kernel load-balances connections). A
    worker does everything per-request-CPU-bound locally: parse, auth,
    decode, host resize/quantization, text fingerprints (native C++),
    and image/audio hashing on the CPU (started with --device cpu and
    CUDA_VISIBLE_DEVICES="": the integer hashes are bit-equal to the
    card's, the float64-product parity contract, tests/goldens/) — then
    forwards index reads/writes to the owner through this module.
    Workers never touch the WAL, the data dir, or the card.

Whatever crosses the socket is plain Python or numpy (hits, rows,
records, key contexts): results computed on the card are copied to the
host inside the owner's backend before they are returned.

Wire protocol (trusted, same-UID, private socket — the socket lives in
the data dir, which deployment docs require be mode 0700):

    frame    := u32_be length || payload
    request  := pickle((req_id, "ns.method", args, kwargs))
    response := pickle((req_id, ok_bool, result_or_exception))

Namespaces: ``ix`` (EmbeddedBackend), ``ks`` (PersistentKeyStore),
``ac`` (AccountStore), ``in`` (InputsCache: an input put through one
worker is read through any other). Method names are ALLOWLISTED per
namespace —
the dispatcher refuses anything else, so a compromised worker cannot
walk attributes. Requests multiplex: each one runs as its own task in
the owner's loop (the backend's internal locks provide the same
serialization in-process callers get), so a slow compact cannot
head-of-line-block a query from another worker. A worker's blocking
calls each take a connection of their own from a small pool, so a
compaction running on one does not hold up the next synchronous call.

Worker-side failure semantics: a dead owner surfaces as
ConnectionError -> the HTTP layer's 503 envelope (the store IS down —
there is nothing else to say). A dead worker costs nothing: the kernel
stops routing new connections to its socket and the supervisor
restarts it; the owner just sees a closed connection and drops any
in-flight responses for it.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import socket
import struct
import threading

_LEN = struct.Struct(">I")
_MAX_FRAME = 256 * 1024 * 1024  # 16 MiB bodies -> far smaller frames

# -- allowlists --------------------------------------------------------------

IX_ASYNC = frozenset({
    "upsert", "upsert_fingerprint_batch", "upsert_embedding_batch",
    "delete", "knn", "knn_batch", "knn_fingerprint",
    "knn_fingerprint_batch", "knn_audio", "knn_haitsma", "knn_lsh",
    "knn_multihash", "bm25", "bm25_explain", "flush",
    "get_record_metadata",
})
# get_record and list_records are synchronous on the backend, and the
# record routes and the reranker call them so
IX_SYNC = frozenset({
    "bm25_idf_map", "knn_is_approximate", "fingerprint_is_approximate",
    "_wal_size", "compact", "get_record", "list_records",
})
KS_ASYNC = frozenset({"lookup"})
KS_SYNC = frozenset({"issue", "revoke", "list_keys"})
AC_SYNC = frozenset({"signup", "login", "resolve", "logout"})
IN_SYNC = frozenset({"put", "get", "delete"})

_ALLOWED = {
    "ix": IX_ASYNC | IX_SYNC,
    "ks": KS_ASYNC | KS_SYNC,
    "ac": AC_SYNC,
    "in": IN_SYNC,
}


async def _read_frame(reader: asyncio.StreamReader):
    head = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(head)
    if n > _MAX_FRAME:
        raise ConnectionError(f"ipc frame too large: {n}")
    return pickle.loads(await reader.readexactly(n))


def _frame(obj) -> bytes:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(payload)) + payload


# ---------------------------------------------------------------------------
# Owner side
# ---------------------------------------------------------------------------


class OwnerServer:
    """Serves the three owned objects to workers over a unix socket."""

    def __init__(self, index, keystore=None, accounts=None,
                 path: str = "owner.sock", inputs=None):
        self.path = path
        self._objs = {"ix": index, "ks": keystore, "ac": accounts, "in": inputs}
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._server = await asyncio.start_unix_server(
            self._client, path=self.path
        )
        os.chmod(self.path, 0o600)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        wlock = asyncio.Lock()
        tasks: set[asyncio.Task] = set()

        async def respond(req_id, ok, payload):
            try:
                body = _frame((req_id, ok, payload))
            except Exception as e:  # unpicklable result/exception
                body = _frame((req_id, False,
                               RuntimeError(f"unpicklable: {e!r}")))
            try:
                async with wlock:
                    writer.write(body)
                    await writer.drain()
            except (ConnectionError, OSError):
                pass  # the worker went away: nobody is waiting

        async def handle(req_id, name, args, kwargs):
            try:
                ns, _, meth = name.partition(".")
                if meth not in _ALLOWED.get(ns, ()):  # attr-walk guard
                    raise AttributeError(f"ipc method not allowed: {name}")
                obj = self._objs[ns]
                if obj is None:
                    raise RuntimeError(f"owner has no {ns!r} object")
                fn = getattr(obj, meth)
                if asyncio.iscoroutinefunction(fn):
                    res = await fn(*args, **kwargs)
                else:
                    # sync store ops (compact can block for seconds):
                    # off-loop so they never stall other workers' calls
                    res = await asyncio.to_thread(fn, *args, **kwargs)
                await respond(req_id, True, res)
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                # every failure of the call answers, a ConnectionError the
                # backend raised too (a webhook that is down): the worker
                # maps it to its 503 instead of waiting forever
                await respond(req_id, False, e)

        try:
            while True:
                req_id, name, args, kwargs = await _read_frame(reader)
                t = asyncio.create_task(handle(req_id, name, args, kwargs))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionError, EOFError):
            pass
        finally:
            for t in tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


class _AsyncChannel:
    """One multiplexed async connection to the owner (lazy connect)."""

    def __init__(self, path: str):
        self.path = path
        self._reader = None
        self._writer = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._connect_lock = asyncio.Lock()
        self._wlock = asyncio.Lock()
        self._pump_task: asyncio.Task | None = None  # strong ref: the
        # loop holds tasks only weakly, an unreferenced pump can be GC'd

    async def _ensure(self) -> None:
        if self._writer is not None:
            return
        async with self._connect_lock:
            if self._writer is not None:
                return
            reader, writer = await asyncio.open_unix_connection(self.path)
            self._reader, self._writer = reader, writer
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())

    async def _pump(self) -> None:
        try:
            while True:
                req_id, ok, payload = await _read_frame(self._reader)
                fut = self._pending.pop(req_id, None)
                if fut is not None and not fut.done():
                    if ok:
                        fut.set_result(payload)
                    else:
                        fut.set_exception(payload)
        except (asyncio.IncompleteReadError, ConnectionError, EOFError,
                asyncio.CancelledError):
            pass
        finally:
            self._writer = None
            err = ConnectionError("owner connection lost")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()

    async def call(self, name: str, *args, **kwargs):
        await self._ensure()
        self._next_id += 1
        req_id = self._next_id
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        async with self._wlock:
            w = self._writer
            if w is None:  # pump died between _ensure and here
                self._pending.pop(req_id, None)
                raise ConnectionError("owner connection lost")
            w.write(_frame((req_id, name, args, kwargs)))
            await w.drain()
        return await fut

    def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None


class _SyncChannel:
    """Blocking connections for the synchronous call sites
    (is_approximate markers, idf maps, records, the inputs cache, admin
    compact). Each call takes a connection of its own from an idle pool
    (a new one when none is idle) and returns it afterwards, so calls
    from several threads run side by side: a compaction in flight on one
    connection does not hold up a marker lookup on the next. The lock
    guards only the pool and the request ids."""

    MAX_IDLE = 8

    def __init__(self, path: str):
        self.path = path
        self._idle: list[socket.socket] = []
        self._lock = threading.Lock()
        self._next_id = 0

    def _checkout(self) -> tuple[socket.socket, int]:
        with self._lock:
            self._next_id += 1
            req_id = self._next_id
            s = self._idle.pop() if self._idle else None
        if s is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(self.path)
            except OSError:
                s.close()
                raise
        return s, req_id

    def _checkin(self, s: socket.socket) -> None:
        with self._lock:
            if len(self._idle) < self.MAX_IDLE:
                self._idle.append(s)
                return
        s.close()

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(min(1 << 20, n - len(buf)))
            if not chunk:
                raise ConnectionError("owner closed")
            buf += chunk
        return bytes(buf)

    def call(self, name: str, *args, timeout: float = 300.0, **kwargs):
        s, req_id = self._checkout()
        try:
            s.settimeout(timeout)
            s.sendall(_frame((req_id, name, args, kwargs)))
            (n,) = _LEN.unpack(self._recv_exact(s, _LEN.size))
            if n > _MAX_FRAME:
                raise ConnectionError(f"ipc frame too large: {n}")
            rid, ok, payload = pickle.loads(self._recv_exact(s, n))
            if rid != req_id:
                raise ConnectionError("ipc response out of order")
        except (OSError, ConnectionError):
            s.close()
            raise
        self._checkin(s)
        if ok:
            return payload
        raise payload

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for s in idle:
            try:
                s.close()
            except Exception:
                pass


def _make_async(name: str):
    async def call(self, *args, **kwargs):
        return await self._chan.call(name, *args, **kwargs)

    call.__name__ = name.split(".")[-1]
    return call


def _make_sync(name: str, timeout: float = 300.0):
    def call(self, *args, **kwargs):
        return self._sync.call(name, *args, timeout=timeout, **kwargs)

    call.__name__ = name.split(".")[-1]
    return call


class RemoteBackend:
    """Worker-side IndexBackend proxy: every index read/write crosses
    to the owner; everything else about the backend's contract (error
    types, Hit/Record shapes, filter validation server-side) rides the
    pickle unchanged. close() closes only this worker's connections —
    the owner owns the store's lifecycle."""

    def __init__(self, path: str, device="cpu"):
        import torch

        self._chan = _AsyncChannel(path)
        self._sync = _SyncChannel(path)
        # where this worker computes fingerprints (the handlers read
        # index.device): the CPU, the owner holds the card
        self.device = torch.device(device)
        # advisory attributes the /v1/info route reads via getattr:
        # workers inherit the owner's env, so these mirror the owner's
        # EmbeddedBackend configuration without an IPC round trip
        self.knn_quant = (os.environ.get("UCFP_KNN_QUANT", "none")
                          or "none").lower()
        self._qbatch_ms = float(
            os.environ.get("UCFP_QUERY_BATCH_MS", "0") or 0)

    def close(self) -> None:
        self._chan.close()
        self._sync.close()


for _n in IX_ASYNC:
    setattr(RemoteBackend, _n, _make_async(f"ix.{_n}"))
for _n in IX_SYNC:
    setattr(RemoteBackend, _n, _make_sync(f"ix.{_n}"))


class RemoteKeyStore:
    """Worker-side PersistentKeyStore proxy. lookup() carries a small
    positive TTL cache so issued-key traffic does not pay a unix RTT
    per request; revocation therefore propagates to other workers
    within UCFP_IPC_AUTH_TTL_S (default 2 s) — documented in
    the docs. The static service bearer never reaches here
    (CompositeKeyLookup checks it first, in-process)."""

    def __init__(self, path: str):
        self._chan = _AsyncChannel(path)
        self._sync = _SyncChannel(path)
        self._ttl = float(os.environ.get("UCFP_IPC_AUTH_TTL_S", "2.0"))
        self._cache: dict[str, tuple[float, object]] = {}

    async def lookup(self, token: str):
        import time

        now = time.monotonic()
        hit = self._cache.get(token)
        if hit is not None and hit[0] > now:
            return hit[1]
        ctx = await self._chan.call("ks.lookup", token)
        if ctx is not None:
            if len(self._cache) > 4096:  # bound the cache
                self._cache.clear()
            self._cache[token] = (now + self._ttl, ctx)
        return ctx

    def known_tenant_ids(self) -> tuple[int, ...]:
        return ()  # only used owner-side (signup tenant reservation)

    def close(self) -> None:
        self._chan.close()
        self._sync.close()


for _n in KS_SYNC:
    setattr(RemoteKeyStore, _n, _make_sync(f"ks.{_n}"))


class RemoteAccounts:
    """Worker-side AccountStore proxy (dashboard signup/login/session
    resolve). All sync + low-rate; resolve rides one unix RTT."""

    def __init__(self, path: str):
        self._sync = _SyncChannel(path)

    def close(self) -> None:
        self._sync.close()


for _n in AC_SYNC:
    setattr(RemoteAccounts, _n, _make_sync(f"ac.{_n}"))


class RemoteInputs:
    """Worker-side InputsCache proxy: the cache lives in the owner, so an
    input put through one worker is read (?input_id=) through any other."""

    def __init__(self, path: str):
        self._sync = _SyncChannel(path)

    def close(self) -> None:
        self._sync.close()


for _n in IN_SYNC:
    setattr(RemoteInputs, _n, _make_sync(f"in.{_n}"))
