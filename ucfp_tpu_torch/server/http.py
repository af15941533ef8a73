"""Minimal asyncio HTTP/1.1 server plumbing: parse, route, respond.

Stands in for the reference's axum stack (src/server/mod.rs:78-290 and
src/bin/ucfp.rs:264-273) with the same layer semantics, inner to outer:
handlers < body limit (16 MiB default, 413) < concurrency limit 512 <
timeout 10 s (408) < trace/metrics. Keep-alive supported; graceful
shutdown on cancel. No external HTTP framework — stdlib only, so the
host layer stays dependency-free (the C++ server port slots in behind
the same Router contract).

Copied from ucfp_tpu/server/http.py; only its imports and two comments
differ (they no longer quote the reference's measurements).
"""

from __future__ import annotations

import asyncio
import json
import re
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional
from urllib.parse import parse_qs, unquote

MAX_HEADER_BYTES = 32 * 1024
DEFAULT_BODY_LIMIT = 16 * 1024 * 1024
DEFAULT_TIMEOUT_SECS = 10.0
DEFAULT_CONCURRENCY = 512

_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    409: "Conflict", 413: "Payload Too Large", 415: "Unsupported Media Type",
    422: "Unprocessable Entity", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable",
}


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes
    params: dict[str, str] = field(default_factory=dict)
    extensions: dict = field(default_factory=dict)
    remote_addr: str = ""  # client IP (per-IP limits on public auth routes)

    def json(self):
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise HttpError(400, "bad_json", f"invalid JSON body: {e}")
        except UnicodeDecodeError as e:
            # json.loads(bytes) raises this (NOT a JSONDecodeError
            # subclass) for invalid UTF-8 — still a client error
            raise HttpError(400, "bad_json", f"body is not UTF-8: {e}")

    def qp_int(self, name: str, default: Optional[int] = None) -> Optional[int]:
        v = self.query.get(name)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            raise HttpError(400, "bad_query", f"query param {name} must be int")

    def qp_float(self, name: str, default: Optional[float] = None) -> Optional[float]:
        v = self.query.get(name)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            raise HttpError(400, "bad_query", f"query param {name} must be float")

    def qp_bool(self, name: str, default: bool = False) -> bool:
        v = self.query.get(name)
        if v is None:
            return default
        return v.lower() in ("1", "true", "yes", "on")


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)

    @classmethod
    def json(cls, obj, status: int = 200, headers: Optional[dict] = None) -> "Response":
        return cls(
            status=status,
            body=json.dumps(obj, separators=(",", ":")).encode(),
            headers=headers or {},
        )

    @classmethod
    def text(cls, s: str, status: int = 200, content_type: str = "text/plain") -> "Response":
        return cls(status=status, body=s.encode(), content_type=content_type)


class _BodyTooLarge(Exception):
    """Chunked body exceeded the body limit mid-stream."""


class HttpError(Exception):
    """Error envelope {error, message} (reference src/server/error.rs:22-41)."""

    def __init__(self, status: int, code: str, message: str,
                 headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.code = code
        self.message = message
        self.headers = headers or {}

    def to_response(self) -> Response:
        return Response.json(
            {"error": self.code, "message": self.message},
            status=self.status,
            headers=self.headers,
        )


Handler = Callable[[Request], Awaitable[Response]]


class Router:
    """Pattern routes like /v1/records/{tenant_id}/{record_id}."""

    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern, str, Handler, bool, bool]] = []

    def add(self, method: str, pattern: str, handler: Handler,
            protected: bool = True, streaming: bool = False) -> None:
        rx = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )
        self._routes.append((method, rx, pattern, handler, protected, streaming))

    def match(self, method: str, path: str):
        """-> (handler, params, pattern, protected, streaming) or 404/405."""
        path_seen = False
        for m, rx, pattern, handler, protected, streaming in self._routes:
            g = rx.match(path)
            if g:
                path_seen = True
                if m == method:
                    return (
                        handler,
                        {k: unquote(v) for k, v in g.groupdict().items()},
                        pattern, protected, streaming,
                    )
        if path_seen:
            raise HttpError(405, "method_not_allowed", f"{method} not allowed")
        raise HttpError(404, "not_found", f"no route for {path}")

    def is_streaming(self, method: str, path: str) -> bool:
        try:
            return self.match(method, path)[4]
        except HttpError:
            return False


class BodyStream:
    """Incremental request-body reader for streaming routes: yields the
    socket's bytes as they arrive (Content-Length budget or chunked
    framing) so a long-running ingest holds O(chunk) memory instead of
    buffering the whole body (reference multipart audio route,
    handlers.rs:963-1011)."""

    def __init__(self, reader: asyncio.StreamReader,
                 content_length: Optional[int] = None, chunked: bool = False):
        self._r = reader
        self._remaining = content_length or 0
        self._chunked = chunked
        self._chunk_left = 0
        self.consumed = 0  # body bytes handed out (usage metering)
        self.done = content_length == 0 and not chunked

    async def read(self, n: int = 65536) -> bytes:
        """Up to n body bytes; b'' at end. Raises ValueError on bad
        chunked framing (the connection is no longer trustworthy)."""
        if self.done:
            return b""
        if not self._chunked:
            take = min(n, self._remaining)
            data = await self._r.readexactly(take)
            self._remaining -= take
            self.consumed += take
            if self._remaining == 0:
                self.done = True
            return data
        if self._chunk_left == 0:
            line = await self._r.readline()
            if not line.endswith(b"\n"):
                raise ValueError("bad chunk header")
            size = int(line.strip().split(b";", 1)[0], 16)
            if size < 0:
                raise ValueError("bad chunk size")
            if size == 0:
                while True:  # trailer section
                    t = await self._r.readline()
                    if not t.endswith(b"\n"):
                        raise ValueError("bad trailer")
                    if t in (b"\r\n", b"\n"):
                        self.done = True
                        return b""
            self._chunk_left = size
        take = min(n, self._chunk_left)
        data = await self._r.readexactly(take)
        self._chunk_left -= take
        self.consumed += take
        if self._chunk_left == 0:
            if await self._r.readexactly(2) != b"\r\n":
                raise ValueError("bad chunk terminator")
        return data

    async def drain(self, cap: int = 64 * 1024 * 1024) -> bool:
        """Consume any unread remainder so keep-alive framing survives a
        handler that returned early. False = too much left, close."""
        spent = 0
        while not self.done:
            data = await self.read(65536)
            spent += len(data)
            if spent > cap:
                return False
            if not data and self.done:
                break
        return True


class _ZeroCopyProtocol(asyncio.streams.StreamReaderProtocol,
                        asyncio.BufferedProtocol):
    """StreamReaderProtocol with a direct-fill fast path for large
    fixed-length bodies.

    The default stream stack copies every body byte ~4 times on its way
    to the handler (transport recv -> bytes, feed_data append into the
    reader buffer, read() slice out, final join) plus a flow-control
    pause/resume dance per 256 KB slice — the dominant host cost at
    multi-MB batch bodies. Because this class also
    subclasses BufferedProtocol, the selector transport recv()s straight
    into whatever get_buffer() returns:

    * reader mode (headers, small bodies, chunked, streaming routes):
      get_buffer() hands out a scratch block and buffer_updated() feeds
      the StreamReader exactly like the default protocol — same copies,
      same flow control, byte-identical behavior.
    * fill mode (read_body_into): get_buffer() returns the remaining
      window of the caller's preallocated body buffer, so the kernel
      writes each byte to its final location — ZERO Python-level copies
      and no per-slice wakeups. Over-delivered bytes (a pipelined next
      request) stay in the kernel buffer: the fill window is capped at
      the body end, and the next get_buffer() is back in reader mode.
    """

    _SCRATCH = 1 << 18

    def __init__(self, reader: asyncio.StreamReader, client_connected_cb,
                 loop: asyncio.AbstractEventLoop):
        super().__init__(reader, client_connected_cb, loop=loop)
        # StreamReaderProtocol holds the reader weakly after
        # connection_made; keep it alive and reachable for the fill path
        self._zc_reader = reader
        self._scratch = memoryview(bytearray(self._SCRATCH))
        self._fill_buf: Optional[memoryview] = None
        self._fill_pos = 0
        self._fill_end = 0
        self._fill_waiter: Optional[asyncio.Future] = None

    # -- BufferedProtocol interface (replaces data_received) -----------
    def get_buffer(self, sizehint: int) -> memoryview:
        if self._fill_buf is not None:
            return self._fill_buf[self._fill_pos:self._fill_end]
        return self._scratch

    def buffer_updated(self, nbytes: int) -> None:
        if self._fill_buf is not None:
            self._fill_pos += nbytes
            if self._fill_pos >= self._fill_end:
                self._fill_buf = None
                w, self._fill_waiter = self._fill_waiter, None
                if w is not None and not w.done():
                    w.set_result(None)
            return
        # reader mode: same one copy the default transport path makes
        # (sock.recv allocating a bytes) before feed_data
        self.data_received(bytes(self._scratch[:nbytes]))

    def _fail_fill(self, exc: BaseException) -> None:
        if self._fill_waiter is None:
            return
        self._fill_buf = None
        w, self._fill_waiter = self._fill_waiter, None
        if not w.done():
            w.set_exception(exc)

    def eof_received(self):
        self._fail_fill(asyncio.IncompleteReadError(b"", self._fill_end))
        return super().eof_received()

    def connection_lost(self, exc) -> None:
        self._fail_fill(exc if exc is not None
                        else asyncio.IncompleteReadError(b"", self._fill_end))
        super().connection_lost(exc)

    async def read_body_into(self, buf: bytearray, clen: int) -> None:
        """Fill buf[:clen] with the next clen socket bytes. Raises
        asyncio.IncompleteReadError / ConnectionResetError like
        readexactly. Caller must close the connection if cancelled
        (partial bytes are dropped with the buffer)."""
        reader = self._zc_reader
        pos = 0
        # the header readuntil() may have over-read into the body: drain
        # the reader's already-buffered bytes first (private-attr probe;
        # readexactly returns instantly for buffered lengths)
        pending = getattr(reader, "_buffer", None)
        while pending is not None and len(pending) and pos < clen:
            take = min(len(pending), clen - pos)
            data = await reader.readexactly(take)
            buf[pos:pos + take] = data
            pos += take
        if pos >= clen:
            return
        self._fill_buf = memoryview(buf)
        self._fill_pos = pos
        self._fill_end = clen
        w = asyncio.get_running_loop().create_future()
        self._fill_waiter = w
        try:
            await w
        finally:
            self._fill_buf = None
            self._fill_waiter = None
            if w.done() and not w.cancelled():
                w.exception()  # retrieve (silences never-retrieved warning
                #                when the await itself was cancelled)


class Metrics:
    """Prometheus counters/histograms, matched-route path labels,
    /metrics self-scrape excluded (reference src/bin/ucfp.rs:75-101)."""

    BUCKETS = [0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]

    def __init__(self) -> None:
        self.requests: dict[tuple[str, str, int], int] = {}
        self.duration_sum: dict[tuple[str, str], float] = {}
        self.duration_count: dict[tuple[str, str], int] = {}
        self.duration_buckets: dict[tuple[str, str], list[int]] = {}

    # standard methods only: the method string comes off the wire, so an
    # unconstrained label would let a scanner grow the metrics maps
    # without bound and inject quotes into the exposition format
    KNOWN_METHODS = frozenset(
        ("GET", "HEAD", "POST", "PUT", "DELETE", "PATCH", "OPTIONS")
    )

    def observe(self, method: str, path_label: str, status: int, secs: float) -> None:
        if path_label == "/metrics":
            return
        if method not in self.KNOWN_METHODS:
            method = "OTHER"
        k3 = (method, path_label, status)
        self.requests[k3] = self.requests.get(k3, 0) + 1
        k2 = (method, path_label)
        self.duration_sum[k2] = self.duration_sum.get(k2, 0.0) + secs
        self.duration_count[k2] = self.duration_count.get(k2, 0) + 1
        b = self.duration_buckets.setdefault(k2, [0] * len(self.BUCKETS))
        for i, ub in enumerate(self.BUCKETS):
            if secs <= ub:
                b[i] += 1

    def render(self) -> str:
        out = [
            "# HELP ucfp_http_requests_total HTTP requests by route/status",
            "# TYPE ucfp_http_requests_total counter",
        ]
        for (m, p, s), n in sorted(self.requests.items()):
            out.append(
                f'ucfp_http_requests_total{{method="{m}",path="{p}",status="{s}"}} {n}'
            )
        out += [
            "# HELP ucfp_http_request_duration_seconds request latency",
            "# TYPE ucfp_http_request_duration_seconds histogram",
        ]
        for (m, p), cnt in sorted(self.duration_count.items()):
            buckets = self.duration_buckets[(m, p)]
            for i, ub in enumerate(self.BUCKETS):
                out.append(
                    f'ucfp_http_request_duration_seconds_bucket{{method="{m}",path="{p}",le="{ub}"}} {buckets[i]}'
                )
            out.append(
                f'ucfp_http_request_duration_seconds_bucket{{method="{m}",path="{p}",le="+Inf"}} {cnt}'
            )
            out.append(
                f'ucfp_http_request_duration_seconds_sum{{method="{m}",path="{p}"}} {self.duration_sum[(m, p)]}'
            )
            out.append(
                f'ucfp_http_request_duration_seconds_count{{method="{m}",path="{p}"}} {cnt}'
            )
        return "\n".join(out) + "\n"


class HttpServer:
    def __init__(
        self,
        router: Router,
        middleware: Optional[Callable] = None,
        body_limit: int = DEFAULT_BODY_LIMIT,
        timeout_secs: float = DEFAULT_TIMEOUT_SECS,
        concurrency: int = DEFAULT_CONCURRENCY,
    ):
        self.router = router
        self.middleware = middleware  # async (request, handler, protected) -> Response
        self.body_limit = body_limit
        self.timeout_secs = timeout_secs
        import os

        # streaming routes run as long as data keeps arriving; the
        # normal request timeout would kill a multi-minute audio stream
        self.stream_timeout_secs = float(
            os.environ.get("UCFP_STREAM_TIMEOUT_SECS", "3600")
        )
        # bound on reading one request's headers + buffered body: without
        # it a client trickling bytes (or just idling mid-body) pins a
        # connection, its task, and up to body_limit of buffer forever —
        # the handler timeout only starts AFTER the body is read. Doubles
        # as the keep-alive idle timeout between pipelined requests.
        self.read_timeout_secs = float(
            os.environ.get("UCFP_READ_TIMEOUT_SECS", "30")
        )
        self.metrics = Metrics()
        self._sem = asyncio.Semaphore(concurrency)
        self._server: Optional[asyncio.AbstractServer] = None
        # graceful drain (SIGTERM): when draining, responses close their
        # connections and drain() waits for in-flight requests
        self.draining = False
        self._inflight = 0
        self._idle: Optional[asyncio.Event] = None
        self._conns: set[asyncio.StreamWriter] = set()

    def _begin_request(self) -> None:
        self._inflight += 1
        if self._idle is None:
            self._idle = asyncio.Event()
        self._idle.clear()

    def _end_request(self) -> None:
        self._inflight -= 1
        if self._inflight == 0 and self._idle is not None:
            self._idle.set()

    async def drain(self, timeout: float = 10.0) -> bool:
        """Stop keep-alive reuse, wait for in-flight requests (both the
        asyncio front and the native bridge route through
        handle_request), then close lingering idle connections. Returns
        True when everything finished inside the deadline (the docker
        stop contract: no mid-request 500s, reference bin/ucfp.rs:279-284
        graceful shutdown)."""
        self.draining = True
        ok = True
        if self._inflight > 0:
            if self._idle is None:
                self._idle = asyncio.Event()
            try:
                await asyncio.wait_for(self._idle.wait(), timeout)
            except asyncio.TimeoutError:
                ok = False
        for w in list(self._conns):
            try:
                w.close()
            except Exception:
                pass
        return ok

    async def handle_request(self, req: Request) -> tuple[Response, str]:
        """Route + middleware + metrics. Returns (response, path_label)."""
        start = time.monotonic()
        # unmatched requests share one label — recording raw paths would
        # let a pre-auth scanner grow the metrics maps without bound
        path_label = "<unmatched>"
        self._begin_request()  # drain() waits on this (both HTTP fronts)
        try:
            handler, params, pattern, protected, streaming = self.router.match(
                req.method, req.path
            )
            path_label = pattern
            req.params = params
            timeout = self.stream_timeout_secs if (
                streaming and "body_stream" in req.extensions
            ) else self.timeout_secs
            async with self._sem:
                if self.middleware is not None:
                    resp = await asyncio.wait_for(
                        self.middleware(req, handler, protected),
                        timeout=timeout,
                    )
                else:
                    resp = await asyncio.wait_for(
                        handler(req), timeout=timeout
                    )
        except HttpError as e:
            resp = e.to_response()
        except asyncio.TimeoutError:
            resp = HttpError(408, "timeout", "request timed out").to_response()
        except Exception as e:
            # domain errors carry their own HTTP mapping (core/errors.py)
            status = getattr(e, "http_status", None)
            code = getattr(e, "code", None)
            if isinstance(status, int) and isinstance(code, str):
                resp = HttpError(status, code, str(e)).to_response()
            else:  # pragma: no cover - last-resort envelope
                resp = HttpError(
                    500, "internal", f"{type(e).__name__}: {e}"
                ).to_response()
        except BaseException:  # cancellation during shutdown
            self._end_request()
            raise
        self._end_request()
        elapsed = time.monotonic() - start
        self.metrics.observe(req.method, path_label, resp.status, elapsed)
        if path_label != "/metrics":
            from .logging import logger

            logger().info(
                "request",
                method=req.method,
                path=path_label,
                status=resp.status,
                elapsed_ms=round(elapsed * 1000.0, 3),
                bytes_in=len(req.body),
                bytes_out=len(resp.body),
            )
        return resp, path_label

    # bounded-slice body reads above this size: readexactly(12 MB) grows
    # the StreamReader's internal bytearray by ~256 KB recv chunks, and
    # bytearray growth re-copies the accumulated prefix (quadratic in
    # the body size). Slice reads keep the reader's buffer O(slice) and
    # join once.
    _BODY_SLICE = 1 << 18

    async def _read_body_exact(self, reader: asyncio.StreamReader,
                               clen: int, proto=None) -> bytes:
        """readexactly(clen) without the large-buffer growth churn.
        Same failure contract: asyncio.IncompleteReadError on EOF."""
        if clen <= self._BODY_SLICE:
            return await reader.readexactly(clen)
        if isinstance(proto, _ZeroCopyProtocol):
            # kernel writes each byte to its final location; the one
            # bytes() at the end is the only Python-level copy
            buf = bytearray(clen)
            await proto.read_body_into(buf, clen)
            return bytes(buf)
        # transports without the buffered protocol (tests, exotic
        # setups): bounded-slice reads keep the reader buffer O(slice)
        chunks: list[bytes] = []
        remaining = clen
        while remaining:
            c = await reader.read(min(self._BODY_SLICE, remaining))
            if not c:
                raise asyncio.IncompleteReadError(b"".join(chunks), clen)
            chunks.append(c)
            remaining -= len(c)
        return b"".join(chunks)

    async def _read_chunked(self, reader: asyncio.StreamReader) -> Optional[bytes]:
        """Buffered chunked-body read for non-streaming routes: the SAME
        decoder as streaming routes (BodyStream), plus the body limit.
        Returns None on malformed framing (caller responds 400)."""
        stream = BodyStream(reader, chunked=True)
        parts: list[bytes] = []
        total = 0
        try:
            while not stream.done:
                data = await stream.read(65536)
                total += len(data)
                if total > self.body_limit:
                    raise _BodyTooLarge()
                if data:
                    parts.append(data)
        except ValueError:
            return None
        return b"".join(parts)

    async def _client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) and peer else ""
        try:
            proto = writer.transport.get_protocol()
        except Exception:  # pragma: no cover - mock transports in tests
            proto = None
        self._conns.add(writer)
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"), self.read_timeout_secs
                    )
                except asyncio.TimeoutError:
                    return  # idle keep-alive or header-trickling client
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                except asyncio.LimitOverrunError:
                    writer.write(_raw_response(431, b'{"error":"headers_too_large"}'))
                    await writer.drain()
                    return
                lines = head.decode("latin-1").split("\r\n")
                try:
                    method, target, _version = lines[0].split(" ", 2)
                except ValueError:
                    writer.write(_raw_response(400, b'{"error":"bad_request_line"}'))
                    await writer.drain()
                    return
                headers: dict[str, str] = {}
                for ln in lines[1:]:
                    if ":" in ln:
                        k, v = ln.split(":", 1)
                        headers[k.strip().lower()] = v.strip()
                path_probe = target.partition("?")[0]
                # Transfer-Encoding wins over Content-Length (RFC 7230
                # §3.3.3) — ignoring it would let a chunked body be parsed
                # as the next pipelined request (request smuggling)
                te = headers.get("transfer-encoding", "").lower()
                if te not in ("", "chunked"):
                    writer.write(_raw_response(
                        501, b'{"error":"unsupported_transfer_encoding"}'
                    ))
                    await writer.drain()
                    return
                if self.router.is_streaming(method, path_probe):
                    # streaming route: hand the socket to the handler via
                    # BodyStream — O(chunk) memory for unbounded bodies,
                    # no body_limit (length is the point; auth still
                    # gates it in the middleware)
                    if te == "chunked":
                        stream = BodyStream(reader, chunked=True)
                    else:
                        clen = _parse_content_length(headers)
                        if clen is None:
                            writer.write(_raw_response(
                                400, b'{"error":"bad_content_length"}'
                            ))
                            await writer.drain()
                            return
                        stream = BodyStream(reader, content_length=clen)
                    path, _, qs = target.partition("?")
                    query = {k: v[0] for k, v in
                             parse_qs(qs, keep_blank_values=True).items()}
                    req = Request(method, path, query, headers, b"",
                                  remote_addr=remote)
                    req.extensions["body_stream"] = stream
                    try:
                        resp, _ = await self.handle_request(req)
                        # drain under the read timeout: an early response
                        # (401/400 before the handler consumed the body)
                        # otherwise leaves an unbounded readexactly on a
                        # client-controlled stream — N stalled bodies
                        # would pin N sockets + tasks forever (every
                        # other read path is already wait_for-wrapped)
                        framing_ok = await asyncio.wait_for(
                            stream.drain(), self.read_timeout_secs
                        )
                    except asyncio.TimeoutError:
                        writer.write(_raw_response(
                            408, b'{"error":"timeout"}'
                        ))
                        await writer.drain()
                        return
                    except (ValueError, asyncio.IncompleteReadError,
                            ConnectionResetError):
                        writer.write(_raw_response(
                            400, b'{"error":"bad_stream_body"}'
                        ))
                        await writer.drain()
                        return
                    keep = framing_ok and not self.draining and (
                        headers.get("connection", "keep-alive").lower() != "close"
                    )
                    writer.write(_serialize(resp, keep))
                    await writer.drain()
                    if not keep:
                        return
                    continue
                if te:
                    # te == "chunked" here — other values were rejected
                    # with 501 before the streaming branch
                    try:
                        body = await asyncio.wait_for(
                            self._read_chunked(reader), self.read_timeout_secs
                        )
                    except _BodyTooLarge:
                        writer.write(_raw_response(413, b'{"error":"payload_too_large"}'))
                        await writer.drain()
                        return
                    except asyncio.TimeoutError:
                        writer.write(_raw_response(408, b'{"error":"timeout"}'))
                        await writer.drain()
                        return
                    except (asyncio.IncompleteReadError, ConnectionResetError):
                        return
                    if body is None:
                        # _read_chunked reports bad framing (including
                        # readline limit overruns) as None
                        writer.write(_raw_response(400, b'{"error":"bad_chunked_body"}'))
                        await writer.drain()
                        return
                else:
                    clen = _parse_content_length(headers)
                    if clen is None:
                        writer.write(_raw_response(400, b'{"error":"bad_content_length"}'))
                        await writer.drain()
                        return
                    if clen > self.body_limit:
                        writer.write(
                            _raw_response(413, b'{"error":"payload_too_large"}')
                        )
                        await writer.drain()
                        return
                    try:
                        body = (
                            await asyncio.wait_for(
                                self._read_body_exact(reader, clen, proto),
                                self.read_timeout_secs,
                            )
                            if clen else b""
                        )
                    except asyncio.TimeoutError:
                        # body-trickling client: drop the buffer, answer
                        # 408, close (the stream is mid-body, unusable)
                        writer.write(_raw_response(408, b'{"error":"timeout"}'))
                        await writer.drain()
                        return
                    except (asyncio.IncompleteReadError, ConnectionResetError):
                        return
                path, _, qs = target.partition("?")
                query = {k: v[0] for k, v in parse_qs(qs, keep_blank_values=True).items()}
                req = Request(method, path, query, headers, body,
                              remote_addr=remote)
                resp, _ = await self.handle_request(req)
                keep = not self.draining and (
                    headers.get("connection", "keep-alive").lower() != "close"
                )
                writer.write(_serialize(resp, keep))
                await writer.drain()
                if not keep:
                    return
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def serve(self, host: str, port: int,
                    reuse_port: bool = False):
        # start_server() with a custom protocol factory: the zero-copy
        # protocol needs to be the transport's protocol object (the
        # selector transport picks recv_into over recv by isinstance
        # check on BufferedProtocol at connection time).
        # reuse_port=True is the multi-worker front: every worker binds
        # the same port with SO_REUSEPORT and the kernel load-balances
        # accepted connections across them (server/ipc.py).
        loop = asyncio.get_running_loop()

        def factory() -> _ZeroCopyProtocol:
            reader = asyncio.StreamReader(limit=MAX_HEADER_BYTES, loop=loop)
            return _ZeroCopyProtocol(reader, self._client, loop)

        self._server = await loop.create_server(
            factory, host, port, reuse_port=reuse_port or None
        )
        return self._server


def _serialize(resp: Response, keep_alive: bool) -> bytes:
    status_text = _STATUS_TEXT.get(resp.status, "Unknown")
    head = [
        f"HTTP/1.1 {resp.status} {status_text}",
        f"content-type: {resp.content_type}",
        f"content-length: {len(resp.body)}",
        f"connection: {'keep-alive' if keep_alive else 'close'}",
    ]
    for k, v in resp.headers.items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + resp.body


def _parse_content_length(headers) -> "int | None":
    """Content-Length -> non-negative int, None on malformed values.
    ONE parser for the streaming and buffered branches so hardening
    (e.g. rejecting comma-joined duplicates) can't silently diverge."""
    try:
        clen = int(headers.get("content-length", "0") or "0")
    except ValueError:
        return None
    return clen if clen >= 0 else None


def _raw_response(status: int, body: bytes) -> bytes:
    return _serialize(Response(status=status, body=body), keep_alive=False)
