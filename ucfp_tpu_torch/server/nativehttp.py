"""Bridge between the native epoll HTTP front and the Python handlers
(port of ucfp_tpu/server/nativehttp.py).

native/httpfront.cpp (a copy of the reference's, built by
_build.build_host into _build/) owns sockets, parsing, keep-alive, and
writes; this bridge pulls parsed requests on a thread of its own,
schedules them onto the asyncio loop (where the handlers and the device
pipeline live: the pull thread makes no CUDA call), and pushes responses
back through the C ABI. Selected with UCFP_HTTP=native or
`python -m ucfp_tpu_torch.server --native-http`.
"""

from __future__ import annotations

import asyncio
import ctypes
import threading
from urllib.parse import parse_qs

from ..core import UcfpError
from ..native import UcfpHttpReq, load_httpfront
from .http import HttpServer, Request, _STATUS_TEXT


class NativeHttpBridge:
    def __init__(self, server: HttpServer, host: str, port: int):
        self.lib = load_httpfront()
        if self.lib is None:
            raise RuntimeError("native HTTP front unavailable: native/httpfront.cpp "
                               "did not build (no g++ toolchain?)")
        self.server = server
        self._h = self.lib.ucfp_http_start(
            host.encode(), port, server.body_limit
        )
        if not self._h:
            raise OSError(f"native HTTP front failed to bind {host}:{port}")
        self.port = self.lib.ucfp_http_port(self._h)
        self._stop = threading.Event()
        self._paused = False
        self._thread: threading.Thread | None = None
        # guards the native handle: _respond from late handler tasks must
        # not race ucfp_http_stop freeing the Server
        self._hlock = threading.Lock()

    def _to_request(self, raw: UcfpHttpReq) -> tuple[int, Request, bool]:
        headers: dict[str, str] = {}
        # split ONLY on \n (the C side's separator): str.splitlines also
        # breaks on latin-1 control chars (0x85 NEL etc.) that are legal
        # obs-text inside header values
        for line in (raw.headers or b"").decode("latin-1").split("\n"):
            k, _, v = line.partition("\t")
            if k:
                headers[k] = v
        target = (raw.path or b"/").decode("latin-1")
        path, _, qs = target.partition("?")
        query = {k: v[0] for k, v in parse_qs(qs, keep_blank_values=True).items()}
        body = ctypes.string_at(raw.body, raw.body_len) if raw.body_len else b""
        close_after = headers.get("connection", "").lower() == "close"
        # keep the RAW path: the router unquotes captured params itself,
        # and the asyncio front routes raw paths — decoding here would
        # double-decode and diverge between the two fronts
        req = Request(
            (raw.method or b"GET").decode("latin-1"),
            path,
            query,
            headers,
            body,
            remote_addr=(raw.peer or b"").decode("latin-1"),
        )
        return raw.id, req, close_after

    def _respond(self, req_id: int, resp, close_after: bool) -> None:
        extra = f"content-type: {resp.content_type}\r\n"
        for k, v in resp.headers.items():
            extra += f"{k}: {v}\r\n"
        with self._hlock:
            if self._h is None:
                return  # shut down while the handler was in flight
            self._respond_locked(req_id, resp, extra, close_after)

    def _respond_locked(self, req_id, resp, extra, close_after) -> None:
        self.lib.ucfp_http_respond(
            self._h,
            req_id,
            resp.status,
            _STATUS_TEXT.get(resp.status, "Unknown").encode(),
            extra.encode("latin-1"),
            resp.body,
            len(resp.body),
            1 if close_after else 0,
        )

    def _pull_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        raw = UcfpHttpReq()
        while not self._stop.is_set() and not self._paused:
            rc = self.lib.ucfp_http_next(self._h, 200, ctypes.byref(raw))
            if rc <= 0:
                if rc < 0:
                    break
                continue
            req_id, req, close_after = self._to_request(raw)
            self.lib.ucfp_http_free_req(ctypes.byref(raw))

            async def handle(req_id=req_id, req=req, close_after=close_after):
                try:
                    resp, _ = await self.server.handle_request(req)
                except UcfpError as e:  # pragma: no cover - handled inside
                    from .http import HttpError

                    resp = HttpError(e.http_status, e.code, e.message).to_response()
                self._respond(req_id, resp, close_after)

            asyncio.run_coroutine_threadsafe(handle(), loop)

    async def serve_forever(self) -> None:
        loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._pull_loop, args=(loop,), daemon=True
        )
        self._thread.start()
        try:
            while not self._stop.is_set():
                await asyncio.sleep(0.5)
        finally:
            self.stop()

    def pause(self) -> None:
        """Stop pulling new requests WITHOUT freeing the native server:
        in-flight handler coroutines can still _respond through it.
        Part of graceful drain (pause -> server.drain -> stop)."""
        self._paused = True
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def stop(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            if self._thread is not None:
                # the pull loop polls with a 200 ms timeout, so it exits
                # promptly; wait without a timeout rather than freeing the
                # native Server under a live ucfp_http_next call
                self._thread.join()
            with self._hlock:
                h, self._h = self._h, None
            if h:
                self.lib.ucfp_http_stop(h)
