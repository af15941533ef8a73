"""The system under test: the port's app, with its production middleware,
served on loopback from the harness's process on an event loop thread of
its own (the pattern of chip_smoke.py's _ServerThread, with a full stop)."""

from __future__ import annotations

import asyncio
import http.client
import os
import secrets
import threading


class ServedApp:
    """state_from_env's composition over `backend`: a service bearer and
    the persistent keystore (the run issues one key and sends it), the
    in-memory token bucket at the configuration's rate and burst, and the
    usage log sink under `tmp`."""

    def __init__(self, backend, cfg: dict, tmp: str):
        from ucfp_tpu_torch.server.app import build_server, state_from_env

        st = cfg["settings"]
        self.state = state_from_env(
            data_dir=backend.data_dir, token=secrets.token_hex(16),
            usage_log=os.path.join(tmp, "usage.ndjson"),
            rate=float(st["rate_limit"]["rps"]), burst=float(st["rate_limit"]["burst"]),
            index=backend)
        key = self.state.keystore.issue(
            cfg["tenant_id"], rate_limit_per_min=st["key"]["rate_limit_per_min"],
            daily_quota=st["key"]["daily_quota"])
        self.token = key["token"]
        self.server = build_server(self.state)
        self.loop = asyncio.new_event_loop()
        self.ready = threading.Event()
        self.thread = threading.Thread(target=self._run, name="perfbench-server", daemon=True)
        self.thread.start()
        if not self.ready.wait(60):
            raise RuntimeError("the server did not start within 60 s")

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)

        async def start():
            self.srv = await self.server.serve("127.0.0.1", 0)
            self.port = self.srv.sockets[0].getsockname()[1]

        self.loop.run_until_complete(start())
        self.ready.set()
        self.loop.run_forever()

    def get(self, path: str) -> tuple[int, bytes]:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def post(self, path: str, body: bytes) -> tuple[int, bytes]:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            conn.request("POST", path, body=body,
                         headers={"authorization": f"Bearer {self.token}",
                                  "content-type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def stop(self) -> None:
        """The server's own shutdown: stop accepting, drain what is in
        flight, let the usage writes finish, join the worker threads, then
        stop the loop and join its thread."""

        async def shut():
            self.srv.close()
            await self.server.drain(30)
            me = asyncio.current_task()
            rest = [t for t in asyncio.all_tasks() if t is not me]
            if rest:
                _, pending = await asyncio.wait(rest, timeout=5)
                for t in pending:
                    t.cancel()
                await asyncio.gather(*pending, return_exceptions=True)
            await self.loop.shutdown_default_executor()

        asyncio.run_coroutine_threadsafe(shut(), self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        if self.thread.is_alive():
            raise RuntimeError("the server thread did not stop")
        self.loop.close()
