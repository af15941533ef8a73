"""The load generator: a process of its own, one thread, asyncio.

    python3 -m perfbench.loadgen   (driven by perfbench.run over stdin/stdout)

Line 1 on stdin names the kind, the query items file, the configuration
and the mix; the generator builds every request body before it answers
"ready". Line 2 gives the port, the bearer and the load's times on the
system-wide monotonic clock (CLOCK_MONOTONIC, shared with the harness):
t_begin (warm-up traffic starts), t0 (the window opens) and t_end. An
open loop sends each request when it is due, on an idle keep-alive
connection or a new one; a closed loop runs `clients` connections that
each send their next request when the last answer is in. The result, a
pickle of every request's item, due, sent and done times, status and
answer, goes to stdout once every request due in the window is answered
or grace_s has passed after t_end."""

from __future__ import annotations

import asyncio
import importlib
import json
import pickle
import sys
import time

import numpy as np

from perfbench import schedule

now = time.monotonic
MAX_IDLE_S = 5.0


class _Conn:
    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer
        self.idle_since = now()

    async def call(self, payload: bytes) -> tuple[int, bytes]:
        self.writer.write(payload)
        head = await self.reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        n = 0
        for line in lines[1:]:
            key, _, val = line.partition(":")
            if key.strip().lower() == "content-length":
                n = int(val.strip())
        body = await self.reader.readexactly(n) if n else b""
        return status, body


class Load:
    def __init__(self, port: int, token: str, bodies: list[bytes]):
        self.port = port
        head = ("POST /v1/query HTTP/1.1\r\nhost: 127.0.0.1\r\n"
                f"authorization: Bearer {token}\r\ncontent-type: application/json\r\n")
        self.payloads = [(head + f"content-length: {len(b)}\r\n\r\n").encode() + b
                         for b in bodies]
        # item, due, sent, done, status, answer per request, in send order
        self.rows: list[list] = []
        self.idle: list[_Conn] = []

    async def connect(self) -> _Conn:
        r, w = await asyncio.open_connection("127.0.0.1", self.port)
        return _Conn(r, w)

    def take_idle(self) -> _Conn | None:
        """The most recently used idle connection; one idle for MAX_IDLE_S
        or more is closed instead (the server ends keep-alive connections
        idle for UCFP_READ_TIMEOUT_SECS, 30 s by default)."""
        while self.idle:
            conn = self.idle.pop()
            if now() - conn.idle_since < MAX_IDLE_S:
                return conn
            conn.writer.close()
        return None

    async def one(self, conn: _Conn | None, item: int, due: float) -> _Conn | None:
        row = [item % len(self.payloads), due, 0.0, 0.0, -1, b""]
        self.rows.append(row)
        try:
            if conn is None:
                conn = self.take_idle() or await self.connect()
            row[2] = now()
            row[4], row[5] = await conn.call(self.payloads[row[0]])
        except (OSError, asyncio.IncompleteReadError, ValueError, IndexError) as e:
            row[5] = repr(e).encode()
            conn = None  # a broken connection is dropped, not reused
        row[3] = now()
        return conn

    async def open_loop(self, due_abs: np.ndarray, pool: int):
        self.idle = [await self.connect() for _ in range(pool)]
        tasks = []

        async def send(i: int, due: float):
            conn = await self.one(None, i, due)
            if conn is not None:
                conn.idle_since = now()
                self.idle.append(conn)

        for i, due in enumerate(due_abs):
            delay = due - now()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(asyncio.create_task(send(i, float(due))))
        return tasks

    async def closed_loop(self, clients: int, t_begin: float, t_end: float):
        counter = iter(range(1 << 62))
        conns = [await self.connect() for _ in range(clients)]
        delay = t_begin - now()
        if delay > 0:
            await asyncio.sleep(delay)

        async def client(conn):
            while conn is not None and now() < t_end:
                conn = await self.one(conn, next(counter), float("nan"))

        return [asyncio.create_task(client(c)) for c in conns]


async def _drive(setup: dict, go: dict, bodies: list[bytes]) -> dict:
    load = Load(go["port"], go["token"], bodies)
    traffic = setup["traffic"]
    deadline = go["t_end"] + go["grace_s"]
    if traffic["loop"] == "open":
        plan = schedule.open_loop(traffic["rate_per_s"], traffic["warmup_s"],
                                  setup["seconds"])
        due_abs = go["t_begin"] + plan["due"]
        tasks = await load.open_loop(due_abs, pool=int(traffic.get("pool", 16)))
    else:
        tasks = await load.closed_loop(int(traffic["clients"]), go["t_begin"], go["t_end"])
    done, pending = await asyncio.wait(tasks, timeout=max(0.0, deadline - now()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    for t in done:
        t.result()
    cols = list(zip(*load.rows)) if load.rows else [[]] * 6
    return {"item": np.asarray(cols[0], np.int64), "due": np.asarray(cols[1], float),
            "sent": np.asarray(cols[2], float), "done": np.asarray(cols[3], float),
            "status": np.asarray(cols[4], np.int64), "answer": list(cols[5])}


def main() -> int:
    setup = json.loads(sys.stdin.readline())
    kind = importlib.import_module(f"perfbench.kinds.{setup['kind']}")
    items = np.load(setup["items"])
    bodies = kind.bodies(items, setup["config"], setup["traffic"])
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    line = sys.stdin.readline()
    if not line:
        return 1
    res = asyncio.run(_drive(setup, json.loads(line), bodies))
    sys.stdout.buffer.write(pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
