"""Usage metering sinks (reference: src/server/usage.rs).

  * UsageEvent{tenant, key_id, op, modality, algorithm, bytes_in, units,
    elapsed_ms, status, ts unix-ms}  (usage.rs:49-81)
  * UsageOp Ingest/Upsert/Query/Describe/Delete  (usage.rs:31-42)
  * NoopUsageSink; LogUsageSink (NDJSON append); WebhookUsageSink
    (queued, batch 32, 5x exponential backoff then drop, usage.rs:159-246)

Copied from ucfp_tpu/server/usage.py; only its imports differ.
"""

from __future__ import annotations

import abc
import asyncio
import enum
import json
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional


class UsageOp(enum.Enum):
    INGEST = "ingest"
    UPSERT = "upsert"
    QUERY = "query"
    DESCRIBE = "describe"
    DELETE = "delete"


@dataclass
class UsageEvent:
    tenant_id: int
    key_id: str
    op: UsageOp
    modality: Optional[str] = None
    algorithm: Optional[str] = None
    bytes_in: int = 0
    units: int = 1
    elapsed_ms: float = 0.0
    status: int = 200
    ts: int = 0  # unix millis

    def to_json(self) -> str:
        d = asdict(self)
        d["op"] = self.op.value
        return json.dumps(d, separators=(",", ":"))


class UsageSink(abc.ABC):
    @abc.abstractmethod
    async def record(self, event: UsageEvent) -> None: ...

    async def close(self) -> None:  # optional drain
        return None


class NoopUsageSink(UsageSink):
    async def record(self, event: UsageEvent) -> None:
        return None


class LogUsageSink(UsageSink):
    """NDJSON append (usage.rs:116-155)."""

    def __init__(self, path: str):
        self.path = path

    async def record(self, event: UsageEvent) -> None:
        def work():
            with open(self.path, "a") as f:
                f.write(event.to_json() + "\n")

        await asyncio.to_thread(work)


class WebhookUsageSink(UsageSink):
    """Queued batching sink: batch 32, 5 retries with exponential backoff,
    then the batch is dropped (usage.rs:214-234)."""

    BATCH = 32
    MAX_RETRIES = 5
    # bounded: a down webhook drains at ~10 events/s through the backoff
    # loop, so an unbounded queue under real traffic grows until OOM.
    # Full queue -> the OLDEST pending event is dropped (usage metering
    # is fire-and-forget; newest data is the most valuable).
    MAX_QUEUE = 10_000

    def __init__(self, post: Callable, backoff_base: float = 0.1):
        self._post = post  # async callable(list[UsageEvent])
        self._backoff = backoff_base
        self._queue: asyncio.Queue[Optional[UsageEvent]] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self.dropped = 0

    def _ensure_worker(self):
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def record(self, event: UsageEvent) -> None:
        self._ensure_worker()
        if self._queue.qsize() >= self.MAX_QUEUE:
            try:
                victim = self._queue.get_nowait()
                if victim is None:  # never swallow the shutdown signal
                    self._queue.put_nowait(None)
                self.dropped += 1
            except asyncio.QueueEmpty:
                pass
        self._queue.put_nowait(event)

    async def _run(self):
        batch: list[UsageEvent] = []
        while True:
            ev = await self._queue.get()
            if ev is None:
                break
            batch.append(ev)
            while len(batch) < self.BATCH and not self._queue.empty():
                nxt = self._queue.get_nowait()
                if nxt is None:
                    await self._send(batch)
                    return
                batch.append(nxt)
            await self._send(batch)
            batch = []

    async def _send(self, batch: list[UsageEvent]):
        for attempt in range(self.MAX_RETRIES):
            try:
                await self._post(list(batch))
                return
            except Exception:
                await asyncio.sleep(self._backoff * (2**attempt))
        # dropped after MAX_RETRIES, matching the reference

    async def close(self) -> None:
        if self._task is not None and not self._task.done():
            self._queue.put_nowait(None)
            await self._task


def now_ms() -> int:
    return int(time.time() * 1000)
