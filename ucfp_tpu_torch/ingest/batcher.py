"""Deadline batcher: cross-request batching onto fixed-size device batches.

The single biggest architectural change vs the reference's
request-at-a-time model (SURVEY.md section 7): ingest requests enqueue
decoded, same-shape payloads; a scheduler flushes a batch to the device
when either `max_batch` items are waiting or the oldest item has waited
`max_delay_ms` — the classic deadline batching policy. The reference's
`IngestSource::next_batch(max)` trait (src/ingest/mod.rs:18-28) is the
natural seam this fills.

Shape bucketing: device kernels compile per input shape, so the batcher
keys queues by an arbitrary hashable bucket (e.g. decoded image HxW).
Padding to a small set of canonical buckets is the caller's choice.

Copied from ucfp_tpu/ingest/batcher.py; only its imports differ.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Hashable


@dataclass
class _Pending:
    payload: Any
    future: asyncio.Future


class DeadlineBatcher:
    """Groups awaitable work items into device-sized batches per bucket.

    run_batch(bucket, payloads) -> list of per-item results (same order).
    """

    def __init__(
        self,
        run_batch: Callable[[Hashable, list], Awaitable[list]],
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        weigh: Callable[[Any], int] | None = None,
    ):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1000.0
        # weighted mode: payloads are themselves GROUPS (e.g. [N, H, W]
        # image stacks from the bulk route) and the flush threshold is
        # total weight (rows), not item count — 8 groups of 1024 rows
        # and 64 groups of 128 rows should both flush near the same
        # device batch size
        self.weigh = weigh
        self._queues: dict[Hashable, list[_Pending]] = {}
        self._weights: dict[Hashable, int] = {}
        self._timers: dict[Hashable, asyncio.TimerHandle] = {}
        self._lock = asyncio.Lock()
        # strong refs: the loop holds tasks weakly, and a GC'd flush task
        # would leave every queued future hanging forever
        self._flush_tasks: set = set()

    def _spawn_flush(self, bucket: Hashable) -> None:
        task = asyncio.ensure_future(self._flush(bucket))
        self._flush_tasks.add(task)
        task.add_done_callback(self._flush_tasks.discard)

    async def submit(self, bucket: Hashable, payload: Any):
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        flush_now = False
        async with self._lock:
            q = self._queues.setdefault(bucket, [])
            q.append(_Pending(payload, fut))
            if self.weigh is not None:
                w = self._weights.get(bucket, 0) + self.weigh(payload)
                self._weights[bucket] = w
                full = w >= self.max_batch
            else:
                full = len(q) >= self.max_batch
            if full:
                flush_now = True
            elif bucket not in self._timers:
                self._timers[bucket] = loop.call_later(
                    self.max_delay, self._spawn_flush, bucket
                )
        if flush_now:
            # detached task, NOT awaited in this submitter: a cancelled
            # submitter (client disconnect) mid-run_batch would raise
            # CancelledError past _flush's `except Exception` and orphan
            # every sibling future in the batch forever
            self._spawn_flush(bucket)
        return await fut

    async def _flush(self, bucket: Hashable) -> None:
        async with self._lock:
            timer = self._timers.pop(bucket, None)
            if timer is not None:
                timer.cancel()
            q = self._queues.pop(bucket, [])
            self._weights.pop(bucket, None)
        if not q:
            return
        # the flush_now race can admit a few extra items; keep device
        # batches at the contracted size by chunking
        for chunk in self._chunks(q):
            try:
                results = await self.run_batch(
                    bucket, [p.payload for p in chunk]
                )
                if len(results) != len(chunk):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(chunk)} payloads"
                    )
                for p, r in zip(chunk, results):
                    if not p.future.done():
                        p.future.set_result(r)
            except Exception as e:
                for p in chunk:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _chunks(self, q: list[_Pending]):
        """Split a flushed queue into device-batch-sized chunks: by item
        count, or by cumulative weight when weighted (a chunk always
        takes at least one item, so an over-weight single group still
        runs)."""
        if self.weigh is None:
            for lo in range(0, len(q), self.max_batch):
                yield q[lo:lo + self.max_batch]
            return
        chunk: list[_Pending] = []
        w = 0
        for p in q:
            pw = self.weigh(p.payload)
            if chunk and w + pw > self.max_batch:
                yield chunk
                chunk, w = [], 0
            chunk.append(p)
            w += pw
        if chunk:
            yield chunk

    async def flush_all(self) -> None:
        for bucket in list(self._queues.keys()):
            await self._flush(bucket)

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())
