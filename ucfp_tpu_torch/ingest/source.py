"""Pull-based ingest sources (reference: src/ingest/mod.rs:18-28).

The reference declares `IngestSource { next_batch(max), ack(ids) }` with
no implementation — the seam for S3/queue ingestion. Here the trait is
implemented and wired: `run_ingest_loop` drains a source in batches into
the index (the batching seam SURVEY.md section 7 identifies as the TPU
batching hook) and acks on durable upsert.

Copied from ucfp_tpu/ingest/source.py; only its imports differ.
"""

from __future__ import annotations

import abc
import asyncio
from typing import Optional

from ..core import Record


class IngestSource(abc.ABC):
    @abc.abstractmethod
    async def next_batch(self, max_items: int) -> list[Record]:
        """Up to max_items pending records; empty when drained."""

    @abc.abstractmethod
    async def ack(self, record_ids: list[tuple[int, int]]) -> None:
        """Confirm durable ingestion of (tenant_id, record_id) pairs."""


class MemoryIngestSource(IngestSource):
    """In-memory queue source — the test/reference implementation."""

    def __init__(self) -> None:
        self._pending: list[Record] = []
        self._acked: list[tuple[int, int]] = []

    def offer(self, rec: Record) -> None:
        self._pending.append(rec)

    async def next_batch(self, max_items: int) -> list[Record]:
        batch = self._pending[:max_items]
        self._pending = self._pending[max_items:]
        return batch

    async def ack(self, record_ids: list[tuple[int, int]]) -> None:
        self._acked.extend(record_ids)

    @property
    def acked(self) -> list[tuple[int, int]]:
        return list(self._acked)


async def run_ingest_loop(
    source: IngestSource,
    index,
    batch_size: int = 64,
    idle_sleep: float = 0.05,
    max_batches: Optional[int] = None,
) -> int:
    """Drain a source into the index; returns records ingested. With
    max_batches=None runs until the source yields an empty batch."""
    total = 0
    batches = 0
    while max_batches is None or batches < max_batches:
        batch = await source.next_batch(batch_size)
        if not batch:
            if max_batches is None:
                break
            await asyncio.sleep(idle_sleep)
            batches += 1
            continue
        await index.upsert(batch)
        await source.ack([(r.tenant_id, r.record_id) for r in batch])
        total += len(batch)
        batches += 1
    return total
