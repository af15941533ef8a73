"""Playground live-tune byte cache (reference: src/server/inputs_cache.rs).

Keyed (tenant, input_id); TTL 600 s; 200 MiB per-tenant soft cap with
oldest-first eviction; ids seeded from a monotonic nanosecond counter.

Copied from ucfp_tpu/server/inputs_cache.py; only its imports differ.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

TTL_SECS = 600.0
TENANT_CAP_BYTES = 200 * 1024 * 1024


@dataclass
class _Entry:
    data: bytes
    content_type: str
    sample_rate: Optional[int]
    created: float


class InputsCache:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: dict[tuple[int, str], _Entry] = {}
        self._id_seed = time.time_ns()

    def put(
        self,
        tenant_id: int,
        data: bytes,
        content_type: str = "application/octet-stream",
        sample_rate: Optional[int] = None,
    ) -> str:
        if len(data) > TENANT_CAP_BYTES:
            # a single oversized body would evict everything AND still
            # exceed the documented per-tenant cap
            raise ValueError(
                f"input exceeds the {TENANT_CAP_BYTES} byte tenant cap"
            )
        with self._lock:
            self._id_seed += 1
            input_id = f"in_{self._id_seed:x}"
            now = self._clock()
            self._evict(tenant_id, len(data), now)
            self._entries[(tenant_id, input_id)] = _Entry(
                data, content_type, sample_rate, now
            )
            return input_id

    def get(self, tenant_id: int, input_id: str) -> Optional[_Entry]:
        with self._lock:
            e = self._entries.get((tenant_id, input_id))
            if e is None:
                return None
            if self._clock() - e.created > TTL_SECS:
                del self._entries[(tenant_id, input_id)]
                return None
            return e

    def delete(self, tenant_id: int, input_id: str) -> bool:
        with self._lock:
            return self._entries.pop((tenant_id, input_id), None) is not None

    def _evict(self, tenant_id: int, incoming: int, now: float) -> None:
        # expire stale entries, then evict oldest-first to the tenant cap
        stale = [k for k, e in self._entries.items() if now - e.created > TTL_SECS]
        for k in stale:
            del self._entries[k]
        mine = sorted(
            ((k, e) for k, e in self._entries.items() if k[0] == tenant_id),
            key=lambda kv: kv[1].created,
        )
        used = sum(len(e.data) for _, e in mine)
        i = 0
        while used + incoming > TENANT_CAP_BYTES and i < len(mine):
            k, e = mine[i]
            used -= len(e.data)
            del self._entries[k]
            i += 1


_GLOBAL: Optional[InputsCache] = None


def global_cache() -> InputsCache:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = InputsCache()
    return _GLOBAL
