"""Per-tenant rate limiting (reference: src/server/ratelimit.rs).

  * RateDecision Allow{remaining, reset_ms} / Deny{retry_after_ms}
  * NoopRateLimiter
  * InMemoryTokenBucket — float tokens, default 100 rps / 200 burst
    (ratelimit.rs:89-198), idle buckets evicted after 1 h, sweep every
    5 min
  * WebhookRateLimiter — remote decision via injected fetch

Copied from ucfp_tpu/server/ratelimit.py; only its imports differ.
"""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class RateDecision:
    allowed: bool
    remaining: int = 0
    reset_ms: int = 0
    retry_after_ms: int = 0
    # bucket size of the budget this decision came from; 0 = unbounded.
    # Surfaced as the X-RateLimit-Limit response header.
    limit: int = 0


class TenantRateLimiter(abc.ABC):
    @abc.abstractmethod
    async def check(self, tenant_id: int, rate_class: str = "default") -> RateDecision: ...


class NoopRateLimiter(TenantRateLimiter):
    async def check(self, tenant_id: int, rate_class: str = "default") -> RateDecision:
        return RateDecision(allowed=True, remaining=1 << 30)


class InMemoryTokenBucket(TenantRateLimiter):
    IDLE_EVICT_SECS = 3600.0
    SWEEP_EVERY_SECS = 300.0

    def __init__(self, rate: float = 100.0, burst: float = 200.0, clock=time.monotonic):
        self.rate = rate
        self.burst = burst
        self._clock = clock
        self._buckets: dict[int, list[float]] = {}  # tenant -> [tokens, last]
        self._last_sweep = clock()

    async def check(self, tenant_id: int, rate_class: str = "default") -> RateDecision:
        now = self._clock()
        if now - self._last_sweep > self.SWEEP_EVERY_SECS:
            self._buckets = {
                t: b
                for t, b in self._buckets.items()
                if now - b[1] < self.IDLE_EVICT_SECS
            }
            self._last_sweep = now
        b = self._buckets.get(tenant_id)
        if b is None:
            b = [self.burst, now]
            self._buckets[tenant_id] = b
        tokens = min(self.burst, b[0] + (now - b[1]) * self.rate)
        b[1] = now
        if tokens >= 1.0:
            b[0] = tokens - 1.0
            reset_ms = int(1000.0 * (self.burst - b[0]) / self.rate)
            return RateDecision(allowed=True, remaining=int(b[0]),
                                reset_ms=reset_ms, limit=int(self.burst))
        b[0] = tokens
        return RateDecision(
            allowed=False,
            retry_after_ms=int(1000.0 * (1.0 - tokens) / self.rate),
            limit=int(self.burst),
        )


class FixedWindowLimiter:
    """String-keyed fixed-window counters: per-minute rate and optional
    daily quota. Rebuild of the reference web tier's KV counters
    (web/src/lib/server/ratelimit.ts:10-80 — `rl:{key}:{minute}` minute
    windows, `quota:{key}:{day}` daily quotas; D1 defaults 600/min and
    50 000/day per API key, 60/min/IP for the demo path). Synchronous —
    callers hold no locks across awaits; the asyncio server runs one
    event loop so plain dict ops are safe."""

    MAX_KEYS = 16384  # stale-window sweep threshold

    def __init__(self, clock=time.time):
        self._clock = clock
        self._minute: dict[str, list[int]] = {}  # key -> [window, count]
        self._day: dict[str, list[int]] = {}

    def _sweep(self, table: dict, current: int) -> None:
        if len(table) > self.MAX_KEYS:
            for k in [k for k, row in table.items() if row[0] != current]:
                del table[k]

    def check(self, key: str, per_min: int, daily: int = 0) -> RateDecision:
        now = self._clock()
        win = int(now // 60)
        day = int(now // 86400)
        if daily:
            drow = self._day.get(key)
            if drow is None or drow[0] != day:
                self._sweep(self._day, day)
                drow = [day, 0]
                self._day[key] = drow
            if drow[1] >= daily:
                return RateDecision(
                    allowed=False,
                    retry_after_ms=int(((day + 1) * 86400 - now) * 1000),
                    limit=daily,
                )
        remaining = 1 << 30
        limit = 0
        if per_min:
            row = self._minute.get(key)
            if row is None or row[0] != win:
                self._sweep(self._minute, win)
                row = [win, 0]
                self._minute[key] = row
            if row[1] >= per_min:
                return RateDecision(
                    allowed=False,
                    retry_after_ms=int(((win + 1) * 60 - now) * 1000),
                    limit=per_min,
                )
            row[1] += 1
            remaining = per_min - row[1]
            limit = per_min
        if daily:
            drow = self._day[key]
            drow[1] += 1
            if daily - drow[1] < remaining:
                remaining = daily - drow[1]
                limit = daily
        return RateDecision(
            allowed=True,
            remaining=remaining,
            reset_ms=int(((win + 1) * 60 - now) * 1000),
            limit=limit,
        )


class WebhookRateLimiter(TenantRateLimiter):
    def __init__(self, fetch: Callable):
        self._fetch = fetch

    async def check(self, tenant_id: int, rate_class: str = "default") -> RateDecision:
        return await self._fetch(tenant_id, rate_class)
