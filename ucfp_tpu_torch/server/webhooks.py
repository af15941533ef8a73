"""HTTP fetchers wiring the webhook DI seams to real endpoints.

The reference composes three webhook-backed implementations from env
vars (bin/ucfp.rs:106-205): UCFP_KEY_LOOKUP_URL (apikey.rs:317-418,
60 s TTL cache), UCFP_RATELIMIT_URL (ratelimit.rs:206-273), and
UCFP_USAGE_WEBHOOK_URL (usage.rs:159-246, batch 32 + backoff-then-drop).
The DI classes here already exist with injected fetchers; this module
provides the actual HTTP callables (urllib in a worker thread — no new
dependencies) and their failure posture:

  * key lookup:  4xx -> unknown token; network error -> warn + unknown
    (fail CLOSED: auth is the security boundary)
  * rate limit:  any error -> warn + allow (fail OPEN: limiting is QoS,
    an outage must not take the API down — the reference's webhook
    degrade posture)
  * usage:       errors raise; WebhookUsageSink's retry/backoff/drop
    handles them

Wire shapes:
  POST key_url   {"token": str}                 -> 200 {tenant_id,
                 key_id?, scopes?, rate_class?, rate_limit_per_min?,
                 daily_quota?} | 4xx
  POST rate_url  {"tenant_id": int, "rate_class": str} -> 200
                 {allowed, remaining?, reset_ms?, retry_after_ms?}
  POST usage_url {"events": [UsageEvent-dict, ...]}    -> 2xx

Copied from ucfp_tpu/server/webhooks.py; only its imports differ.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import urllib.error
import urllib.request

from .auth import ApiKeyContext
from .logging import logger
from .ratelimit import RateDecision

DEFAULT_TIMEOUT_SECS = 5.0


async def _post_json(url: str, payload: dict,
                     timeout: float = DEFAULT_TIMEOUT_SECS):
    """-> (status, parsed-JSON-or-None); HTTPError surfaces as status."""

    def do():
        req = urllib.request.Request(
            # default=str: UsageEvent rows carry the UsageOp enum
            url, data=json.dumps(payload, default=str).encode(),
            headers={"content-type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                body = r.read()
                return r.status, (json.loads(body) if body else None)
        except urllib.error.HTTPError as e:
            return e.code, None

    return await asyncio.to_thread(do)


def key_lookup_fetch(url: str):
    """Fetcher for WebhookKeyLookup (its 60 s TTL cache caches BOTH
    hits and misses, bounding webhook traffic)."""

    async def fetch(token: str):
        try:
            status, body = await _post_json(url, {"token": token})
        except Exception as e:
            # transport failure: fail closed for THIS request but do
            # NOT let the TTL cache treat it as an authoritative miss —
            # a 5 s blip would otherwise lock the token out for 60 s
            logger().warn("key webhook unreachable", url=url, err=str(e))
            raise
        if status >= 500 or status == 429:
            # server-side failure is TRANSIENT, like a transport error:
            # raising keeps the TTL cache from storing a 503 blip as an
            # authoritative 60 s miss (only 2xx/4xx are authoritative)
            logger().warn("key webhook server error", url=url,
                          status=status)
            raise RuntimeError(f"key webhook answered {status}")
        if status != 200 or not isinstance(body, dict):
            return None
        try:
            tenant_id = int(body["tenant_id"])
            return ApiKeyContext(
                tenant_id=tenant_id,
                # per-tenant default: a shared literal "webhook" would
                # meter every tenant's per-key minute/day budget in ONE
                # FixedWindowLimiter bucket (app.py keys it by
                # f"key:{ctx.key_id}")
                key_id=str(body.get("key_id", f"webhook-t{tenant_id}")),
                scopes=tuple(body.get("scopes", ())),
                rate_class=str(body.get("rate_class", "default")),
                rate_limit_per_min=int(body.get("rate_limit_per_min", 0)),
                daily_quota=int(body.get("daily_quota", 0)),
            )
        except (KeyError, TypeError, ValueError) as e:
            logger().warn("key webhook bad payload", url=url, err=str(e))
            return None

    return fetch


def ratelimit_fetch(url: str):
    """Fetcher for WebhookRateLimiter."""

    async def fetch(tenant_id: int, rate_class: str) -> RateDecision:
        try:
            status, body = await _post_json(
                url, {"tenant_id": tenant_id, "rate_class": rate_class}
            )
            if status == 200 and isinstance(body, dict):
                return RateDecision(
                    allowed=bool(body.get("allowed", True)),
                    remaining=int(body.get("remaining", 0)),
                    reset_ms=int(body.get("reset_ms", 0)),
                    retry_after_ms=int(body.get("retry_after_ms", 0)),
                    limit=int(body.get("limit", 0)),
                )
        except Exception as e:
            logger().warn("ratelimit webhook unreachable", url=url, err=str(e))
        # fail open: a limiter outage must not take the API down
        return RateDecision(allowed=True, remaining=1 << 30)

    return fetch


def usage_post(url: str):
    """Poster for WebhookUsageSink (raising errors drive its
    retry-with-backoff-then-drop loop, usage.rs:214-234)."""

    async def post(events: list) -> None:
        payload = {
            "events": [
                dataclasses.asdict(e) if dataclasses.is_dataclass(e) else e
                for e in events
            ]
        }
        status, _ = await _post_json(url, payload)
        if status >= 300:
            raise RuntimeError(f"usage webhook answered {status}")

    return post


def challenge_verify_fetch(url: str, secret: str = ""):
    """Verifier for the anonymous demo route's abuse challenge
    (reference web/src/lib/server/turnstile.ts): POSTs the Cloudflare
    siteverify wire shape {"secret", "response", "remoteip"} and
    accepts on 200 + {"success": true}. FAIL CLOSED — an unreachable
    or erroring verifier rejects the request: the challenge exists to
    stop abuse, so an outage must not open the anonymous route."""

    async def verify(token: str, remoteip: str) -> bool:
        try:
            status, body = await _post_json(
                url,
                {"secret": secret, "response": token, "remoteip": remoteip},
            )
        except Exception as e:
            logger().warn("challenge webhook unreachable", url=url, err=str(e))
            return False
        return status == 200 and isinstance(body, dict) \
            and bool(body.get("success"))

    return verify
