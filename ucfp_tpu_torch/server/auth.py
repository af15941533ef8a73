"""Pluggable API-key auth (reference: src/server/apikey.rs).

  * ApiKeyContext{tenant_id, key_id, scopes, rate_class}  (apikey.rs:34-48)
  * StaticSingleKey  — constant-time compare (apikey.rs:70-108)
  * StaticMapKey     — multi-tenant key file, minimal TOML subset parser
                       (apikey.rs:134-313)
  * WebhookKeyLookup — remote lookup with 60 s TTL cache and bounded size
                       (apikey.rs:317-418); performs no network here (zero
                       egress build) unless given a custom fetch callable.

Copied from ucfp_tpu/server/auth.py; only its imports differ.
"""

from __future__ import annotations

import abc
import hmac
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True)
class ApiKeyContext:
    tenant_id: int
    key_id: str = "default"
    scopes: tuple[str, ...] = ()
    rate_class: str = "default"
    # per-key budgets (reference D1 api_keys schema: rate_limit_per_min
    # 600, daily_quota 50000 — web/migrations/0001_init.sql). 0 = no
    # per-key limit (static service bearers).
    rate_limit_per_min: int = 0
    daily_quota: int = 0


class ApiKeyLookup(abc.ABC):
    @abc.abstractmethod
    async def lookup(self, token: str) -> Optional[ApiKeyContext]:
        """Return the key's context, or None for an unknown token."""

    def known_tenant_ids(self) -> tuple[int, ...]:
        """Tenant ids this lookup can authenticate, where enumerable.
        Dashboard signup reserves these so a new account never lands on
        a tenant id that an API key already names (tenant-isolation:
        the colliding pair could query/delete each other's records).
        Webhook lookups can't enumerate — they return () and the
        operator owns id assignment there."""
        return ()


# Scope names → the route families they unlock. A key with EMPTY scopes
# is unrestricted (the reference default: apikey.rs:101 builds contexts
# with Vec::new() and its keys-file TOML documents
# `scopes = ["ingest", "query"]`, apikey.rs:173; the web error-codes doc
# specifies 403 on scope mismatch).
SCOPE_ROUTES: tuple[tuple[str, str], ...] = (
    ("/v1/ingest/", "ingest"),
    ("/v1/inputs", "ingest"),
    ("/v1/records", "records"),
    ("/v1/query", "query"),
    ("/v1/pipeline/", "query"),
    ("/v1/admin/", "admin"),
)


def required_scope(path: str) -> Optional[str]:
    """The scope a protected route needs, or None for unscoped routes
    (e.g. /v1/auth/whoami). Prefixes match on path-segment boundaries —
    a future /v1/recordsets must not silently inherit the records scope."""
    for prefix, scope in SCOPE_ROUTES:
        if prefix.endswith("/"):
            if path.startswith(prefix) or path == prefix[:-1]:
                return scope
        elif path == prefix or path.startswith(prefix + "/"):
            return scope
    return None


def scope_allows(ctx: ApiKeyContext, path: str) -> bool:
    if not ctx.scopes:
        return True
    need = required_scope(path)
    return need is None or need in ctx.scopes


def _parse_scope_list(raw: str) -> tuple[str, ...]:
    """Parse the TOML array form `["ingest", "query"]` (and tolerate a
    bare comma list)."""
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        raw = raw[1:-1]
    return tuple(
        s for s in (part.strip().strip('"').strip("'") for part in raw.split(","))
        if s
    )


class StaticSingleKey(ApiKeyLookup):
    """One service token, tenant 0 (service bearer). Constant-time compare."""

    def __init__(self, token: str, tenant_id: int = 0):
        self._token = token.encode()
        self._ctx = ApiKeyContext(tenant_id=tenant_id, key_id="static")

    async def lookup(self, token: str) -> Optional[ApiKeyContext]:
        if hmac.compare_digest(token.encode(), self._token):
            return self._ctx
        return None

    def known_tenant_ids(self) -> tuple[int, ...]:
        return (self._ctx.tenant_id,)


def parse_keys_file(content: str) -> dict[str, ApiKeyContext]:
    """Minimal TOML-subset parser for the keys file, like the reference's
    hand-rolled one (apikey.rs:134-313). Format:

        [keys.some-key-id]
        token = "secret"
        tenant_id = 7
    """
    keys: dict[str, ApiKeyContext] = {}
    section: Optional[str] = None
    fields: dict[str, str] = {}

    def commit():
        nonlocal fields, section
        if section is not None and "token" in fields:
            keys[fields["token"]] = ApiKeyContext(
                tenant_id=int(fields.get("tenant_id", "0")),
                key_id=section,
                scopes=_parse_scope_list(fields.get("scopes", "")),
                rate_class=fields.get("rate_class", "default"),
            )
        fields = {}

    for raw in content.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            commit()
            name = line[1:-1].strip()
            section = name.split(".", 1)[1] if name.startswith("keys.") else name
        elif "=" in line and section is not None:
            k, v = line.split("=", 1)
            fields[k.strip()] = v.strip().strip('"')
    commit()
    return keys


class StaticMapKey(ApiKeyLookup):
    """Multi-tenant static key map loaded from a keys file."""

    def __init__(self, keys: dict[str, ApiKeyContext]):
        self._keys = keys

    @classmethod
    def from_file(cls, path: str) -> "StaticMapKey":
        with open(path) as f:
            return cls(parse_keys_file(f.read()))

    async def lookup(self, token: str) -> Optional[ApiKeyContext]:
        # constant-time scan over all keys so timing doesn't leak which
        # prefix matched; compare bytes — compare_digest raises on
        # non-ASCII str input, which would turn a bad credential into a 500
        found: Optional[ApiKeyContext] = None
        tb = token.encode()
        for t, ctx in self._keys.items():
            if hmac.compare_digest(tb, t.encode()):
                found = ctx
        return found

    def known_tenant_ids(self) -> tuple[int, ...]:
        return tuple(ctx.tenant_id for ctx in self._keys.values())


class WebhookKeyLookup(ApiKeyLookup):
    """Remote key lookup with TTL cache (apikey.rs:317-418).

    `fetch(token) -> Optional[ApiKeyContext]` is injected; the default
    raises, since this build has no egress.
    """

    TTL_SECS = 60.0
    MAX_CACHE = 4096

    def __init__(self, fetch: Callable, clock=time.monotonic):
        self._fetch = fetch
        self._clock = clock
        self._cache: dict[str, tuple[float, Optional[ApiKeyContext]]] = {}

    async def lookup(self, token: str) -> Optional[ApiKeyContext]:
        now = self._clock()
        hit = self._cache.get(token)
        if hit is not None and now - hit[0] < self.TTL_SECS:
            return hit[1]
        try:
            ctx = await self._fetch(token)
        except Exception:
            # transport/5xx failure: never cache it as an authoritative
            # miss (a 5 s blip would lock a valid token out for the
            # whole TTL). Degrade to STALENESS, not to lockout: serve
            # the last-known answer however old it is — during an
            # outage longer than the 60 s TTL, availability for
            # already-seen keys beats freshness (the entry refreshes on
            # the first successful fetch). Unknown tokens still fail
            # closed.
            if hit is not None:
                return hit[1]
            return None
        if len(self._cache) >= self.MAX_CACHE:
            self._cache.clear()  # clear-on-overflow, like the reference
        self._cache[token] = (now, ctx)
        return ctx
