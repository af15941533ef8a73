"""Persistent API-key issuance and revocation.

Self-hosted equivalent of the reference web control plane's key
management (web/src/lib/server/keys.ts: token = "ucfp_" +
base64url(random32), display prefix kept, sha256 digest stored — the
plaintext is returned exactly once at issuance). Keys live in a JSON
file next to the index data; lookups compare sha256 digests, so a
leaked keys file does not leak tokens.

Copied from ucfp_tpu/server/keystore.py; only its imports differ.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import secrets
import threading
import time
from typing import Optional

from .auth import ApiKeyContext, ApiKeyLookup


def _digest(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()


class PersistentKeyStore(ApiKeyLookup):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._keys: dict[str, dict] = {}  # sha256 -> row
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._keys = json.load(f)
            except (json.JSONDecodeError, OSError):
                self._keys = {}

    def _save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._keys, f, indent=1)
            f.flush()
            os.fsync(f.fileno())  # the plaintext is shown once; the
            # digest must survive a crash or the issued key is dead
        os.replace(tmp, self.path)

    # reference D1 api_keys defaults (web/migrations/0001_init.sql)
    DEFAULT_RPM = 600
    DEFAULT_DAILY = 50_000

    def issue(self, tenant_id: int, key_id: Optional[str] = None,
              rate_limit_per_min: Optional[int] = None,
              daily_quota: Optional[int] = None,
              scopes: Optional[list] = None) -> dict:
        """Create a key; returns the one-time plaintext token. Raises
        ValueError when key_id is already in use — revoke() deletes by
        key_id, so duplicates would make one call revoke both keys."""
        token = "ucfp_" + base64.urlsafe_b64encode(secrets.token_bytes(32)).rstrip(
            b"="
        ).decode()
        rpm = self.DEFAULT_RPM if rate_limit_per_min is None else int(rate_limit_per_min)
        daily = self.DEFAULT_DAILY if daily_quota is None else int(daily_quota)
        if rpm < 0 or daily < 0:
            raise ValueError("rate_limit_per_min/daily_quota must be >= 0")
        if key_id is not None:
            import re

            if not isinstance(key_id, str) or not re.fullmatch(
                r"[A-Za-z0-9._-]{1,64}", key_id
            ):
                # a non-string id would never match revoke()'s path-string
                # comparison — an unrevocable live credential
                raise ValueError(
                    "key_id must be 1-64 chars of [A-Za-z0-9._-]"
                )
        scope_list = [str(s) for s in (scopes or [])]
        from .auth import SCOPE_ROUTES

        known = {s for _, s in SCOPE_ROUTES}
        bad = [s for s in scope_list if s not in known]
        if bad:
            raise ValueError(
                f"unknown scopes {bad}; valid: {sorted(known)}"
            )
        with self._lock:
            existing = {row["key_id"] for row in self._keys.values()}
            if key_id is not None and key_id in existing:
                raise ValueError(f"key_id {key_id!r} already exists")
            kid = key_id
            while kid is None or kid in existing:
                kid = f"key_{secrets.token_hex(4)}"
            self._keys[_digest(token)] = {
                "key_id": kid,
                "tenant_id": tenant_id,
                "prefix": token[:12],
                "created": int(time.time()),
                "rate_limit_per_min": rpm,
                "daily_quota": daily,
                "scopes": scope_list,
            }
            self._save()
        return {"token": token, "key_id": kid, "tenant_id": tenant_id,
                "prefix": token[:12], "rate_limit_per_min": rpm,
                "daily_quota": daily, "scopes": scope_list}

    def revoke(self, key_id: str) -> bool:
        with self._lock:
            found = [h for h, row in self._keys.items() if row["key_id"] == key_id]
            for h in found:
                del self._keys[h]
            if found:
                self._save()
            return bool(found)

    def list_keys(self, tenant_id: Optional[int] = None) -> list[dict]:
        with self._lock:
            return [
                {k: v for k, v in row.items()}
                for row in self._keys.values()
                if tenant_id is None or row["tenant_id"] == tenant_id
            ]

    async def lookup(self, token: str) -> Optional[ApiKeyContext]:
        row = self._keys.get(_digest(token))
        if row is None:
            return None
        return ApiKeyContext(
            tenant_id=row["tenant_id"],
            key_id=row["key_id"],
            scopes=tuple(row.get("scopes", ())),
            # rows written before quotas existed get the schema defaults
            rate_limit_per_min=row.get("rate_limit_per_min", self.DEFAULT_RPM),
            daily_quota=row.get("daily_quota", self.DEFAULT_DAILY),
        )

    def known_tenant_ids(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(row["tenant_id"] for row in self._keys.values())


class CompositeKeyLookup(ApiKeyLookup):
    """First match wins across several lookups (service bearer + issued)."""

    def __init__(self, *lookups: ApiKeyLookup):
        self.lookups = lookups

    async def lookup(self, token: str) -> Optional[ApiKeyContext]:
        for lk in self.lookups:
            ctx = await lk.lookup(token)
            if ctx is not None:
                return ctx
        return None

    def known_tenant_ids(self) -> tuple[int, ...]:
        out: list[int] = []
        for lk in self.lookups:
            out.extend(lk.known_tenant_ids())
        return tuple(out)
