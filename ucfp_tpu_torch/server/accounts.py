"""User accounts + browser sessions for the dashboard.

Self-hosted rebuild of the reference web control plane's auth
(web/src/lib/server/auth.ts:32-150 and web/migrations/0001_init.sql):

  * users: PBKDF2-SHA256 password hashes (per-user random salt), each
    signup auto-assigned the next tenant_id (the D1 schema's
    auto-tenant trigger)
  * sessions: the browser cookie holds a random token; the store keeps
    only sha256(token), so a leaked store cannot mint sessions
    (auth.ts session id = sha256(cookie token))
  * signup / login / logout handlers; a valid session authenticates
    protected API routes scoped to the user's tenant (the reference's
    SvelteKit layer proxies with a service bearer + X-Ucfp-Tenant —
    here the session acts directly with the same tenant scoping)

Storage is one JSON file beside the index data, written atomically and
fsync'd like the keystore.

Copied from ucfp_tpu/server/accounts.py; only its imports differ.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import threading
import time
from typing import Optional

PBKDF2_ITERS = 100_000
SESSION_TTL_SECS = 7 * 24 * 3600
_MAX_SESSIONS = 4096  # clear-on-overflow bound, like the key cache


def _hash_password(password: str, salt: bytes) -> str:
    return hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, PBKDF2_ITERS
    ).hex()


class AccountStore:
    def __init__(self, path: str, reserved_tenants=None):
        self.path = path
        self._lock = threading.Lock()
        # disk writes happen OUTSIDE self._lock (resolve() takes it
        # synchronously on the event loop — an fsync under it would
        # stall every in-flight request): mutations snapshot the JSON
        # under the lock, then write under _io_lock with a version
        # counter so two racing saves can't regress the file
        self._io_lock = threading.Lock()
        self._version = 0
        self._written = 0
        #: optional callable returning tenant ids assigned OUTSIDE this
        #: store (issued API keys, keys files) — signup must not hand a
        #: new user a tenant id that already names someone else's data
        self._reserved = reserved_tenants
        self._users: dict[str, dict] = {}  # email -> row
        self._sessions: dict[str, dict] = {}  # sha256(token) -> row
        if os.path.exists(path):
            try:
                with open(path) as f:
                    blob = json.load(f)
                self._users = blob.get("users", {})
                self._sessions = blob.get("sessions", {})
            except (json.JSONDecodeError, OSError):
                pass

    def _snapshot_locked(self) -> tuple[int, str]:
        """Serialize the store under self._lock; the caller writes the
        blob to disk AFTER dropping the lock (_write_snapshot)."""
        self._version += 1
        return self._version, json.dumps(
            {"users": self._users, "sessions": self._sessions}
        )

    def _write_snapshot(self, snap: tuple[int, str]) -> None:
        version, blob = snap
        with self._io_lock:
            if version <= self._written:
                return  # a newer snapshot already reached disk
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._written = version

    def _next_tenant_id(self) -> int:
        used = [row["tenant_id"] for row in self._users.values()]
        if self._reserved is not None:
            # tenants named by issued API keys / keys files: a signup
            # colliding with one would share that tenant's data
            # namespace (query/list/delete each other's records)
            used.extend(self._reserved())
        return max(used, default=0) + 1

    # -- users ---------------------------------------------------------------

    def signup(self, email: str, password: str) -> dict:
        """Create a user with the next free tenant_id; returns a fresh
        session. Raises ValueError on a duplicate email or weak input."""
        email = email.strip().lower()
        if not email or "@" not in email or len(email) > 254:
            raise ValueError("invalid email")
        if len(password) < 8:
            raise ValueError("password must be at least 8 characters")
        # PBKDF2 (100k rounds, tens of ms on one core) runs OUTSIDE the
        # lock: resolve() takes this lock synchronously on the event
        # loop, so hashing under it would stall every session-cookie
        # request for the duration
        salt = secrets.token_bytes(16)
        pw = _hash_password(password, salt)
        with self._lock:
            if email in self._users:
                raise ValueError("account already exists")
            self._users[email] = {
                "salt": salt.hex(),
                "pw": pw,
                "tenant_id": self._next_tenant_id(),
                "created": int(time.time()),
            }
            sess = self._new_session_locked(email)
            snap = self._snapshot_locked()
        self._write_snapshot(snap)
        return sess

    def login(self, email: str, password: str) -> Optional[dict]:
        """Constant-time verify; returns a fresh session or None."""
        email = email.strip().lower()
        with self._lock:
            row = self._users.get(email)
            salt = bytes.fromhex(row["salt"]) if row else b"\x00" * 16
            expect = row["pw"] if row else ""
        # always burn a PBKDF2 round so unknown emails are not
        # distinguishable from wrong passwords by timing — but hash
        # OUTSIDE the lock (see signup); re-check under the lock after
        got = _hash_password(password, salt)
        with self._lock:
            row = self._users.get(email)
            if row is None or row["pw"] != expect or not hmac.compare_digest(
                got, row["pw"]
            ):
                return None
            sess = self._new_session_locked(email)
            snap = self._snapshot_locked()
        self._write_snapshot(snap)
        return sess

    # -- sessions ------------------------------------------------------------

    def _new_session_locked(self, email: str) -> dict:
        if len(self._sessions) >= _MAX_SESSIONS:
            # evict expired first, then oldest-expiring — clearing the
            # whole map would log out every user on session #4096
            now = time.time()
            expired = [h for h, row in self._sessions.items()
                       if row["expires"] < now]
            for h in expired:
                del self._sessions[h]
            while len(self._sessions) >= _MAX_SESSIONS:
                oldest = min(self._sessions, key=lambda h: self._sessions[h]["expires"])
                del self._sessions[oldest]
        token = secrets.token_urlsafe(32)
        self._sessions[hashlib.sha256(token.encode()).hexdigest()] = {
            "email": email,
            "tenant_id": self._users[email]["tenant_id"],
            "expires": int(time.time()) + SESSION_TTL_SECS,
        }
        return {
            "token": token,
            "email": email,
            "tenant_id": self._users[email]["tenant_id"],
        }

    def resolve(self, token: str) -> Optional[dict]:
        """Session row for a cookie token, or None if unknown/expired.
        Called on the request path (event loop): never fsyncs — an
        expired row is dropped in memory only, and the next mutating
        call's _save persists the purge (expiry is re-checked on every
        resolve, so a stale on-disk row cannot authenticate)."""
        h = hashlib.sha256(token.encode()).hexdigest()
        with self._lock:
            row = self._sessions.get(h)
            if row is None:
                return None
            if row["expires"] < time.time():
                del self._sessions[h]
                return None
            return dict(row)

    def logout(self, token: str) -> bool:
        h = hashlib.sha256(token.encode()).hexdigest()
        with self._lock:
            if self._sessions.pop(h, None) is None:
                return False
            snap = self._snapshot_locked()
        self._write_snapshot(snap)
        return True
