"""The port's production request path against the reference's: keys,
accounts and the admin key routes.

Both packages build their server state with their own `state_from_env`
on the same settings (a service token, a keys file, the keystore and the
accounts under each one's data directory) and the same requests go to
both apps in process (test_torch_server.py's pattern). Every status and
every JSON body must be equal once the values that are random or
time-bound are masked; those are named where they are masked:

  * key secrets (`token`) and their first 12 characters (`prefix`),
  * key ids the keystore draws itself (`key_<hex>`),
  * session tokens (the `ucfp_session` cookie),
  * `created` stamps (unix seconds).

Each side's own secret is used for its own follow-up requests.
"""

import asyncio
import json
import re

import pytest

from ucfp_tpu.server import app as japp
from ucfp_tpu.server.http import Request as JRequest
from ucfp_tpu.server.ratelimit import FixedWindowLimiter as JWindows
from ucfp_tpu_torch.server import app as tapp
from ucfp_tpu_torch.server.http import Request as TRequest
from ucfp_tpu_torch.server.ratelimit import FixedWindowLimiter as TWindows

TOKEN = "svc-t0k"
# every setting state_from_env and the handlers read; each test starts
# from none of them (UCFP_WORKERS and UCFP_HTTP no longer stop a start,
# and are unset all the same)
ENV = ("UCFP_KEY_LOOKUP_URL", "UCFP_KEYS_FILE", "UCFP_TOKEN", "UCFP_RATELIMIT_URL",
       "UCFP_RATELIMIT_RPS", "UCFP_RATELIMIT_BURST", "UCFP_USAGE_WEBHOOK_URL",
       "UCFP_USAGE_LOG_PATH", "UCFP_DEMO_CHALLENGE_URL", "UCFP_DEMO_CHALLENGE_SECRET",
       "UCFP_DATA_DIR", "UCFP_AUTH_IP_RPM", "UCFP_DEMO_RPM", "UCFP_INGEST_COALESCE_MS",
       "UCFP_INGEST_COALESCE_ROWS", "UCFP_INGEST_PAD", "UCFP_AUTOCOMPACT_MB",
       "UCFP_WORKERS", "UCFP_HTTP", "UCFP_DISABLED_ALGORITHMS")

_MASKS = (
    (re.compile(rb'"token": ?"[^"]*"'), b'"token":"?"'),
    (re.compile(rb'"prefix": ?"[^"]*"'), b'"prefix":"?"'),
    (re.compile(rb'"created": ?\d+'), b'"created":0'),
    (re.compile(rb'key_[0-9a-f]{8}'), b'key_?'),
    # PIL's decode errors name an object address
    (re.compile(rb"0x[0-9a-f]+"), b"0x?"),
)
# response headers both sides must agree on (set-cookie compared masked;
# the content type is compared separately)
_HEADERS = ("retry-after", "x-ratelimit-limit", "x-ratelimit-remaining",
            "x-ratelimit-reset-ms")


def mask(body: bytes) -> bytes:
    for pat, sub in _MASKS:
        body = pat.sub(sub, body)
    return body


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


class Pair:
    """A value that differs between the two servers (a key secret, a
    session cookie): `.j` goes to the reference, `.t` to the port."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    def side(self, i):
        return self.j if i == 0 else self.t


class ProdServers:
    """Both production servers from their own state_from_env, in process.

    clock: the token bucket's clock (both packages' InMemoryTokenBucket;
    by default a clock that stands still, so the x-ratelimit-* headers do
    not depend on how long a request took); wall: the middleware's fixed
    windows (per-key quotas, per-IP limits; by default a wall clock that
    stands still), patched into both app modules' FixedWindowLimiter
    before the build."""

    def __init__(self, tmp_path, monkeypatch, *, token=TOKEN, keys_file=None,
                 usage_log=False, rate=None, burst=None, clock=None, wall=None,
                 env=None):
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        wall = wall or (lambda: 1_700_000_030.0)
        for mod, cls in ((japp, JWindows), (tapp, TWindows)):
            monkeypatch.setattr(mod, "FixedWindowLimiter",
                                lambda cls=cls: cls(clock=wall))
        self.usage = [str(tmp_path / f"{n}-usage.ndjson") if usage_log else None
                      for n in ("jax", "torch")]
        self.j_state = japp.state_from_env(
            data_dir=str(tmp_path / "jax"), token=token, keys_file=keys_file,
            usage_log=self.usage[0], rate=rate, burst=burst)
        self.t_state = tapp.state_from_env(
            data_dir=str(tmp_path / "torch"), token=token, keys_file=keys_file,
            usage_log=self.usage[1], rate=rate, burst=burst, device="cpu")
        clock = clock or (lambda: 1000.0)
        if hasattr(self.j_state.rate_limit, "_clock"):
            for st in (self.j_state, self.t_state):
                st.rate_limit._clock = clock
                st.rate_limit._last_sweep = clock()
        self.j = japp.build_server(self.j_state, timeout_secs=120.0)
        self.t = tapp.build_server(self.t_state, timeout_secs=120.0)

    def raw(self, method, path, body=b"", query=None, token=TOKEN, headers=None,
            remote="10.0.0.1", masks=()):
        """-> [(status, masked body, headers)] of the reference and the
        port; asserts they agree. `masks`: more (pattern, substitute)
        pairs for this call's time-bound fields."""
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        out = []
        for i, (app, mod, req_cls) in enumerate(((self.j, japp, JRequest),
                                                  (self.t, tapp, TRequest))):
            h = {"content-length": str(len(body))}
            for k, v in (headers or {}).items():
                h[k] = v.side(i) if isinstance(v, Pair) else v
            tok = token.side(i) if isinstance(token, Pair) else token
            if tok is not None:
                h["authorization"] = f"Bearer {tok}"
            q = {k: v.side(i) if isinstance(v, Pair) else v
                 for k, v in (query or {}).items()}
            p = path.side(i) if isinstance(path, Pair) else path
            req = req_cls(method, p, q, h, body, remote_addr=remote)

            async def go():
                resp, _ = await app.handle_request(req)
                # the usage events are fire-and-forget tasks: let them land
                # (this loop's: a finished task of an earlier test's loop
                # can linger in the module's set, and gather refuses it)
                loop = asyncio.get_running_loop()
                await asyncio.gather(*[t for t in list(mod._usage_tasks)
                                       if t.get_loop() is loop])
                return resp

            resp = asyncio.run(go())
            hdrs = {k: resp.headers[k] for k in _HEADERS if k in resp.headers}
            if "set-cookie" in resp.headers:
                hdrs["set-cookie"] = re.sub(r"ucfp_session=[^;]+", "ucfp_session=?",
                                            resp.headers["set-cookie"])
            body_m = mask(resp.body)
            for pat, sub in masks:
                body_m = re.sub(pat, sub, body_m)
            out.append((resp.status, body_m, hdrs, resp))
        assert out[0][:3] == out[1][:3], (method, path, query, out[0][:3], out[1][:3])
        assert out[0][3].content_type == out[1][3].content_type
        return out

    def call(self, method, path, body=b"", query=None, token=TOKEN, headers=None,
             remote="10.0.0.1", masks=()):
        """-> (status, JSON) after the equality check."""
        out = self.raw(method, path, body, query, token, headers, remote, masks)
        raw = out[1][1]
        return out[1][0], json.loads(raw) if raw else None

    def pair(self, method, path, body=b"", query=None, token=TOKEN, field="token",
             masks=()):
        """A call whose answer carries a per-side secret: -> (status, JSON,
        Pair of the secret field from each side's unmasked body)."""
        out = self.raw(method, path, body, query, token, masks=masks)
        st, res = out[1][0], json.loads(out[1][1])
        vals = [json.loads(o[3].body).get(field) for o in out]
        return st, res, Pair(*vals)

    def cookie(self, out) -> Pair:
        vals = []
        for o in out:
            raw = o[3].headers["set-cookie"]
            vals.append(raw.split(";", 1)[0])
        return Pair(*vals)

    def close(self):
        self.j_state.index.close()
        self.t_state.index.close()


def test_accounts_signup_login_whoami_logout(tmp_path, monkeypatch):
    """Signup, login, whoami and logout: the same statuses, bodies and
    cookie attributes (session tokens masked); a session acts as its
    tenant on protected routes and stops working after logout."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        # validation answers before any password hashing
        assert s.call("POST", "/v1/auth/signup", {"email": "nope", "password": "x" * 9},
                      token=None)[0] == 400
        assert s.call("POST", "/v1/auth/signup", {"email": "a@b.co", "password": "short"},
                      token=None)[0] == 400
        out = s.raw("POST", "/v1/auth/signup",
                    {"email": "User@Example.com", "password": "hunter2pass"}, token=None)
        assert out[1][0] == 201
        assert json.loads(out[1][1]) == {"email": "user@example.com", "tenant_id": 1}
        st, res = s.call("POST", "/v1/auth/signup",
                         {"email": "user@example.com", "password": "hunter2pass"},
                         token=None)
        assert (st, res["error"]) == (409, "bad_signup")
        assert s.call("POST", "/v1/auth/login",
                      {"email": "user@example.com", "password": "wrong-pass"},
                      token=None)[0] == 401
        login = s.raw("POST", "/v1/auth/login",
                      {"email": "user@example.com", "password": "hunter2pass"}, token=None)
        assert login[1][0] == 200
        cookie = s.cookie(login)
        st, who = s.call("GET", "/v1/auth/whoami", token=None,
                         headers={"cookie": cookie})
        assert (st, who) == (200, {"tenant_id": 1, "key_id": "session:user@example.com"})
        # the session is scoped to its tenant
        assert s.call("GET", "/v1/records/1", token=None, headers={"cookie": cookie})[0] == 200
        assert s.call("GET", "/v1/records/2", token=None, headers={"cookie": cookie})[0] == 403
        out = s.raw("POST", "/v1/auth/logout", token=None, headers={"cookie": cookie})
        assert out[1][0] == 200 and out[1][2]["set-cookie"].endswith("Max-Age=0")
        st, res = s.call("GET", "/v1/auth/whoami", token=None, headers={"cookie": cookie})
        assert (st, res["message"]) == (401, "missing bearer token")
        # the service bearer and X-Api-Key
        assert s.call("GET", "/v1/auth/whoami")[1]["tenant_id"] == 0
        assert s.call("GET", "/v1/auth/whoami", token=None,
                      headers={"x-api-key": TOKEN})[0] == 200
        assert s.call("GET", "/v1/auth/whoami", token="wrong")[1]["message"] == \
            "unknown API key"
    finally:
        s.close()


def test_admin_keys_create_list_revoke(tmp_path, monkeypatch):
    """Issued keys through the admin routes: create, list, scopes (403),
    tenant scoping, revoke (then 401), and the validation errors."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        st, k5, tok5 = s.pair("POST", "/v1/admin/keys",
                              {"tenant_id": 5, "key_id": "k5", "scopes": ["query"],
                               "rate_limit_per_min": 100})
        assert st == 201 and k5["key_id"] == "k5" and k5["daily_quota"] == 50_000
        st, k6, tok6 = s.pair("POST", "/v1/admin/keys", {"tenant_id": 6})
        assert st == 201 and k6["key_id"] == "key_?"
        for body, code in (({"tenant_id": 5, "key_id": "k5"}, 409),
                           ({"tenant_id": 5, "scopes": ["nope"]}, 400),
                           ({"tenant_id": 5, "scopes": "query"}, 400),
                           ({"tenant_id": 5, "daily_quota": -1}, 400),
                           ({"tenant_id": "x"}, 400),
                           ({"tenant_id": 5, "key_id": "bad id!"}, 400)):
            assert s.call("POST", "/v1/admin/keys", body)[0] == code, body
        st, lst = s.call("GET", "/v1/admin/keys")
        assert st == 200 and sorted(r["tenant_id"] for r in lst["keys"]) == [5, 6]
        assert len(s.call("GET", "/v1/admin/keys", query={"tenant_id": "5"})[1]["keys"]) == 1
        # the scoped key: query yes, ingest and admin no
        q = {"tenant_id": 5, "modality": "text", "terms": ["a"]}
        assert s.call("POST", "/v1/query", q, token=tok5)[0] == 200
        st, res = s.call("POST", "/v1/ingest/text/5/1", b"hello world", token=tok5)
        assert (st, res["message"]) == (403, "key lacks the 'ingest' scope")
        assert s.call("GET", "/v1/admin/keys", token=tok5)[0] == 403
        # an unscoped tenant key: its own keys only, its own tenant only
        st, mine = s.call("GET", "/v1/admin/keys", token=tok6)
        assert st == 200 and [r["tenant_id"] for r in mine["keys"]] == [6]
        assert s.call("POST", "/v1/admin/keys", {"tenant_id": 5}, token=tok6)[0] == 403
        assert s.call("DELETE", "/v1/admin/keys/k5", token=tok6)[0] == 404
        assert s.call("POST", "/v1/ingest/text/6/1", b"hello world", token=tok6)[0] == 201
        assert s.call("POST", "/v1/ingest/text/5/1", b"hello world", token=tok6)[0] == 403
        assert s.call("POST", "/v1/admin/compact", b"", token=tok6)[0] == 403
        # revoke: the key stops working
        assert s.call("DELETE", "/v1/admin/keys/k5") == (200, {"revoked": 1})
        assert s.call("DELETE", "/v1/admin/keys/k5")[0] == 404
        st, res = s.call("POST", "/v1/query", q, token=tok5)
        assert (st, res["message"]) == (401, "unknown API key")
    finally:
        s.close()


def test_keys_file_and_token_precedence(tmp_path, monkeypatch):
    """UCFP_KEYS_FILE wins over UCFP_TOKEN; with neither (and no lookup
    URL) both packages refuse to start."""
    keys = tmp_path / "keys.toml"
    keys.write_text('[keys.kf]\ntoken = "kf-tok"\ntenant_id = 3\n')
    monkeypatch.setenv("UCFP_KEYS_FILE", str(keys))
    monkeypatch.setenv("UCFP_TOKEN", "env-tok")
    s = ProdServers(tmp_path, monkeypatch, token=None)
    try:
        assert s.call("GET", "/v1/auth/whoami", token="kf-tok")[1] == {
            "tenant_id": 3, "key_id": "kf"}
        assert s.call("GET", "/v1/auth/whoami", token="env-tok")[0] == 401
    finally:
        s.close()
    monkeypatch.delenv("UCFP_KEYS_FILE")
    monkeypatch.delenv("UCFP_TOKEN")
    for fn, kw in ((japp.state_from_env, {}), (tapp.state_from_env, {"device": "cpu"})):
        with pytest.raises(SystemExit, match="refusing to start without auth"):
            fn(data_dir=str(tmp_path / "none"), **kw)
