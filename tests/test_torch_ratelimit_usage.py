"""The port's rate limits, usage metering and env wiring against the
reference's (test_torch_auth_keys.ProdServers: each package's own
state_from_env, the same requests, equal statuses, bodies and
x-ratelimit-* / retry-after headers).

Rate-limit decisions come from one injected clock that both packages'
token buckets read (and one frozen wall clock for the per-key and per-IP
fixed windows), so every decision and header is deterministic. Masked,
as time-bound: the usage events' `ts` (unix ms) and `elapsed_ms`.
"""

import asyncio
import json
import sys

import pytest

from test_torch_auth_keys import ProdServers, _env  # noqa: F401 (autouse fixture)
from test_webhooks import WebhookEndpoint
from ucfp_tpu.server import app as japp
from ucfp_tpu_torch.server import app as tapp

TIME_MASKS = ((rb'"ts": ?\d+', b'"ts":0'), (rb'"elapsed_ms": ?[0-9.e-]+', b'"elapsed_ms":0'))


@pytest.fixture()
def endpoint():
    ep = WebhookEndpoint()
    yield ep
    ep.stop()


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_token_bucket_429_retry_after_and_headers(tmp_path, monkeypatch):
    """rate 1/s, burst 3: three requests pass (remaining 2, 1, 0), the
    fourth answers 429 with Retry-After and x-ratelimit-*, and a second
    later one token is back."""
    clock = Clock()
    s = ProdServers(tmp_path, monkeypatch, rate=1.0, burst=3.0, clock=clock)
    try:
        assert type(s.t_state.rate_limit).__name__ == "InMemoryTokenBucket"
        seen = []
        for _ in range(3):
            out = s.raw("GET", "/v1/auth/whoami")
            seen.append(out[1][2]["x-ratelimit-remaining"])
        assert seen == ["2", "1", "0"]
        out = s.raw("GET", "/v1/auth/whoami")
        st, body, hdrs = out[1][:3]
        assert st == 429 and json.loads(body)["message"] == "tenant rate limit exceeded"
        assert hdrs == {"retry-after": "1", "x-ratelimit-limit": "3",
                        "x-ratelimit-remaining": "0"}
        # other tenants have their own bucket; public routes have none
        assert s.call("GET", "/v1/info", token=None)[0] == 200
        clock.t += 1.0
        assert s.call("GET", "/v1/auth/whoami")[0] == 200
        assert s.call("GET", "/v1/auth/whoami")[0] == 429
    finally:
        s.close()


def test_per_key_minute_and_day_quotas(tmp_path, monkeypatch):
    """An issued key's own minute window and daily quota sit on top of
    the tenant bucket: 429 'API key rate limit exceeded', Retry-After to
    the window's end, and the window turns over with the wall clock."""
    wall = Clock(1_700_000_030.0)
    s = ProdServers(tmp_path, monkeypatch, wall=wall)
    try:
        _, _, per_min = s.pair("POST", "/v1/admin/keys",
                               {"tenant_id": 4, "key_id": "m2", "rate_limit_per_min": 2,
                                "daily_quota": 0})
        _, _, per_day = s.pair("POST", "/v1/admin/keys",
                               {"tenant_id": 5, "key_id": "d3", "rate_limit_per_min": 0,
                                "daily_quota": 3})
        to_minute = str(int(60 - wall.t % 60))
        to_day = str(int(86400 - wall.t % 86400))
        for tok, n_ok, retry in ((per_min, 2, to_minute), (per_day, 3, to_day)):
            rem = [s.raw("GET", "/v1/auth/whoami", token=tok)[1][2]["x-ratelimit-remaining"]
                   for _ in range(n_ok)]
            assert rem[-1] == "0"
            out = s.raw("GET", "/v1/auth/whoami", token=tok)
            st, body, hdrs = out[1][:3]
            assert st == 429 and json.loads(body)["message"] == "API key rate limit exceeded"
            assert hdrs["retry-after"] == retry and hdrs["x-ratelimit-remaining"] == "0"
        wall.t += 60.0
        assert s.call("GET", "/v1/auth/whoami", token=per_min)[0] == 200
        assert s.call("GET", "/v1/auth/whoami", token=per_day)[0] == 429
    finally:
        s.close()


def test_per_ip_auth_and_demo_windows(tmp_path, monkeypatch):
    """UCFP_AUTH_IP_RPM and UCFP_DEMO_RPM: per client address, on the
    public account POSTs and the demo route; 0 turns the demo off (404)."""
    s = ProdServers(tmp_path, monkeypatch,
                    env={"UCFP_AUTH_IP_RPM": "2", "UCFP_DEMO_RPM": "1"})
    try:
        bad = {"email": "no-at-sign", "password": "whatever1"}
        for _ in range(2):
            assert s.call("POST", "/v1/auth/signup", bad, token=None)[0] == 400
        out = s.raw("POST", "/v1/auth/login", bad, token=None)
        assert out[1][0] == 429 and out[1][2]["retry-after"] == "10"  # the frozen wall
        assert s.call("POST", "/v1/auth/signup", bad, token=None, remote="10.0.0.2")[0] == 400
        assert s.call("POST", "/v1/demo/fingerprint", b"hello demo world", token=None,
                      headers={"content-type": "text/plain"})[0] == 200
        st, res = s.call("POST", "/v1/demo/fingerprint", b"hello", token=None)
        assert (st, res["message"]) == (429, "demo rate limit exceeded")
    finally:
        s.close()
    monkeypatch.setenv("UCFP_DEMO_RPM", "0")
    s = ProdServers(tmp_path / "off", monkeypatch)
    try:
        assert s.call("POST", "/v1/demo/fingerprint", b"hello", token=None)[0] == 404
    finally:
        s.close()


def test_usage_lines_and_admin_usage(tmp_path, monkeypatch):
    """One NDJSON usage line per metered request, the same fields on both
    sides (op, modality, algorithm, bytes_in, status, tenant, key), and
    /v1/admin/usage returning them, filtered by tenant and limited."""
    from test_conformance import fixed_png

    s = ProdServers(tmp_path, monkeypatch, usage_log=True)
    try:
        _, _, tok7 = s.pair("POST", "/v1/admin/keys", {"tenant_id": 7, "key_id": "k7"})
        reqs = [
            ("POST", "/v1/ingest/text/7/1", b"the quick brown fox jumps", {}, tok7),
            ("POST", "/v1/ingest/text/7/2", b"over the lazy dog again and again " * 8,
             {"algorithm": "tlsh"}, tok7),
            ("POST", "/v1/ingest/image/7/3", fixed_png(10, 64, 64), {"algorithm": "phash"},
             tok7),
            ("POST", "/v1/query", {"tenant_id": 7, "modality": "text", "terms": ["fox"]},
             {}, tok7),
            ("GET", "/v1/records/7/1", b"", {}, tok7),
            ("GET", "/v1/records/7/99", b"", {}, tok7),
            ("DELETE", "/v1/records/7/2", b"", {}, tok7),
            ("POST", "/v1/ingest/text/8/1", b"not my tenant", {}, tok7),
            ("POST", "/v1/ingest/text/0/5", b"service tenant text", {}, None),
        ]
        for method, path, body, q, tok in reqs:
            s.call(method, path, body, q, **({"token": tok} if tok else {}))
        lines = []
        for path in s.usage:
            with open(path) as f:
                lines.append([json.loads(ln) for ln in f])
        # the key-issuing call is metered too (service bearer, tenant 0)
        assert len(lines[0]) == len(lines[1]) == len(reqs) + 1
        for ev in lines[0] + lines[1]:
            ev["ts"] = ev["elapsed_ms"] = 0
        assert lines[0] == lines[1]
        assert [(e["op"], e["modality"], e["algorithm"], e["status"]) for e in lines[1][1:5]] == [
            ("ingest", "text", "minhash-h128", 201), ("ingest", "text", "tlsh-128-1", 201),
            ("ingest", "image", "imgfprint-phash-v1", 201), ("query", "text", None, 200)]
        st, res = s.call("GET", "/v1/admin/usage", masks=TIME_MASKS)
        assert st == 200 and len(res["events"]) == len(reqs) + 1
        st, res = s.call("GET", "/v1/admin/usage", query={"tenant_id": "7", "limit": "3"},
                         masks=TIME_MASKS)
        assert [e["status"] for e in res["events"]] == [404, 200, 403]
        st, res = s.call("GET", "/v1/admin/usage", token=tok7, masks=TIME_MASKS)
        assert {e["tenant_id"] for e in res["events"]} == {7}
    finally:
        s.close()


def test_state_from_env_precedence(tmp_path, monkeypatch, endpoint):
    """The reference's precedence in both: UCFP_KEY_LOOKUP_URL > keys
    file > token; UCFP_RATELIMIT_URL > the in-memory bucket (100 / 200
    by default, none at a rate of 0); usage webhook > log > noop. The
    webhooks are served from a local socket."""
    endpoint.handlers["/keys"] = (200, {"tenant_id": 7, "key_id": "wk"})
    endpoint.handlers["/rl"] = (200, {"allowed": False, "retry_after_ms": 2500,
                                      "limit": 10})
    monkeypatch.setenv("UCFP_KEY_LOOKUP_URL", endpoint.url("/keys"))
    monkeypatch.setenv("UCFP_RATELIMIT_URL", endpoint.url("/rl"))
    s = ProdServers(tmp_path / "hooks", monkeypatch)
    try:
        for st in (s.j_state, s.t_state):
            assert [type(lk).__name__ for lk in st.api_keys.lookups] == [
                "WebhookKeyLookup", "PersistentKeyStore"]
            assert type(st.rate_limit).__name__ == "WebhookRateLimiter"
        out = s.raw("GET", "/v1/auth/whoami", token="remote-tok")
        assert out[1][0] == 429 and out[1][2]["retry-after"] == "2"
        assert out[1][2]["x-ratelimit-limit"] == "10"
        assert ("/keys", {"token": "remote-tok"}) in endpoint.requests
        assert ("/rl", {"tenant_id": 7, "rate_class": "default"}) in endpoint.requests
    finally:
        s.close()
    monkeypatch.delenv("UCFP_KEY_LOOKUP_URL")
    monkeypatch.delenv("UCFP_RATELIMIT_URL")
    cases = (
        ({}, "InMemoryTokenBucket", "NoopUsageSink", (100.0, 200.0)),
        ({"UCFP_RATELIMIT_RPS": "0", "UCFP_USAGE_LOG_PATH": str(tmp_path / "u.ndjson")},
         "NoopRateLimiter", "LogUsageSink", None),
        ({"UCFP_RATELIMIT_RPS": "5", "UCFP_RATELIMIT_BURST": "7",
          "UCFP_USAGE_LOG_PATH": str(tmp_path / "u.ndjson"),
          "UCFP_USAGE_WEBHOOK_URL": endpoint.url("/usage")},
         "InMemoryTokenBucket", "WebhookUsageSink", (5.0, 7.0)),
    )
    for i, (env, limiter, sink, rb) in enumerate(cases):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            states = [japp.state_from_env(data_dir=str(tmp_path / f"j{i}"), token="t"),
                      tapp.state_from_env(data_dir=str(tmp_path / f"t{i}"), token="t",
                                          device="cpu")]
            for st in states:
                assert type(st.rate_limit).__name__ == limiter
                assert type(st.usage).__name__ == sink
                if rb:
                    assert (st.rate_limit.rate, st.rate_limit.burst) == rb
                st.index.close()
    # the port's webhook usage sink posts batches the reference's way
    from ucfp_tpu_torch.server.usage import UsageEvent, UsageOp, WebhookUsageSink
    from ucfp_tpu_torch.server.webhooks import usage_post

    endpoint.handlers["/usage"] = (200, {})

    async def post():
        sink = WebhookUsageSink(usage_post(endpoint.url("/usage")))
        for i in range(3):
            await sink.record(UsageEvent(tenant_id=1, key_id="k", op=UsageOp.QUERY,
                                         bytes_in=i, ts=i))
        await sink.close()

    asyncio.run(post())
    events = [e for p, b in endpoint.requests if p == "/usage" for e in b["events"]]
    assert [e["bytes_in"] for e in events] == [0, 1, 2]


@pytest.mark.parametrize("env,item", [
    ({"UCFP_INGEST_COALESCE_MS": "2"}, "item 9"),
    ({"UCFP_WORKERS": "2"}, "item 18"),
    ({"UCFP_HTTP": "native"}, "item 18"),
])
def test_deferred_settings_refuse_to_start(tmp_path, monkeypatch, env, item):
    """The settings that once stopped the start (ROADMAP queue 1 items 9
    and 18) are served now: the state builds with each of them, on the
    env and on the command line, and the launcher takes the path each
    asks for (coalescing in the handlers, the multi-worker front, the
    native front)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    state = tapp.state_from_env(data_dir=str(tmp_path / "db"), token="t", device="cpu")
    try:
        handlers = tapp.build_server(state).router.match(
            "POST", "/v1/ingest/image/batch/0")[0].__self__
        assert handlers._coalesce_on == ("UCFP_INGEST_COALESCE_MS" in env)
    finally:
        state.index.close()
    from ucfp_tpu_torch.server import __main__ as cli
    from ucfp_tpu_torch.server import multiworker

    seen = {}

    async def fake_run(bind, st, native_http=None, reuse_port=False):
        seen["run"] = native_http
        st.index.close()

    monkeypatch.setattr(cli, "run", fake_run)
    monkeypatch.setattr(multiworker, "run_multiworker",
                        lambda bind, n, args: seen.update(workers=n))
    flag = {"UCFP_WORKERS": ["--workers", "2"], "UCFP_HTTP": ["--native-http"]}.get(
        next(iter(env)), [])
    for argv_env in ((), tuple(env)):  # the env alone, then the flag alone
        for k in argv_env:
            monkeypatch.delenv(k)
        seen.clear()
        monkeypatch.setattr(sys, "argv", ["server", "--token", "t", "--device", "cpu",
                                          "--data-dir", str(tmp_path / "cli"),
                                          *(flag if argv_env else [])])
        cli.main()
        if "UCFP_WORKERS" in env:
            assert seen == {"workers": 2}
        elif "UCFP_HTTP" in env:
            # the env is read inside run (native_http=None), the flag here
            assert seen == {"run": True if argv_env else None}
        else:
            assert seen == {"run": None}
