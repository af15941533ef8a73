"""Server composition: router, auth middleware, env wiring, launcher
(port of ucfp_tpu/server/app.py).

  * public routes: /, /docs, /docs/{page}, /healthz, /v1/info,
    /v1/algorithms, /metrics, /v1/demo/fingerprint and the account
    routes under /v1/auth/ (per-IP windows on the demo and auth POSTs)
  * protected routes behind the auth -> rate-limit -> usage middleware:
    bearer (or X-Api-Key, or a dashboard session cookie) -> ApiKeyLookup
    (static keys + the persistent keystore; 401) -> key scope gate (403)
    -> tenant token bucket and per-key minute/day quotas (429 +
    Retry-After) -> handler -> x-ratelimit-* headers and a
    fire-and-forget UsageEvent
  * env resolution with the reference's precedence and refuse-if-none
    rule: UCFP_KEY_LOOKUP_URL > UCFP_KEYS_FILE > UCFP_TOKEN; rate limits
    UCFP_RATELIMIT_URL > UCFP_RATELIMIT_RPS / _BURST (100 / 200);
    usage UCFP_USAGE_WEBHOOK_URL > UCFP_USAGE_LOG_PATH > noop; the
    keystore and accounts under the data directory

  * the launcher (run): boot warm-up (server/warmup.py, unless
    UCFP_WARMUP=0), the asyncio front or the native epoll front
    (UCFP_HTTP=native, server/nativehttp.py), SO_REUSEPORT for the
    multi-worker front's workers (server/multiworker.py), and a graceful
    drain on SIGTERM/SIGINT

Run: python -m ucfp_tpu_torch.server --bind 127.0.0.1:8080 --token t --data-dir d
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass
from typing import Optional

from ..index.embedded import EmbeddedBackend
from .auth import ApiKeyLookup, StaticMapKey, StaticSingleKey
from .handlers import Handlers
from .http import HttpError, HttpServer, Request, Response, Router
from .inputs_cache import InputsCache
from .ratelimit import (
    FixedWindowLimiter,
    InMemoryTokenBucket,
    NoopRateLimiter,
    TenantRateLimiter,
)
from .usage import LogUsageSink, NoopUsageSink, UsageEvent, UsageOp, UsageSink, now_ms


@dataclass
class ServerState:
    index: EmbeddedBackend
    api_keys: ApiKeyLookup
    rate_limit: TenantRateLimiter
    usage: UsageSink
    inputs: InputsCache
    keystore: object = None  # Optional[PersistentKeyStore]
    accounts: object = None  # Optional[AccountStore]
    # optional anonymous-abuse challenge for /v1/demo/fingerprint:
    # async (token, remoteip) -> bool (Turnstile-compatible webhook,
    # reference web/src/lib/server/turnstile.ts). None = no challenge.
    challenge: object = None


# strong refs for in-flight usage tasks (see middleware comment)
_usage_tasks: set = set()

_OP_BY_PREFIX = [
    ("/v1/ingest", UsageOp.INGEST),
    ("/v1/records", UsageOp.UPSERT),
    ("/v1/query", UsageOp.QUERY),
]


def build_server(
    state: ServerState,
    body_limit: Optional[int] = None,
    timeout_secs: Optional[float] = None,
) -> HttpServer:
    h = Handlers(
        state.index,
        state.inputs,
        keystore=state.keystore,
        usage_log_path=getattr(state.usage, "path", None),
        accounts=state.accounts,
    )
    r = Router()
    # public (mod.rs:78-88)
    async def index_page(req: Request) -> Response:
        from .webui import PAGE

        return Response(body=PAGE.encode(), content_type="text/html; charset=utf-8")

    r.add("GET", "/", index_page, protected=False)

    # documentation site (reference web/src/lib/docs markdown pages)
    async def docs_index(req: Request) -> Response:
        from .docsite import index_html

        return Response(body=index_html().encode(),
                        content_type="text/html; charset=utf-8")

    async def docs_page(req: Request) -> Response:
        from .docsite import page_html

        page = page_html(req.params.get("page", ""))
        if page is None:
            raise HttpError(404, "not_found", "no such doc page")
        return Response(body=page.encode(),
                        content_type="text/html; charset=utf-8")

    r.add("GET", "/docs", docs_index, protected=False)
    r.add("GET", "/docs/{page}", docs_page, protected=False)
    r.add("GET", "/healthz", h.healthz, protected=False)
    r.add("GET", "/v1/info", h.info, protected=False)
    r.add("GET", "/v1/algorithms", h.algorithms, protected=False)
    # anonymous compute-only demo (reference /api/fingerprint anon path)
    r.add("POST", "/v1/demo/fingerprint", h.demo_fingerprint, protected=False)
    # protected (mod.rs:104-193)
    r.add("PUT", "/v1/records", h.upsert_records)
    r.add("POST", "/v1/records", h.upsert_records)
    r.add("GET", "/v1/records/{tenant_id}", h.list_records)
    r.add("GET", "/v1/records/{tenant_id}/{record_id}", h.describe_record)
    r.add("DELETE", "/v1/records/{tenant_id}/{record_id}", h.delete_record)
    r.add("POST", "/v1/query", h.query)
    # literal-segment routes register BEFORE their parameterized
    # shadows: the router matches in registration order, so
    # /ingest/text/batch/0 must not bind tenant_id="batch"
    r.add("POST", "/v1/ingest/text/batch/{tenant_id}", h.ingest_text_batch)
    r.add("POST", "/v1/ingest/text/{tenant_id}/{record_id}", h.ingest_text)
    r.add(
        "POST", "/v1/ingest/text/{tenant_id}/{record_id}/stream",
        h.ingest_text_stream, streaming=True,
    )
    # batched image ingest (TPU-first extension: one device batch + one
    # WAL group commit for up to 1024 images). Registered BEFORE the
    # per-record route so "batch" is not captured as a tenant id.
    r.add("POST", "/v1/ingest/image/batch/{tenant_id}", h.ingest_image_batch)
    # batched pre-computed embedding ingest (binary f32 rows -> one WAL
    # run commit; remote twin of upsert_embedding_batch)
    r.add("POST", "/v1/ingest/embedding/batch/{tenant_id}",
          h.ingest_embedding_batch)
    r.add("POST", "/v1/ingest/image/{tenant_id}/{record_id}", h.ingest_image)
    r.add("POST", "/v1/ingest/image/{tenant_id}/{record_id}/semantic",
          h.ingest_image_semantic)
    r.add("POST", "/v1/ingest/text/{tenant_id}/{record_id}/preprocess/{kind}",
          h.ingest_text_preprocess)
    # registered before the parameterized route: the router matches in
    # order and "batch" must not bind as a tenant id (the image/text
    # batch routes follow the same rule)
    r.add("POST", "/v1/ingest/audio/batch/{tenant_id}", h.ingest_audio_batch)
    r.add("POST", "/v1/ingest/audio/{tenant_id}/{record_id}", h.ingest_audio)
    r.add(
        "POST",
        "/v1/ingest/audio/{tenant_id}/{record_id}/stream",
        h.ingest_audio_stream,
        streaming=True,
    )
    # dedicated watermark route (reference mod.rs:156-159)
    r.add(
        "POST",
        "/v1/ingest/audio/{tenant_id}/{record_id}/watermark",
        h.ingest_audio_watermark,
    )
    # dashboard accounts (reference web/src/routes/api/auth/*)
    r.add("POST", "/v1/auth/signup", h.auth_signup, protected=False)
    r.add("POST", "/v1/auth/login", h.auth_login, protected=False)
    r.add("POST", "/v1/auth/logout", h.auth_logout, protected=False)
    r.add("GET", "/v1/auth/whoami", h.auth_whoami)
    r.add("POST", "/v1/admin/keys", h.admin_create_key)
    r.add("GET", "/v1/admin/keys", h.admin_list_keys)
    r.add("DELETE", "/v1/admin/keys/{key_id}", h.admin_revoke_key)
    r.add("GET", "/v1/admin/usage", h.admin_usage)
    r.add("POST", "/v1/admin/compact", h.admin_compact)
    r.add("POST", "/v1/inputs", h.inputs_put_ctx)
    r.add("POST", "/v1/inputs/{tenant_id}", h.inputs_put)
    r.add("DELETE", "/v1/inputs/{tenant_id}/{input_id}", h.inputs_delete)
    r.add("POST", "/v1/pipeline/inspect/text", h.inspect_text)
    r.add("POST", "/v1/pipeline/inspect/image", h.inspect_image)
    r.add("POST", "/v1/pipeline/inspect/audio", h.inspect_audio)
    # reference path shapes carry the tenant in the path (mod.rs:176-193)
    r.add("POST", "/v1/pipeline/inspect/text/{tenant_id}", h.inspect_text)
    r.add("POST", "/v1/pipeline/inspect/image/{tenant_id}", h.inspect_image)
    r.add("POST", "/v1/pipeline/inspect/audio/{tenant_id}", h.inspect_audio)

    server: HttpServer = HttpServer(
        r,
        body_limit=body_limit or int(os.environ.get("UCFP_BODY_LIMIT_MB", "16")) * 1024 * 1024,
        timeout_secs=timeout_secs
        or float(os.environ.get("UCFP_REQUEST_TIMEOUT_SECS", "10")),
    )

    async def metrics_handler(req: Request) -> Response:
        return Response.text(
            server.metrics.render(), content_type="text/plain; version=0.0.4"
        )

    r.add("GET", "/metrics", metrics_handler, protected=False)

    # per-key minute/day budgets (reference web KV counters) + per-IP
    # limits on the public auth routes (signup burns 2 PBKDF2-100k
    # hashes on a one-core host; the reference demo path is 60/min/IP)
    key_quota = FixedWindowLimiter()
    auth_ip_rpm = int(os.environ.get("UCFP_AUTH_IP_RPM", "30"))
    demo_rpm = int(os.environ.get("UCFP_DEMO_RPM", "60"))

    async def middleware(req: Request, handler, protected: bool) -> Response:
        if not protected:
            if req.path.startswith("/v1/auth/") and req.method == "POST":
                d = key_quota.check(f"ip:{req.remote_addr}", auth_ip_rpm)
                if not d.allowed:
                    raise HttpError(
                        429, "rate_limited", "auth rate limit exceeded",
                        headers={"retry-after": str(max(1, d.retry_after_ms // 1000))},
                    )
            elif req.path == "/v1/demo/fingerprint":
                # reference demo limit: 60/min/IP (ratelimit.ts:10-80)
                if demo_rpm <= 0:
                    raise HttpError(404, "not_found", "demo is disabled")
                if state.challenge is not None:
                    # anonymous-abuse challenge (reference turnstile.ts:
                    # anonymous ingest requires a CAPTCHA token + the IP
                    # limit). Token rides a header; the Turnstile client
                    # field name is accepted as an alias.
                    tok = (req.headers.get("x-challenge-token")
                           or req.headers.get("cf-turnstile-response", ""))
                    if not tok:
                        raise HttpError(
                            403, "challenge_required",
                            "demo requires a challenge token "
                            "(x-challenge-token header)",
                        )
                    if not await state.challenge(tok, req.remote_addr):
                        raise HttpError(
                            403, "challenge_failed",
                            "challenge verification failed",
                        )
                d = key_quota.check(f"demo:{req.remote_addr}", demo_rpm)
                if not d.allowed:
                    raise HttpError(
                        429, "rate_limited", "demo rate limit exceeded",
                        headers={"retry-after": str(max(1, d.retry_after_ms // 1000))},
                    )
            return await handler(req)
        # bearer parse -> lookup (mod.rs:310-330); a dashboard session
        # cookie is an accepted alternative, scoped to its tenant
        authz = req.headers.get("authorization", "")
        ctx = None
        if authz.lower().startswith("bearer "):
            ctx = await state.api_keys.lookup(authz[7:].strip())
            if ctx is None:
                raise HttpError(401, "unauthorized", "unknown API key")
        elif req.headers.get("x-api-key"):
            # X-Api-Key fallback transport for callers that cannot set
            # Authorization (reference docs/authentication.md); Bearer
            # wins when both are present
            ctx = await state.api_keys.lookup(req.headers["x-api-key"].strip())
            if ctx is None:
                raise HttpError(401, "unauthorized", "unknown API key")
        elif state.accounts is not None:
            from .auth import ApiKeyContext
            from .handlers import session_token

            tok = session_token(req)
            sess = state.accounts.resolve(tok) if tok else None
            if sess is not None:
                ctx = ApiKeyContext(
                    tenant_id=sess["tenant_id"],
                    key_id=f"session:{sess['email']}",
                )
        if ctx is None:
            raise HttpError(401, "unauthorized", "missing bearer token")
        # scope gate: keys issued with explicit scopes may only touch
        # their route families; empty scopes = unrestricted (web
        # docs/error-codes: 403 on scope mismatch)
        from .auth import required_scope, scope_allows

        if not scope_allows(ctx, req.path):
            raise HttpError(
                403, "forbidden",
                f"key lacks the {required_scope(req.path)!r} scope",
            )
        # rate check (mod.rs:332-345)
        decision = await state.rate_limit.check(ctx.tenant_id, ctx.rate_class)
        if not decision.allowed:
            raise HttpError(
                429,
                "rate_limited",
                "tenant rate limit exceeded",
                headers={
                    "retry-after": str(max(1, decision.retry_after_ms // 1000)),
                    **({"x-ratelimit-limit": str(decision.limit)}
                       if decision.limit else {}),
                    "x-ratelimit-remaining": "0",
                },
            )
        # per-key budget on top of the tenant bucket (ratelimit.ts:10-80:
        # minute window + daily quota; a key may exhaust its own budget
        # without touching the tenant's)
        if ctx.rate_limit_per_min or ctx.daily_quota:
            kd = key_quota.check(
                f"key:{ctx.key_id}", ctx.rate_limit_per_min, ctx.daily_quota
            )
            if not kd.allowed:
                raise HttpError(
                    429,
                    "rate_limited",
                    "API key rate limit exceeded",
                    headers={
                        "retry-after": str(max(1, kd.retry_after_ms // 1000)),
                        **({"x-ratelimit-limit": str(kd.limit)}
                           if kd.limit else {}),
                        "x-ratelimit-remaining": "0",
                    },
                )
            decision = kd if kd.remaining < decision.remaining else decision
        req.extensions["api_key"] = ctx
        start = time.monotonic()
        status = 500
        try:
            resp = await handler(req)
            status = resp.status
            # expose the token-bucket state like the reference's
            # RateDecision::Allow{remaining, reset_ms}
            resp.headers.setdefault("x-ratelimit-remaining", str(decision.remaining))
            resp.headers.setdefault("x-ratelimit-reset-ms", str(decision.reset_ms))
            if decision.limit:
                resp.headers.setdefault("x-ratelimit-limit", str(decision.limit))
            return resp
        except HttpError as e:
            status = e.status
            raise
        except asyncio.CancelledError:
            # the request-timeout wait_for cancels the middleware; the
            # HTTP layer answers 408 — meter it as such, not as a 500
            status = 408
            raise
        except Exception as e:
            status = getattr(e, "http_status", 500)
            raise
        finally:
            op = UsageOp.DESCRIBE
            if req.method in ("PUT", "POST"):
                for prefix, o in _OP_BY_PREFIX:
                    if req.path.startswith(prefix):
                        op = o
                        break
            elif req.method == "DELETE":
                op = UsageOp.DELETE
            # modality/algorithm (usage.rs:49-81 populates both; the
            # dashboard usage view groups on them). Handlers set the
            # resolved pair in extensions; the path is the fallback.
            modality = req.extensions.get("usage_modality")
            algorithm = req.extensions.get("usage_algorithm")
            if modality is None and req.path.startswith("/v1/ingest/"):
                seg = req.path.split("/")
                modality = seg[3] if len(seg) > 3 else None
                algorithm = algorithm or req.query.get("algorithm")
            stream = req.extensions.get("body_stream")
            ev = UsageEvent(
                tenant_id=ctx.tenant_id,
                key_id=ctx.key_id,
                op=op,
                modality=modality,
                algorithm=algorithm,
                # streamed requests carry body=b''; meter what the
                # handler actually consumed off the socket
                bytes_in=stream.consumed if stream is not None else len(req.body),
                elapsed_ms=(time.monotonic() - start) * 1000.0,
                status=status,
                ts=now_ms(),
            )
            # fire-and-forget (mod.rs:396-409); hold a strong reference —
            # the loop keeps only a weak one and GC could drop the task
            # before it runs, silently losing metering events
            task = asyncio.get_running_loop().create_task(state.usage.record(ev))
            _usage_tasks.add(task)
            task.add_done_callback(_usage_tasks.discard)

    server.middleware = middleware
    return server


def state_from_env(
    data_dir: Optional[str] = None,
    token: Optional[str] = None,
    keys_file: Optional[str] = None,
    usage_log: Optional[str] = None,
    rate: Optional[float] = None,
    burst: Optional[float] = None,
    index=None,
    keystore=None,
    accounts=None,
    device=None,
    inputs=None,
) -> ServerState:
    """Env-driven composition with the reference's precedence and
    refuse-if-no-auth rule (bin/ucfp.rs:106-205).

    index/keystore/accounts/inputs override the locally-opened stores:
    the multi-worker front passes Remote* proxies (server/ipc.py), so
    only the owner process opens the data directory and holds the card.
    The index opens on `device` (the CUDA card by default) and shards as
    the reference does on a CUDA device with at least two cards
    (UCFP_SHARD, UCFP_MESH_SHAPE; EmbeddedBackend's mesh rule); a CPU
    device never shards."""
    data_dir = data_dir or os.environ.get("UCFP_DATA_DIR", "./ucfp-data")
    # auth precedence: UCFP_KEY_LOOKUP_URL > UCFP_KEYS_FILE > UCFP_TOKEN,
    # else refuse (bin/ucfp.rs:106-148)
    key_url = os.environ.get("UCFP_KEY_LOOKUP_URL")
    keys_file = keys_file or os.environ.get("UCFP_KEYS_FILE")
    token = token or os.environ.get("UCFP_TOKEN")
    if key_url:
        from .auth import WebhookKeyLookup
        from .webhooks import key_lookup_fetch

        api_keys: ApiKeyLookup = WebhookKeyLookup(key_lookup_fetch(key_url))
    elif keys_file:
        api_keys = StaticMapKey.from_file(keys_file)
    elif token:
        api_keys = StaticSingleKey(token)
    else:
        raise SystemExit(
            "refusing to start without auth: set UCFP_KEY_LOOKUP_URL, "
            "UCFP_KEYS_FILE or UCFP_TOKEN"
        )
    # rate limiting: webhook | in-memory token bucket (bin/ucfp.rs:151-174)
    rate_url = os.environ.get("UCFP_RATELIMIT_URL")
    rate = rate if rate is not None else float(os.environ.get("UCFP_RATELIMIT_RPS", "100"))
    burst = burst if burst is not None else float(os.environ.get("UCFP_RATELIMIT_BURST", "200"))
    if rate_url:
        from .ratelimit import WebhookRateLimiter
        from .webhooks import ratelimit_fetch

        rate_limit: TenantRateLimiter = WebhookRateLimiter(
            ratelimit_fetch(rate_url)
        )
    else:
        rate_limit = (
            NoopRateLimiter() if rate <= 0 else InMemoryTokenBucket(rate, burst)
        )
    # usage: webhook | NDJSON log | noop (bin/ucfp.rs:177-205)
    usage_url = os.environ.get("UCFP_USAGE_WEBHOOK_URL")
    usage_log = usage_log or os.environ.get("UCFP_USAGE_LOG_PATH")
    if usage_url:
        from .usage import WebhookUsageSink
        from .webhooks import usage_post

        usage: UsageSink = WebhookUsageSink(usage_post(usage_url))
    elif usage_log:
        usage = LogUsageSink(usage_log)
    else:
        usage = NoopUsageSink()
    # issued keys live beside the index; the static service bearer and
    # issued tenant keys compose (first match wins)
    from .keystore import CompositeKeyLookup, PersistentKeyStore

    if keystore is None:
        keystore = PersistentKeyStore(os.path.join(data_dir, "keys.json"))
    composite = CompositeKeyLookup(api_keys, keystore)
    if accounts is None:
        from .accounts import AccountStore

        # signup tenant assignment must skip ids that API keys already
        # name (keys file / service bearer / issued keys) — a collision
        # would put two principals in one data namespace. Live closure:
        # a key issued after boot is reserved too.
        accounts = AccountStore(
            os.path.join(data_dir, "accounts.json"),
            reserved_tenants=composite.known_tenant_ids,
        )
    # anonymous demo challenge: webhook verifier, default off
    # (self-hosted divergence note in docs/api-reference.md)
    challenge_url = os.environ.get("UCFP_DEMO_CHALLENGE_URL")
    challenge = None
    if challenge_url:
        from .webhooks import challenge_verify_fetch

        challenge = challenge_verify_fetch(
            challenge_url, os.environ.get("UCFP_DEMO_CHALLENGE_SECRET", "")
        )
    return ServerState(
        index=(index if index is not None
               else EmbeddedBackend(data_dir, device=device)),
        api_keys=composite,
        rate_limit=rate_limit,
        usage=usage,
        inputs=inputs if inputs is not None else InputsCache(),
        keystore=keystore,
        accounts=accounts,
        challenge=challenge,
    )


async def run(bind: str, state: ServerState, native_http: bool | None = None,
              reuse_port: bool = False) -> None:
    """Serve until SIGTERM/SIGINT, then drain in-flight requests inside
    UCFP_DRAIN_SECS and close the index (WAL flushed). Starts the boot
    warm-up unless UCFP_WARMUP=0; native_http (default: UCFP_HTTP=native)
    serves through the C++ epoll front; reuse_port binds with
    SO_REUSEPORT (the multi-worker front's workers)."""
    import signal

    from .logging import logger

    host, _, port = bind.rpartition(":")
    host = host or "127.0.0.1"
    server = build_server(state)
    if os.environ.get("UCFP_WARMUP", "1") != "0":
        # the first load of each kernel library, the first launch of each
        # fused scan and the cuBLAS handle, off the request path
        from .warmup import start_background_warmup

        start_background_warmup(state.index.device)
    if native_http is None:
        native_http = os.environ.get("UCFP_HTTP", "").lower() == "native"
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass
    drain_secs = float(os.environ.get("UCFP_DRAIN_SECS", "10"))
    shards = getattr(state.index, "_n_shards", lambda: 1)()
    if native_http:
        from .nativehttp import NativeHttpBridge

        bridge = NativeHttpBridge(server, host, int(port))
        logger().info("serving", front="native-epoll", port=bridge.port,
                      device=str(state.index.device), shards=shards)
        serve_task = asyncio.create_task(bridge.serve_forever())
        await stop.wait()
        logger().info("draining", deadline_s=drain_secs)
        # pause keeps the native server alive so in-flight handlers can
        # still respond; stop() frees it after the drain
        await asyncio.to_thread(bridge.pause)
        ok = await server.drain(drain_secs)
        bridge.stop()
    else:
        srv = await server.serve(host, int(port), reuse_port=reuse_port)
        logger().info("serving", front="asyncio", port=int(port),
                      device=str(state.index.device), shards=shards)
        serve_task = asyncio.create_task(srv.serve_forever())
        await stop.wait()
        logger().info("draining", deadline_s=drain_secs)
        srv.close()  # stop accepting; existing connections continue
        ok = await server.drain(drain_secs)
        try:
            await asyncio.wait_for(srv.wait_closed(), timeout=5.0)
        except asyncio.TimeoutError:  # pragma: no cover - defensive
            pass
    serve_task.cancel()
    try:
        await serve_task
    except (asyncio.CancelledError, Exception):
        pass
    try:
        state.index.close()
    except Exception as e:  # pragma: no cover - close must not flip exit 0
        logger().warn("index_close_failed", error=str(e))
    logger().info("stopped", drained=ok, kernel_launches=kernel_launches())
    logger().close()


def kernel_launches() -> int:
    """This process's CUDA kernel launches since boot, summed over every
    kernel wrapper's count (0 in a process that never held the card)."""
    from ..ops import fused_scan, int2_scan, int4_scan, sketch_scan
    from ..ops.audio import haitsma

    return sum(n for mod in (fused_scan, int4_scan, int2_scan, sketch_scan, haitsma)
               for n in mod.LAUNCHES.values())
