"""Server composition for the text, image, vector and audio routes (port
of ucfp_tpu/server/app.py).

  * public: /healthz
  * protected routes behind the auth middleware: bearer (or X-Api-Key)
    -> ApiKeyLookup (401) -> key scope gate (403) -> handler
  * auth from --token / UCFP_TOKEN or --keys-file / UCFP_KEYS_FILE,
    refusing to start without one

Run: python -m ucfp_tpu_torch.server --bind 127.0.0.1:8080 --token t --data-dir d
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass
from typing import Optional

from ..index.embedded import EmbeddedBackend
from .auth import ApiKeyLookup, StaticMapKey, StaticSingleKey, required_scope, scope_allows
from .handlers import Handlers
from .http import HttpError, HttpServer, Request, Response, Router


@dataclass
class ServerState:
    index: EmbeddedBackend
    api_keys: ApiKeyLookup


def build_server(
    state: ServerState,
    body_limit: Optional[int] = None,
    timeout_secs: Optional[float] = None,
) -> HttpServer:
    h = Handlers(state.index)
    r = Router()
    r.add("GET", "/healthz", h.healthz, protected=False)
    r.add("PUT", "/v1/records", h.upsert_records)
    r.add("POST", "/v1/records", h.upsert_records)
    r.add("GET", "/v1/records/{tenant_id}", h.list_records)
    r.add("GET", "/v1/records/{tenant_id}/{record_id}", h.describe_record)
    r.add("DELETE", "/v1/records/{tenant_id}/{record_id}", h.delete_record)
    r.add("POST", "/v1/query", h.query)
    # literal-segment routes register BEFORE their parameterized shadows:
    # the router matches in order, so "batch" must not bind as a tenant id
    r.add("POST", "/v1/ingest/text/batch/{tenant_id}", h.ingest_text_batch)
    r.add("POST", "/v1/ingest/text/{tenant_id}/{record_id}", h.ingest_text)
    r.add("POST", "/v1/ingest/text/{tenant_id}/{record_id}/stream",
          h.ingest_text_stream, streaming=True)
    r.add("POST", "/v1/ingest/image/batch/{tenant_id}", h.ingest_image_batch)
    r.add("POST", "/v1/ingest/embedding/batch/{tenant_id}",
          h.ingest_embedding_batch)
    r.add("POST", "/v1/ingest/image/{tenant_id}/{record_id}", h.ingest_image)
    r.add("POST", "/v1/ingest/image/{tenant_id}/{record_id}/semantic",
          h.ingest_image_semantic)
    r.add("POST", "/v1/ingest/text/{tenant_id}/{record_id}/preprocess/{kind}",
          h.ingest_text_preprocess)
    r.add("POST", "/v1/ingest/audio/batch/{tenant_id}", h.ingest_audio_batch)
    r.add("POST", "/v1/ingest/audio/{tenant_id}/{record_id}", h.ingest_audio)
    r.add("POST", "/v1/ingest/audio/{tenant_id}/{record_id}/stream",
          h.ingest_audio_stream, streaming=True)
    r.add("POST", "/v1/ingest/audio/{tenant_id}/{record_id}/watermark",
          h.ingest_audio_watermark)
    r.add("POST", "/v1/pipeline/inspect/audio", h.inspect_audio)
    r.add("POST", "/v1/pipeline/inspect/audio/{tenant_id}", h.inspect_audio)

    server = HttpServer(
        r,
        body_limit=body_limit or int(os.environ.get("UCFP_BODY_LIMIT_MB", "16")) * 1024 * 1024,
        timeout_secs=timeout_secs
        or float(os.environ.get("UCFP_REQUEST_TIMEOUT_SECS", "10")),
    )

    async def middleware(req: Request, handler, protected: bool) -> Response:
        if not protected:
            return await handler(req)
        # bearer parse -> lookup; X-Api-Key is the fallback transport
        authz = req.headers.get("authorization", "")
        ctx = None
        if authz.lower().startswith("bearer "):
            ctx = await state.api_keys.lookup(authz[7:].strip())
            if ctx is None:
                raise HttpError(401, "unauthorized", "unknown API key")
        elif req.headers.get("x-api-key"):
            ctx = await state.api_keys.lookup(req.headers["x-api-key"].strip())
            if ctx is None:
                raise HttpError(401, "unauthorized", "unknown API key")
        if ctx is None:
            raise HttpError(401, "unauthorized", "missing bearer token")
        # keys issued with explicit scopes may only touch their route
        # families; empty scopes = unrestricted
        if not scope_allows(ctx, req.path):
            raise HttpError(
                403, "forbidden",
                f"key lacks the {required_scope(req.path)!r} scope",
            )
        req.extensions["api_key"] = ctx
        return await handler(req)

    server.middleware = middleware
    return server


def state_from_env(
    data_dir: Optional[str] = None,
    token: Optional[str] = None,
    keys_file: Optional[str] = None,
    device=None,
) -> ServerState:
    """UCFP_KEYS_FILE > UCFP_TOKEN, else refuse to start. The index shards
    as the reference does on a CUDA device with at least two cards
    (UCFP_SHARD, UCFP_MESH_SHAPE; EmbeddedBackend's mesh rule); a CPU
    device never shards."""
    data_dir = data_dir or os.environ.get("UCFP_DATA_DIR", "./ucfp-data")
    keys_file = keys_file or os.environ.get("UCFP_KEYS_FILE")
    token = token or os.environ.get("UCFP_TOKEN")
    if keys_file:
        api_keys: ApiKeyLookup = StaticMapKey.from_file(keys_file)
    elif token:
        api_keys = StaticSingleKey(token)
    else:
        raise SystemExit(
            "refusing to start without auth: set UCFP_KEYS_FILE or UCFP_TOKEN"
        )
    return ServerState(index=EmbeddedBackend(data_dir, device=device),
                       api_keys=api_keys)


async def run(bind: str, state: ServerState) -> None:
    """Serve until SIGTERM/SIGINT, then drain in-flight requests inside
    UCFP_DRAIN_SECS and close the index (WAL flushed)."""
    import signal

    from .logging import logger

    host, _, port = bind.rpartition(":")
    host = host or "127.0.0.1"
    server = build_server(state)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass
    drain_secs = float(os.environ.get("UCFP_DRAIN_SECS", "10"))
    srv = await server.serve(host, int(port))
    logger().info("serving", front="asyncio", port=int(port),
                  device=str(state.index.device), shards=state.index._n_shards())
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
    logger().info("stopped", drained=ok)
    logger().close()
