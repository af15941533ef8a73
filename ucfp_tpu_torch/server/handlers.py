"""Endpoint logic for the image + vector slice (port of ucfp_tpu/server/handlers.py).

Routes, each answering with the same status and the same JSON bytes as
the reference for the same request:
  public:    GET  /healthz
  protected: PUT|POST /v1/records                  raw Record upsert
             GET  /v1/records/{tid}                list (insertion order)
             GET  /v1/records/{tid}/{rid}          describe (metadata)
             DELETE /v1/records/{tid}/{rid}
             POST /v1/query                        vector / vectors /
                                                   fingerprint_hex /
                                                   fingerprints_hex
             POST /v1/ingest/image/{tid}/{rid}     ?algorithm=multi|phash|dhash|ahash
             POST /v1/ingest/image/batch/{tid}     framed images, one device batch
             POST /v1/ingest/embedding/batch/{tid} framed f32 rows
             POST /v1/ingest/audio/{tid}/{rid}     ?algorithm=wang|panako|haitsma|watermark
             POST /v1/ingest/audio/{tid}/{rid}/watermark
             POST /v1/ingest/audio/batch/{tid}     framed PCM clips, one device
                                                   pass per equal-length group

Image hashing and the audio fingerprints run on the backend's device.
Query shapes and routes that need what this build does not serve yet
(BM25 terms, LSH fingerprints, the embedding reranker, semantic image
ingest, the neural audio embedder, the audio stream route, the audio
inspector) answer 501.

tenant_guard: a key with tenant 0 is the service bearer and may touch any
tenant; any other key must match the path/body tenant exactly or gets 403.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional

import numpy as np

from ..core import (
    ForbiddenError,
    Hit,
    Modality,
    Query,
    Record,
    RecordNotFound,
    UcfpError,
)
from ..index.embedded import LATER_SLICE_ALGOS, EmbeddedBackend
from ..matcher import Matcher
from ..modality import audio as amod
from ..modality import image as imod
from ..ops.audio.constellation import PanakoConfig, WangConfig
from ..ops.audio.haitsma import HaitsmaConfig
from ..ops import imagehash
from .auth import ApiKeyContext
from .http import HttpError, Request, Response

SERVICE_TENANT = 0
# batched /v1/query cap: the scans materialize [Q, C] score matrices
MAX_QUERY_BATCH = 256
MAX_QUERY_K = 10_000
# embedding batch route row cap: 4096 x 768-d f32 rows = ~12.6 MB,
# inside the 16 MiB body limit with framing headroom
MAX_EMB_BATCH = 4096
ALGORITHM_SEMANTIC_LOCAL = "embedding-local"  # text semantic tag

# friendly algorithm ids -> the canonical tags records are stored under
# (the reference's map, every modality: a query must canonicalize the
# same aliases even where this build then answers 501)
FP_QUERY_ALGO_ALIASES = {
    "phash": imod.ALGORITHM_PHASH,
    "dhash": imod.ALGORITHM_DHASH,
    "ahash": imod.ALGORITHM_AHASH,
    "multi": imod.ALGORITHM_MULTI,
    "wang": "audiofp-wang-v1",
    "panako": "audiofp-panako-v1",
    "haitsma": "audiofp-haitsma-v1",
    "lsh": "minhash-lsh-h128",
    "minhash": "minhash-h128",
    "simhash-tf": "simhash-b64-tf",
    "simhash-idf": "simhash-b64-idf",
    "tlsh": "tlsh-128-1",
}


def _ctx(req: Request) -> ApiKeyContext:
    return req.extensions["api_key"]


def tenant_guard(ctx: ApiKeyContext, tenant_id: int) -> None:
    """Service bearer (tenant 0) may touch any tenant."""
    if ctx.tenant_id != SERVICE_TENANT and ctx.tenant_id != tenant_id:
        raise ForbiddenError(
            f"key for tenant {ctx.tenant_id} may not access tenant {tenant_id}"
        )


def _hash_image_group(algo: str, gray: np.ndarray, h: int, w: int,
                      count: int, device) -> list[bytes]:
    """One device hash launch for `count` same-shape luma images
    [N, H, W] u8 — the single implementation behind both the deadline
    batcher and the bulk ingest route. Small single-hash and camera-size
    multi inputs are first resized on the host with the exact fixed-point
    tent (byte-identical to the device stage), so fewer bytes cross to the
    device."""
    if algo != "multi" and (h, w) != imod.SINGLE_HASH_INPUT[algo]:
        th, tw = imod.SINGLE_HASH_INPUT[algo]
        gray = imod.resize_gray_batch(gray, th, tw)
        h, w = th, tw
    if algo == "multi":
        if h * w > imod.MULTI_PRE_THRESHOLD:
            out = imod.device_get(imagehash.multihash_kernel_pre(
                *imod.multi_pre_planes(gray), device=device))
        else:
            out = imod.device_get(imagehash.multihash_kernel_gray(
                gray, h, w, device=device))
        return [imagehash.serialize_multihash(out, i) for i in range(count)]
    return _hash_single_rows(algo, gray, h, w, count, device)


def _hash_single_rows(algo: str, gray: np.ndarray, h: int, w: int,
                      count: int, device) -> list[bytes]:
    """One single-hash launch over target-shape luma rows [count, H, W]."""
    out = imod.device_get(
        imagehash.single_hash_kernel_gray(gray, h, w, algo, device=device))
    return [bytes(out[i]) for i in range(count)]


def _err(e: UcfpError) -> HttpError:
    return HttpError(e.http_status, e.code, e.message)


def _path_ids(req: Request) -> tuple[int, int]:
    try:
        return int(req.params["tenant_id"]), int(req.params["record_id"])
    except (KeyError, ValueError):
        raise HttpError(400, "bad_path", "tenant_id/record_id must be integers")


def _path_tenant(req: Request) -> int:
    """Tenant-only path guard for the batch routes."""
    try:
        tid = int(req.params["tenant_id"])
    except (KeyError, ValueError):
        raise HttpError(400, "bad_path", "tenant_id must be an integer")
    if not (0 <= tid < 2**32):
        raise HttpError(400, "bad_path", "tenant_id must fit u32")
    return tid


def _algo_gate(algorithm_id: str) -> None:
    """Per-algorithm disable switch: UCFP_DISABLED_ALGORITHMS, a comma
    list of algorithm ids, answers 501."""
    import os

    raw = os.environ.get("UCFP_DISABLED_ALGORITHMS", "")
    if not raw:
        return
    disabled = {a.strip() for a in raw.split(",") if a.strip()}
    if algorithm_id in disabled:
        raise HttpError(
            501, "unsupported",
            f"algorithm {algorithm_id!r} is disabled in this deployment "
            f"(listed in UCFP_DISABLED_ALGORITHMS)",
        )


def _not_served(what: str) -> HttpError:
    return HttpError(501, "unsupported", f"{what} is not served by this build yet")


def _audio_pcm(req: Request, raw) -> np.ndarray:
    """Decode a raw PCM body per ?encoding= (f32 default, s16 the
    half-the-bytes wire for 16-bit-sourced audio, value-identical)."""
    enc = req.query.get("encoding", "f32")
    try:
        if enc == "f32":
            return amod.decode_f32le(raw)
        if enc == "s16":
            return amod.decode_s16le(raw)
    except UcfpError as e:
        raise _err(e)
    raise HttpError(400, "bad_query", "encoding must be f32 or s16")


def _ingest_response(rec: Record) -> Response:
    body = {
        "tenant_id": rec.tenant_id,
        "record_id": rec.record_id,
        "modality": rec.modality.value,
        "format_version": rec.format_version,
        "algorithm": rec.algorithm,
        "config_hash": rec.config_hash,
        "fingerprint_bytes": len(rec.fingerprint),
        "fingerprint_hex": rec.fingerprint.hex(),
        "has_embedding": rec.embedding is not None,
    }
    return Response.json(body, status=201)


class Handlers:
    def __init__(self, index: EmbeddedBackend):
        self.index = index
        self.device = index.device
        self.matcher = Matcher(index)
        # cross-request device batching for image hashing: concurrent
        # same-shape decodes share one kernel launch (2 ms deadline,
        # 64-image batches)
        from ..ingest.batcher import DeadlineBatcher

        async def _run_image_batch(bucket, payloads):
            algo, h, w = bucket
            stacked = np.stack(payloads)
            return await asyncio.to_thread(
                _hash_image_group, algo, stacked, h, w, len(payloads),
                self.device)

        self.image_batcher = DeadlineBatcher(_run_image_batch, max_batch=64,
                                             max_delay_ms=2.0)

    # -- public ---------------------------------------------------------------

    async def healthz(self, req: Request) -> Response:
        try:
            await self.index.flush()  # index ping
        except Exception as e:
            raise HttpError(503, "unhealthy", str(e))
        return Response.json({"status": "ok"})

    # -- records ----------------------------------------------------------------

    @staticmethod
    def _valid_embedding(emb) -> Optional[list[float]]:
        """Embeddings must be flat lists of finite numbers BEFORE the WAL
        append."""
        if emb is None:
            return None
        if not isinstance(emb, list) or not emb:
            raise ValueError("embedding must be a non-empty array of numbers")
        if not set(map(type, emb)) <= {int, float}:
            raise ValueError("embedding entries must be numbers")
        arr = np.asarray(emb, np.float64)
        if not np.isfinite(arr).all():
            raise ValueError("embedding entries must be finite")
        return arr.tolist()

    @staticmethod
    def _valid_vector(vec, name: str):
        """Query vectors must be flat numeric lists (400, not 500)."""
        if vec is None:
            return None
        if not isinstance(vec, list) or not set(map(type, vec)) <= {int, float}:
            raise HttpError(400, "bad_query", f"{name} must be a list of numbers")
        return vec

    async def upsert_records(self, req: Request) -> Response:
        body = req.json()
        # {"records": [...]}; a bare record object or bare array too
        if isinstance(body, dict) and "records" in body:
            items = body["records"]
            if not isinstance(items, list):
                raise HttpError(400, "bad_record", "records must be an array")
        else:
            items = body if isinstance(body, list) else [body]
        recs = []
        for r in items:
            try:
                if not isinstance(r, dict):
                    raise ValueError("each record must be an object")
                fp = r["fingerprint"]
                meta = r.get("metadata", [])
                if not isinstance(fp, list) or not isinstance(meta, list):
                    raise ValueError("fingerprint/metadata must be u8 arrays")
                for field in ("tenant_id", "record_id"):
                    if isinstance(r[field], bool) or not isinstance(
                        r[field], int
                    ):
                        raise ValueError(f"{field} must be an integer")
                for field in ("format_version", "config_hash"):
                    v = r.get(field)
                    if v is not None and (
                        isinstance(v, bool) or not isinstance(v, int)
                    ):
                        raise ValueError(f"{field} must be an integer")
                text = r.get("text")
                if text is not None and not isinstance(text, str):
                    raise ValueError("text must be a string")
                rec = Record(
                    tenant_id=r["tenant_id"],
                    record_id=r["record_id"],
                    modality=Modality(r["modality"]),
                    format_version=r.get("format_version", 1),
                    algorithm=r["algorithm"],
                    config_hash=r.get("config_hash", 0),
                    fingerprint=bytes(fp),
                    embedding=self._valid_embedding(r.get("embedding")),
                    model_id=r.get("model_id"),
                    metadata=bytes(meta),
                    text=text,
                )
            except (KeyError, ValueError, TypeError) as e:
                raise HttpError(400, "bad_record", f"invalid record: {e}")
            tenant_guard(_ctx(req), rec.tenant_id)
            recs.append(rec)
        await self.index.upsert(recs)
        return Response.json({"upserted": len(recs)})

    async def list_records(self, req: Request) -> Response:
        """GET /v1/records/{tenant_id}?offset=&limit= — insertion order."""
        try:
            tid = int(req.params["tenant_id"])
        except (KeyError, ValueError):
            raise HttpError(400, "bad_path", "tenant_id must be an integer")
        tenant_guard(_ctx(req), tid)
        offset = max(0, req.qp_int("offset", 0))
        limit = min(max(1, req.qp_int("limit", 50)), 1000)
        rows, total = self.index.list_records(tid, offset, limit)
        return Response.json({
            "records": rows, "total": total,
            "offset": offset, "limit": limit,
        })

    async def describe_record(self, req: Request) -> Response:
        tid, rid = _path_ids(req)
        tenant_guard(_ctx(req), tid)
        try:
            m = await self.index.get_record_metadata(tid, rid)
            row = self.index.get_record(tid, rid)
        except RecordNotFound as e:
            raise _err(e)
        return Response.json(
            {
                "tenant_id": m.tenant_id,
                "record_id": m.record_id,
                "modality": m.modality.value,
                "algorithm": m.algorithm,
                "config_hash": m.config_hash,
                "format_version": m.format_version,
                "fingerprint_bytes": m.fingerprint_bytes,
                "has_embedding": m.has_embedding,
                "embedding_dim": (len(row["embedding"])
                                  if row["embedding"] is not None else 0),
                "metadata_bytes": len(row["metadata"]),
                "model_id": m.model_id,
                **self._describe_includes(req, row),
            }
        )

    @staticmethod
    def _describe_includes(req: Request, row: dict) -> dict:
        raw = req.query.get("include", "")
        if not raw:
            return {}
        out: dict = {}
        for part in raw.split(","):
            part = part.strip()
            if part == "fingerprint":
                out["fingerprint_hex"] = bytes(row["fingerprint"]).hex()
            elif part == "embedding":
                # stored as an np.float32 row: JSON-ify at the edge
                emb = row["embedding"]
                out["embedding"] = (
                    emb if emb is None or isinstance(emb, list)
                    else [float(x) for x in emb]
                )
            elif part:
                raise HttpError(
                    400, "bad_query",
                    f"unknown include {part!r} (valid: fingerprint, embedding)",
                )
        return out

    async def delete_record(self, req: Request) -> Response:
        tid, rid = _path_ids(req)
        tenant_guard(_ctx(req), tid)
        await self.index.delete(tid, [rid])
        return Response.json({"deleted": 1})

    # -- query -------------------------------------------------------------------

    async def query(self, req: Request) -> Response:
        body = req.json()
        try:
            tenant_id = int(body["tenant_id"])
            modality = Modality(body["modality"])
            k = max(1, int(body.get("k", 10)))
            rrf_k = int(body.get("rrf_k", 60))
        except (KeyError, ValueError, TypeError) as e:
            raise HttpError(400, "bad_query", f"invalid query: {e}")
        if k > MAX_QUERY_K:
            raise HttpError(400, "bad_query", f"k must be <= {MAX_QUERY_K}")
        if not (0 <= rrf_k <= 1_000_000):
            raise HttpError(400, "bad_query", "rrf_k must be in [0, 1000000]")
        tenant_guard(_ctx(req), tenant_id)
        flt = body.get("filter")
        if flt is not None:
            # {"algorithm": str, "model_id": str} filters vector hits on
            # the device; anything else surfaces 501
            from ..index.backend import validate_filter

            try:
                validate_filter(flt)
            except UcfpError as e:
                raise _err(e)
            if isinstance(flt.get("algorithm"), str):
                alg_f = FP_QUERY_ALGO_ALIASES.get(flt["algorithm"])
                if flt["algorithm"] == "semantic":
                    alg_f = (imod.ALGORITHM_SEMANTIC
                             if modality == Modality.IMAGE
                             else ALGORITHM_SEMANTIC_LOCAL)
                if alg_f is not None:
                    flt = {**flt, "algorithm": alg_f}
        explain = req.qp_bool("explain")
        from ..core import POOL_FRAC_TIERS

        RECALL_TIERS = {
            "fast": POOL_FRAC_TIERS[0],
            "balanced": POOL_FRAC_TIERS[1],
            "high": None,
            # "exact": the exhaustive scan, never marked approximate
            "exact": None,
        }
        tier = body.get("recall_tier")
        if tier is not None and tier not in RECALL_TIERS:
            raise HttpError(
                400, "bad_query",
                f"recall_tier must be one of {sorted(RECALL_TIERS)}",
            )
        pool_frac = RECALL_TIERS.get(tier) if tier else None
        exact = tier == "exact"
        vector = self._valid_vector(body.get("vector"), "vector")
        terms = body.get("terms") or []
        if not isinstance(terms, list) or not all(
            isinstance(t, str) for t in terms
        ):
            raise HttpError(400, "bad_query", "terms must be a list of strings")
        fp_hex = body.get("fingerprint_hex")
        vectors = body.get("vectors")

        if vectors is not None:
            # batched query: all vectors share one device product
            if not isinstance(vectors, list) or not all(
                isinstance(v, list) for v in vectors
            ):
                raise HttpError(400, "bad_query", "vectors must be a list of vectors")
            vectors = [
                self._valid_vector(v, f"vectors[{i}]")
                for i, v in enumerate(vectors)
            ]
            if len(vectors) > MAX_QUERY_BATCH:
                raise HttpError(
                    400, "bad_query",
                    f"at most {MAX_QUERY_BATCH} vectors per batch",
                )
            try:
                results = await self.index.knn_batch(
                    tenant_id, vectors, k, filter=flt, exact=exact
                )
            except UcfpError as e:
                raise _err(e)
            out = {
                "results": [
                    {"hits": [self._hit_out(tenant_id, h) for h in hits]}
                    for hits in results
                ]
            }
            if vectors and self.index.knn_is_approximate(
                tenant_id, len(vectors[0]), k, batch=True, exact=exact,
                batch_q=len(vectors), filtered=flt is not None,
            ):
                out["approximate"] = True  # fused candidates or an int4/int2 pool
            return Response.json(out)

        fps_hex = body.get("fingerprints_hex")
        if flt is not None and (fps_hex is not None or fp_hex is not None):
            raise HttpError(
                501, "unsupported",
                "filters apply to vector/terms queries only",
            )
        if fps_hex is not None:
            algorithm = body.get("algorithm")
            if not algorithm:
                raise HttpError(
                    400, "bad_query", "fingerprints_hex queries require algorithm"
                )
            algorithm = FP_QUERY_ALGO_ALIASES.get(algorithm, algorithm)
            if not isinstance(fps_hex, list) or not all(
                isinstance(s, str) for s in fps_hex
            ):
                raise HttpError(
                    400, "bad_query", "fingerprints_hex must be a list of hex strings"
                )
            if len(fps_hex) > MAX_QUERY_BATCH:
                raise HttpError(
                    400, "bad_query",
                    f"at most {MAX_QUERY_BATCH} fingerprints per batch",
                )
            try:
                fps = [bytes.fromhex(s) for s in fps_hex]
            except ValueError:
                raise HttpError(400, "bad_query", "fingerprints_hex entry is not hex")
            if algorithm in LATER_SLICE_ALGOS:
                raise _not_served(f"{algorithm} matching")
            # the single-fingerprint path's routing: landmark offset voting
            # and sliding BER are other metrics than raw Hamming
            if algorithm == imod.ALGORITHM_MULTI:
                results = await self.index.knn_multihash(
                    tenant_id, fps, k, self._multihash_weights(body)
                )
                approx = False
            elif algorithm in (amod.ALGORITHM_WANG, amod.ALGORITHM_PANAKO):
                results = [
                    await self.index.knn_audio(tenant_id, algorithm, fp, k)
                    for fp in fps
                ]
                approx = False
            elif algorithm == amod.ALGORITHM_HAITSMA:
                results = [await self.index.knn_haitsma(tenant_id, fp, k)
                           for fp in fps]
                approx = False
            else:
                approx = self.index.fingerprint_is_approximate(
                    tenant_id, algorithm, k
                )
                results = await self.index.knn_fingerprint_batch(
                    tenant_id, algorithm, fps, k
                )
            out = {
                "results": [
                    {"hits": [self._hit_out(tenant_id, h) for h in hits]}
                    for hits in results
                ]
            }
            if approx:
                out["approximate"] = True
            return Response.json(out)

        approximate = False
        if fp_hex is not None:
            algorithm = body.get("algorithm")
            if not algorithm:
                raise HttpError(
                    400, "bad_query", "fingerprint_hex queries require algorithm"
                )
            algorithm = FP_QUERY_ALGO_ALIASES.get(algorithm, algorithm)
            try:
                fp = bytes.fromhex(fp_hex)
            except ValueError:
                raise HttpError(400, "bad_query", "fingerprint_hex is not hex")
            if algorithm in LATER_SLICE_ALGOS:
                raise _not_served(f"{algorithm} matching")
            if algorithm in (amod.ALGORITHM_WANG, amod.ALGORITHM_PANAKO):
                hits = await self.index.knn_audio(tenant_id, algorithm, fp, k)
            elif algorithm == amod.ALGORITHM_HAITSMA:
                hits = await self.index.knn_haitsma(tenant_id, fp, k)
            elif algorithm == imod.ALGORITHM_MULTI:
                # weighted component comparison: raw Hamming over the
                # 536-byte bundle would XOR f32 histogram bytes
                res = await self.index.knn_multihash(
                    tenant_id, [fp], k, self._multihash_weights(body)
                )
                hits = res[0]
            else:
                approximate = self.index.fingerprint_is_approximate(
                    tenant_id, algorithm, k)
                hits = await self.index.knn_fingerprint(tenant_id, algorithm, fp, k)
        else:
            if req.query.get("rerank") == "embedding":
                raise _not_served("the embedding reranker")
            q = Query(
                tenant_id=tenant_id,
                modality=modality,
                k=k,
                vector=vector,
                terms=list(terms),
                rrf_k=rrf_k,
                explain=explain,
                filter=flt,
                pool_frac=pool_frac,
                exact=exact,
            )
            approximate = bool(vector) and self.index.knn_is_approximate(
                tenant_id, len(vector), k, pool_frac=pool_frac, exact=exact
            )
            hits = await self.matcher.search(q)
        out = {"hits": [self._hit_out(tenant_id, h) for h in hits]}
        if approximate:
            out["approximate"] = True
        return Response.json(out)

    @staticmethod
    def _multihash_weights(body: dict) -> Optional[dict]:
        """MultiHashConfigDto-shaped weights from the query body,
        validated against the manifest bounds."""
        w = body.get("multihash")
        if w is None:
            return None
        if not isinstance(w, dict):
            raise HttpError(400, "bad_query", "multihash must be an object")
        for key, v in w.items():
            if key not in imagehash.MULTIHASH_DEFAULT_WEIGHTS:
                raise HttpError(400, "bad_query", f"unknown multihash knob {key!r}")
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise HttpError(400, "bad_query", f"{key} must be a number")
            hi = 64.0 if key == "block_distance_threshold" else 1.0
            if not (0.0 <= float(v) <= hi):
                raise HttpError(
                    400, "bad_query", f"{key} must be within [0, {hi:g}]"
                )
        return w

    @staticmethod
    def _hit_out(tenant_id: int, h: Hit) -> dict:
        out = {
            "tenant_id": tenant_id,
            "record_id": h.record_id,
            "score": h.score,
            "source": h.source.value,
        }
        if h.vector_score is not None:
            out["vector_score"] = h.vector_score
        if h.bm25_score is not None:
            out["bm25_score"] = h.bm25_score
        if h.vector_rank is not None:
            out["vector_rank"] = h.vector_rank
        if h.bm25_rank is not None:
            out["bm25_rank"] = h.bm25_rank
        return out

    # -- ingest --------------------------------------------------------------------

    @staticmethod
    def _in_range(req: Request, name: str, default, lo, hi, float_=False,
                  alias: Optional[str] = None):
        """Tunables are validated against the manifest's bounds (400).
        `alias` is the reference AudioParams' prefixed spelling
        (panako_* / haitsma_* / watermark_*); it wins when both are
        present."""
        use = name
        if alias is not None and alias in req.query:
            use = alias
        v = req.qp_float(use, default) if float_ else req.qp_int(use, default)
        if v is not None and not (lo <= v <= hi):
            raise HttpError(
                400, "bad_query",
                f"{use} must be within [{lo}, {hi}], got {v}",
            )
        return v

    def _image_pre(self, req: Request) -> imod.PreprocessConfig:
        return imod.PreprocessConfig(
            max_input_bytes=self._in_range(
                req, "max_input_bytes", 50 * 1024 * 1024, 1024, 512 * 1024 * 1024
            ),
            max_dimension=self._in_range(req, "max_dimension", 8192, 64, 16384),
            min_dimension=self._in_range(req, "min_dimension", 32, 1, 1024),
        )

    async def ingest_image(self, req: Request) -> Response:
        tid, rid = _path_ids(req)
        tenant_guard(_ctx(req), tid)
        if req.query.get("input_id"):
            raise _not_served("the inputs cache (?input_id=)")
        raw = req.body
        algorithm = req.query.get("algorithm", "multi")
        _algo_gate(algorithm)
        pre = self._image_pre(req)
        if algorithm == "semantic":
            raise _not_served("semantic image ingest")
        if algorithm not in ("multi", "phash", "dhash", "ahash"):
            raise HttpError(
                400, "bad_algorithm", f"unknown image algorithm {algorithm!r}"
            )
        try:
            # decode off the event loop
            gray = await asyncio.to_thread(imod.decode_gray, raw, pre)
        except UcfpError as e:
            raise _err(e)
        h, w = gray.shape
        fp = await self.image_batcher.submit((algorithm, h, w), gray)
        rec = Record(
            tenant_id=tid,
            record_id=rid,
            modality=Modality.IMAGE,
            algorithm=(imod.ALGORITHM_MULTI if algorithm == "multi"
                       else imod._SINGLE_ALGOS[algorithm]),
            fingerprint=fp,
            config_hash=pre.config_hash(),
        )
        await self.index.upsert([rec])
        return _ingest_response(rec)

    async def ingest_embedding_batch(self, req: Request) -> Response:
        """Many pre-computed embeddings, one request, one WAL run commit.

        Body framing: repeated [u64 LE record_id][u32 LE byte_len]
        [byte_len bytes f32 LE], byte_len identical across rows. Query:
        ?algorithm= (default embedding-local), ?model_id=, ?modality=
        (default text), ?config_hash=. Response: {count, dim, algorithm}.
        Each row's stored fingerprint is its f32-LE bytes."""
        tid = _path_tenant(req)
        tenant_guard(_ctx(req), tid)
        algorithm = req.query.get("algorithm", ALGORITHM_SEMANTIC_LOCAL)
        _algo_gate(algorithm)
        model_id = req.query.get("model_id") or None
        cfg = req.qp_int("config_hash", 0)
        try:
            modality = Modality(req.query.get("modality", "text"))
        except ValueError as e:
            raise HttpError(400, "bad_query", str(e))
        raw = req.body
        if len(raw) < 12:
            raise HttpError(400, "bad_body", "truncated batch frame header")
        _, ln = struct.unpack_from("<QI", raw, 0)
        if ln == 0 or ln % 4 != 0:
            raise HttpError(
                400, "bad_body",
                "row byte length must be a positive multiple of 4 (f32)",
            )
        step = 12 + ln
        if len(raw) % step != 0:
            raise HttpError(
                400, "bad_body",
                "rows must be uniform: body does not tile into "
                f"[u64 rid][u32 len={ln}][{ln} bytes] frames",
            )
        n = len(raw) // step
        if n > MAX_EMB_BATCH:
            raise HttpError(
                400, "bad_body", f"batch exceeds {MAX_EMB_BATCH} rows")
        arr = np.frombuffer(raw, np.uint8).reshape(n, step)
        lens = np.ascontiguousarray(arr[:, 8:12]).view("<u4").ravel()
        if not bool((lens == ln).all()):
            bad = int(np.flatnonzero(lens != ln)[0])
            raise HttpError(
                400, "bad_body",
                f"rows must share one dim: row {bad} has byte_len "
                f"{int(lens[bad])}, row 0 has {ln}",
            )
        rids = [int(r) for r in
                np.ascontiguousarray(arr[:, 0:8]).view("<u8").ravel()]
        mat = np.ascontiguousarray(arr[:, 12:]).view("<f4")
        finite = np.isfinite(mat)
        if not bool(finite.all()):
            bad = int(np.flatnonzero(~finite.all(axis=1))[0])
            raise HttpError(
                400, "bad_body",
                f"embeddings must be finite: row {bad} (record_id "
                f"{rids[bad]}) has a non-finite value",
            )
        try:
            await self.index.upsert_embedding_batch(
                tid, algorithm, rids, mat, modality=modality,
                model_id=model_id, config_hash=cfg,
            )
        except ValueError as e:
            raise HttpError(400, "bad_record", str(e))
        except UcfpError as e:
            raise _err(e)
        return Response.json(
            {"count": n, "dim": ln // 4, "algorithm": algorithm},
            status=201,
        )

    async def ingest_image_batch(self, req: Request) -> Response:
        """Many images, one request, one device batch, one WAL commit.

        Body framing: repeated [u64 LE record_id][u32 LE length][bytes].
        Query: ?algorithm=multi|phash|dhash|ahash (+ preprocess knobs,
        ?quiet=1). Response: {count, algorithm, records: [{record_id,
        fingerprint_hex, fingerprint_bytes}]}."""
        tid = _path_tenant(req)
        tenant_guard(_ctx(req), tid)
        algorithm = req.query.get("algorithm", "multi")
        _algo_gate(algorithm)
        if algorithm not in ("multi", "phash", "dhash", "ahash"):
            raise HttpError(
                400, "bad_algorithm",
                f"batch ingest supports perceptual hashes, not {algorithm!r}",
            )
        pre = self._image_pre(req)
        raw = req.body
        algo_tag = (imod.ALGORITHM_MULTI if algorithm == "multi"
                    else imod._SINGLE_ALGOS[algorithm])

        def work():
            # whole-batch native decode first (uniform fast-path BMPs)
            code, rids, gray = imod.decode_gray_batch(raw, 1024, pre)
            if code == -1:
                raise HttpError(400, "bad_body", "truncated batch frame header")
            if code == -2:
                raise HttpError(400, "bad_body", "truncated batch frame body")
            if code == -3:
                raise HttpError(400, "bad_body", "batch exceeds 1024 images")
            if code == 0:
                n, h, w = gray.shape
                return rids, _hash_image_group(algorithm, gray, h, w, n,
                                               self.device)
            # Python fallback: mixed shapes / non-BMP formats / frames
            # outside the preprocess limits (exact per-image errors)
            mv = memoryview(raw)
            frames: list[tuple[int, memoryview]] = []
            off = 0
            while off < len(raw):
                if off + 12 > len(raw):
                    raise HttpError(
                        400, "bad_body", "truncated batch frame header")
                rid, ln = struct.unpack_from("<QI", raw, off)
                off += 12
                if off + ln > len(raw):
                    raise HttpError(
                        400, "bad_body", "truncated batch frame body")
                frames.append((rid, mv[off:off + ln]))
                off += ln
            if not frames:
                raise HttpError(400, "bad_body", "empty batch")
            if len(frames) > 1024:
                raise HttpError(400, "bad_body", "batch exceeds 1024 images")
            grays = [imod.decode_gray(b, pre) for _, b in frames]
            groups: dict[tuple[int, int], list[int]] = {}
            for i, g in enumerate(grays):
                groups.setdefault(g.shape, []).append(i)
            fps: list[bytes] = [b""] * len(frames)
            for (h, w), idxs in groups.items():
                batch = np.stack([grays[i] for i in idxs])
                hashed = _hash_image_group(algorithm, batch, h, w, len(idxs),
                                           self.device)
                for j, i in enumerate(idxs):
                    fps[i] = hashed[j]
            return [rid for rid, _ in frames], fps

        try:
            rids, fps = await asyncio.to_thread(work)
        except UcfpError as e:
            raise _err(e)
        # columnar upsert: one WAL run append + one vectorized apply
        await self.index.upsert_fingerprint_batch(
            tid, algo_tag, rids, fps, modality=Modality.IMAGE,
            config_hash=pre.config_hash(),
        )
        if req.query.get("quiet") == "1":
            return Response.json(
                {"count": len(rids), "algorithm": algo_tag}, status=201
            )
        return Response.json(
            {
                "count": len(rids),
                "algorithm": algo_tag,
                "records": [
                    {
                        "record_id": rid,
                        "fingerprint_hex": fp.hex(),
                        "fingerprint_bytes": len(fp),
                    }
                    for rid, fp in zip(rids, fps)
                ],
            },
            status=201,
        )

    # -- ingest: audio ---------------------------------------------------------------

    async def ingest_audio_batch(self, req: Request) -> Response:
        """Many clips, one request, one device pass per equal-length group,
        one WAL commit.

        Body framing: repeated [u64 LE record_id][u32 LE length][PCM
        bytes]. Query: ?sample_rate= (required, shared),
        ?algorithm=wang|panako|haitsma (+ the single route's tunables),
        ?encoding=f32|s16, ?quiet=1. Records equal the single route's."""
        tid = _path_tenant(req)
        tenant_guard(_ctx(req), tid)
        sample_rate = req.qp_int("sample_rate", None)
        if sample_rate is None:
            raise HttpError(400, "bad_query", "sample_rate is required")
        algorithm = req.query.get("algorithm", "wang")
        _algo_gate(algorithm)
        if algorithm not in ("wang", "panako", "haitsma"):
            raise HttpError(
                400, "bad_algorithm",
                f"batch ingest supports wang|panako|haitsma, "
                f"not {algorithm!r}",
            )
        cfg = self._audio_cfg(req, algorithm)
        enc = req.query.get("encoding", "f32")
        if enc not in ("f32", "s16"):
            raise HttpError(400, "bad_query", "encoding must be f32 or s16")
        width = 4 if enc == "f32" else 2
        raw = req.body
        mv = memoryview(raw)
        rids: list[int] = []
        clips: list[np.ndarray] = []
        off = 0
        while off < len(raw):
            if off + 12 > len(raw):
                raise HttpError(400, "bad_body",
                                "truncated batch frame header")
            rid, ln = struct.unpack_from("<QI", raw, off)
            off += 12
            if off + ln > len(raw):
                raise HttpError(400, "bad_body",
                                "truncated batch frame body")
            if ln == 0 or ln % width != 0:
                raise HttpError(
                    400, "bad_body",
                    f"clip length must be a non-zero multiple of "
                    f"{width} ({enc} LE)",
                )
            rids.append(rid)
            if enc == "f32":
                clips.append(np.frombuffer(mv[off:off + ln], dtype="<f4")
                             .astype(np.float32))
            else:
                # raw i16 straight through (the batch's s16 fast path)
                clips.append(np.frombuffer(mv[off:off + ln], dtype="<i2"))
            off += ln
        if not rids:
            raise HttpError(400, "bad_body", "empty batch")
        if len(rids) > 256:
            raise HttpError(400, "bad_body", "batch exceeds 256 clips")

        try:
            recs = await asyncio.to_thread(
                amod.fingerprint_audio_batch,
                algorithm, clips, sample_rate, tid, rids, cfg, self.device,
            )
        except UcfpError as e:
            raise _err(e)
        await self.index.upsert(recs)
        if req.query.get("quiet") == "1":
            return Response.json(
                {"count": len(recs), "algorithm": recs[0].algorithm},
                status=201,
            )
        return Response.json(
            {
                "count": len(recs),
                "algorithm": recs[0].algorithm,
                "records": [
                    {
                        "record_id": r.record_id,
                        "fingerprint_hex": r.fingerprint.hex(),
                        "fingerprint_bytes": len(r.fingerprint),
                    }
                    for r in recs
                ],
            },
            status=201,
        )

    def _audio_cfg(self, req: Request, algorithm: str):
        """Classical-audio tunables: the one place the names, defaults,
        ranges and aliases live, for the single and the batch route."""
        if algorithm == "wang":
            return WangConfig(
                fan_out=self._in_range(req, "fan_out", 10, 1, 32),
                target_zone_t=self._in_range(req, "target_zone_t", 63, 1, 256),
                target_zone_f=self._in_range(req, "target_zone_f", 64, 1, 256),
                peaks_per_sec=self._in_range(req, "peaks_per_sec", 30, 1, 120),
                min_anchor_mag_db=self._in_range(
                    req, "min_anchor_mag_db", -50.0, -120.0, 0.0, float_=True
                ),
                local_floor=req.qp_bool("local_floor", False),
            )
        if algorithm == "panako":
            return PanakoConfig(
                fan_out=self._in_range(req, "fan_out", 5, 1, 32,
                                       alias="panako_fan_out"),
                target_zone_t=self._in_range(
                    req, "target_zone_t", 96, 1, 256,
                    alias="panako_target_zone_t"),
                target_zone_f=self._in_range(
                    req, "target_zone_f", 96, 1, 256,
                    alias="panako_target_zone_f"),
                peaks_per_sec=self._in_range(
                    req, "peaks_per_sec", 30, 1, 120,
                    alias="panako_peaks_per_sec"),
                min_anchor_mag_db=self._in_range(
                    req, "min_anchor_mag_db", -50.0, -120.0, 0.0,
                    float_=True, alias="panako_min_anchor_mag_db"),
            )
        return HaitsmaConfig(
            fmin=self._in_range(req, "fmin", 300.0, 50.0, 2000.0,
                                float_=True, alias="haitsma_fmin"),
            fmax=self._in_range(req, "fmax", 2000.0, 500.0, 2500.0,
                                float_=True, alias="haitsma_fmax"),
            # flagged ucfp-int-fft-v1 spectrogram (forks config_hash)
            fft=req.qp_bool("fft", req.qp_bool("haitsma_fft", False)),
        )

    async def ingest_audio(self, req: Request) -> Response:
        tid, rid = _path_ids(req)
        tenant_guard(_ctx(req), tid)
        if req.query.get("input_id"):
            raise _not_served("the inputs cache (?input_id=)")
        sample_rate = req.qp_int("sample_rate", None)
        if sample_rate is None:
            raise HttpError(400, "bad_query", "sample_rate is required")
        algorithm = req.query.get("algorithm", "wang")
        _algo_gate(algorithm)
        samples = _audio_pcm(req, req.body)
        fingerprint = {"wang": amod.fingerprint_wang, "panako": amod.fingerprint_panako,
                       "haitsma": amod.fingerprint_haitsma}.get(algorithm)
        try:
            if fingerprint is not None:
                rec = await asyncio.to_thread(
                    fingerprint, samples, sample_rate, tid, rid,
                    self._audio_cfg(req, algorithm), self.device)
            elif algorithm == "neural":
                raise _not_served("the neural audio embedder")
            elif algorithm == "watermark":
                # the PN key is a per-tenant secret (header preferred over
                # the query: keys in URLs leak into logs)
                wkey = (req.headers.get("x-watermark-key")
                        or req.query.get("watermark_key"))
                if not wkey:
                    raise HttpError(
                        400, "bad_query",
                        "watermark requires the per-tenant key "
                        "(X-Watermark-Key header or watermark_key param)",
                    )
                wcfg = amod.WatermarkConfig(
                    key=wkey,
                    threshold=self._in_range(
                        req, "threshold", 0.5, 0.0, 1.0, float_=True,
                        alias="watermark_threshold")
                )
                rep = await asyncio.to_thread(
                    amod.detect_watermark, samples, sample_rate, wcfg)
                # a report, not a Record (audio.rs:333-400)
                return Response.json(
                    {
                        "detected": rep.detected,
                        "payload": rep.payload,
                        "confidence": rep.confidence,
                    }
                )
            else:
                raise HttpError(
                    400, "bad_algorithm", f"unknown audio algorithm {algorithm!r}"
                )
        except UcfpError as e:
            raise _err(e)
        await self.index.upsert([rec])
        return _ingest_response(rec)

    async def ingest_audio_watermark(self, req: Request) -> Response:
        """The dedicated watermark route: ?algorithm=watermark on the main
        audio route."""
        req.query = dict(req.query)
        req.query["algorithm"] = "watermark"
        return await self.ingest_audio(req)

    async def ingest_audio_stream(self, req: Request) -> Response:
        raise _not_served("the audio stream route")

    async def inspect_audio(self, req: Request) -> Response:
        raise _not_served("the audio inspector")
