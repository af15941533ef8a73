"""EmbeddedBackend: WAL-durable host store + device-cached ANN matrices.

Port of ucfp_tpu/index/embedded.py for the image and vector slice. The
host side is the reference's: an fsync'd append-only WAL (same engines,
same bytes on disk, so a data directory written by ucfp_tpu reopens here)
replayed on open into per-record rows, and per-(tenant, dim) vector caches
and per-(tenant, algorithm) packed-fingerprint caches with
capacity-doubling padding, prefix validity (`arange < n`) and
swap-with-last removal. Device state is a pure cache of those host
matrices, uploaded lazily on the next query and patched row by row after
small writes.

Device side: the caches live on one torch device (the CUDA card unless
the caller names another) as float32 vectors and int32 tensors holding
the u32 fingerprint words; under UCFP_KNN_QUANT=int8 (or knn_quant=
"int8") the vector caches live as per-row int8 rows plus their norms
instead (ops.knn.quantize_rows_int8); under int4 and int2 as those plus
the packed columns and their inverse norms (ops.knn.pack_int4_cols,
pack_int2_cols, packed on the device); under sketch as the int8 rows
plus the lane-tiled sign sketch (ops.knn.build_sketch_chunked +
tile_sketch, built on the device). Any other UCFP_KNN_QUANT value serves
the exact f32 path, as in the reference. Queries run ops.knn (exact
paths, the int8 product and the prefilter pipelines), ops.fused_scan
(the CUDA candidate scans, at capacities of 32,768 rows or more),
ops.int4_scan / int2_scan / sketch_scan (the prefilter scans) and
ops.imagehash.multihash_weighted_topk. Each approximate tier serves where
the reference's cost model says it beats the exact int8 path (the
ops.knn *_beats_exact predicates), so both packages serve the same tier.
Row patches update the device tensors in place (saving a catalog copy
per write); all work runs on one stream in launch order, so a query sees
whole rows.

Query micro-batching (UCFP_QUERY_BATCH_MS > 0) coalesces concurrent
plain knn() and knn_fingerprint() calls into one knn_batch /
knn_fingerprint_batch dispatch per bucket, as the reference does.

Sharded serving (the reference's mesh paths): with a mesh (the `mesh=`
argument, or on a CUDA device the reference's rule: UCFP_SHARD=auto and at
least two cards, UCFP_MESH_SHAPE=<s>x<d> for a 2-D mesh) every ANN cache is
cut into equal row blocks, one per shard on the shard's device
(parallel.sharded_knn.ShardedTensor; the packed int4/int2 columns into
column blocks, the tiled sketch into tile-row blocks), each built from its
own host rows; a row patch goes to the row's shard. Queries run the
reference's sharded dispatch (parallel.sharded_knn: per-shard top-k and a
merge; the cost-model gates on per-shard capacities and pools) and are
exact except where a per-shard prefilter pool does not cover its shard.
A micro-batched flush goes through the sharded knn_batch. The CPU never
shards unless a mesh is passed.

Audio (the reference's audio side): Wang and Panako records also go into
a per-(tenant, algorithm) columnar landmark index (_LandmarkIndex, host
numpy: knn_audio's offset voting), and Haitsma records into a per-tenant
padded stream matrix (_StreamCache) that lives on the device as int32
words plus true lengths; knn_haitsma runs the minimum bit-error-rate
search (ops.audio.haitsma.min_ber_batch: the kernel csrc/min_ber.cu on
the card) over every stored stream at once, per shard under a mesh (the
search is row-parallel), the shards' rows concatenated in row order.
Replaying the WAL on open rebuilds both.

Text (the reference's text side, host code): every record's text goes
into the BM25 engine (index/bm25.make_engine: the native bm25.cpp unless
UCFP_BM25=python) in the same logical transaction as its fingerprint
write, and a record with no text clears its document; records tagged
minhash-lsh-h128 also go into per-tenant LSH band buckets (knn_lsh:
union of the query's buckets, ranked by MinHash slot agreement).
bm25_idf_map feeds SimHash-IDF. MinHash (258 words) and TLSH (18 words)
fingerprints are wider than the fused Hamming scan's 16 words, so their
queries take the exact scan, as in the reference. Replaying the WAL on
open rebuilds both indexes.

Compaction (the reference's compact and _snapshot_frames, host code):
the log is rewritten as a snapshot of the live rows, two-phase, so
queries and writes go on during the rewrite; the native engine writes it
as the same run frames, so a compacted port log is byte-equal to the
reference's. UCFP_AUTOCOMPACT_MB bounds the log's growth: after a write,
once the log is past that many MiB and has doubled since the last
snapshot, a worker thread compacts it (maybe_autocompact). Compactions
run one at a time: compact waits for a running one, autocompaction
skips while one runs. (The reference lets two run at once, and the
second can drop writes it acknowledged.)
"""

from __future__ import annotations

import asyncio
import itertools
import os
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from ..core import (
    FingerprintMeta,
    Hit,
    HitSource,
    IngestError,
    Modality,
    Record,
    RecordNotFound,
    TermHit,
    quantize_pool_frac,
)
from ..device import resolve_device
from ..ops import fused_scan
from ..ops import knn as knn_ops
from ..parallel import sharded_knn
from ..parallel.mesh import Mesh, serving_mesh
from ..parallel.sharded_knn import ShardedTensor
from .backend import IndexBackend

LSH_ALGORITHM = "minhash-lsh-h128"
AUDIO_LANDMARK_ALGOS = ("audiofp-wang-v1", "audiofp-panako-v1")
HAITSMA_ALGORITHM = "audiofp-haitsma-v1"
#: algorithms with an index of their own beside the packed fingerprint
#: cache: the columnar batch paths never take them (the reference's gates)
SPECIAL_INDEX_ALGOS = frozenset((LSH_ALGORITHM, *AUDIO_LANDMARK_ALGOS,
                                 HAITSMA_ALGORITHM))
#: the UCFP_KNN_QUANT tiers, whose vector caches hold int8 rows; "none" and
#: any other value serve the exact f32 path, as in the reference
QUANT_TIERS = ("int8", "int4", "int2", "sketch")


def _upsert_event(tenant_id: int, record_id: int, row: dict) -> dict:
    return {
        "op": "upsert",
        "tenant_id": tenant_id,
        "record_id": record_id,
        "modality": row["modality"],
        "algorithm": row["algorithm"],
        "config_hash": row["config_hash"],
        "format_version": row["format_version"],
        "fingerprint": row["fingerprint"],
        "embedding": row["embedding"],
        "model_id": row["model_id"],
        "metadata": row["metadata"],
        "text": row["text"],
    }


def _record_event(rec: Record) -> dict:
    return {
        "op": "upsert",
        "tenant_id": rec.tenant_id,
        "record_id": rec.record_id,
        "modality": rec.modality.value,
        "algorithm": rec.algorithm,
        "config_hash": rec.config_hash,
        "format_version": rec.format_version,
        "fingerprint": rec.fingerprint,
        "embedding": rec.embedding,
        "model_id": rec.model_id,
        "metadata": rec.metadata,
        "text": rec.text,
    }



@dataclass
class _RowCache:
    """Dense row matrix with capacity-doubled padding and swap-with-last
    removal (the reference's _RowCache, unchanged). One implementation
    serves the f32 embedding caches (width = dim) and the packed uint32
    fingerprint caches (width = words)."""

    width: int
    dtype: type = np.float32
    rids: list[int] = field(default_factory=list)
    rows: dict[int, int] = field(default_factory=dict)  # rid -> row
    data: np.ndarray | None = None  # [cap, width]
    # interned (algorithm, model_id) codes per row, for device-masked
    # query filters; only the vector caches track them
    track_tags: bool = False
    tags: np.ndarray | None = None  # [cap, 2] int32
    n: int = 0
    dirty: bool = True
    device: tuple | None = None  # device-side cache tensors
    # rows touched since the last device sync; None = full re-upload
    pending: list | None = None
    # bumped whenever a row CHANGES POSITION (remove's swap-with-last);
    # queries map kernel indices back to rids after the kernel by
    # re-checking gen instead of copying the rid list under the lock
    gen: int = 0

    MAX_PENDING = 256

    def _note(self, row: int) -> None:
        if self.dirty or self.pending is None:
            self.dirty = True
            self.pending = None
        elif len(self.pending) >= self.MAX_PENDING:
            self.dirty = True
            self.pending = None
        else:
            self.pending.append(row)

    def upsert(self, rid: int, vec: np.ndarray,
               tag: tuple[int, int] | None = None) -> None:
        if rid in self.rows:
            row = self.rows[rid]
            self.data[row] = vec
            if self.track_tags and tag is not None:
                self.tags[row] = tag
            self._note(row)
        else:
            if self.data is None:
                self.data = np.zeros((1024, self.width), self.dtype)
                if self.track_tags:
                    self.tags = np.zeros((1024, 2), np.int32)
                self.dirty = True
                self.pending = None
            elif self.n == self.data.shape[0]:
                grown = np.zeros((self.data.shape[0] * 2, self.width), self.dtype)
                grown[: self.n] = self.data
                self.data = grown
                if self.track_tags:
                    gt = np.zeros((grown.shape[0], 2), np.int32)
                    gt[: self.n] = self.tags
                    self.tags = gt
                self.dirty = True  # capacity change: full re-upload
                self.pending = None
            self.data[self.n] = vec
            if self.track_tags and tag is not None:
                self.tags[self.n] = tag
            self.rows[rid] = self.n
            self.rids.append(rid)
            self._note(self.n)
            self.n += 1

    def upsert_many(self, rids: list[int], mat: np.ndarray,
                    tag: tuple[int, int] | None = None) -> None:
        """Bulk append of all-NEW rids (callers gate on novelty);
        equivalent to upsert() per row, pending/dirty bookkeeping
        included."""
        m = len(rids)
        if m == 0:
            return
        grew = False
        if self.data is None:
            cap = 1024
            while cap < m:
                cap *= 2
            self.data = np.zeros((cap, self.width), self.dtype)
            if self.track_tags:
                self.tags = np.zeros((cap, 2), np.int32)
            grew = True
        elif self.n + m > self.data.shape[0]:
            cap = self.data.shape[0]
            while cap < self.n + m:
                cap *= 2
            grown = np.zeros((cap, self.width), self.dtype)
            grown[: self.n] = self.data[: self.n]
            self.data = grown
            if self.track_tags:
                gt = np.zeros((cap, 2), np.int32)
                gt[: self.n] = self.tags[: self.n]
                self.tags = gt
            grew = True
        self.data[self.n: self.n + m] = mat
        if self.track_tags and tag is not None:
            self.tags[self.n: self.n + m] = tag
        row = self.n
        for rid in rids:
            self.rows[rid] = row
            row += 1
        self.rids.extend(rids)
        self.n += m
        if (grew or self.dirty or self.pending is None
                or len(self.pending) + m > self.MAX_PENDING):
            self.dirty = True
            self.pending = None
        else:
            self.pending.extend(range(self.n - m, self.n))

    def remove(self, rid: int) -> None:
        row = self.rows.pop(rid, None)
        if row is None:
            return
        self.gen += 1  # rows move: invalidate deferred rid mappings
        last = self.n - 1
        if row != last:
            self.data[row] = self.data[last]
            if self.track_tags:
                self.tags[row] = self.tags[last]
            moved = self.rids[last]
            self.rids[row] = moved
            self.rows[moved] = row
            self._note(row)
        self.rids.pop()
        self.data[last] = 0
        if self.track_tags:
            self.tags[last] = 0
        self._note(last)
        self.n -= 1


@dataclass
class _StreamCache:
    """Variable-length u32 streams packed into one padded matrix [cap,
    tmax] + true lengths, so a haitsma query is one batched device pass
    over the whole catalog. Row capacity and tmax both grow by doubling
    (the reference's _StreamCache, unchanged)."""

    rids: list[int] = field(default_factory=list)
    rows: dict[int, int] = field(default_factory=dict)
    data: np.ndarray | None = None  # [cap, tmax] uint32
    lens: np.ndarray | None = None  # [cap] int32
    n: int = 0
    dirty: bool = True
    device: tuple | None = None
    gen: int = 0  # bumped on row moves (see _RowCache.gen)

    def upsert(self, rid: int, frames: np.ndarray) -> None:
        t = len(frames)
        if self.data is None:
            tmax = 64
            while tmax < t:
                tmax *= 2
            self.data = np.zeros((64, tmax), np.uint32)
            self.lens = np.zeros(64, np.int32)
        if t > self.data.shape[1]:
            tmax = self.data.shape[1]
            while tmax < t:
                tmax *= 2
            grown = np.zeros((self.data.shape[0], tmax), np.uint32)
            grown[:, : self.data.shape[1]] = self.data
            self.data = grown
        row = self.rows.get(rid)
        if row is None:
            if self.n == self.data.shape[0]:
                grown = np.zeros((self.data.shape[0] * 2, self.data.shape[1]),
                                 np.uint32)
                grown[: self.n] = self.data
                self.data = grown
                glen = np.zeros(grown.shape[0], np.int32)
                glen[: self.n] = self.lens
                self.lens = glen
            row = self.n
            self.rows[rid] = row
            self.rids.append(rid)
            self.n += 1
        self.data[row, :] = 0
        self.data[row, :t] = frames
        self.lens[row] = t
        self.dirty = True

    def remove(self, rid: int) -> None:
        row = self.rows.pop(rid, None)
        if row is None:
            return
        self.gen += 1  # rows move: invalidate deferred rid mappings
        last = self.n - 1
        if row != last:
            self.data[row] = self.data[last]
            self.lens[row] = self.lens[last]
            moved = self.rids[last]
            self.rids[row] = moved
            self.rows[moved] = row
        self.rids.pop()
        self.data[last] = 0
        self.lens[last] = 0
        self.n -= 1
        self.dirty = True


class _LandmarkIndex:
    """Columnar landmark postings, sorted by hash: one vectorized
    searchsorted answers a whole query's hash lookups, a delete is one
    boolean-mask filter, and inserts buffer and consolidate lazily on the
    next read (the reference's _LandmarkIndex, unchanged)."""

    def __init__(self) -> None:
        self.hashes = np.zeros(0, np.uint32)
        self.rids = np.zeros(0, np.uint64)
        self.ts = np.zeros(0, np.int64)
        self._pend: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def __len__(self) -> int:
        return len(self.hashes) + sum(len(p[0]) for p in self._pend)

    def insert(self, rid: int, pairs: np.ndarray) -> None:
        """pairs [L, 2] uint32 (hash, t)."""
        if len(pairs) == 0:
            return
        self._pend.append((
            pairs[:, 0].astype(np.uint32),
            np.full(len(pairs), rid, np.uint64),
            pairs[:, 1].astype(np.int64),
        ))

    def _consolidate(self) -> None:
        if not self._pend:
            return
        ph = np.concatenate([p[0] for p in self._pend])
        pr = np.concatenate([p[1] for p in self._pend])
        pt = np.concatenate([p[2] for p in self._pend])
        order = np.argsort(ph, kind="stable")
        ph, pr, pt = ph[order], pr[order], pt[order]
        if len(self.hashes) == 0:
            self.hashes, self.rids, self.ts = ph, pr, pt
        else:
            # the base is already sorted: merge in O(N + P)
            pos = np.searchsorted(self.hashes, ph, side="right")
            self.hashes = np.insert(self.hashes, pos, ph)
            self.rids = np.insert(self.rids, pos, pr)
            self.ts = np.insert(self.ts, pos, pt)
        self._pend = []

    def remove(self, rid: int) -> None:
        self._consolidate()
        keep = self.rids != np.uint64(rid)
        self.hashes = self.hashes[keep]
        self.rids = self.rids[keep]
        self.ts = self.ts[keep]

    def lookup(self, h_query: np.ndarray):
        """All postings matching each query hash.
        -> (qidx [M], rids [M], ts [M]): qidx maps each match back to
        its position in h_query."""
        self._consolidate()
        if len(self.hashes) == 0 or len(h_query) == 0:
            z = np.zeros(0, np.int64)
            return z, np.zeros(0, np.uint64), np.zeros(0, np.int64)
        lo = np.searchsorted(self.hashes, h_query, "left")
        hi = np.searchsorted(self.hashes, h_query, "right")
        reps = hi - lo
        m = int(reps.sum())
        if m == 0:
            z = np.zeros(0, np.int64)
            return z, np.zeros(0, np.uint64), np.zeros(0, np.int64)
        starts = np.repeat(lo, reps)
        offs = np.arange(m, dtype=np.int64) - np.repeat(
            np.cumsum(reps) - reps, reps
        )
        idx = starts + offs
        qidx = np.repeat(np.arange(len(h_query), dtype=np.int64), reps)
        return qidx, self.rids[idx], self.ts[idx]


def _VecCache(dim: int) -> _RowCache:  # noqa: N802 - constructor alias
    return _RowCache(width=dim, dtype=np.float32, track_tags=True)


def _HamCache(words: int) -> _RowCache:  # noqa: N802 - constructor alias
    return _RowCache(width=words, dtype=np.uint32)


class EmbeddedBackend(IndexBackend):
    """Single-directory embedded index on one torch device, or row-sharded
    over a mesh of them.

    wal_engine: "auto" prefers the native C++ log and falls back to the
    pure-Python JSON log; an existing file's format always wins.
    device: None = the CUDA card (raises when there is none); "cpu" runs
    the plain PyTorch paths on the host.
    mesh: None = the reference's rule on a CUDA device
    (parallel.mesh.serving_mesh: UCFP_SHARD, UCFP_MESH_SHAPE, at least two
    cards), no sharding on the CPU; a parallel.mesh.Mesh shards over its
    devices whatever the environment says (entries may repeat: [cuda:0] *
    8 is 8 shards on one card, [cpu] * 8 the tests' mesh).
    """

    def __init__(self, data_dir: str, wal_engine: str = "auto", device=None,
                 knn_quant: str | None = None, mesh: Mesh | None = None):
        from .wal import GroupCommitWal, JsonWal, open_wal

        self.device = resolve_device(device)
        # sharded serving: with a mesh every ANN cache is cut into row
        # blocks, one per shard, and every query runs per shard plus a merge
        # (parallel.sharded_knn), as the reference does on more than one
        # device. Capacities are powers of two, so rows split evenly.
        if mesh is None and self.device.type == "cuda":
            mesh = serving_mesh()
        self._mesh = mesh
        self._mesh_axes: tuple = mesh.axis_names if mesh is not None else ("d",)
        # "none" = exact f32 cosine; "int8" = per-row symmetric int8 rows
        # (a quarter of the f32 bytes; scores are cosines of the quantized
        # vectors); "int4" / "int2" / "sketch" = int8 plus a packed int4,
        # packed int2 or sign-sketch prefilter whose pool is rescored over
        # the int8 rows. Also settable via UCFP_KNN_QUANT; other values
        # serve the exact f32 path, as in the reference.
        self.knn_quant = (knn_quant or os.environ.get("UCFP_KNN_QUANT", "none")).lower()
        self._planes: dict[int, torch.Tensor] = {}  # dim -> device sketch planes
        # Query micro-batching (opt-in, UCFP_QUERY_BATCH_MS > 0):
        # concurrent plain single queries coalesce into one batched device
        # dispatch per (tenant, dim, k) or (tenant, algorithm, k) bucket
        # inside the deadline window, flushing at most UCFP_QBATCH_MAX
        # queries at once. Filtered, exact and pool_frac queries bypass it.
        self._qbatch_ms = float(os.environ.get("UCFP_QUERY_BATCH_MS", "0") or 0)
        self._qbatch_max = max(1, int(os.environ.get("UCFP_QBATCH_MAX", "64") or 64))
        # the reference pads each flush to a power of two ("max": to
        # UCFP_QBATCH_MAX); the port does not pad, but dispatches a flush
        # as at the padded size, since the int4 and int2 batch dispatch
        # depends on it
        self._qbatch_pad = os.environ.get("UCFP_QBATCH_PAD", "pow2").lower()
        # kind ("vec"/"fp") -> {event loop -> DeadlineBatcher}
        self._batchers: dict[str, dict] = {}
        # flushes and total queries through the micro-batchers since boot
        self._qbatch_flushes = 0
        self._qbatch_items = 0
        self._tag_codes: dict[str, int] = {}  # algorithm/model_id interning
        # tenant -> insertion-ordered record ids (listing pagination)
        self._tenant_rows: dict[int, dict[int, None]] = {}
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._wal_path = os.path.join(data_dir, "ucfp.wal")
        self._lock = threading.Lock()  # one writer, same-txn BM25 semantics
        # one compaction at a time: two rewrites would share the WAL's
        # engine and buffer watermark (reentrant: maybe_autocompact
        # holds it around compact)
        self._compact_lock = threading.RLock()
        self._records: dict[tuple[int, int], dict] = {}
        from .bm25 import make_engine

        self._bm25 = make_engine(
            prefer_native=os.environ.get("UCFP_BM25", "native") != "python"
        )
        self._lsh: dict[int, dict[tuple[int, int], set[int]]] = {}  # tenant -> band buckets
        self._vec: dict[tuple[int, int], _RowCache] = {}  # (tenant, dim)
        self._ham: dict[tuple[int, str], _RowCache] = {}  # (tenant, algorithm)
        # (tenant, algorithm) -> columnar postings: wang and panako hashes
        # share the u32 space, so one index per algorithm
        self._audio: dict[tuple[int, str], _LandmarkIndex] = {}
        self._haitsma: dict[int, _StreamCache] = {}  # tenant -> padded streams
        if os.path.exists(self._wal_path) and os.path.getsize(self._wal_path) > 0:
            wal_engine = "auto"  # the existing log's format wins
        # group commit: concurrent requests' appends share one fsync
        self._wal = GroupCommitWal(
            JsonWal(self._wal_path) if wal_engine == "json"
            else open_wal(self._wal_path, wal_engine)
        )
        try:
            self._replay()
        except BaseException:
            self._wal.close()
            raise
        # the log's size at the last snapshot (here: at open), the base of
        # autocompaction's doubling rule
        self._wal_floor = self._wal_size()

    # -- WAL ----------------------------------------------------------------

    def _replay(self) -> None:
        # the native engine replays uniform fingerprint/embedding runs as
        # columnar groups; the JSON engine replays per event — same state
        skipped = 0
        groups_fn = getattr(self._wal, "replay_groups", None)
        groups = groups_fn() if groups_fn is not None else None
        if groups is None:
            groups = (("events", [ev]) for ev in self._wal.replay())
        for kind, payload in groups:
            if kind == "fp_run":
                skipped += self._replay_fp_run(payload)
            elif kind == "emb_run":
                skipped += self._replay_emb_run(payload)
            else:
                for ev in payload:
                    skipped += self._replay_event(ev)
        if skipped:
            from ..server.logging import logger

            logger().warn("wal_replay_skipped_events", count=skipped)

    def _replay_event(self, ev: dict) -> int:
        # a malformed event is skipped with a warning (the reference's rule)
        try:
            if ev.get("op") == "upsert":
                self._apply_upsert(self._rec_from_wal(ev))
            elif ev.get("op") == "delete":
                for rid in ev["record_ids"]:
                    self._apply_delete(ev["tenant_id"], rid)
            return 0
        except Exception as e:  # noqa: BLE001 - replay must finish
            from ..server.logging import logger

            logger().warn(
                "wal_replay_skip", op=ev.get("op"),
                tenant_id=ev.get("tenant_id"),
                record_id=ev.get("record_id"), error=str(e),
            )
            return 1

    def _run_gate(self, run: dict) -> bool:
        """What _apply_fp_rows/_apply_emb_rows handle: all-new unique
        rids, plain Hamming algorithm, width fit. Anything else expands
        to per-event replay, so semantics never fork."""
        t = run["tenant_id"]
        alg = run["algorithm"]
        flen = run["flen"]
        if flen <= 0 or flen % 4 or alg in SPECIAL_INDEX_ALGOS:
            return False
        hcache = self._ham.get((t, alg))
        if hcache is not None and hcache.width != flen // 4:
            return False
        seen: set[int] = set()
        for rid in run["record_ids"]:
            if rid in seen or (t, rid) in self._records:
                return False  # dup/update: per-event semantics
            seen.add(rid)
        return True

    def _replay_fp_run(self, run: dict) -> int:
        """Columnar apply of one uniform fingerprint-only upsert run."""
        from .wal import fp_run_events

        if self._run_gate(run):
            block = run["fp_block"]
            flen = run["flen"]
            fps = [block[i * flen: (i + 1) * flen]
                   for i in range(len(run["record_ids"]))]
            self._apply_fp_rows(
                run["tenant_id"], run["algorithm"], run["record_ids"], fps,
                flen, run["modality"], run["config_hash"],
                run["format_version"], meta=run["metadata"], fp_block=block,
            )
            return 0
        return sum(self._replay_event(ev) for ev in fp_run_events(run))

    def _replay_emb_run(self, run: dict) -> int:
        """Columnar apply of one uniform embedding upsert run (finite
        floats only; anything else gets per-event skip accounting)."""
        from .wal import emb_run_events

        mat = run["emb_mat"]
        if self._run_gate(run) and bool(np.all(np.isfinite(mat))):
            block = run["fp_block"]
            flen = run["flen"]
            fps = [block[i * flen: (i + 1) * flen]
                   for i in range(len(run["record_ids"]))]
            self._apply_emb_rows(
                run["tenant_id"], run["algorithm"], run["record_ids"], fps,
                flen, run["modality"], run["config_hash"],
                run["format_version"], meta=run["metadata"],
                model_id=run["model_id"], emb_mat=mat, fp_block=block,
            )
            return 0
        return sum(self._replay_event(ev) for ev in emb_run_events(run))

    @staticmethod
    def _rec_from_wal(ev: dict) -> Record:
        return Record(
            tenant_id=ev["tenant_id"],
            record_id=ev["record_id"],
            modality=Modality(ev["modality"]),
            algorithm=ev["algorithm"],
            fingerprint=ev["fingerprint"],
            format_version=ev.get("format_version", 1),
            config_hash=ev.get("config_hash", 0),
            embedding=ev.get("embedding"),
            model_id=ev.get("model_id"),
            metadata=ev.get("metadata", b""),
            text=ev.get("text"),
        )

    # -- mutations ------------------------------------------------------------

    def _apply_upsert(self, rec: Record) -> None:
        key = (rec.tenant_id, rec.record_id)
        # convert fallible inputs BEFORE touching any table
        emb_arr = (np.asarray(rec.embedding, np.float32)
                   if rec.embedding is not None else None)
        if emb_arr is not None and (emb_arr.ndim != 1 or not np.all(np.isfinite(emb_arr))):
            raise ValueError("embedding must be a flat finite float vector")
        packed = np.asarray(knn_ops.pack_bits_to_u32(rec.fingerprint), np.uint32)
        old = self._records.get(key)
        if old is None:
            self._tenant_rows.setdefault(rec.tenant_id, {})[rec.record_id] = None
        self._records[key] = {
            "modality": rec.modality.value,
            "algorithm": rec.algorithm,
            "config_hash": rec.config_hash,
            "format_version": rec.format_version,
            "fingerprint": rec.fingerprint,
            "embedding": emb_arr,
            "model_id": rec.model_id,
            "metadata": rec.metadata,
            "text": rec.text,
        }
        # vectors table
        if old is not None and old["embedding"] is not None:
            olddim = len(old["embedding"])
            if rec.embedding is None or len(rec.embedding) != olddim:
                c = self._vec.get((rec.tenant_id, olddim))
                if c:
                    c.remove(rec.record_id)
        if emb_arr is not None:
            dim = len(emb_arr)
            cache = self._vec.setdefault((rec.tenant_id, dim), _VecCache(dim))
            cache.upsert(
                rec.record_id, emb_arr,
                tag=(self._tag_code(rec.algorithm),
                     self._tag_code(rec.model_id)),
            )
        # packed fingerprint table
        if old is not None and old["algorithm"] != rec.algorithm:
            h = self._ham.get((rec.tenant_id, old["algorithm"]))
            if h:
                h.remove(rec.record_id)
        hcache = self._ham.get((rec.tenant_id, rec.algorithm))
        if hcache is None:
            hcache = _HamCache(words=len(packed))
            self._ham[(rec.tenant_id, rec.algorithm)] = hcache
        if len(packed) == hcache.width:
            hcache.upsert(rec.record_id, packed)
        else:
            # width mismatch: drop any stale row so knn_fingerprint never
            # scores this record against its previous fingerprint
            hcache.remove(rec.record_id)
        # LSH band-bucket index for re-tagged MinHash records
        if old is not None and old["algorithm"] == LSH_ALGORITHM:
            self._lsh_remove(rec.tenant_id, rec.record_id, old["fingerprint"])
        if rec.algorithm == LSH_ALGORITHM:
            self._lsh_insert(rec.tenant_id, rec.record_id, rec.fingerprint)
        # audio landmark inverted index (wang/panako offset voting)
        if old is not None and old["algorithm"] in AUDIO_LANDMARK_ALGOS:
            self._audio_index_remove(rec.tenant_id, old["algorithm"],
                                     rec.record_id)
        if rec.algorithm in AUDIO_LANDMARK_ALGOS:
            self._audio_index_insert(rec.tenant_id, rec.algorithm,
                                     rec.record_id, rec.fingerprint)
        # haitsma padded-stream cache (batched min-BER lookups)
        if old is not None and old["algorithm"] == HAITSMA_ALGORITHM:
            sc = self._haitsma.get(rec.tenant_id)
            if sc and (rec.algorithm != HAITSMA_ALGORITHM
                       or len(rec.fingerprint) % 4 != 0):
                # replaced by another algorithm or a misaligned
                # fingerprint: either way the old stream is stale
                sc.remove(rec.record_id)
        if rec.algorithm == HAITSMA_ALGORITHM and len(rec.fingerprint) % 4 == 0:
            sc = self._haitsma.setdefault(rec.tenant_id, _StreamCache())
            sc.upsert(rec.record_id,
                      np.frombuffer(rec.fingerprint, dtype="<u4"))
        # BM25 in the same logical transaction (no text clears the doc);
        # textless records that never had text skip the engine
        if rec.text is not None or (old is not None
                                    and old["text"] is not None):
            self._bm25.upsert_one(rec.tenant_id, rec.record_id, rec.text)

    def _batch_rows_ok(self, recs: list[Record], t: int, alg: str,
                       flen: int, emb: bool) -> bool:
        """Shared gate of the vectorized applies: one tenant/algorithm/
        width, all-new unique rids, embeddings all present (or all
        absent) with one model_id."""
        model = recs[0].model_id
        seen: set[int] = set()
        for r in recs:
            if (r.tenant_id != t or r.algorithm != alg
                    or (r.embedding is not None) != emb or r.text is not None
                    or (emb and r.model_id != model)
                    or len(r.fingerprint) != flen
                    or r.record_id in seen
                    or (t, r.record_id) in self._records):
                return False
            seen.add(r.record_id)
        hcache = self._ham.get((t, alg))
        return hcache is None or hcache.width == flen // 4

    def _apply_upsert_batch(self, recs: list[Record],
                            emb_mat: np.ndarray | None = None) -> bool:
        """Vectorized apply for one batch of all-NEW records sharing
        (tenant, algorithm) and fingerprint width. Returns False —
        mutating NOTHING — when any record doesn't fit; the caller then
        runs the per-record path."""
        first = recs[0]
        t = first.tenant_id
        alg = first.algorithm
        flen = len(first.fingerprint)
        if alg in SPECIAL_INDEX_ALGOS or flen == 0 or flen % 4 != 0:
            return False
        emb = first.embedding is not None
        if not self._batch_rows_ok(recs, t, alg, flen, emb):
            return False
        fps = [bytes(r.fingerprint) for r in recs]
        rids = [r.record_id for r in recs]
        if not emb:
            self._apply_fp_rows(t, alg, rids, fps, flen, first.modality.value,
                                None, None, recs=recs)
            return True
        mat = emb_mat
        if mat is None:
            try:
                mat = np.asarray([r.embedding for r in recs], np.float32)
            except (TypeError, ValueError):
                return False
            if (mat.ndim != 2 or mat.shape[0] != len(recs)
                    or not np.all(np.isfinite(mat))):
                return False  # ragged / non-finite: per-record errors
        self._apply_emb_rows(t, alg, rids, fps, flen, first.modality.value,
                             None, None, model_id=first.model_id,
                             emb_mat=mat, recs=recs)
        return True

    def _apply_delete(self, tenant_id: int, rid: int) -> None:
        self._bm25.clear_one(tenant_id, rid)
        old = self._records.pop((tenant_id, rid), None)
        if old is None:
            return
        t = self._tenant_rows.get(tenant_id)
        if t is not None:
            t.pop(rid, None)
        if old["embedding"] is not None:
            c = self._vec.get((tenant_id, len(old["embedding"])))
            if c:
                c.remove(rid)
        h = self._ham.get((tenant_id, old["algorithm"]))
        if h:
            h.remove(rid)
        if old["algorithm"] in AUDIO_LANDMARK_ALGOS:
            self._audio_index_remove(tenant_id, old["algorithm"], rid)
        if old["algorithm"] == LSH_ALGORITHM:
            self._lsh_remove(tenant_id, rid, old["fingerprint"])
        if old["algorithm"] == HAITSMA_ALGORITHM:
            sc = self._haitsma.get(tenant_id)
            if sc:
                sc.remove(rid)

    # -- LSH band buckets --------------------------------------------------------

    @staticmethod
    def _lsh_signature(fp: bytes) -> Optional[np.ndarray]:
        if len(fp) < 8 + 8 or (len(fp) - 8) % 8 != 0:
            return None
        return np.frombuffer(fp, dtype="<u8", offset=8)

    def _lsh_insert(self, tenant_id: int, rid: int, fp: bytes) -> None:
        from ..ops.textsig import band_hashes

        sig = self._lsh_signature(fp)
        if sig is None or len(sig) < 120:
            return
        buckets = self._lsh.setdefault(tenant_id, {})
        for j, bh in enumerate(band_hashes(sig)):
            buckets.setdefault((j, bh), set()).add(rid)

    def _lsh_remove(self, tenant_id: int, rid: int, fp: bytes) -> None:
        from ..ops.textsig import band_hashes

        sig = self._lsh_signature(fp)
        if sig is None or len(sig) < 120:
            return
        buckets = self._lsh.get(tenant_id)
        if not buckets:
            return
        for j, bh in enumerate(band_hashes(sig)):
            s = buckets.get((j, bh))
            if s is not None:
                s.discard(rid)
                if not s:
                    del buckets[(j, bh)]

    async def knn_lsh(self, tenant_id: int, fingerprint: bytes, k: int) -> list[Hit]:
        """Sub-linear candidate retrieval: union the band buckets the query
        signature lands in, then rank candidates by MinHash slot agreement
        (estimated Jaccard), ties to the lower record id."""
        sig = self._lsh_signature(fingerprint)
        if sig is None or len(sig) < 120 or k == 0:
            return []

        def work():
            from ..ops.textsig import band_hashes

            with self._lock:
                buckets = self._lsh.get(tenant_id, {})
                cands: set[int] = set()
                for j, bh in enumerate(band_hashes(sig)):
                    cands |= buckets.get((j, bh), set())
                rows = {
                    rid: self._records.get((tenant_id, rid)) for rid in cands
                }
            rids_l, sigs = [], []
            for rid, row in rows.items():
                if row is None:
                    continue
                other = self._lsh_signature(row["fingerprint"])
                if other is None or len(other) != len(sig):
                    continue
                rids_l.append(rid)
                sigs.append(other)
            if not sigs:
                return []
            # one vectorized slot-agreement pass over all candidates
            mat = np.stack(sigs)  # [N, h]
            scores = (mat == sig[None, :]).mean(axis=1)
            rid_arr = np.asarray(rids_l, np.uint64)
            order = np.lexsort((rid_arr, -scores))[:k]
            return [
                Hit(record_id=int(rid_arr[i]), score=float(scores[i]),
                    source=HitSource.VECTOR)
                for i in order
            ]

        return await asyncio.to_thread(work)

    def bm25_idf_map(self, tenant_id: int, terms: list[str]) -> dict[str, float]:
        """Corpus IDF for the SimHash-IDF weighting.

        The caller's tokens come from the TEXT tokenizer (\\w+, keeps
        underscores; or grapheme/cjk forms) while the BM25 corpus is
        keyed by its own tokenizer ([^\\W_]+) — so each term is mapped
        to its BM25 subtokens and weighted by the MAX sub-IDF (its most
        informative component)."""
        from .bm25 import tokenize as bm25_tokenize

        sub_of: dict[str, list[str]] = {}
        for t in terms:
            subs = bm25_tokenize(t)
            sub_of[t] = subs if subs else [t.lower()]
        flat = sorted({s for subs in sub_of.values() for s in subs})
        with self._lock:
            base = self._bm25.idf_map(tenant_id, flat)
        out: dict[str, float] = {}
        for t, subs in sub_of.items():
            vals = [base[s] for s in subs if s in base]
            if vals:
                out[t] = max(vals)
        return out

    def _tag_code(self, value: str | None) -> int:
        """Intern algorithm/model_id strings to dense int codes for the
        per-row filter tags (0 = absent)."""
        if value is None:
            return 0
        code = self._tag_codes.get(value)
        if code is None:
            code = len(self._tag_codes) + 1
            self._tag_codes[value] = code
        return code

    def _vector_filter_mask(self, cache: _RowCache, flt: dict):
        """[cap] bool row mask for a supported filter (raises Unsupported
        for other shapes); None when no row can match."""
        from .backend import validate_filter

        validate_filter(flt)
        mask = np.ones(cache.data.shape[0], bool)
        for col, key in ((0, "algorithm"), (1, "model_id")):
            v = flt.get(key)
            if v is None:
                continue
            code = self._tag_codes.get(v)
            if code is None:
                return None  # value never ingested: nothing matches
            mask &= cache.tags[:, col] == code
        return mask

    # -- IndexBackend -----------------------------------------------------------

    def _validate_records(self, records: list[Record]) -> "np.ndarray | None":
        """Reject malformed or out-of-slice records BEFORE the WAL append.
        A uniform all-embedding batch validates as one matrix conversion,
        returned for the batched apply to reuse."""
        mat = None
        if len(records) >= 2 and all(r.embedding is not None for r in records):
            try:
                m = np.asarray([r.embedding for r in records], np.float32)
            except (TypeError, ValueError):
                m = None
            if (m is not None and m.ndim == 2
                    and m.shape[0] == len(records)
                    and np.all(np.isfinite(m))):
                mat = m
        for rec in records:
            if mat is None and rec.embedding is not None:
                emb = np.asarray(rec.embedding, np.float32)
                if emb.ndim != 1 or not np.all(np.isfinite(emb)):
                    raise ValueError(
                        f"record {rec.tenant_id}/{rec.record_id}: embedding "
                        f"must be a flat finite float vector"
                    )
            if not isinstance(rec.fingerprint, (bytes, bytearray)):
                raise ValueError(
                    f"record {rec.tenant_id}/{rec.record_id}: fingerprint "
                    f"must be bytes"
                )
        return mat

    async def upsert(self, records: list[Record]) -> None:
        wal = self._wal  # snapshot: close() may null the attr mid-await

        def apply():
            emb_mat = self._validate_records(records)
            self._check_durability(wal)
            with self._lock:
                # buffered WAL append and memory apply share ONE critical
                # section, so replay order always equals apply order; the
                # shared fsync happens after the lock drops (group commit)
                ticket = (wal.append_buffered(
                    [_record_event(r) for r in records]
                ) if wal is not None else None)
                if len(records) < 2 or not self._apply_upsert_batch(
                        records, emb_mat=emb_mat):
                    for rec in records:
                        self._apply_upsert(rec)
            return ticket

        ticket = await asyncio.to_thread(apply)
        if ticket is not None:
            # durability before ack: a failed group fsync raises here
            await wal.wait_durable(ticket)
        await self._maybe_autocompact_async()

    def _columnar_ok(self, n: int, algorithm: str, fingerprints: list,
                     record_ids: list[int]) -> int:
        """Fingerprint width when a batch qualifies for the columnar path,
        else -1 (the Record path then owns every error)."""
        flen = len(fingerprints[0]) if isinstance(
            fingerprints[0], (bytes, bytearray)) else -1
        ok = (
            n >= 2 and flen > 0 and flen % 4 == 0
            and algorithm not in SPECIAL_INDEX_ALGOS
            and all(type(fp) is bytes and len(fp) == flen for fp in fingerprints)
            and all(type(r) is int and 0 <= r <= 2**64 - 1 for r in record_ids)
        )
        return flen if ok else -1

    def _novel_locked(self, tenant_id: int, algorithm: str, flen: int,
                      record_ids: list[int]) -> bool:
        hcache = self._ham.get((tenant_id, algorithm))
        if hcache is not None and hcache.width != flen // 4:
            return False  # width clash: per-record path errors
        seen: set[int] = set()
        for rid in record_ids:
            if rid in seen or (tenant_id, rid) in self._records:
                return False  # dup/update: per-record semantics
            seen.add(rid)
        return True

    async def upsert_fingerprint_batch(
        self,
        tenant_id: int,
        algorithm: str,
        record_ids: list[int],
        fingerprints: list[bytes],
        *,
        modality=None,
        config_hash: int = 0,
        format_version: int = 1,
    ) -> None:
        """Columnar fast path for the uniform batch-ingest shape: one WAL
        run append + one vectorized store apply. Equivalent to upsert() of
        the corresponding Records (identical WAL bytes and state), and
        falls back to that path whenever the batch doesn't qualify."""
        from ..core.types import _check_u32, _check_u64

        if modality is None:
            modality = Modality.IMAGE
        n = len(record_ids)
        if n != len(fingerprints):
            raise ValueError("record_ids and fingerprints length mismatch")
        if n == 0:
            return
        _check_u32("tenant_id", tenant_id)
        _check_u64("config_hash", config_hash)
        wal = self._wal
        flen = self._columnar_ok(n, algorithm, fingerprints, record_ids)

        def apply():
            self._check_durability(wal)
            with self._lock:
                if not self._novel_locked(tenant_id, algorithm, flen, record_ids):
                    return None
                ticket = (wal.append_buffered_run(
                    tenant_id, modality.value, record_ids, fingerprints,
                    algorithm=algorithm, config_hash=config_hash,
                    format_version=format_version,
                ) if wal is not None else None)
                self._apply_fp_rows(
                    tenant_id, algorithm, record_ids, fingerprints, flen,
                    modality.value, config_hash, format_version,
                )
                return (ticket,)

        done = await asyncio.to_thread(apply) if flen > 0 else None
        if done is None:
            await self.upsert([
                Record(tenant_id=tenant_id, record_id=rid,
                       modality=modality, algorithm=algorithm,
                       fingerprint=fp, config_hash=config_hash,
                       format_version=format_version)
                for rid, fp in zip(record_ids, fingerprints)
            ])
            return
        (ticket,) = done
        if ticket is not None:
            await wal.wait_durable(ticket)
        await self._maybe_autocompact_async()

    async def upsert_embedding_batch(
        self,
        tenant_id: int,
        algorithm: str,
        record_ids: list[int],
        embeddings,
        *,
        fingerprints: list[bytes] | None = None,
        modality=None,
        model_id: str | None = None,
        config_hash: int = 0,
        format_version: int = 1,
    ) -> None:
        """Columnar fast path for bulk vector loads: one WAL run append +
        one vectorized store apply. `fingerprints=None` derives each row's
        f32-LE bytes. Equivalent to upsert() of the corresponding Records,
        falling back to that path whenever the batch doesn't qualify."""
        from ..core.types import _check_u32, _check_u64

        if modality is None:
            modality = Modality.IMAGE
        n = len(record_ids)
        mat = np.asarray(embeddings, np.float32)
        if mat.ndim != 2 or mat.shape[0] != n:
            raise ValueError(
                f"embeddings must be an [n={n}, d] matrix, got {mat.shape}"
            )
        if not np.all(np.isfinite(mat)):
            raise ValueError("embeddings must be finite")
        if n == 0:
            return
        if fingerprints is None:
            step = 4 * mat.shape[1]
            block = mat.astype("<f4", copy=False).tobytes()
            fingerprints = [block[i * step: (i + 1) * step] for i in range(n)]
        if n != len(fingerprints):
            raise ValueError("record_ids and fingerprints length mismatch")
        _check_u32("tenant_id", tenant_id)
        _check_u64("config_hash", config_hash)
        wal = self._wal
        flen = (self._columnar_ok(n, algorithm, fingerprints, record_ids)
                if mat.shape[1] > 0 else -1)

        def apply():
            self._check_durability(wal)
            with self._lock:
                if not self._novel_locked(tenant_id, algorithm, flen, record_ids):
                    return None
                ticket = (wal.append_buffered_emb_run(
                    tenant_id, modality.value, record_ids, fingerprints,
                    mat, algorithm=algorithm, model_id=model_id,
                    config_hash=config_hash,
                    format_version=format_version,
                ) if wal is not None else None)
                self._apply_emb_rows(
                    tenant_id, algorithm, record_ids, fingerprints, flen,
                    modality.value, config_hash, format_version,
                    model_id=model_id, emb_mat=mat,
                )
                return (ticket,)

        done = await asyncio.to_thread(apply) if flen > 0 else None
        if done is None:
            await self.upsert([
                Record(tenant_id=tenant_id, record_id=rid,
                       modality=modality, algorithm=algorithm,
                       fingerprint=bytes(fp), config_hash=config_hash,
                       format_version=format_version,
                       embedding=mat[i].tolist(), model_id=model_id)
                for i, (rid, fp) in enumerate(zip(record_ids, fingerprints))
            ])
            return
        (ticket,) = done
        if ticket is not None:
            await wal.wait_durable(ticket)
        await self._maybe_autocompact_async()

    def _store_rows(self, t: int, alg: str, rids: list[int], fps: list[bytes],
                    flen: int, mod_value: str, cfg, fmt, meta: bytes,
                    model_id, embs, recs, fp_block) -> None:
        """Row tables + packed-fingerprint cache for a gated uniform run
        (caller holds the lock, or owns the store during replay, and has
        verified novelty + width fit). `recs`, when given, supplies the
        per-record fields (the Record path's rows)."""
        hcache = self._ham.get((t, alg))
        if hcache is None:
            hcache = _HamCache(words=flen // 4)
            self._ham[(t, alg)] = hcache
        packed = np.frombuffer(
            b"".join(fps) if fp_block is None else fp_block, "<u4"
        ).reshape(len(fps), flen // 4)
        trows = self._tenant_rows.setdefault(t, {})
        records = self._records
        for i, (rid, fp) in enumerate(zip(rids, fps)):
            trows[rid] = None
            row = {
                "modality": mod_value,
                "algorithm": alg,
                "config_hash": cfg,
                "format_version": fmt,
                "fingerprint": fp,
                "embedding": embs[i] if embs is not None else None,
                "model_id": model_id,
                "metadata": meta,
                "text": None,
            }
            if recs is not None:
                r = recs[i]
                row.update(modality=r.modality.value,
                           config_hash=r.config_hash,
                           format_version=r.format_version,
                           fingerprint=r.fingerprint, model_id=r.model_id,
                           metadata=r.metadata)
            records[(t, rid)] = row
        hcache.upsert_many(rids, packed)

    def _apply_fp_rows(self, t: int, alg: str, rids: list[int],
                       fps: list[bytes], flen: int, mod_value: str,
                       cfg, fmt, *, meta: bytes = b"",
                       fp_block: bytes | None = None, recs=None) -> None:
        self._store_rows(t, alg, rids, fps, flen, mod_value, cfg, fmt, meta,
                         None, None, recs, fp_block)

    def _apply_emb_rows(self, t: int, alg: str, rids: list[int],
                        fps: list[bytes], flen: int, mod_value: str,
                        cfg, fmt, *, meta: bytes = b"",
                        model_id: str | None = None,
                        emb_mat: np.ndarray = None,
                        fp_block: bytes | None = None, recs=None) -> None:
        """_apply_fp_rows plus the vector cache (embeddings stored as f32
        row views of emb_mat)."""
        self._store_rows(t, alg, rids, fps, flen, mod_value, cfg, fmt, meta,
                         model_id, emb_mat, recs, fp_block)
        cache = self._vec.setdefault(
            (t, emb_mat.shape[1]), _VecCache(emb_mat.shape[1]))
        cache.upsert_many(
            rids, emb_mat,
            tag=(self._tag_code(alg), self._tag_code(model_id)),
        )

    @staticmethod
    def _check_durability(wal) -> None:
        """Refuse new writes while the WAL cannot commit."""
        if wal is not None and getattr(wal, "degraded", False):
            raise IngestError(
                "write-ahead log durability failure: ingest refused until "
                "a WAL fsync round succeeds (check disk space/health)"
            )

    async def delete(self, tenant_id: int, record_ids: list[int]) -> None:
        wal = self._wal

        def apply():
            self._check_durability(wal)
            with self._lock:
                ticket = (wal.append_buffered(
                    [{"op": "delete", "tenant_id": tenant_id,
                      "record_ids": record_ids}]
                ) if wal is not None else None)
                for rid in record_ids:
                    self._apply_delete(tenant_id, rid)
            return ticket

        ticket = await asyncio.to_thread(apply)
        if ticket is not None:
            await wal.wait_durable(ticket)
        await self._maybe_autocompact_async()

    # -- device caches ------------------------------------------------------------

    def _to_device(self, arr: np.ndarray, device=None) -> torch.Tensor:
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)  # u32 bit patterns, int32 storage
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device or self.device)

    def _n_shards(self) -> int:
        return self._mesh.size if self._mesh is not None else 1

    def _blocks(self, cap: int) -> list:
        """(device, first row, end row) of each shard of a cap-row cache, in
        shard order: the whole cache on self.device without a mesh."""
        if self._mesh is None:
            return [(self.device, 0, cap)]
        devs = list(self._mesh.devices.reshape(-1))
        if cap % len(devs):
            raise ValueError(f"capacity {cap} does not split over {len(devs)} shards")
        rows = cap // len(devs)
        return [(dev, s * rows, (s + 1) * rows) for s, dev in enumerate(devs)]

    def _joined(self, blocks: list, dim: int = 0):
        """One tensor per shard -> the cache tensor: that tensor without a
        mesh, else a ShardedTensor split on `dim`."""
        return blocks[0] if self._mesh is None else ShardedTensor(blocks, dim)

    @staticmethod
    def _block(t, s: int) -> torch.Tensor:
        """Shard s of a cache tensor (the tensor itself without a mesh)."""
        return t.shards[s] if isinstance(t, ShardedTensor) else t

    def _put_matrix(self, arr: np.ndarray):
        """Host rows (a matrix or a row vector, the reference's _put_matrix
        and _put_rowvec) on the device, row-sharded under a mesh."""
        return self._joined([self._to_device(arr[lo:hi], dev)
                             for dev, lo, hi in self._blocks(len(arr))])

    def _device_valid(self, cap: int, n: int):
        # built on the device(s): rows below n are live
        return self._joined([torch.arange(lo, hi, device=dev) < n
                             for dev, lo, hi in self._blocks(cap)])

    def _scatter_rows(self, m, ridx: list[int], vals: np.ndarray):
        """Row patch IN PLACE (see module doc); under a mesh global row r
        goes to its shard's block at r - the block's first row."""
        for s, (dev, lo, hi) in enumerate(self._blocks(m.shape[0])):
            mine = [j for j, r in enumerate(ridx) if lo <= r < hi]
            if mine:
                local = torch.as_tensor([ridx[j] - lo for j in mine], device=dev)
                self._block(m, s)[local] = self._to_device(vals[mine], dev)
        return m

    #: rows per host quantization pass when the int8 cache is built: the
    #: f32 temporaries stay this many rows, not a catalog copy
    INT8_BUILD_ROWS = 1 << 16

    def _device_int8(self, cache: _RowCache) -> tuple:
        """(q8m [cap, D8] int8, row_norm [cap] f32, valid) on the device —
        the int8 branch of the reference's _device_vec, same rule: a full
        build on first use or capacity growth, otherwise only the rows
        touched since the last sync, quantized on the host. D8 pads the
        width with zero columns for the int8 product (ops.knn.padded_dim);
        the host cache and the WAL keep D.

        Under int4 with an even D (int2: D % 4 == 0) the reference's
        5-tuple (q8m, row_norm, packed_t [D/2 or D/4, cap] int8, inv_n
        [cap] f32, valid): the packed columns are packed on the device from
        q8m[:, :D] and patched column by column after small writes; other
        dims get no packed parts (the dispatch serves them exact). Under
        sketch (q8m, row_norm, sketch [cap/128, 24, 128] int32, valid): the
        lane-tiled sign sketch of q8m[:, :D], built on the device and
        patched at [i // 128, :, i % 128] for row i."""
        cap, dim = cache.data.shape
        packed = ((self._int4_on() and dim % 2 == 0)
                  or (self._int2_on() and dim % 4 == 0))
        min_pool = knn_ops.INT2_MIN_POOL if self._int2_on() else knn_ops.INT4_MIN_POOL
        blocks = self._blocks(cap)
        if cache.dirty or cache.device is None:
            cache.device = None  # the old copy can go before the new one lands
            # under a mesh each shard builds its parts from its own rows on
            # its own device; a shard's packed columns are the column block
            # of the whole pack (packing is per row), and its tiled sketch
            # the tile-row block
            per = [self._int8_block(cache.data[lo:hi], dim, dev, packed, cap > 2 * min_pool)
                   for dev, lo, hi in blocks]
            dims = [0, 0] + ([1, 0] if packed else []) + ([0] if self._sketch_on() else [])
            parts = [self._joined([p[i] for p in per], d) for i, d in enumerate(dims)]
            cache.device = (*parts, self._device_valid(cap, cache.n))
            cache.dirty = False
            cache.pending = []
        elif cache.pending:
            rows = sorted(set(cache.pending))
            for s, (dev, lo, hi) in enumerate(blocks):
                mine = [r for r in rows if lo <= r < hi]
                if mine:
                    self._int8_patch([self._block(t, s) for t in cache.device[:-1]],
                                     cache.data[mine], [r - lo for r in mine], dim, dev,
                                     packed)
            cache.device = (*cache.device[:-1], self._device_valid(cap, cache.n))
            cache.pending = []
        return cache.device

    def _int8_block(self, data: np.ndarray, dim: int, dev, packed: bool,
                    real_packed: bool) -> list:
        """One block's quantized parts on `dev`, built from its host rows:
        q8m, row_norm, [packed_t, inv_n], [tiled sketch]."""
        rows = data.shape[0]
        q8m = torch.zeros((rows, knn_ops.padded_dim(dim)), dtype=torch.int8, device=dev)
        row_norm = torch.empty(rows, dtype=torch.float32, device=dev)
        for lo in range(0, rows, self.INT8_BUILD_ROWS):
            hi = min(rows, lo + self.INT8_BUILD_ROWS)
            q8, rn = knn_ops.quantize_rows_int8(data[lo:hi])
            q8m[lo:hi, :dim] = torch.from_numpy(q8).to(dev)
            row_norm[lo:hi] = torch.from_numpy(rn).to(dev)
        parts = [q8m, row_norm]
        if packed and real_packed:
            pack_full = (knn_ops.pack_int2_cols_chunked if self._int2_on()
                         else knn_ops.pack_int4_cols_chunked)
            parts += pack_full(q8m[:, :dim])
        elif packed:
            # at or below 2 * MIN_POOL every k gives pool * 2 >= cap, so no
            # query reads the packed columns: zero-width placeholders keep
            # the layout (growth rebuilds in full)
            den = 4 if self._int2_on() else 2
            parts += [torch.zeros((dim // den, 0), dtype=torch.int8, device=dev),
                      torch.zeros(0, dtype=torch.float32, device=dev)]
        if self._sketch_on():
            parts.append(knn_ops.tile_sketch(knn_ops.build_sketch_chunked(
                q8m[:, :dim], self._sketch_planes(dim).to(dev))))
        return parts

    def _int8_patch(self, parts: list, data: np.ndarray, ridx_rows: list[int], dim: int,
                    dev, packed: bool) -> None:
        """Patch one block's parts IN PLACE for its touched rows (block-local
        row numbers) from their host rows."""
        q8, rn = knn_ops.quantize_rows_int8(data)
        q8m, row_norm = parts[0], parts[1]
        ridx = torch.as_tensor(ridx_rows, device=dev)
        q8d = torch.from_numpy(q8).to(dev)
        q8m[ridx, :dim] = q8d
        row_norm[ridx] = torch.from_numpy(rn).to(dev)
        if packed:
            packed_t, inv_n = parts[2], parts[3]
            if packed_t.shape[1]:  # real columns: catalog row i is column i
                pack_rows = (knn_ops.pack_int2_cols if self._int2_on()
                             else knn_ops.pack_int4_cols)
                pk, inv = pack_rows(q8d)
                packed_t[:, ridx] = pk
                inv_n[ridx] = inv
        if self._sketch_on():
            tiled = parts[2]
            lanes = knn_ops.SKETCH_LANES
            words = torch.arange(knn_ops.SKETCH_WORDS, device=dev)
            tiled[(ridx // lanes)[:, None], words[None, :], (ridx % lanes)[:, None]] = \
                knn_ops.sketch_rows_int8(q8d, self._sketch_planes(dim).to(dev))

    def _int4_on(self) -> bool:
        return self.knn_quant == "int4"

    def _int2_on(self) -> bool:
        return self.knn_quant == "int2"

    def _sketch_on(self) -> bool:
        return self.knn_quant == "sketch"

    def _sketch_planes(self, dim: int) -> torch.Tensor:
        """The [dim, SKETCH_BITS] hyperplanes on the device, made once per dim."""
        p = self._planes.get(dim)
        if p is None:
            p = torch.from_numpy(knn_ops.sketch_planes(dim)).to(self.device)
            self._planes[dim] = p
        return p

    # The cost-model gates run on per-shard values (capacity and pool per
    # shard), mirroring what each shard executes; without a mesh they are
    # the whole catalog's.

    def _cap_l(self, cap: int) -> int:
        return max(1, cap // self._n_shards())

    def _int2_worth_it(self, cap: int, dim: int, k: int, fused: bool = True) -> bool:
        """The reference's gate for the single-query int2 prefilter."""
        cap_l = self._cap_l(cap)
        return knn_ops.int2_beats_exact(cap_l, dim, knn_ops.int2_pool(cap_l, k), fused=fused)

    def _int2_batch_worth_it(self, cap: int, dim: int, k: int, q: int) -> bool:
        """The reference's gate for the batched int2 prefilter: a real
        packed cache and a cost model that prefers it for q queries."""
        if cap <= 2 * knn_ops.INT2_MIN_POOL:
            return False  # zero-width placeholder packed cache
        cap_l = self._cap_l(cap)
        return knn_ops.int2_batch_beats_exact(cap_l, dim, q,
                                              knn_ops.int2_batch_pool(cap_l, k))

    def _sketch_worth_it(self, cap: int, dim: int, k: int, pool_frac) -> bool:
        """The reference's gate for the sketch prefilter: the cost model
        must prefer it to the exact int8 scan at this (capacity, pool);
        under a mesh at each shard's capacity and pool share (the floor
        of sharded_knn.sharded_cosine_sketch_topk)."""
        cand = knn_ops.sketch_pool(cap, k, pool_frac)
        cap_l = self._cap_l(cap)
        if self._n_shards() > 1:
            cand = min(cap_l, max(512, 16 * k, -(-cand * cap_l // cap)))
        return knn_ops.sketch_beats_exact(cap_l, dim, cand)

    def _int4_worth_it(self, cap: int, dim: int, k: int, fused: bool = True) -> bool:
        """The reference's gate for the single-query int4 prefilter: the
        cost model must prefer it to the exact int8 scan at this capacity
        (fused=False models the filtered form)."""
        cap_l = self._cap_l(cap)
        return knn_ops.int4_beats_exact(cap_l, dim, knn_ops.int4_pool(cap_l, k), fused=fused)

    def _int4_batch_worth_it(self, cap: int, dim: int, k: int, q: int) -> bool:
        """The reference's gate for the batched int4 prefilter: a real
        packed cache (the batch pool is smaller than the single one, so
        its own exhaustive branch does not cover every placeholder
        capacity) and a cost model that prefers it for q queries."""
        if cap <= 2 * knn_ops.INT4_MIN_POOL:
            return False  # zero-width placeholder packed cache
        cap_l = self._cap_l(cap)
        return knn_ops.int4_batch_beats_exact(cap_l, dim, q,
                                              knn_ops.int4_batch_pool(cap_l, k))

    def _device_rows(self, cache: _RowCache) -> tuple:
        """(matrix, valid) on the device — the reference's _device_vec
        and _device_ham, which share this rule: full upload on first
        build or capacity growth, otherwise only the rows touched since
        the last sync."""
        cap = cache.data.shape[0]
        if cache.dirty or cache.device is None:
            cache.device = (self._put_matrix(cache.data),
                            self._device_valid(cap, cache.n))
            cache.dirty = False
            cache.pending = []
        elif cache.pending:
            rows = sorted(set(cache.pending))
            m, _v = cache.device
            cache.device = (self._scatter_rows(m, rows, cache.data[rows]),
                            self._device_valid(cap, cache.n))
            cache.pending = []
        return cache.device

    @staticmethod
    def _fused_pool_ok(cap: int, n: int, k: int) -> bool:
        """THE dispatch predicate for the fused candidate path — the query
        paths and the approximate markers must agree."""
        tile = fused_scan.ROWS_PER_TILE * fused_scan.LANES
        n_candidates = (cap // tile) * fused_scan.LANES
        return cap % tile == 0 and min(k, n) <= min(16, n_candidates)

    def knn_is_approximate(self, tenant_id: int, dim: int, k: int,
                           batch: bool = False,
                           pool_frac: "float | None" = None,
                           exact: bool = False,
                           batch_q: int = 1,
                           filtered: bool = False) -> bool:
        """True when a (dim, k) vector query rides an approximate path —
        the fused candidate cells (near-exact for k <= 16, exact top-1)
        or a sketch, int4 or int2 pool that does not cover the catalog —
        so the serving layer marks the response. The reference's rules, in
        its order: a single sketch query where the cost model serves the
        sketch (pool_frac is its pool); batch=True mirrors knn_batch's
        dispatch for `batch_q` queries (filtered batches stay on the int8
        path); a single query that micro-batching may coalesce is judged
        at the worst case, a full 64-query flush; then the single-query
        packed tiers. Every rule gates on min(k, n), as the dispatch
        does; the packed tiers' pools are judged per shard (each shard
        keeps its own), and the sharded int8 and f32 scans are exact."""
        if exact:
            return False
        cache = self._vec.get((tenant_id, dim))
        if cache is None or cache.n == 0 or cache.data is None:
            return False
        kk = min(k, cache.n)
        cap = cache.data.shape[0]
        cap_l = self._cap_l(cap)
        if (self._sketch_on() and not batch
                and self._sketch_worth_it(cap, dim, kk, pool_frac)):
            # the whole catalog's pool, conservative under a mesh as in
            # the reference
            return knn_ops.sketch_pool(cap, kk, pool_frac) * 2 < cap
        tier = self._packed_tier()
        if tier is not None:
            worth, batch_worth, pool, batch_pool = tier[:4]
            if batch and not filtered and batch_worth(cap, dim, kk, batch_q):
                return batch_pool(cap_l, kk) * 2 < cap_l
            if (not batch and self._qbatch_ms > 0 and pool_frac is None
                    and batch_worth(cap, dim, kk, 64) and batch_pool(cap_l, kk) * 2 < cap_l):
                return True
            if not batch and worth(cap, dim, kk):
                return pool(cap_l, kk) * 2 < cap_l
        if self._mesh is not None:
            return False
        return self._fused_pool_ok(cap, cache.n, kk)

    def _packed_tier(self):
        """(single gate, batch gate, pool, batch pool, single pipeline,
        batched pipeline, their sharded forms) of the packed tier this
        backend serves, or None."""
        if self._int4_on():
            return (self._int4_worth_it, self._int4_batch_worth_it,
                    knn_ops.int4_pool, knn_ops.int4_batch_pool,
                    knn_ops.cosine_int4_topk, knn_ops.cosine_int4_topk_batched,
                    sharded_knn.sharded_cosine_int4_topk,
                    sharded_knn.sharded_cosine_int4_batch_topk)
        if self._int2_on():
            return (self._int2_worth_it, self._int2_batch_worth_it,
                    knn_ops.int2_pool, knn_ops.int2_batch_pool,
                    knn_ops.cosine_int2_topk, knn_ops.cosine_int2_topk_batched,
                    sharded_knn.sharded_cosine_int2_topk,
                    sharded_knn.sharded_cosine_int2_batch_topk)
        return None

    def fingerprint_is_approximate(self, tenant_id: int, algorithm: str,
                                   k: int) -> bool:
        """Same marker for the fused Hamming serving path (the sharded
        Hamming scan is exact)."""
        if self._mesh is not None:
            return False
        cache = self._ham.get((tenant_id, algorithm))
        if cache is None or cache.n == 0 or cache.data is None:
            return False
        if cache.width > fused_scan.MAX_FUSED_HAMMING_WORDS:
            return False  # wide fingerprints serve the exact kernel
        return self._fused_pool_ok(cache.data.shape[0], cache.n,
                                   min(k, cache.n))

    def _resolve(self, cache: _RowCache, gen_snap: int, rids_copy,
                 idx: np.ndarray, keep: np.ndarray):
        """Kernel row indices -> rids: {row: rid} for the kept entries,
        or None when a delete moved rows since the snapshot (retry)."""
        if rids_copy is not None:
            return rids_copy
        with self._lock:
            if cache.gen != gen_snap:
                return None
            # gen unchanged => no row moved and the rid list only grew,
            # so every kept index (< n_snap) names its snapshot record
            return {int(i): cache.rids[int(i)]
                    for i in idx.reshape(-1)[keep.reshape(-1)]}

    def _snapshot(self, cache: _RowCache, attempt: int, last: int,
                  flt_mask=True, quant: bool = False):
        """Device tensors + (gen, rid copy on the final attempt, n), all
        under the lock (see the reference's knn for why n and gen must be
        read together). The filter mask is ANDed into the validity mask,
        the last device tensor."""
        dev = self._device_int8(cache) if quant else self._device_rows(cache)
        if flt_mask is not True:
            dev = (*dev[:-1], dev[-1] & self._put_matrix(flt_mask))
        rids_copy = list(cache.rids) if attempt == last else None
        return dev, cache.gen, rids_copy, cache.n

    async def knn(
        self,
        tenant_id: int,
        query: list[float],
        k: int,
        filter: Optional[dict] = None,
        pool_frac: Optional[float] = None,
        exact: bool = False,
    ) -> list[Hit]:
        """Cosine top-k: empty query, k=0 or zero-norm query -> empty;
        only vectors of matching dim. exact forces the exhaustive scan;
        filter {"algorithm", "model_id"} masks rows on the device.
        pool_frac sets the sketch tier's rescore pool (snapped to the
        reference's tiers); a query that names one is not micro-batched,
        as in the reference."""
        if not query or k == 0:
            return []
        pool_frac = quantize_pool_frac(pool_frac)  # the reference's ValueError
        q = np.asarray(query, np.float32)
        if float(np.linalg.norm(q)) == 0.0:
            return []
        from .backend import validate_filter

        validate_filter(filter)  # bad shapes surface even on empty caches
        cache = self._vec.get((tenant_id, len(query)))
        if cache is None or cache.n == 0:
            return []
        if (self._qbatch_ms > 0 and filter is None and not exact
                and pool_frac is None):
            # opt-in micro-batching (see __init__), after the cheap host
            # early-outs so degenerate queries never wait for a window
            return await self._submit_query_batched(tenant_id, list(query), k)
        res = await self._knn_rows(cache, q[None], k, filter, exact, single=True,
                                   pool_frac=pool_frac)
        return res[0]

    async def knn_batch(
        self, tenant_id: int, queries: list[list[float]], k: int,
        filter: Optional[dict] = None, exact: bool = False,
        dispatch_q: Optional[int] = None,
    ) -> list[list[Hit]]:
        """Batched cosine top-k: all queries share ONE device product.
        Zero-norm queries get empty lists. dispatch_q: the batch size the
        int4 and int2 dispatch is judged at (default the batch's own; a
        micro-batch flush passes the reference's padded size)."""
        if k == 0 or not queries:
            return [[] for _ in queries]
        dims = {len(q) for q in queries}
        if len(dims) != 1:
            from ..core import ModalityError

            raise ModalityError("all queries in a batch must share one dim")
        dim = dims.pop()
        if dim == 0:
            return [[] for _ in queries]
        qm = np.asarray(queries, np.float32)
        cache = self._vec.get((tenant_id, dim))
        if cache is None or cache.n == 0:
            return [[] for _ in queries]
        if filter is not None:
            from .backend import validate_filter

            validate_filter(filter)
        res = await self._knn_rows(cache, qm, k, filter, exact,
                                   dispatch_q=dispatch_q or qm.shape[0])
        return [[] if float(np.linalg.norm(qm[row])) == 0.0 else hits
                for row, hits in enumerate(res)]

    def _int8_single_topk(self, q: np.ndarray, q8m, row_norm, valid, kk: int,
                          n: int, exact: bool, n_prefix: int | None):
        """The reference's single-query int8 top-k: the int8 product plus
        kernel #4 (unfiltered: validity is the prefix rule, n_prefix) or
        the filtered scores through kernel #3 when the fused candidate
        path applies, else the exhaustive cosine_topk_int8."""
        if exact or not self._fused_pool_ok(q8m.shape[0], n, kk):
            qd = torch.from_numpy(q[None]).to(self.device)
            return knn_ops.cosine_topk_int8(qd, q8m, row_norm, valid, kk)
        # the reference quantizes the single query on the host, in numpy
        qa = float(np.abs(q).max())
        qs = 1.0 if qa == 0.0 else qa / 127.0
        qq = np.clip(np.round(q / qs), -127, 127).astype(np.int8)
        qn = float(np.linalg.norm(np.asarray(qq, np.float32)))
        dots = knn_ops.int8_dots(torch.from_numpy(qq[None]).to(self.device), q8m)[0]
        if n_prefix is not None:
            s1, i1 = fused_scan.dots_norm_topk_fused(
                dots, row_norm, n_prefix, np.float32(1.0 / max(qn, 1e-9)), kk)
        else:
            q_floor = torch.tensor(max(qn, 1e-9), dtype=torch.float32,
                                   device=self.device)
            denom = q_floor * torch.clamp(row_norm, min=1e-9)
            ok = valid & (row_norm > 0.0)
            sc = torch.where(ok, dots.float() / denom, knn_ops.NEG_INF)
            s1, i1 = fused_scan.scores_topk_fused(sc, kk)
        return s1[None, :], i1[None, :]

    def _int8_batch_topk(self, qm: np.ndarray, q8m, row_norm, valid, kk: int,
                         n: int, exact: bool, n_prefix: int | None):
        """The reference knn_batch's int8 branch: one int8 product for the
        whole block, then kernel #5 (unfiltered) or the filtered scores
        through kernel #1 when the fused candidate path applies, else the
        exhaustive cosine_topk_int8."""
        qd = torch.from_numpy(qm).to(self.device)
        if exact or not self._fused_pool_ok(q8m.shape[0], n, kk):
            return knn_ops.cosine_topk_int8(qd, q8m, row_norm, valid, kk)
        qq = knn_ops._quantize_query_rows(qd)
        dots = knn_ops.int8_dots(qq, q8m)
        qn = knn_ops.int8_norms(qq)
        q_floor = torch.clamp(qn, min=1e-9)
        if n_prefix is not None:
            inv_q = torch.where(qn > 0.0, torch.ones_like(qn) / q_floor,
                                torch.zeros_like(qn))
            return fused_scan.dots_norm_topk_fused_batched(
                dots, row_norm, n_prefix, inv_q, kk)
        denom = q_floor[:, None] * torch.clamp(row_norm, min=1e-9)[None, :]
        ok = valid[None, :] & (row_norm[None, :] > 0.0)
        sc = torch.where(ok, dots.float() / denom, knn_ops.NEG_INF)
        return fused_scan.scores_topk_fused_batched(sc, kk)

    def _quant_topk(self, qm: np.ndarray, dev: tuple, kk: int, n: int, exact: bool,
                    unfiltered: bool, single: bool, dispatch_q: int, pool_frac=None):
        """The reference's quantized dispatch, in its order. Single: the
        sketch prefilter where its gate passes (filtered too: the filter
        is in `valid`), then the int4 or int2 prefilter (fused when
        unfiltered, a mask pass when filtered); batch: int4 or int2,
        unfiltered only. Everything else takes the int8 path."""
        cap, dim = dev[0].shape[0], qm.shape[1]
        # unfiltered queries: validity is the prefix rule, which the fused
        # kernels apply in-stream
        n_prefix = n if unfiltered else None
        if not exact and single and self._sketch_on() and self._sketch_worth_it(
                cap, dim, kk, pool_frac):
            q8m, row_norm, sketch, valid = dev
            s1, i1 = knn_ops.cosine_sketch_topk(
                torch.from_numpy(qm[0]).to(self.device), self._sketch_planes(dim), q8m,
                row_norm, sketch, valid, kk, knn_ops.sketch_pool(cap, kk, pool_frac))
            return s1[None, :], i1[None, :]
        tier = None if exact else self._packed_tier()
        if tier is not None:
            worth, batch_worth, pool, pool_b, pipe, pipe_b = tier[:6]
            if single and worth(cap, dim, kk, fused=unfiltered):
                q8m, row_norm, packed_t, inv_n, valid = dev
                s1, i1 = pipe(torch.from_numpy(qm[0]).to(self.device), q8m, row_norm,
                              packed_t, inv_n, valid, kk, pool(cap, kk), n_valid=n_prefix)
                return s1[None, :], i1[None, :]
            if not single and unfiltered and batch_worth(cap, dim, kk, dispatch_q):
                q8m, row_norm, packed_t, inv_n, _valid = dev
                return pipe_b(torch.from_numpy(qm).to(self.device), q8m, row_norm,
                              packed_t, inv_n, n, kk, pool_b(cap, kk))
        q8m, row_norm, valid = dev[0], dev[1], dev[-1]
        topk = self._int8_single_topk if single else self._int8_batch_topk
        return topk(qm[0] if single else qm, q8m, row_norm, valid, kk, n, exact, n_prefix)

    def _sharded_topk(self, qm: np.ndarray, dev: tuple, kk: int, n: int, exact: bool,
                      unfiltered: bool, single: bool, dispatch_q: int, quant: bool,
                      pool_frac=None):
        """The reference's sharded dispatch, in its order (one query:
        embedded.py:2244-2306; a batch: 2513-2550): a single query takes the
        sharded sketch, int4 or int2 prefilter where its per-shard gate
        passes (filtered too), a batch the sharded int4 or int2 batch
        prefilter (unfiltered only); everything else the exact sharded int8
        scan (quantized tiers) or the sharded f32 cosine."""
        mesh, axes = self._mesh, self._mesh_axes
        cap, dim = dev[0].shape[0], qm.shape[1]
        qd = torch.from_numpy(qm).to(self.device)
        if quant and not exact:
            if single and self._sketch_on() and self._sketch_worth_it(cap, dim, kk, pool_frac):
                q8m, row_norm, sketch, valid = dev
                s1, i1 = sharded_knn.sharded_cosine_sketch_topk(
                    qd[0], self._sketch_planes(dim), q8m, row_norm, sketch, valid, kk,
                    knn_ops.sketch_pool(cap, kk, pool_frac), mesh, axes)
                return s1[None, :], i1[None, :]
            tier = self._packed_tier()
            if tier is not None:
                worth, batch_worth = tier[:2]
                sharded, sharded_b = tier[6:]
                if single and worth(cap, dim, kk, fused=unfiltered):
                    q8m, row_norm, packed_t, inv_n, valid = dev
                    s1, i1 = sharded(qd[0], q8m, row_norm, packed_t, inv_n, valid, kk, mesh,
                                     axes, n_valid=n if unfiltered else None)
                    return s1[None, :], i1[None, :]
                if not single and unfiltered and batch_worth(cap, dim, kk, dispatch_q):
                    q8m, row_norm, packed_t, inv_n, _valid = dev
                    return sharded_b(qd, q8m, row_norm, packed_t, inv_n, n, kk, mesh, axes)
        if quant:
            return sharded_knn.sharded_cosine_int8_batch_topk(
                qd, dev[0], dev[1], dev[-1], kk, mesh, axes)
        matrix, valid = dev
        return sharded_knn.sharded_cosine_topk(qd, matrix, valid, kk, mesh, axes)

    async def _knn_rows(self, cache: _RowCache, qm: np.ndarray, k: int,
                        filter: Optional[dict], exact: bool,
                        single: bool = False, dispatch_q: int = 1,
                        pool_frac=None) -> list[list[Hit]]:
        quant = self.knn_quant in QUANT_TIERS

        def work(_attempt=0, _last=2):
            with self._lock:
                # filter mask under the SAME lock as the device snapshot:
                # a concurrent capacity doubling would change its length
                flt_mask = (self._vector_filter_mask(cache, filter)
                            if filter is not None else True)
                if flt_mask is None:
                    return [[] for _ in range(qm.shape[0])]
                dev, gen_snap, rids_copy, n_snap = self._snapshot(
                    cache, _attempt, _last, flt_mask, quant=quant)
            kk = min(k, n_snap)
            if self._mesh is not None:
                scores, idx = self._sharded_topk(qm, dev, kk, n_snap, exact, flt_mask is True,
                                                 single, dispatch_q, quant, pool_frac)
            elif quant:
                scores, idx = self._quant_topk(qm, dev, kk, n_snap, exact,
                                               flt_mask is True, single, dispatch_q,
                                               pool_frac)
            else:
                matrix, valid = dev
                qd = torch.from_numpy(qm).to(self.device)
                if not exact and self._fused_pool_ok(matrix.shape[0], n_snap, kk):
                    scores, idx = knn_ops.cosine_topk_fused(qd, matrix, valid, kk)
                else:
                    scores, idx = knn_ops.cosine_topk(qd, matrix, valid, kk)
            scores = scores.cpu().numpy()
            idx = idx.cpu().numpy()
            keep = np.isfinite(scores)
            rids = self._resolve(cache, gen_snap, rids_copy, idx, keep)
            if rids is None:  # a delete moved rows: retry OUTSIDE the lock
                return work(_attempt + 1)
            out = []
            for row in range(qm.shape[0]):
                pairs = [(rids[int(i)], float(s))
                         for s, i in zip(scores[row], idx[row]) if np.isfinite(s)]
                # descending score, ties by ascending record id
                pairs.sort(key=lambda t: (-t[1], t[0]))
                out.append([Hit(record_id=r, score=s, source=HitSource.VECTOR)
                            for r, s in pairs])
            return out

        return await asyncio.to_thread(work)

    # -- query micro-batching ---------------------------------------------------
    #
    # The reference pads each flush to a power of two (UCFP_QBATCH_PAD)
    # to bound XLA's compiles per shape; the padded rows are sliced off,
    # and PyTorch compiles nothing per shape, so the port runs each flush
    # at its own size. The batch size still picks the int4 and int2 tiers
    # (their cost models take Q), so a flush is dispatched as at the
    # padded size.

    def _deadline_batcher(self, kind: str, run):
        """Per-event-loop DeadlineBatcher registry: a batcher holds
        loop-bound asyncio primitives, so each running loop gets its own
        (a server runs one loop; tests and threaded direct callers run
        many). Closed loops' entries are pruned on the way."""
        from ..ingest.batcher import DeadlineBatcher

        loop = asyncio.get_running_loop()
        with self._lock:
            reg = self._batchers.setdefault(kind, {})
            b = reg.get(loop)
            if b is None:
                for dead in [lp for lp in reg if lp.is_closed()]:
                    del reg[dead]
                b = DeadlineBatcher(run, max_batch=self._qbatch_max,
                                    max_delay_ms=self._qbatch_ms)
                reg[loop] = b
        return b

    def _note_flush(self, payloads: list) -> None:
        with self._lock:  # several event-loop threads may flush at once
            self._qbatch_flushes += 1
            self._qbatch_items += len(payloads)

    def _padded_flush(self, n: int) -> int:
        """The size of the reference's padded flush of n queries."""
        if self._qbatch_pad == "max":
            return self._qbatch_max
        return 1 << (n - 1).bit_length() if n > 1 else 1

    async def _run_vec_bucket(self, bucket, payloads):
        t, _dim, kk = bucket
        self._note_flush(payloads)
        return await self.knn_batch(t, payloads, kk,
                                    dispatch_q=self._padded_flush(len(payloads)))

    async def _submit_query_batched(self, tenant_id: int, query: list,
                                    k: int) -> list[Hit]:
        """Enqueue one plain vector query; resolves to its own hits once
        its (tenant, dim, k) bucket flushes through knn_batch."""
        b = self._deadline_batcher("vec", self._run_vec_bucket)
        return await b.submit((tenant_id, len(query), k), query)

    async def _run_fp_bucket(self, bucket, payloads):
        t, alg, kk = bucket
        self._note_flush(payloads)
        return await self.knn_fingerprint_batch(t, alg, payloads, kk)

    async def _submit_fp_batched(self, tenant_id: int, algorithm: str,
                                 fingerprint: bytes, k: int) -> list[Hit]:
        """Fingerprint twin of _submit_query_batched (its own registry
        kind, so bucket keys cannot collide)."""
        b = self._deadline_batcher("fp", self._run_fp_bucket)
        return await b.submit((tenant_id, algorithm, k), fingerprint)

    async def knn_fingerprint(
        self, tenant_id: int, algorithm: str, fingerprint: bytes, k: int
    ) -> list[Hit]:
        """Hamming top-k over packed stored fingerprints; score =
        1 - dist/bits so larger is better."""
        if k == 0 or not fingerprint:
            return []
        if self._qbatch_ms > 0:
            # the same opt-in micro-batching as plain vector queries
            return await self._submit_fp_batched(tenant_id, algorithm,
                                                 fingerprint, k)
        res = await self.knn_fingerprint_batch(tenant_id, algorithm,
                                               [fingerprint], k)
        return res[0]

    def _pack_queries(self, fingerprints: list[bytes], width: int,
                      nbytes: int | None = None):
        """[Q, width] u32 query words + per-row ok flags (width- or
        length-mismatched rows become zeros and get empty results)."""
        packs, ok_rows = [], []
        for fp in fingerprints:
            p = (np.asarray(knn_ops.pack_bits_to_u32(fp), np.uint32)
                 if fp else np.zeros(0, np.uint32))
            ok = bool(fp) and (len(fp) == nbytes if nbytes is not None
                               else len(p) == width)
            packs.append(p if ok else np.zeros(width, np.uint32))
            ok_rows.append(ok)
        return np.stack(packs), ok_rows

    async def knn_fingerprint_batch(
        self, tenant_id: int, algorithm: str, fingerprints: list[bytes], k: int
    ) -> list[list[Hit]]:
        """Batched Hamming top-k: all queries share ONE device dispatch.
        Width-mismatched or empty fingerprints return an empty hit list
        at their position."""
        if k == 0 or not fingerprints:
            return [[] for _ in fingerprints]
        cache = self._ham.get((tenant_id, algorithm))
        if cache is None or cache.n == 0:
            return [[] for _ in fingerprints]
        qm, ok_rows = self._pack_queries(fingerprints, cache.width)
        if not any(ok_rows):
            return [[] for _ in fingerprints]

        def work(_attempt=0, _last=2):
            with self._lock:
                (matrix, valid), gen_snap, rids_copy, n_snap = self._snapshot(
                    cache, _attempt, _last)
            kk = min(k, n_snap)
            qd = self._to_device(qm)
            if self._mesh is not None:
                # the reference's sharded Hamming scan: exact, masked
                dist, idx = sharded_knn.sharded_hamming_topk(
                    qd, matrix, valid, kk, self._mesh, self._mesh_axes)
            elif (self._fused_pool_ok(matrix.shape[0], n_snap, kk)
                    and cache.width <= fused_scan.MAX_FUSED_HAMMING_WORDS):
                dist, idx = fused_scan.hamming_topk_fused_batched(
                    qd, matrix, valid, kk)
            else:
                dist, idx = knn_ops.hamming_topk(qd, matrix, valid, kk)
            dist = dist.cpu().numpy()
            idx = idx.cpu().numpy()
            keep = dist < 2**30  # masked rows surface as 2^30 / 2^31-1
            rids = self._resolve(cache, gen_snap, rids_copy, idx, keep)
            if rids is None:
                return work(_attempt + 1)
            bits = cache.width * 32
            res: list[list[Hit]] = []
            for row in range(qm.shape[0]):
                if not ok_rows[row]:
                    res.append([])
                    continue
                out = [(rids[int(i)], int(d))
                       for d, i in zip(dist[row], idx[row]) if d < 2**30]
                out.sort(key=lambda t: (t[1], t[0]))
                res.append([Hit(record_id=rid, score=1.0 - d / bits,
                                source=HitSource.VECTOR) for rid, d in out])
            return res

        return await asyncio.to_thread(work)

    async def knn_multihash(
        self, tenant_id: int, fingerprints: list[bytes], k: int,
        weights: Optional[dict] = None,
    ) -> list[list[Hit]]:
        """Weighted multi-hash comparison over stored 536-byte bundles:
        three 64-bit Hamming terms, histogram L1 and the fraction of 4x4
        blocks within block_distance_threshold, weighted (defaults
        0.4/.3/.1/.1/.1). One batched device dispatch."""
        from ..modality.image import ALGORITHM_MULTI
        from ..ops import imagehash as ih

        if k == 0 or not fingerprints:
            return [[] for _ in fingerprints]
        cache = self._ham.get((tenant_id, ALGORITHM_MULTI))
        if cache is None or cache.n == 0 or cache.width != ih.MULTIHASH_WORDS:
            return [[] for _ in fingerprints]
        qm, ok_rows = self._pack_queries(fingerprints, ih.MULTIHASH_WORDS,
                                         nbytes=ih.MULTIHASH_BYTES)
        if not any(ok_rows):
            return [[] for _ in fingerprints]
        params = torch.from_numpy(ih.multihash_params(weights)).to(self.device)

        def work(_attempt=0, _last=2):
            with self._lock:
                (matrix, valid), gen_snap, rids_copy, n_snap = self._snapshot(
                    cache, _attempt, _last)
            kk = min(k, n_snap)
            if self._mesh is not None:
                scores, idx = sharded_knn.sharded_multihash_topk(
                    self._to_device(qm), matrix, valid, params, kk, self._mesh,
                    self._mesh_axes)
            else:
                scores, idx = ih.multihash_weighted_topk(
                    self._to_device(qm), matrix, valid, params, kk)
            scores = scores.cpu().numpy()
            idx = idx.cpu().numpy()
            keep = np.isfinite(scores)
            rids = self._resolve(cache, gen_snap, rids_copy, idx, keep)
            if rids is None:
                return work(_attempt + 1)
            res: list[list[Hit]] = []
            for row in range(qm.shape[0]):
                if not ok_rows[row]:
                    res.append([])
                    continue
                out = [(rids[int(i)], float(s))
                       for s, i in zip(scores[row], idx[row]) if np.isfinite(s)]
                out.sort(key=lambda t: (-t[1], t[0]))
                res.append([Hit(record_id=rid, score=s, source=HitSource.VECTOR)
                            for rid, s in out])
            return res

        return await asyncio.to_thread(work)

    # -- audio ------------------------------------------------------------------

    def _audio_index_insert(self, tenant_id: int, algorithm: str, rid: int,
                            fp: bytes) -> None:
        pairs = np.frombuffer(fp, dtype="<u4")
        if pairs.size % 2:
            return
        self._audio.setdefault(
            (tenant_id, algorithm), _LandmarkIndex()
        ).insert(rid, pairs.reshape(-1, 2))

    def _audio_index_remove(self, tenant_id: int, algorithm: str,
                            rid: int) -> None:
        idx = self._audio.get((tenant_id, algorithm))
        if idx is not None:
            idx.remove(rid)

    def _device_haitsma(self, cache: _StreamCache):
        """Padded stream matrix (int32 words) + lengths on the device,
        row-sharded under a mesh like the ANN caches; re-uploaded whole
        after any write, as in the reference."""
        if cache.dirty or cache.device is None:
            cache.device = (self._put_matrix(cache.data),
                            self._put_matrix(cache.lens))
            cache.dirty = False
        return cache.device

    def _min_ber_rows(self, data, lens, q_pad: np.ndarray, q_true: int) -> np.ndarray:
        """min_ber_batch over the stream matrix -> [cap] BERs on the host;
        per shard under a mesh, in row order."""
        from ..ops.audio import haitsma as hops

        out = []
        for s, (dev, _lo, _hi) in enumerate(self._blocks(data.shape[0])):
            ber, _off = hops.min_ber_batch(self._block(data, s), self._block(lens, s),
                                           self._to_device(q_pad, dev), q_true)
            out.append(ber.cpu().numpy())
        return np.concatenate(out)

    async def knn_haitsma(
        self, tenant_id: int, fingerprint: bytes, k: int
    ) -> list[Hit]:
        """Philips-style sliding bit-error-rate lookup, one batched device
        pass over the whole padded-stream catalog; records rank by minimum
        BER (score = 1 - ber)."""
        if k == 0 or len(fingerprint) < 4 or len(fingerprint) % 4:
            return []
        q = np.frombuffer(fingerprint, dtype="<u4")
        cache = self._haitsma.get(tenant_id)
        if cache is None or cache.n == 0:
            return []

        def work():
            with self._lock:
                if cache.n == 0:
                    return []
                tmax = cache.data.shape[1]
                if len(q) > tmax:
                    # query longer than every stored stream
                    return []
                data, lens = self._device_haitsma(cache)
                rids = list(cache.rids)
            qb = 64
            while qb < len(q):
                qb *= 2
            qb = min(qb, tmax)
            q_pad = np.zeros(qb, np.uint32)
            q_pad[: len(q)] = q
            ber = self._min_ber_rows(data, lens, q_pad, len(q))[: len(rids)]
            scored = [
                (rid, 1.0 - float(b))
                for rid, b in zip(rids, ber)
                if np.isfinite(b) and b < 1.0
            ]
            scored.sort(key=lambda x: (-x[1], x[0]))
            return [
                Hit(record_id=rid, score=s, source=HitSource.VECTOR)
                for rid, s in scored[:k]
            ]

        return await asyncio.to_thread(work)

    async def knn_audio(
        self, tenant_id: int, algorithm: str, fingerprint: bytes, k: int
    ) -> list[Hit]:
        """Shazam-style offset voting over stored Wang/Panako landmarks
        (host numpy, the reference's code): for each query (hash, t) found
        in the landmark index, one vote per (query landmark, record,
        offset bin t_db - t_q); a record scores its largest bin over the
        query's landmark count. Panako queries also try the adjacent
        quantized time-ratio steps (bits 12-15) and bin offsets by 8
        frames (a stretched query's offset drifts)."""
        if k == 0 or not fingerprint:
            return []
        pairs = np.frombuffer(fingerprint, dtype="<u4")
        if pairs.size == 0 or pairs.size % 2:
            return []
        pairs = pairs.reshape(-1, 2)
        panako = algorithm == "audiofp-panako-v1"
        off_bin = 8 if panako else 1

        # expand panako hashes across adjacent quantized time-ratio steps
        h0 = pairs[:, 0].astype(np.uint32)
        tq0 = pairs[:, 1].astype(np.int64)
        qi0 = np.arange(len(pairs), dtype=np.int64)
        if panako:
            ratio = (h0 >> 12) & 0xF
            lo_ok = ratio > 0
            hi_ok = ratio < 15
            h_exp = np.concatenate(
                [h0, h0[lo_ok] - (1 << 12), h0[hi_ok] + (1 << 12)]
            )
            tq_exp = np.concatenate([tq0, tq0[lo_ok], tq0[hi_ok]])
            qi_exp = np.concatenate([qi0, qi0[lo_ok], qi0[hi_ok]])
        else:
            h_exp, tq_exp, qi_exp = h0, tq0, qi0

        def work():
            with self._lock:
                idx = self._audio.get((tenant_id, algorithm))
                if idx is None or len(idx) == 0:
                    return []
                qrep, rids_m, ts_m = idx.lookup(h_exp)
            if len(qrep) == 0:
                return []
            qi = qi_exp[qrep]
            offb = (ts_m - tq_exp[qrep]) // off_bin
            # one vote per (query landmark, record, offset-bin): dedupe and
            # count over a packed 64-bit key sized to the actual ranges
            urids, rinv = np.unique(rids_m, return_inverse=True)
            off0 = (offb - offb.min()).astype(np.uint64)
            qiu = qi.astype(np.uint64)
            qbits = max(int(qiu.max()) if len(qiu) else 0, 1).bit_length()
            obits = max(int(off0.max()) if len(off0) else 0, 1).bit_length()
            rbits = max(len(urids) - 1, 1).bit_length()
            if rbits + obits + qbits <= 63:
                key = ((rinv.astype(np.uint64) << (obits + qbits))
                       | (off0 << qbits) | qiu)
                distinct = np.unique(key)
                vote_key, counts = np.unique(distinct >> qbits,
                                             return_counts=True)
                rid_idx = (vote_key >> obits).astype(np.int64)
            else:  # pathological ranges: exact 3-column unique
                triples = np.stack(
                    [rinv.astype(np.int64), off0.astype(np.int64),
                     qiu.astype(np.int64)], axis=1)
                distinct = np.unique(triples, axis=0)
                ro_pairs, counts = np.unique(distinct[:, :2], axis=0,
                                             return_counts=True)
                rid_idx = ro_pairs[:, 0]
            best = np.zeros(len(urids), np.int64)
            np.maximum.at(best, rid_idx, counts)
            total = max(len(pairs), 1)
            order = np.lexsort((urids, -best))
            out = []
            for i in order[: k]:
                if best[i] <= 0:
                    break
                out.append(Hit(
                    record_id=int(urids[i]),
                    score=min(float(best[i]) / total, 1.0),
                    source=HitSource.VECTOR,
                ))
            return out

        return await asyncio.to_thread(work)

    async def bm25(self, tenant_id: int, terms: list[str], k: int) -> list[Hit]:
        def work():
            with self._lock:
                res = self._bm25.search(tenant_id, terms, k)
            return [
                Hit(record_id=d, score=s, source=HitSource.BM25) for d, s in res
            ]

        return await asyncio.to_thread(work)

    async def bm25_explain(
        self, tenant_id: int, terms: list[str], k: int
    ) -> list[tuple[Hit, list[TermHit]]]:
        def work():
            with self._lock:
                res = self._bm25.search_explain(tenant_id, terms, k)
            return [
                (Hit(record_id=d, score=s, source=HitSource.BM25), th)
                for d, s, th in res
            ]

        return await asyncio.to_thread(work)

    async def flush(self) -> None:
        wal = self._wal  # snapshot vs concurrent close()
        if wal is not None:
            await wal.wait_durable(wal.append_buffered([]))

    async def get_record_metadata(
        self, tenant_id: int, record_id: int
    ) -> FingerprintMeta:
        row = self._records.get((tenant_id, record_id))
        if row is None:
            raise RecordNotFound(f"record {tenant_id}/{record_id} not found")
        return FingerprintMeta(
            tenant_id=tenant_id,
            record_id=record_id,
            modality=Modality(row["modality"]),
            algorithm=row["algorithm"],
            config_hash=row["config_hash"],
            format_version=row["format_version"],
            fingerprint_bytes=len(row["fingerprint"]),
            has_embedding=row["embedding"] is not None,
            model_id=row["model_id"],
        )

    def list_records(self, tenant_id: int, offset: int = 0,
                     limit: int = 50) -> tuple[list[dict], int]:
        """Paginated per-tenant listing in insertion order ->
        ([{record_id, modality, algorithm, fingerprint_bytes,
        has_embedding}], total)."""
        with self._lock:
            rows = self._tenant_rows.get(tenant_id, {})
            total = len(rows)
            ids = list(itertools.islice(rows.keys(), offset, offset + limit))
            out = []
            for rid in ids:
                row = self._records[(tenant_id, rid)]
                out.append({
                    "record_id": rid,
                    "modality": row["modality"],
                    "algorithm": row["algorithm"],
                    "fingerprint_bytes": len(row["fingerprint"]),
                    "has_embedding": row["embedding"] is not None,
                })
        return out, total

    def get_record(self, tenant_id: int, record_id: int) -> dict:
        row = self._records.get((tenant_id, record_id))
        if row is None:
            raise RecordNotFound(f"record {tenant_id}/{record_id} not found")
        return row

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def compact(self) -> None:
        """Rewrite the WAL as a snapshot of current state (checkpoint).

        Two-phase: the store lock is held only to pin the snapshot
        (sorted row REFS — rows are replaced, never mutated, so the
        refs stay stable) and take the WAL buffer watermark; the encode
        + file write + fsync run OUTSIDE the lock, so queries and
        memory applies proceed during the rewrite (durability acks for
        concurrent ingest wait until the swap, then drain to the new
        log). On the native engine the snapshot is emitted as
        array-direct run frames (byte-identical to the per-event
        encode, so the compacted log is unchanged — only the encode
        cost drops) and the resulting uniform runs make the NEXT
        replay columnar too. A call made while another compaction runs
        waits for it, then compacts."""
        with self._compact_lock:
            wal = self._wal
            ctx = wal.begin_rewrite()
            try:
                with self._lock:
                    wal.mark_rewrite(ctx)
                    items = sorted(self._records.items())
                if wal.supports_encoded_rewrite:
                    wal.commit_rewrite(ctx, blobs=self._snapshot_frames(items))
                else:
                    wal.commit_rewrite(ctx, events=[
                        _upsert_event(tid, rid, row)
                        for (tid, rid), row in items
                    ])
            except BaseException:
                wal.abort_rewrite(ctx)
                raise
            self._wal_floor = self._wal_size()

    def _snapshot_frames(self, items: list) -> Iterator:
        """Encoded WAL frames of a pinned state snapshot (sorted
        ((tenant, rid), row) items) — single frames (bytes) for rows
        with optional fields, fixed-length frame blocks
        ((bytes, frame_len, count)) for maximal uniform
        fingerprint-only runs, the shape NativeWal.rewrite_encoded
        appends in one C call. The framed bytes are identical to
        [encode_event(_upsert_event(...))] in the same order
        (encode_fp_run_block's contract), so this changes the
        snapshot's cost, never its bytes."""
        from .wal import (encode_emb_run_block, encode_event,
                          encode_fp_run_block)

        n = len(items)
        i = 0
        while i < n:
            (tid, rid), row = items[i]
            if (row["text"] is not None
                    or (row["embedding"] is None and row["model_id"])
                    or (row["embedding"] is not None
                        and len(row["embedding"]) == 0)):
                # text rows, model-without-embedding, and degenerate
                # empty embeddings stay per-frame
                yield encode_event(_upsert_event(tid, rid, row))
                i += 1
                continue
            if row["embedding"] is not None:
                mod0 = row["modality"]
                alg0 = row["algorithm"]
                cfg0 = row["config_hash"]
                fmt0 = row["format_version"]
                meta0 = row["metadata"]
                model0 = row["model_id"]
                flen0 = len(row["fingerprint"])
                elen0 = len(row["embedding"])
                j = i + 1
                while j < n:
                    (t2, _), r2 = items[j]
                    e2 = r2["embedding"]
                    if (t2 != tid
                            or e2 is None or len(e2) != elen0
                            or r2["model_id"] != model0
                            or r2["text"] is not None
                            or r2["algorithm"] != alg0
                            or r2["modality"] != mod0
                            or r2["config_hash"] != cfg0
                            or r2["format_version"] != fmt0
                            or r2["metadata"] != meta0
                            or len(r2["fingerprint"]) != flen0):
                        break
                    j += 1
                yield encode_emb_run_block(
                    tid, mod0,
                    [items[k][0][1] for k in range(i, j)],
                    [items[k][1]["fingerprint"] for k in range(i, j)],
                    [items[k][1]["embedding"] for k in range(i, j)],
                    algorithm=alg0, model_id=model0, config_hash=cfg0,
                    format_version=fmt0, metadata=meta0,
                )
                i = j
                continue
            mod0 = row["modality"]
            alg0 = row["algorithm"]
            cfg0 = row["config_hash"]
            fmt0 = row["format_version"]
            meta0 = row["metadata"]
            flen0 = len(row["fingerprint"])
            j = i + 1
            while j < n:
                (t2, _), r2 = items[j]
                if (t2 != tid
                        or r2["embedding"] is not None or r2["model_id"]
                        or r2["text"] is not None
                        or r2["algorithm"] != alg0 or r2["modality"] != mod0
                        or r2["config_hash"] != cfg0
                        or r2["format_version"] != fmt0
                        or r2["metadata"] != meta0
                        or len(r2["fingerprint"]) != flen0):
                    break
                j += 1
            # validate=False: every row passed Record validation at
            # ingest (u64 rid, bytes fingerprint); the loop above pinned
            # the uniform width
            yield encode_fp_run_block(
                tid, mod0,
                [items[k][0][1] for k in range(i, j)],
                [items[k][1]["fingerprint"] for k in range(i, j)],
                algorithm=alg0, config_hash=cfg0, format_version=fmt0,
                metadata=meta0, validate=False,
            )
            i = j

    def _wal_size(self) -> int:
        try:
            return os.path.getsize(self._wal_path)
        except OSError:
            return 0

    async def _maybe_autocompact_async(self) -> None:
        """Event-loop-safe autocompact: the cheap threshold check runs
        inline; the compaction itself (backend lock + full WAL rewrite +
        fsyncs, ~0.3 s per 100k records) runs in a worker thread so it
        never freezes concurrent requests."""
        if self._autocompact_due():
            await asyncio.to_thread(self.maybe_autocompact)

    def _autocompact_due(self) -> bool:
        thresh_mb = float(os.environ.get("UCFP_AUTOCOMPACT_MB", "0") or 0)
        if thresh_mb <= 0:
            return False
        size = self._wal_size()
        floor = getattr(self, "_wal_floor", 0)
        return size > thresh_mb * 1024 * 1024 and size > 2 * max(floor, 1)

    def maybe_autocompact(self) -> bool:
        """Opt-in log-growth bound (UCFP_AUTOCOMPACT_MB): compact when
        the WAL exceeds the threshold AND has doubled since the last
        snapshot — churn-heavy deployments otherwise replay every
        superseded event on restart. Returns True when it compacted;
        False, without waiting, while another compaction runs."""
        if not self._compact_lock.acquire(blocking=False):
            return False
        try:
            if self._autocompact_due():
                self.compact()
                return True
            return False
        finally:
            self._compact_lock.release()
