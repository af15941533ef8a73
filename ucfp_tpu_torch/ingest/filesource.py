"""File-based pull ingest sources.

The reference declares the `IngestSource` seam for future S3/queue
ingestion (src/ingest/mod.rs:18-28) but ships no implementation. These
are the self-hosted equivalents:

  * NdjsonIngestSource — raw Record rows from an NDJSON spool file,
    with a durable sidecar ack offset so a restarted drain resumes
    exactly after the last acked batch (at-least-once semantics).
  * SpoolDirectoryIngestSource — content files dropped into a spool
    directory are fingerprinted through the modality pipeline and
    indexed; acked files move to done/, failures to failed/. This is
    the bulk-loader: many files batch through the device kernels in one
    drain loop instead of one HTTP round trip each.

Run either with `run_ingest_loop` (source.py) or the CLI:

    python -m ucfp_tpu_torch.ingest --data-dir /var/lib/ucfp --spool ./spool

Copied from ucfp_tpu/ingest/filesource.py. Its imports differ, the
fingerprints run on the source's torch device, and the directory spool's
next_batch fingerprints a batch through the batch paths (one multi-hash
launch per image shape, one Wang pass per tenant and sample rate; text
stays host code), with the single-file records and per-file errors. A
batch hands each file out once (the reference's can repeat a batch's
last files; see _next_paths).
"""

from __future__ import annotations

import json
import os
from collections import deque
from pathlib import Path
from typing import Optional

from ..core import Modality, ModalityError, Record
from ..device import resolve_device
from .source import IngestSource


def _int(v) -> int:
    """int() that raises ValueError (the caught type) instead of
    OverflowError on float infinities."""
    try:
        return int(v)
    except OverflowError:
        raise ValueError("non-finite number where an integer is required")


def _record_from_row(row: dict) -> Record:
    fp = row.get("fingerprint", [])
    if isinstance(fp, str):
        fingerprint = bytes.fromhex(fp)
    else:
        fingerprint = bytes(_int(b) & 0xFF for b in fp)
    emb = row.get("embedding")
    if emb is not None:
        if not isinstance(emb, list) or not all(
            isinstance(x, (int, float)) and not isinstance(x, bool) for x in emb
        ):
            raise ValueError("embedding must be a flat list of numbers")
        emb = [float(x) for x in emb]
    meta = row.get("metadata", [])
    if not isinstance(meta, (list, str, bytes)):
        # bytes(int) would zero-allocate that many bytes (same guard as
        # the HTTP upsert handler)
        raise ValueError("metadata must be a list of bytes")
    if isinstance(meta, str):
        meta = meta.encode("utf-8")
    else:
        meta = bytes(_int(b) & 0xFF for b in meta) if isinstance(meta, list) else meta
    return Record(
        tenant_id=_int(row["tenant_id"]),
        record_id=_int(row["record_id"]),
        modality=Modality(row["modality"]),
        algorithm=str(row.get("algorithm", "custom-v1")),
        fingerprint=fingerprint,
        format_version=_int(row.get("format_version", 1)),
        config_hash=_int(row.get("config_hash", 0)),
        embedding=emb,
        model_id=row.get("model_id"),
        text=row.get("text"),
        metadata=meta,
    )


class NdjsonIngestSource(IngestSource):
    """Record rows (PUT /v1/records shape) from an NDJSON file.

    A sidecar `<path>.ack` holds the byte offset of the last durably
    acked batch; reopening resumes from there. Malformed lines are
    skipped and counted (`skipped`), never fatal — one bad row must not
    wedge the spool (same stance as WAL replay)."""

    def __init__(self, path: str):
        self.path = path
        self._ack_path = path + ".ack"
        self.skipped = 0
        self._offset = 0
        if os.path.exists(self._ack_path):
            try:
                with open(self._ack_path) as f:
                    self._offset = int(f.read().strip() or "0")
            except (ValueError, OSError):
                self._offset = 0
        # batches handed out but not yet acked: (frozenset ids, end offset)
        self._inflight: deque = deque()

    async def next_batch(self, max_items: int) -> list[Record]:
        out: list[Record] = []
        pos = self._inflight[-1][1] if self._inflight else self._offset
        with open(self.path, "rb") as f:
            f.seek(pos)
            while len(out) < max_items:
                line = f.readline()
                if not line:
                    break
                pos = f.tell()
                if line.strip():
                    try:
                        out.append(_record_from_row(json.loads(line)))
                    except (ValueError, KeyError, TypeError):
                        self.skipped += 1
        if out:
            ids = frozenset((r.tenant_id, r.record_id) for r in out)
            self._inflight.append((ids, pos))
        elif not self._inflight:
            # nothing pending and nothing new: fully drained — advance
            # past any trailing malformed lines so they aren't re-read
            self._offset = pos
        return out

    async def ack(self, record_ids: list) -> None:
        ids = frozenset(
            (int(t), int(r)) for t, r in record_ids
        )
        while self._inflight and self._inflight[0][0] <= ids:
            self._offset = self._inflight.popleft()[1]
        tmp = self._ack_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self._offset))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ack_path)


# content-file handling for the directory spool ------------------------------

_TEXT_EXT = {".txt", ".md", ".html", ".htm"}
_IMAGE_EXT = {".png", ".jpg", ".jpeg", ".webp", ".bmp", ".gif"}
_AUDIO_EXT = {".f32", ".wav"}


def fingerprint_file(path: Path, tenant_id: int, record_id: int,
                     sample_rate: int = 8000, device=None) -> Record:
    """Fingerprint one content file by extension with the default
    algorithm of its modality (minhash / multi / wang)."""
    ext = path.suffix.lower()
    data = path.read_bytes()
    if ext in _TEXT_EXT:
        return _text_record(data, ext, tenant_id, record_id)
    if ext in _IMAGE_EXT:
        from ..modality import image as imod

        return imod.fingerprint_multi(data, tenant_id, record_id, device=device)
    if ext in _AUDIO_EXT:
        from ..modality import audio as amod

        samples, sr = _audio_samples(data, ext, sample_rate)
        return amod.fingerprint_wang(samples, sr, tenant_id, record_id,
                                     device=device)
    raise ModalityError(f"unsupported spool extension {ext!r}")


def _text_record(data: bytes, ext: str, tenant_id: int, record_id: int) -> Record:
    from ..modality import text as tmod

    opts = tmod.TextOpts(
        preprocess="html" if ext in (".html", ".htm") else None
    )
    return tmod.fingerprint_minhash(
        data.decode("utf-8"), tenant_id, record_id, opts
    )


def _audio_samples(data: bytes, ext: str, sample_rate: int):
    from ..modality import audio as amod

    if ext == ".wav":
        pcm, sr = amod.wav_to_f32(data)
    else:
        pcm, sr = data, sample_rate
    return amod.decode_f32le(pcm), sr


def fingerprint_files(items: list, sample_rate: int = 8000,
                      device=None) -> list:
    """fingerprint_file over [(path, tenant_id, record_id)], batched:
    images are decoded on the host and hashed in one multi-hash launch
    per shape, audio clips in one Wang pass per (tenant, rate) group
    (fingerprint_audio_batch groups equal lengths), text on the host.
    -> one Record or Exception per item, in order, each equal to what
    fingerprint_file gives for that file alone (a group that raises is
    redone file by file, so each file keeps its own error)."""
    import numpy as np

    from ..modality import audio as amod
    from ..modality import image as imod

    out: list = [None] * len(items)
    images: dict = {}  # (h, w) -> [(i, rgb)]
    clips: dict = {}  # (tenant, sr) -> [(i, samples)]
    pre = imod.PreprocessConfig()
    for i, (path, tid, rid) in enumerate(items):
        ext = path.suffix.lower()
        try:
            data = path.read_bytes()
            if ext in _TEXT_EXT:
                out[i] = _text_record(data, ext, tid, rid)
            elif ext in _IMAGE_EXT:
                rgb = imod.decode_rgb(data, pre)
                images.setdefault(rgb.shape, []).append((i, rgb))
            elif ext in _AUDIO_EXT:
                samples, sr = _audio_samples(data, ext, sample_rate)
                clips.setdefault((tid, sr), []).append((i, samples))
            else:
                raise ModalityError(f"unsupported spool extension {ext!r}")
        except Exception as e:  # this file's own error
            out[i] = e

    def one_by_one(group):
        for i, _ in group:
            path, tid, rid = items[i]
            try:
                out[i] = fingerprint_file(path, tid, rid, sample_rate, device)
            except Exception as e:
                out[i] = e

    for group in images.values():
        try:
            recs = imod.fingerprint_batch(
                np.stack([rgb for _, rgb in group]),
                [items[i][1] for i, _ in group],
                [items[i][2] for i, _ in group], pre, device)
        except Exception:
            one_by_one(group)
            continue
        for (i, _), rec in zip(group, recs):
            out[i] = rec
    for (tid, sr), group in clips.items():
        try:
            recs = amod.fingerprint_audio_batch(
                "wang", [x for _, x in group], sr, tid,
                [items[i][2] for i, _ in group], device=device)
        except Exception:
            one_by_one(group)
            continue
        for (i, _), rec in zip(group, recs):
            out[i] = rec
    return out


class SpoolDirectoryIngestSource(IngestSource):
    """Content files named `{tenant}_{record}.{ext}` in a spool dir.

    next_batch fingerprints up to max_items files through the modality
    pipeline; ack moves the files to done/ (failures land in failed/
    immediately so the loop never re-reads them). Files without the
    `{tenant}_{record}` prefix get tenant `default_tenant` and a record
    id hashed from the filename (stable across re-runs)."""

    def __init__(self, spool_dir: str, default_tenant: int = 0,
                 sample_rate: int = 8000, device=None):
        self.dir = Path(spool_dir)
        self.device = resolve_device(device)
        self.done = self.dir / "done"
        self.failed = self.dir / "failed"
        self.done.mkdir(parents=True, exist_ok=True)
        self.failed.mkdir(parents=True, exist_ok=True)
        self.default_tenant = default_tenant
        self.sample_rate = sample_rate
        self.errors: list[tuple[str, str]] = []
        self._inflight: dict[tuple[int, int], Path] = {}
        # cached directory listing: draining a 200k-file spool must not
        # re-list + re-sort the directory per batch (quadratic); the
        # listing refreshes only when exhausted, catching late arrivals
        self._listing: deque = deque()

    def _ids_for(self, path: Path) -> tuple[int, int]:
        parts = path.stem.split("_", 2)
        if len(parts) >= 2:
            try:
                return int(parts[0]), int(parts[1])
            except ValueError:
                pass
        import hashlib

        h = hashlib.sha256(path.name.encode()).digest()
        return self.default_tenant, int.from_bytes(h[:8], "little") >> 1

    def _next_paths(self, max_items: int):
        # `taken` grows with this batch's own picks: the reference's copy
        # (filesource.py:215-234) refreshes the listing mid-batch without
        # them and hands the batch's last files out twice
        taken = set(self._inflight.values())
        out = []
        refreshed = False
        while len(out) < max_items:
            if not self._listing:
                if refreshed:
                    break
                self._listing = deque(
                    p for p in sorted(self.dir.iterdir())
                    if p.is_file() and p not in taken
                )
                refreshed = True
                if not self._listing:
                    break
                continue
            path = self._listing.popleft()
            if path.is_file() and path not in taken:
                out.append(path)
                taken.add(path)
        return out

    async def next_batch(self, max_items: int) -> list[Record]:
        import asyncio

        items = [(path, *self._ids_for(path))
                 for path in self._next_paths(max_items)]
        results = await asyncio.to_thread(
            fingerprint_files, items, self.sample_rate, self.device)
        out: list[Record] = []
        for (path, tid, rid), rec in zip(items, results):
            if isinstance(rec, Exception):  # quarantine, keep draining
                self.errors.append((path.name, f"{type(rec).__name__}: {rec}"))
                path.rename(self.failed / path.name)
                continue
            self._inflight[(tid, rid)] = path
            out.append(rec)
        return out

    async def ack(self, record_ids: list) -> None:
        for key in record_ids:
            path = self._inflight.pop((int(key[0]), int(key[1])), None)
            if path is not None and path.exists():
                path.rename(self.done / path.name)
