"""WAL backends: native C++ (binary frames) with pure-Python JSON fallback.

Both speak the same event-dict protocol the embedded backend uses:
  {"op": "upsert", tenant_id, record_id, modality, algorithm, config_hash,
   format_version, fingerprint: bytes, embedding: list[float]|None,
   model_id, metadata: bytes, text}
  {"op": "delete", tenant_id, record_ids: [..]}

The native path (native/walstore.cpp) frames a compact struct
codec with CRC32 and one fsync per batch; the JSON path keeps hex-encoded
lines. Replay tolerates torn tails in both.

Copied from ucfp_tpu/index/wal.py; only its imports and comments differ
(they no longer quote the reference's measurements), and the bulk
replay's copy of the native buffer (_copy_out), which replays logs of
2 GiB or more.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterable, Iterator

_MOD_TO_U8 = {"text": 0, "image": 1, "audio": 2}
_U8_TO_MOD = {v: k for k, v in _MOD_TO_U8.items()}

OP_UPSERT = 1
OP_DELETE = 2


def encode_event(ev: dict) -> bytes:
    """Binary codec for one WAL event (little-endian, length-prefixed)."""
    if ev["op"] == "delete":
        rids = ev["record_ids"]
        return struct.pack("<BII", OP_DELETE, ev["tenant_id"], len(rids)) + struct.pack(
            f"<{len(rids)}Q", *rids
        )
    alg = ev["algorithm"].encode()
    fp: bytes = ev["fingerprint"]
    emb = ev.get("embedding")
    model = (ev.get("model_id") or "").encode()
    meta: bytes = ev.get("metadata", b"")
    text = ev.get("text")
    if emb is None and not model and text is None:
        # fingerprint-only records (the high-rate image ingest shape)
        # collapse to ONE struct.pack instead of the six-pack bytearray
        # build below.
        # Byte-identical output (tested in test_wal.py).
        return struct.pack(
            f"<BIQBIQBH{len(alg)}sI{len(fp)}sI{len(meta)}s",
            OP_UPSERT,
            ev["tenant_id"],
            ev["record_id"],
            _MOD_TO_U8[ev["modality"]],
            ev.get("format_version", 1),
            ev.get("config_hash", 0),
            0,
            len(alg), alg,
            len(fp), bytes(fp),
            len(meta), meta,
        )
    flags = (1 if emb is not None else 0) | (2 if model else 0) | (
        4 if text is not None else 0
    )
    out = bytearray()
    out += struct.pack(
        "<BIQBIQB",
        OP_UPSERT,
        ev["tenant_id"],
        ev["record_id"],
        _MOD_TO_U8[ev["modality"]],
        ev.get("format_version", 1),
        ev.get("config_hash", 0),
        flags,
    )
    out += struct.pack("<H", len(alg)) + alg
    out += struct.pack("<I", len(fp)) + fp
    if emb is not None:
        out += struct.pack("<I", len(emb)) + struct.pack(f"<{len(emb)}f", *emb)
    if model:
        out += struct.pack("<H", len(model)) + model
    out += struct.pack("<I", len(meta)) + meta
    if text is not None:
        tb = text.encode()
        out += struct.pack("<I", len(tb)) + tb
    return bytes(out)


def encode_events_batch(events: list[dict]) -> list[bytes]:
    """Encode a batch of events, vectorizing the uniform high-rate shape.

    The batch image/text ingest routes produce runs of fingerprint-only
    upserts that differ ONLY in record_id and fingerprint bytes (same
    tenant/modality/format/config/algorithm/metadata, equal fingerprint
    length). Those encode as one numpy row-matrix fill instead of one
    struct.pack per record. Byte-identical to [encode_event(e) for e in events]
    by contract (fuzz-pinned in test_wal.py); any non-uniform batch
    falls through to the per-event encoder.
    """
    n = len(events)
    if n < 4:
        return [encode_event(ev) for ev in events]
    first = events[0]
    if first.get("op") != "upsert":
        return [encode_event(ev) for ev in events]
    fp0 = first.get("fingerprint")
    if not isinstance(fp0, (bytes, bytearray)):
        return [encode_event(ev) for ev in events]
    if first.get("embedding") is not None:
        # uniform embedding runs (the bulk vector-load shape) vectorize
        # too — record_id, fingerprint, and the float block vary; all
        # other fields (incl. model_id) must match the first event
        out = _encode_emb_batch(events, first, n, flen=len(fp0))
        if out is not None:
            return out
        return [encode_event(ev) for ev in events]
    flen = len(fp0)
    tenant = first.get("tenant_id")
    mod = first.get("modality")
    fmt = first.get("format_version", 1)
    cfg = first.get("config_hash", 0)
    alg = first.get("algorithm")
    meta = first.get("metadata", b"")
    # ONE pass: verify uniformity while collecting the two varying
    # fields (the per-event dict lookups dominate this function's cost,
    # so the check and the collection must not be separate loops)
    rids: list[int] = []
    fps: list[bytes] = []
    get = dict.get
    for ev in events:
        fp = get(ev, "fingerprint")
        rid = get(ev, "record_id")
        if (
            get(ev, "op") != "upsert"
            or get(ev, "embedding") is not None
            or get(ev, "model_id")
            or get(ev, "text") is not None
            or get(ev, "tenant_id") != tenant
            or get(ev, "modality") != mod
            or get(ev, "format_version", 1) != fmt
            or get(ev, "config_hash", 0) != cfg
            or get(ev, "algorithm") != alg
            or get(ev, "metadata", b"") != meta
            or type(fp) is not bytes and not isinstance(fp, bytearray)
            or len(fp) != flen
            # record_id must be a genuine in-range int: np.array(...,
            # '<u8') would silently TRUNCATE a float (durably logging
            # the wrong id — memory and replay diverge) and raise a
            # different exception type for negatives than struct.pack;
            # the per-event path preserves the exact pre-batch behavior
            or type(rid) is not int
            or not 0 <= rid < 2**64
        ):
            return [encode_event(ev) for ev in events]
        rids.append(rid)
        fps.append(fp)
    return _fill_fp_frames(first, alg, rids, fps, n, flen)


def _fill_fp_block(first: dict, alg: str, rids: list, fps: list,
                   n: int, flen: int) -> tuple[bytes, int]:
    """One row-matrix fill for a uniform fingerprint-only run: encode the
    first event as the template frame, then overwrite the two varying
    columns (record_id, fingerprint). Returns the concatenated frames +
    the fixed frame length. Byte-identity with the per-event encoder is
    the contract (fuzz-pinned in test_wal.py)."""
    import numpy as np

    template = encode_event(first)
    frame_len = len(template)
    arr = np.empty((n, frame_len), np.uint8)
    arr[:] = np.frombuffer(template, np.uint8)
    # field offsets in the fingerprint-only frame:
    #   <B op><I tenant><Q rid><B mod><I fmt><Q cfg><B flags=0>
    #   <H alen>alg <I flen>fp <I mlen>meta
    arr[:, 5:13] = np.array(rids, dtype="<u8").view(np.uint8).reshape(n, 8)
    if flen:
        fp_off = 27 + 2 + len(alg.encode()) + 4
        arr[:, fp_off : fp_off + flen] = np.frombuffer(
            b"".join(fps), np.uint8
        ).reshape(n, flen)
    return arr.tobytes(), frame_len


def _fill_fp_frames(first: dict, alg: str, rids: list, fps: list,
                    n: int, flen: int) -> list[bytes]:
    big, frame_len = _fill_fp_block(first, alg, rids, fps, n, flen)
    return [big[i * frame_len : (i + 1) * frame_len] for i in range(n)]


def _encode_emb_batch(events: list[dict], first: dict, n: int,
                      flen: int) -> list[bytes] | None:
    """Vectorized encode of a uniform embedding upsert run (same
    tenant/modality/format/config/algorithm/model_id/metadata, no text,
    equal fingerprint width and embedding dim) — record_id, fingerprint
    bytes, and the float block are the only varying fields. Returns
    None when the batch isn't uniform (or any value can't convert the
    numpy way), and the caller runs the per-event encoder — which
    preserves the exact pre-batch error behavior for malformed values.
    Byte-identical to [encode_event(e) for e in events] by contract
    (fuzz-pinned in test_wal.py): struct.pack '<f' and a numpy '<f4'
    cast are the same C double->float conversion."""
    emb0 = first.get("embedding")
    if type(emb0) is not list and type(emb0) is not tuple:
        return None
    elen = len(emb0)
    tenant = first.get("tenant_id")
    mod = first.get("modality")
    fmt = first.get("format_version", 1)
    cfg = first.get("config_hash", 0)
    alg = first.get("algorithm")
    meta = first.get("metadata", b"")
    model = first.get("model_id")
    rids: list[int] = []
    fps: list[bytes] = []
    embs: list = []
    get = dict.get
    for ev in events:
        fp = get(ev, "fingerprint")
        rid = get(ev, "record_id")
        emb = get(ev, "embedding")
        if (
            get(ev, "op") != "upsert"
            or (type(emb) is not list and type(emb) is not tuple)
            or len(emb) != elen
            or get(ev, "model_id") != model
            or get(ev, "text") is not None
            or get(ev, "tenant_id") != tenant
            or get(ev, "modality") != mod
            or get(ev, "format_version", 1) != fmt
            or get(ev, "config_hash", 0) != cfg
            or get(ev, "algorithm") != alg
            or get(ev, "metadata", b"") != meta
            or type(fp) is not bytes and not isinstance(fp, bytearray)
            or len(fp) != flen
            or type(rid) is not int
            or not 0 <= rid < 2**64
        ):
            return None
        rids.append(rid)
        fps.append(fp)
        embs.append(emb)
    try:
        return _fill_emb_frames(first, alg, rids, fps, embs, n, flen, elen)
    except (TypeError, ValueError, FloatingPointError):
        # non-numeric element / finite-double f32 overflow etc: the
        # per-event encoder raises the canonical struct error (or
        # succeeds on __float__-able values)
        return None


def _fill_emb_block(first: dict, alg: str, rids: list, fps: list,
                    embs: list, n: int, flen: int,
                    elen: int) -> tuple[bytes, int]:
    """Row-matrix fill for a uniform embedding run: template frame +
    three varying column blocks (record_id, fingerprint, f32 floats)."""
    import numpy as np

    template = encode_event(first)
    frame_len = len(template)
    arr = np.empty((n, frame_len), np.uint8)
    arr[:] = np.frombuffer(template, np.uint8)
    arr[:, 5:13] = np.array(rids, dtype="<u8").view(np.uint8).reshape(n, 8)
    fp_off = 27 + 2 + len(alg.encode()) + 4
    if flen:
        arr[:, fp_off : fp_off + flen] = np.frombuffer(
            b"".join(fps), np.uint8
        ).reshape(n, flen)
    if elen:
        # over='raise': a FINITE double that overflows f32 must not
        # silently log inf — struct.pack '<f' raises OverflowError
        # there, so the batch path re-raises and the caller falls back
        # to the per-event encoder (which raises canonically). Genuine
        # inf/nan inputs cast exactly and don't trip this.
        with np.errstate(over="raise"):
            mat = np.asarray(embs, dtype="<f4")
        if mat.shape != (n, elen):
            raise ValueError("ragged embedding run")
        emb_off = fp_off + flen + 4
        arr[:, emb_off : emb_off + 4 * elen] = mat.view(np.uint8)
    return arr.tobytes(), frame_len


def _fill_emb_frames(first: dict, alg: str, rids: list, fps: list,
                     embs: list, n: int, flen: int,
                     elen: int) -> list[bytes]:
    big, frame_len = _fill_emb_block(first, alg, rids, fps, embs, n,
                                     flen, elen)
    return [big[i * frame_len : (i + 1) * frame_len] for i in range(n)]


def encode_fp_run(tenant_id: int, modality: str, record_ids,
                  fingerprints, *, algorithm: str, config_hash: int = 0,
                  format_version: int = 1,
                  metadata: bytes = b"") -> list[bytes]:
    """Array-direct encoder for a uniform fingerprint-only upsert run —
    the batch-ingest WAL path without materializing one event dict per
    record (the per-record dict build and its dict.get lookups).
    Byte-identical to
    [encode_event({...}) for each (record_id, fingerprint)] by contract
    (fuzz-pinned in test_wal.py); the dict protocol stays the wire
    format — this is a constructor for it, not a new format."""
    n = len(record_ids)
    if n != len(fingerprints):
        raise ValueError("record_ids and fingerprints length mismatch")
    if n == 0:
        return []
    flen = _check_fp_run(record_ids, fingerprints)
    first = _fp_run_first(tenant_id, modality, record_ids[0],
                          fingerprints[0], algorithm, config_hash,
                          format_version, metadata)
    return _fill_fp_frames(first, algorithm, list(record_ids),
                           fingerprints, n, flen)


def _check_fp_run(record_ids, fingerprints) -> int:
    """Uniform-run input validation shared by the run encoders; returns
    the fingerprint width."""
    fp0 = fingerprints[0]
    if type(fp0) is not bytes and not isinstance(fp0, bytearray):
        raise ValueError("fingerprints must be bytes")
    flen = len(fp0)
    for fp in fingerprints:
        if (type(fp) is not bytes and not isinstance(fp, bytearray)) \
                or len(fp) != flen:
            raise ValueError("fingerprint run must be uniform bytes")
    for rid in record_ids:
        # genuine in-range ints only: np.array(..., '<u8') silently
        # truncates floats (durably logging the WRONG id) — same guard
        # as encode_events_batch
        if type(rid) is not int or not 0 <= rid < 2**64:
            raise ValueError(f"record_id out of u64 range: {rid!r}")
    return flen


def _fp_run_first(tenant_id, modality, rid0, fp0, algorithm,
                  config_hash, format_version, metadata) -> dict:
    return {
        "op": "upsert",
        "tenant_id": tenant_id,
        "record_id": rid0,
        "modality": modality,
        "format_version": format_version,
        "config_hash": config_hash,
        "algorithm": algorithm,
        "fingerprint": bytes(fp0),
        "metadata": metadata,
        "embedding": None,
        "model_id": None,
        "text": None,
    }


def encode_fp_run_block(tenant_id: int, modality: str, record_ids,
                        fingerprints, *, algorithm: str,
                        config_hash: int = 0, format_version: int = 1,
                        metadata: bytes = b"",
                        validate: bool = True) -> tuple[bytes, int, int]:
    """encode_fp_run without the per-frame slicing: returns
    (concatenated_frames, frame_len, count) for engines that can append
    a fixed-length frame block in one call (NativeWal.rewrite_encoded).
    `validate=False` skips the per-item input checks for callers whose
    inputs are already store-validated (compaction snapshots — every
    row passed Record validation at ingest); the emitted bytes are
    identical either way."""
    n = len(record_ids)
    if n != len(fingerprints):
        raise ValueError("record_ids and fingerprints length mismatch")
    if n == 0:
        return b"", 0, 0
    flen = (_check_fp_run(record_ids, fingerprints) if validate
            else len(fingerprints[0]))
    first = _fp_run_first(tenant_id, modality, record_ids[0],
                          fingerprints[0], algorithm, config_hash,
                          format_version, metadata)
    block, frame_len = _fill_fp_block(first, algorithm, list(record_ids),
                                      fingerprints, n, flen)
    return block, frame_len, n


def encode_emb_run(tenant_id: int, modality: str, record_ids,
                   fingerprints, emb_mat, *, algorithm: str,
                   model_id: str | None = None, config_hash: int = 0,
                   format_version: int = 1,
                   metadata: bytes = b"") -> list[bytes]:
    """Array-direct encoder for a uniform embedding upsert run — the
    bulk vector-load WAL path without per-record event dicts or float
    lists (`emb_mat` is the [n, d] f32 matrix itself). Byte-identical
    to [encode_event({...}) per row] by contract (fuzz-pinned in
    test_wal.py); the dict protocol stays the wire format — this is a
    constructor for it, not a new format."""
    import numpy as np

    n = len(record_ids)
    if n != len(fingerprints):
        raise ValueError("record_ids and fingerprints length mismatch")
    if n == 0:
        return []
    mat = np.asarray(emb_mat, dtype="<f4")
    if mat.ndim != 2 or mat.shape[0] != n or mat.shape[1] == 0:
        raise ValueError("emb_mat must be a non-empty [n, d] matrix")
    flen = _check_fp_run(record_ids, fingerprints)
    first = {
        "op": "upsert",
        "tenant_id": tenant_id,
        "record_id": record_ids[0],
        "modality": modality,
        "format_version": format_version,
        "config_hash": config_hash,
        "algorithm": algorithm,
        "fingerprint": bytes(fingerprints[0]),
        "metadata": metadata,
        "embedding": mat[0],
        "model_id": model_id,
        "text": None,
    }
    return _fill_emb_frames(first, algorithm, list(record_ids),
                            fingerprints, mat, n, flen, mat.shape[1])


def encode_emb_run_block(tenant_id: int, modality: str, record_ids,
                         fingerprints, embeddings, *, algorithm: str,
                         model_id: str | None = None,
                         config_hash: int = 0, format_version: int = 1,
                         metadata: bytes = b"") -> tuple[bytes, int, int]:
    """encode_fp_run_block for a uniform embedding run — compaction
    snapshots of bulk-loaded vector catalogs. The caller guarantees
    store-validated uniform inputs (equal fingerprint width and
    embedding dim, shared model_id); the emitted bytes are identical to
    [encode_event(...) per row] in the same order (fuzz-pinned in
    test_wal.py)."""
    n = len(record_ids)
    if n == 0:
        return b"", 0, 0
    flen = len(fingerprints[0])
    elen = len(embeddings[0])
    first = {
        "op": "upsert",
        "tenant_id": tenant_id,
        "record_id": record_ids[0],
        "modality": modality,
        "format_version": format_version,
        "config_hash": config_hash,
        "algorithm": algorithm,
        "fingerprint": bytes(fingerprints[0]),
        "metadata": metadata,
        "embedding": list(embeddings[0]),
        "model_id": model_id,
        "text": None,
    }
    block, frame_len = _fill_emb_block(first, algorithm, list(record_ids),
                                       fingerprints, embeddings, n, flen,
                                       elen)
    return block, frame_len, n


def decode_event(data: bytes) -> dict:
    op = data[0]
    if op == OP_DELETE:
        tenant, n = struct.unpack_from("<II", data, 1)
        rids = list(struct.unpack_from(f"<{n}Q", data, 9))
        return {"op": "delete", "tenant_id": tenant, "record_ids": rids}
    (_, tenant, rid, mod, fmt, cfg, flags) = struct.unpack_from("<BIQBIQB", data, 0)
    off = struct.calcsize("<BIQBIQB")
    (alen,) = struct.unpack_from("<H", data, off)
    off += 2
    alg = data[off : off + alen].decode()
    off += alen
    (flen,) = struct.unpack_from("<I", data, off)
    off += 4
    fp = data[off : off + flen]
    off += flen
    emb = None
    if flags & 1:
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        emb = list(struct.unpack_from(f"<{n}f", data, off))
        off += 4 * n
    model = None
    if flags & 2:
        (mlen,) = struct.unpack_from("<H", data, off)
        off += 2
        model = data[off : off + mlen].decode()
        off += mlen
    (melen,) = struct.unpack_from("<I", data, off)
    off += 4
    meta = data[off : off + melen]
    off += melen
    text = None
    if flags & 4:
        (tlen,) = struct.unpack_from("<I", data, off)
        off += 4
        text = data[off : off + tlen].decode()
    return {
        "op": "upsert",
        "tenant_id": tenant,
        "record_id": rid,
        "modality": _U8_TO_MOD[mod],
        "format_version": fmt,
        "config_hash": cfg,
        "algorithm": alg,
        "fingerprint": fp,
        "embedding": emb,
        "model_id": model,
        "metadata": meta,
        "text": text,
    }


def _fp_run_layout(tmpl: dict, frame_len: int) -> tuple[int, int] | None:
    """(fp_off, flen) of a fingerprint-only frame template, or None when
    the frame isn't the collapsed fp-only layout (optional fields
    present, or the field lengths don't tile the frame exactly)."""
    if (
        tmpl.get("embedding") is not None
        or tmpl.get("model_id")
        or tmpl.get("text") is not None
    ):
        return None
    alen = len(tmpl["algorithm"].encode())
    flen = len(tmpl["fingerprint"])
    mlen = len(tmpl["metadata"])
    fp_off = 33 + alen  # <B op><I tid><Q rid><B mod><I fmt><Q cfg><B 0><H alen>alg<I flen>
    if frame_len != fp_off + flen + 4 + mlen:
        return None  # layout drift or trailing fields: per-frame path
    return fp_off, flen


def _run_layout(tmpl: dict, frame_len: int) -> tuple[int, int, int] | None:
    """(fp_off, flen, elen) of a run-decodable upsert frame template:
    elen == 0 is the fingerprint-only layout, elen > 0 an embedding
    frame (model_id allowed — it is template-uniform, not varying).
    None when the frame can't run-decode (text present, or the field
    lengths don't tile the frame exactly)."""
    if tmpl.get("text") is not None:
        return None
    emb = tmpl.get("embedding")
    if emb is None:
        lay = _fp_run_layout(tmpl, frame_len)
        return None if lay is None else (lay[0], lay[1], 0)
    alen = len(tmpl["algorithm"].encode())
    flen = len(tmpl["fingerprint"])
    elen = len(emb)
    if elen == 0:
        # a zero-length embedding frame would alias the fp-only tuple
        # (elen 0 marks fp-only downstream): degenerate, per-frame path
        return None
    mlen = len(tmpl["metadata"])
    model = tmpl.get("model_id")
    modlen = 2 + len(model.encode()) if model else 0
    fp_off = 33 + alen
    if frame_len != fp_off + flen + 4 + 4 * elen + modlen + 4 + mlen:
        return None
    return fp_off, flen, elen


def _fp_run_cols(arr, tmpl: dict, fp_off: int, flen: int) -> dict:
    """Extract the two varying columns (record_id, fingerprint) of a
    VERIFIED-uniform fp-only frame block into one run dict."""
    import numpy as np

    rids = np.ascontiguousarray(arr[:, 5:13]).view("<u8").ravel().tolist()
    fp_block = np.ascontiguousarray(arr[:, fp_off : fp_off + flen]).tobytes()
    return {
        "tenant_id": tmpl["tenant_id"],
        "modality": tmpl["modality"],
        "format_version": tmpl["format_version"],
        "config_hash": tmpl["config_hash"],
        "algorithm": tmpl["algorithm"],
        "metadata": tmpl["metadata"],
        "record_ids": rids,
        "fp_block": fp_block,
        "flen": flen,
    }


def _emb_run_cols(arr, tmpl: dict, fp_off: int, flen: int,
                  elen: int) -> dict:
    """Extract the three varying columns (record_id, fingerprint, f32
    block) of a VERIFIED-uniform embedding frame block into one run
    dict."""
    import numpy as np

    run = _fp_run_cols(arr, tmpl, fp_off, flen)
    emb_off = fp_off + flen + 4
    run["model_id"] = tmpl.get("model_id")
    run["elen"] = elen
    # ONE copy (strided frame columns -> contiguous), viewed as the
    # [n, elen] f32 matrix the columnar apply uploads directly
    run["emb_mat"] = np.ascontiguousarray(
        arr[:, emb_off : emb_off + 4 * elen]
    ).view("<f4")
    return run


def _try_decode_run(arr) -> tuple[str, dict] | None:
    """Vectorized decode of a frame block as ONE uniform upsert run —
    the exact inverse of _fill_fp_frames / _fill_emb_frames. `arr` is a
    [n, frame_len] u8 matrix of equal-length OP_UPSERT frames. Returns
    ("fp_run"|"emb_run", run columns) when every frame matches frame 0
    on every byte outside the varying fields (record_id at [5:13],
    fingerprint, and the embedding float block at their length-derived
    offsets), else None. Equality with per-frame decode_event is the
    contract (fuzz-pinned in test_wal.py)."""
    import numpy as np

    n, frame_len = arr.shape
    tmpl = decode_event(arr[0].tobytes())
    layout = _run_layout(tmpl, frame_len)
    if layout is None:
        return None
    fp_off, flen, elen = layout
    col_ok = np.ones(frame_len, bool)
    col_ok[5:13] = False
    col_ok[fp_off : fp_off + flen] = False
    if elen:
        emb_off = fp_off + flen + 4
        col_ok[emb_off : emb_off + 4 * elen] = False
    if (arr[:, col_ok] != arr[0, col_ok]).any():
        return None
    if elen:
        return "emb_run", _emb_run_cols(arr, tmpl, fp_off, flen, elen)
    return "fp_run", _fp_run_cols(arr, tmpl, fp_off, flen)


def fp_run_events(run: dict) -> Iterator[dict]:
    """Expand a decoded run back to its per-event dicts (the fallback
    seam when a run cannot be applied columnar — dup/present record ids,
    special algorithms). Identical to decoding each frame."""
    flen = run["flen"]
    block = run["fp_block"]
    for i, rid in enumerate(run["record_ids"]):
        yield {
            "op": "upsert",
            "tenant_id": run["tenant_id"],
            "record_id": rid,
            "modality": run["modality"],
            "format_version": run["format_version"],
            "config_hash": run["config_hash"],
            "algorithm": run["algorithm"],
            "fingerprint": block[i * flen : (i + 1) * flen],
            "embedding": None,
            "model_id": None,
            "metadata": run["metadata"],
            "text": None,
        }


def emb_run_events(run: dict) -> Iterator[dict]:
    """fp_run_events for an embedding run: each event regains its float
    list (np f32 -> Python float is the same exact widening struct
    '<f' unpack performs)."""
    flen = run["flen"]
    block = run["fp_block"]
    mat = run["emb_mat"]
    for i, rid in enumerate(run["record_ids"]):
        yield {
            "op": "upsert",
            "tenant_id": run["tenant_id"],
            "record_id": rid,
            "modality": run["modality"],
            "format_version": run["format_version"],
            "config_hash": run["config_hash"],
            "algorithm": run["algorithm"],
            "fingerprint": block[i * flen : (i + 1) * flen],
            "embedding": mat[i].tolist(),
            "model_id": run["model_id"],
            "metadata": run["metadata"],
            "text": None,
        }


# runs shorter than this go straight to per-frame decode: the vectorized
# template validation has fixed setup cost (a decode + two masked
# comparisons) that only pays for itself on genuine runs
_MIN_RUN = 8
# bound the [n, frame_len] reshape working set (~256k frames of a
# 128-byte frame is a 32 MB view — the template comparison copies only
# the non-varying columns)
_MAX_RUN = 262144


def _copy_out(ptr, nbytes: int):
    """`nbytes` at a ctypes pointer -> a numpy uint8 array owning a copy:
    one memcpy through the buffer protocol. (ctypes.string_at, which the
    reference uses here, takes its size as a C int, so a log of 2 GiB or
    more replayed short and failed.)"""
    import ctypes

    import numpy as np

    if nbytes == 0:
        return np.zeros(0, np.uint8)
    buf = (ctypes.c_uint8 * nbytes).from_address(ctypes.addressof(ptr.contents))
    return np.frombuffer(buf, np.uint8).copy()


def iter_frame_groups(data, offs) -> Iterator[tuple[str, object]]:
    """Group a replay's raw frames into ("fp_run", run) | ("emb_run",
    run) | ("events", [dict, ...]) items, preserving order. `data` is
    the concatenated payload buffer (np.uint8), `offs` the (n+1) frame
    offsets. Uniform fingerprint-only and uniform embedding upsert runs
    — the batch-ingest / bulk-vector-load / compaction shapes — decode
    as columns in one vectorized pass; everything else decodes per
    frame. The concatenation of the yielded groups equals
    [decode_event(f) for f in frames] exactly (fuzz-pinned)."""
    import numpy as np

    n = len(offs) - 1
    if n <= 0:
        return
    lens = np.diff(offs)
    first = data[offs[:-1]]  # op byte of each frame
    # candidate boundaries: frame length or op byte changes. Frames of
    # equal length may still mix tenants/algorithms — _split refines by
    # template equality and validates each sub-run with its own layout.
    brk = np.flatnonzero((lens[1:] != lens[:-1]) | (first[1:] != first[:-1]))
    starts = np.concatenate([[0], brk + 1, [n]])
    for gi in range(len(starts) - 1):
        s, e = int(starts[gi]), int(starts[gi + 1])
        if int(first[s]) != OP_UPSERT or e - s < _MIN_RUN:
            yield (
                "events",
                [
                    decode_event(data[offs[i] : offs[i + 1]].tobytes())
                    for i in range(s, e)
                ],
            )
            continue
        frame_len = int(lens[s])
        for cs in range(s, e, _MAX_RUN):
            ce = min(cs + _MAX_RUN, e)
            block = data[offs[cs] : offs[cs] + (ce - cs) * frame_len]
            yield from _split_fp_runs(block.reshape(ce - cs, frame_len))


def _split_fp_runs(arr) -> Iterator[tuple[str, object]]:
    """Split an equal-length OP_UPSERT frame block into template-uniform
    sub-runs and vectorized-decode each; sub-runs that fail their own
    layout validation fall back to per-frame decode. The boundary scan
    uses frame 0's field layout as a heuristic only — correctness rests
    on each sub-run being validated against its OWN first frame: when
    the sub-run's layout equals the scan's masked layout, the scan
    already proved byte-uniformity outside the varying fields (the
    alen/flen/elen length fields are unmasked, so a layout change
    always splits); otherwise _try_decode_run re-compares in full.
    Embedding frames run-decode too (record_id, fingerprint, and the
    f32 block are the varying fields)."""
    import numpy as np

    n, frame_len = arr.shape
    ev0 = decode_event(arr[0].tobytes())
    alen0 = len(ev0["algorithm"].encode())
    flen0 = len(ev0.get("fingerprint") or b"")
    emb0 = ev0.get("embedding")
    elen0 = len(emb0) if emb0 is not None else 0
    col_ok = np.ones(frame_len, bool)
    col_ok[5:13] = False
    fp_off0 = 33 + alen0
    masked0 = None  # (fp_off, flen, elen) actually masked by the scan
    if fp_off0 + flen0 <= frame_len:
        col_ok[fp_off0 : fp_off0 + flen0] = False
        masked0 = (fp_off0, flen0, 0)
        if elen0:
            emb_off0 = fp_off0 + flen0 + 4
            if emb_off0 + 4 * elen0 <= frame_len:
                col_ok[emb_off0 : emb_off0 + 4 * elen0] = False
                masked0 = (fp_off0, flen0, elen0)
            else:
                masked0 = None  # emb floats unmasked: no proven shortcut
    tcols = arr[:, col_ok]
    diff = (tcols[1:] != tcols[:-1]).any(axis=1)
    starts = np.concatenate([[0], np.flatnonzero(diff) + 1, [n]])
    for gi in range(len(starts) - 1):
        s, e = int(starts[gi]), int(starts[gi + 1])
        item = None
        if e - s >= _MIN_RUN:
            tmpl = decode_event(arr[s].tobytes())
            layout = _run_layout(tmpl, frame_len)
            if layout is not None and layout == masked0:
                # same layout the scan masked: uniformity is proven
                fp_off, flen, elen = layout
                if elen:
                    item = ("emb_run", _emb_run_cols(
                        arr[s:e], tmpl, fp_off, flen, elen))
                else:
                    item = ("fp_run", _fp_run_cols(
                        arr[s:e], tmpl, fp_off, flen))
            elif layout is not None:
                item = _try_decode_run(arr[s:e])
        if item is not None:
            yield item
        else:
            yield (
                "events",
                [decode_event(arr[i].tobytes()) for i in range(s, e)],
            )


class NativeWal:
    """C++ walstore-backed log."""

    def __init__(self, path: str, lib):
        self._lib = lib
        self._path = path
        self._h = lib.ucfp_wal_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open native WAL at {path}")

    @staticmethod
    def encode(ev: dict) -> bytes:
        """Pre-encode an event to its framed payload (fail-fast seam for
        the group-commit buffer)."""
        return encode_event(ev)

    # batch-aware variant (vectorizes the uniform high-rate shape);
    # GroupCommitWal.append_buffered prefers it when the engine has one
    encode_batch = staticmethod(encode_events_batch)
    # array-direct variants (no per-record event dicts at all);
    # GroupCommitWal.append_buffered_run / append_buffered_emb_run
    # prefer them when present
    encode_fp_run = staticmethod(encode_fp_run)
    encode_emb_run = staticmethod(encode_emb_run)

    def append_encoded_nosync(self, blobs: list[bytes]) -> None:
        """Buffer pre-encoded frames; durable only after flush().

        Multi-frame batches cross ctypes ONCE (one concatenated payload
        + a lens array into ucfp_wal_append_many — byte-identical
        framing)."""
        if len(blobs) > 1:
            import ctypes

            lens = (ctypes.c_uint32 * len(blobs))(*(len(b) for b in blobs))
            rc = self._lib.ucfp_wal_append_many(
                self._h, b"".join(blobs), lens, len(blobs)
            )
            if rc != 0:
                raise OSError(f"wal append failed: {rc}")
            return
        for blob in blobs:
            rc = self._lib.ucfp_wal_append(self._h, blob, len(blob))
            if rc != 0:
                raise OSError(f"wal append failed: {rc}")

    def append_block_nosync(self, block: bytes, frame_len: int,
                            count: int) -> None:
        """Buffer `count` fixed-length frames from one concatenated
        buffer (encode_fp_run_block's shape); durable only after
        flush(). Byte-identical to appending each frame."""
        if count == 0:
            return
        rc = self._lib.ucfp_wal_append_fixed(
            self._h, block, frame_len, count)
        if rc != 0:
            raise OSError(f"wal append failed: {rc}")

    def append_nosync(self, events: list[dict]) -> None:
        """Buffer frames in the engine; durable only after flush()."""
        self.append_encoded_nosync([self.encode(ev) for ev in events])

    def append_events(self, events: list[dict]) -> None:
        self.append_nosync(events)
        rc = self._lib.ucfp_wal_commit(self._h)
        if rc != 0:
            raise OSError(f"wal commit failed: {rc}")

    def replay(self) -> Iterator[dict]:
        import ctypes

        events: list[dict] = []

        def cb(_ctx, data_ptr, length):
            events.append(decode_event(ctypes.string_at(data_ptr, length)))

        cfunc = self._lib._replay_cb_type(cb)
        self._lib.ucfp_wal_replay(self._path.encode(), cfunc, None)
        return iter(events)

    def replay_groups(self) -> Iterator[tuple[str, object]]:
        """Replay as run-grouped items (see iter_frame_groups) — the
        restart-scale path: ONE C call hands back every validated frame
        in a concatenated buffer, uniform fingerprint-only runs decode
        as columns, and nothing crosses ctypes per record."""
        import ctypes

        data_p = ctypes.POINTER(ctypes.c_uint8)()
        offs_p = ctypes.POINTER(ctypes.c_uint64)()
        n = self._lib.ucfp_wal_replay_concat(
            self._path.encode(), ctypes.byref(data_p), ctypes.byref(offs_p)
        )
        if n < 0:
            raise MemoryError("wal bulk replay allocation failed")
        if n == 0:
            return
        try:
            offs = _copy_out(offs_p, (n + 1) * 8).view("<u8")
            data = _copy_out(data_p, int(offs[-1]))
        finally:
            self._lib.ucfp_wal_buf_free(data_p)
            self._lib.ucfp_wal_buf_free(offs_p)
        yield from iter_frame_groups(data, offs)

    def rewrite(self, events: Iterable[dict]) -> None:
        """Compaction: write a snapshot log and atomically replace.

        Failure-safe: any error while writing or replacing abandons the
        .tmp target and reattaches to the ORIGINAL log — the object must
        never be left appending to the tmp file (those events would be
        invisible to the next replay)."""
        self.rewrite_encoded(self.encode(ev) for ev in events)

    # frames buffered per append chunk during rewrite_encoded: bounds
    # the b"".join working set without paying a C crossing per frame
    _REWRITE_CHUNK = 65536

    def rewrite_encoded(self, blobs) -> None:
        """rewrite() over pre-encoded frames — the compaction fast path
        (the store emits array-direct run frames, no per-record event
        dicts). Items are single frames (bytes) or fixed-length frame
        blocks ((concatenated_frames, frame_len, count) tuples, the
        encode_fp_run_block shape). Same failure-safety contract as
        rewrite()."""
        tmp = self._path + ".tmp"
        if os.path.exists(tmp):
            os.unlink(tmp)
        old_path = self._path
        self.close()
        nh = self._lib.ucfp_wal_open(tmp.encode())
        if not nh:
            self._h = self._lib.ucfp_wal_open(old_path.encode())
            raise OSError("cannot open compaction target")
        self._h = nh
        self._path = tmp
        try:
            chunk: list[bytes] = []
            for item in blobs:
                if type(item) is tuple:
                    if chunk:
                        self.append_encoded_nosync(chunk)
                        chunk = []
                    self.append_block_nosync(*item)
                    continue
                chunk.append(item)
                if len(chunk) >= self._REWRITE_CHUNK:
                    self.append_encoded_nosync(chunk)
                    chunk = []
            if chunk:
                self.append_encoded_nosync(chunk)
            self.flush()
            rc = self._lib.ucfp_wal_replace(self._h, old_path.encode())
            if rc != 0:
                raise OSError(f"wal replace failed: {rc}")
        except BaseException:
            self.close()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            self._path = old_path
            self._h = self._lib.ucfp_wal_open(old_path.encode())
            raise
        self._path = old_path

    def flush(self) -> None:
        rc = self._lib.ucfp_wal_commit(self._h)
        if rc != 0:
            raise OSError(f"wal flush failed: {rc}")

    def close(self) -> None:
        if self._h:
            self._lib.ucfp_wal_close(self._h)
            self._h = None


class JsonWal:
    """Pure-Python NDJSON log (hex-encoded bytes), torn-tail tolerant."""

    def __init__(self, path: str):
        self._path = path
        self._truncate_torn_tail()
        self._f = open(path, "ab")

    def _truncate_torn_tail(self) -> None:
        """Drop a crash-torn tail BEFORE appending: new lines written
        after a partial line would corrupt it and then be invisible to
        replay (which stops at the first bad line) — the same silent
        blackhole the native engine truncates at open."""
        if not os.path.exists(self._path) or os.path.getsize(self._path) == 0:
            return
        good = 0
        with open(self._path, "rb") as f:
            while True:
                line = f.readline()
                if not line:
                    break
                if not line.endswith(b"\n"):
                    break  # torn tail
                stripped = line.strip()
                if stripped:
                    try:
                        self._from_json(json.loads(stripped))
                    except (json.JSONDecodeError, KeyError, ValueError):
                        break
                good = f.tell()
        if good < os.path.getsize(self._path):
            with open(self._path, "rb+") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())

    @staticmethod
    def _to_json(ev: dict) -> dict:
        if ev["op"] == "delete":
            return ev
        out = dict(ev)
        out["fingerprint"] = ev["fingerprint"].hex()
        out["metadata"] = ev.get("metadata", b"").hex()
        emb = out.get("embedding")
        if emb is not None and not isinstance(emb, (list, tuple)):
            # compaction snapshots hand back the store's np.float32
            # rows (index/embedded.py _apply_upsert); json can't dump
            # numpy scalars — widen to Python floats (exact)
            out["embedding"] = [float(x) for x in emb]
        return {k: v for k, v in out.items() if v is not None}

    @staticmethod
    def _from_json(ev: dict) -> dict:
        if ev["op"] == "delete":
            return ev
        out = dict(ev)
        out["fingerprint"] = bytes.fromhex(ev["fingerprint"])
        out["metadata"] = bytes.fromhex(ev.get("metadata", ""))
        out.setdefault("embedding", None)
        out.setdefault("model_id", None)
        out.setdefault("text", None)
        out.setdefault("format_version", 1)
        out.setdefault("config_hash", 0)
        return out

    def encode(self, ev: dict) -> bytes:
        """Pre-encode an event to its NDJSON line (fail-fast seam for the
        group-commit buffer)."""
        return json.dumps(self._to_json(ev), separators=(",", ":")).encode() + b"\n"

    def append_encoded_nosync(self, blobs: list[bytes]) -> None:
        """Write pre-encoded lines without the fsync. A partial write
        (ENOSPC mid-batch) is ROLLED BACK by truncating to the pre-write
        offset: the group-commit retry would otherwise append the batch
        again after a torn fragment, producing one malformed line
        mid-file — and replay stops at the first bad line, silently
        dropping every LATER fsync-acked event."""
        pos = self._f.tell()
        try:
            self._f.write(b"".join(blobs))
            self._f.flush()
        except BaseException:
            try:
                self._f.seek(pos)
                self._f.truncate(pos)
            except OSError:
                pass  # rollback best-effort; replay's torn-tail guard
                # still covers an EOF fragment
            raise

    def append_nosync(self, events: list[dict]) -> None:
        """Write lines without the fsync; durable only after flush()."""
        self.append_encoded_nosync([self.encode(e) for e in events])

    def append_events(self, events: list[dict]) -> None:
        self.append_nosync(events)
        os.fsync(self._f.fileno())

    def replay(self) -> Iterator[dict]:
        if not os.path.exists(self._path):
            return iter(())
        events = []
        with open(self._path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(self._from_json(json.loads(line)))
                except (json.JSONDecodeError, KeyError, ValueError):
                    break  # torn tail
        return iter(events)

    def rewrite(self, events: Iterable[dict]) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            for e in events:
                f.write(
                    json.dumps(self._to_json(e), separators=(",", ":")).encode()
                    + b"\n"
                )
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        try:
            os.replace(tmp, self._path)
            # journal the rename itself (the native engine's
            # ucfp_wal_replace fsyncs the directory too) or a crash can
            # resurrect the pre-compaction log
            dfd = os.open(
                os.path.dirname(os.path.abspath(self._path)) or ".",
                os.O_RDONLY,
            )
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        finally:
            # ALWAYS reattach an append handle — callers (GroupCommitWal
            # retry rounds) assume the engine still points at a live log
            # after a failed rewrite; a closed handle would fail every
            # subsequent round forever
            self._f = open(self._path, "ab")

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class GroupCommitWal:
    """Leader-less group commit over either engine: concurrent writers
    buffer events and share ONE fsync, performed by a dedicated writer
    thread.

    The reference amortizes one fsync per upsert *batch*
    (src/index/embedded/mod.rs:157-227 — one redb txn commit); nothing
    there coalesces *concurrent requests*. At one fsync per HTTP upsert
    the end-to-end ingest path is fsync-bound, so
    this wrapper decouples append order from durability:

      seq = wal.append_buffered(events)   # cheap, caller-ordered
      wal.sync_until(seq)                 # or: await wal.wait_durable(seq)

    All events buffered before the writer thread's next round ride one
    fsync. Durability-before-ack is preserved (callers return only after
    their seq commits). On fsync failure the un-synced batch is restored
    to the buffer head — a later successful round may make a failed
    caller's events durable anyway (ack-lost, not data-lost), and replay
    is upsert-idempotent so re-appended duplicates are harmless.

    Every inner-engine call is serialized through this class: the engines
    themselves are single-threaded by contract.
    """

    def __init__(self, inner):
        import threading

        self._inner = inner
        self._cv = threading.Condition()
        self._buf: list[bytes] = []  # pre-encoded blobs, append order
        self._queued = 0
        self._committed = 0
        self._round_err: BaseException | None = None
        self._in_round = False
        self._paused = False
        self._stopped = False
        self._futures: list[tuple[int, object]] = []  # (seq, concurrent Future)
        self._writer = threading.Thread(
            target=self._run, name="ucfp-wal-sync", daemon=True
        )
        self._writer.start()

    # -- hot path ----------------------------------------------------------

    def append_buffered(self, events: list[dict]) -> int:
        """Queue events (ordered by the caller's lock discipline) and
        return the ticket to wait on. Never blocks on I/O. Events are
        encoded HERE so a malformed record fails the caller before any
        state is applied — and can never poison the writer thread."""
        encode_batch = getattr(self._inner, "encode_batch", None)
        if encode_batch is not None:
            blobs = encode_batch(events)
        else:
            blobs = [self._inner.encode(ev) for ev in events]
        return self._queue_blobs(blobs)

    def append_buffered_run(self, tenant_id: int, modality: str,
                            record_ids, fingerprints, *, algorithm: str,
                            config_hash: int = 0, format_version: int = 1,
                            metadata: bytes = b"") -> int:
        """append_buffered for a uniform fingerprint-only upsert run,
        encoded array-direct when the engine supports it (no per-record
        event dicts); engines without the hook (JSON) get the equivalent
        dicts — identical replay either way."""
        enc = getattr(self._inner, "encode_fp_run", None)
        if enc is not None:
            blobs = enc(tenant_id, modality, record_ids, fingerprints,
                        algorithm=algorithm, config_hash=config_hash,
                        format_version=format_version, metadata=metadata)
            return self._queue_blobs(blobs)
        return self.append_buffered([
            {"op": "upsert", "tenant_id": tenant_id, "record_id": rid,
             "modality": modality, "format_version": format_version,
             "config_hash": config_hash, "algorithm": algorithm,
             "fingerprint": bytes(fp), "metadata": metadata,
             "embedding": None, "model_id": None, "text": None}
            for rid, fp in zip(record_ids, fingerprints)
        ])

    def append_buffered_emb_run(self, tenant_id: int, modality: str,
                                record_ids, fingerprints, emb_mat, *,
                                algorithm: str,
                                model_id: str | None = None,
                                config_hash: int = 0,
                                format_version: int = 1,
                                metadata: bytes = b"") -> int:
        """append_buffered for a uniform embedding upsert run (the bulk
        vector-load shape), encoded array-direct when the engine
        supports it; engines without the hook (JSON) get the equivalent
        dicts — identical replay either way (the floats are the f32
        rows in both)."""
        enc = getattr(self._inner, "encode_emb_run", None)
        if enc is not None:
            blobs = enc(tenant_id, modality, record_ids, fingerprints,
                        emb_mat, algorithm=algorithm, model_id=model_id,
                        config_hash=config_hash,
                        format_version=format_version, metadata=metadata)
            return self._queue_blobs(blobs)
        return self.append_buffered([
            {"op": "upsert", "tenant_id": tenant_id, "record_id": rid,
             "modality": modality, "format_version": format_version,
             "config_hash": config_hash, "algorithm": algorithm,
             "fingerprint": bytes(fp), "metadata": metadata,
             "embedding": [float(x) for x in row],
             "model_id": model_id, "text": None}
            for rid, fp, row in zip(record_ids, fingerprints, emb_mat)
        ])

    def _queue_blobs(self, blobs: list[bytes]) -> int:
        with self._cv:
            if self._stopped:
                raise OSError("wal closed")
            self._buf.extend(blobs)
            self._queued += 1
            self._cv.notify_all()
            return self._queued

    def sync_until(self, seq: int) -> None:
        """Block until everything up to ticket `seq` is fsync'd."""
        with self._cv:
            while self._committed < seq:
                if self._round_err is not None and not self._in_round:
                    # last round failed and nothing is being retried right
                    # now — surface it (the buffer was restored; a later
                    # append may still retry and succeed)
                    raise self._round_err
                if self._stopped and not self._writer.is_alive():
                    raise OSError("wal closed")
                self._cv.wait(timeout=1.0)

    async def wait_durable(self, seq: int) -> None:
        """Async wait for ticket `seq` — resolves via the writer thread,
        no executor slot consumed per waiter."""
        import asyncio
        import concurrent.futures

        with self._cv:
            if self._committed >= seq:
                return
            if self._stopped and not self._writer.is_alive():
                # the writer already exited (close() raced this waiter);
                # a future registered now would never be resolved
                raise OSError("wal closed")
            if self._round_err is not None and not self._buf and not self._in_round:
                raise self._round_err
            fut: concurrent.futures.Future = concurrent.futures.Future()
            self._futures.append((seq, fut))
        await asyncio.wrap_future(fut)

    @property
    def degraded(self) -> bool:
        """True while the last durability round FAILED and its events sit
        un-fsync'd in the retry buffer. Callers use this as an ingest
        admission gate: new writes are refused (503) instead of being
        applied to memory ahead of a WAL that cannot commit, which bounds
        the served-but-not-durable divergence window to the requests that
        were already in flight when fsync first failed."""
        with self._cv:
            return self._round_err is not None

    # -- writer thread -----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                # park while paused EVEN IF stopped: a two-phase rewrite
                # owns the inner engine until commit/abort resumes us —
                # appending mid-swap would write to a log about to be
                # replaced (close() rejoins after the rewrite resolves)
                while (self._paused
                       or (not self._stopped
                           and not self._buf
                           and self._committed >= self._queued)):
                    self._cv.wait()
                if self._stopped and (
                    (not self._buf and self._committed >= self._queued)
                    or self._round_err is not None  # final retry failed
                ):
                    self._resolve_futures_locked()
                    return
                batch, self._buf = self._buf, []
                target = self._queued
                self._in_round = True
            err: BaseException | None = None
            try:
                if batch:
                    self._inner.append_encoded_nosync(batch)
                self._inner.flush()
            except BaseException as e:  # noqa: BLE001 — surfaced to waiters
                err = e
            with self._cv:
                self._in_round = False
                if err is None:
                    self._committed = max(self._committed, target)
                    self._round_err = None
                else:
                    # restore for a later retry round; see class docstring
                    self._buf[:0] = batch
                    self._round_err = err
                self._resolve_futures_locked()
                self._cv.notify_all()
            if err is not None:
                # avoid a hot fsync-failure loop
                import time

                time.sleep(0.05)

    def _resolve_futures_locked(self) -> None:
        keep = []
        for seq, fut in self._futures:
            if self._committed >= seq:
                if not fut.done():
                    fut.set_result(None)
            elif self._round_err is not None or self._stopped:
                if not fut.done():
                    fut.set_exception(
                        self._round_err or OSError("wal closed")
                    )
            else:
                keep.append((seq, fut))
        self._futures = keep

    # -- compat / maintenance ---------------------------------------------

    def append_events(self, events: list[dict]) -> None:
        self.sync_until(self.append_buffered(events))

    def flush(self) -> None:
        """Force a durability round covering everything queued so far."""
        self.sync_until(self.append_buffered([]))

    def replay(self) -> Iterator[dict]:
        return self._inner.replay()

    def replay_groups(self) -> Iterator[tuple[str, object]] | None:
        """Run-grouped replay when the engine supports it, else None —
        callers fall back to the per-event replay()."""
        fn = getattr(self._inner, "replay_groups", None)
        return fn() if fn is not None else None

    def rewrite(self, events: Iterable[dict]) -> None:
        """Compaction. The caller snapshots state under the backend lock;
        that snapshot already includes any buffered-but-unsynced events
        (they are applied to memory before their fsync), so the buffer is
        dropped and its waiters are satisfied by the rewrite's own fsync."""
        ctx = self.begin_rewrite()
        self.mark_rewrite(ctx)
        try:
            self.commit_rewrite(ctx, events=events)
        except BaseException:
            self.abort_rewrite(ctx)
            raise

    def rewrite_encoded(self, blobs) -> bool:
        """Compaction over pre-encoded frames when the engine supports it
        (native). Returns False when it doesn't (JSON re-encodes from
        dicts) — the caller falls back to rewrite(events). Same buffer
        semantics as rewrite()."""
        if not self.supports_encoded_rewrite:
            return False
        ctx = self.begin_rewrite()
        self.mark_rewrite(ctx)
        try:
            self.commit_rewrite(ctx, blobs=blobs)
        except BaseException:
            self.abort_rewrite(ctx)
            raise
        return True

    @property
    def supports_encoded_rewrite(self) -> bool:
        return getattr(self._inner, "rewrite_encoded", None) is not None

    # -- two-phase compaction ------------------------------------------------
    #
    # The store's compact() stalls queries only for the in-memory state
    # snapshot, not the file write:
    #
    #   ctx = wal.begin_rewrite()          # park the writer thread
    #   with store_lock:
    #       wal.mark_rewrite(ctx)          # buffer watermark = snapshot
    #       items = snapshot(state)        # immutable row refs
    #   wal.commit_rewrite(ctx, blobs=...) # encode + write OUTSIDE the lock
    #
    # Correctness rests on two invariants the store upholds: (1) every
    # buffered append shares one critical section with its memory apply
    # (so at mark time the snapshot contains exactly the events below
    # the watermark), and (2) catalog rows are replaced, never mutated,
    # so refs snapshotted under the lock stay stable while encoding.
    # Appends issued during the file write keep buffering (their memory
    # applies proceed, durability acks wait); on commit they are
    # retained and the resumed writer drains them to the NEW log.

    def begin_rewrite(self) -> dict:
        """Phase 1: park the writer thread so the inner engine belongs
        to the rewriter. Appenders keep buffering; durability waits
        until commit/abort. One rewrite at a time: a second raises."""
        with self._cv:
            if self._paused:
                raise RuntimeError("a WAL rewrite is already in progress")
            self._paused = True
            while self._in_round:
                self._cv.wait()
        return {"watermark": None, "target": None}

    def mark_rewrite(self, ctx: dict) -> None:
        """Phase 2, called under the store lock while snapshotting:
        everything buffered so far is covered by the snapshot (dropped
        on commit); later appends are retained."""
        with self._cv:
            ctx["watermark"] = len(self._buf)
            ctx["target"] = self._queued

    def commit_rewrite(self, ctx: dict, *, blobs=None, events=None) -> None:
        """Phase 3: rewrite the inner log to the snapshot and atomically
        swap, then drop the covered buffer prefix and resolve its
        waiters (the rewrite's own fsync is their durability). On
        failure the inner engine reattached to the ORIGINAL log and the
        buffer is untouched — nothing is dropped before the swap
        succeeds, so no path loses events."""
        try:
            if blobs is not None:
                self._inner.rewrite_encoded(blobs)
            else:
                self._inner.rewrite(events)
        except BaseException:
            self.abort_rewrite(ctx)
            raise
        with self._cv:
            del self._buf[: ctx["watermark"]]
            self._committed = max(self._committed, ctx["target"])
            self._round_err = None
            self._resolve_futures_locked()
            self._paused = False
            self._cv.notify_all()

    def abort_rewrite(self, ctx: dict) -> None:
        """Unpark the writer after a failed/abandoned rewrite. Safe to
        call after commit_rewrite already resumed (idempotent)."""
        with self._cv:
            if self._paused:
                self._paused = False
                self._cv.notify_all()

    def close(self) -> None:
        import threading

        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._writer is not threading.current_thread():
            self._writer.join(timeout=10.0)
        with self._cv:
            # fail any waiter the writer's exit path missed (a future
            # registered between stop and the join) — _stopped makes
            # this reject everything uncommitted, so nothing can park
            # on a dead writer forever
            self._resolve_futures_locked()
        self._inner.close()


def open_wal(path: str, engine: str = "auto"):
    """engine: auto | native | json.

    auto sniffs an existing file's format first (native frames never
    start with '{'): picking the engine by toolchain availability alone
    would silently replay ZERO events from a log written by the other
    engine and then append the wrong format after it."""
    if engine == "auto" and os.path.exists(path) and os.path.getsize(path) > 0:
        with open(path, "rb") as f:
            engine = "json" if f.read(1) == b"{" else "native"
    if engine in ("auto", "native"):
        from ..native import load_walstore

        lib = load_walstore()
        if lib is not None:
            return NativeWal(path, lib)
        if engine == "native":
            raise OSError("native WAL requested but toolchain unavailable")
    return JsonWal(path)
