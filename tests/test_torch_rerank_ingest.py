"""The port's embedding reranker and pull ingest against the reference's.

Reranker: `?rerank=embedding` answers with the reference's JSON bytes
(test_torch_auth_keys.ProdServers), and the reranker alone gives the
same hits and bit-equal scores (host float32 numpy arithmetic on both
sides, ties by record id).

Pull ingest: the same NDJSON spool and the same content-file spool
drained by each package into its own store give equal stored records,
the same ack offset after a simulated stop, and the same done/ and
failed/ moves and per-file errors. The port's spool runs the batch
paths (one multi-hash launch per image shape, one Wang pass per rate);
its records equal the reference's file-at-a-time ones.
"""

import asyncio
import io
import json
import re
import wave

import numpy as np

from test_conformance import LONG_TEXT, PANGRAM, fixed_audio, fixed_png
from test_torch_auth_keys import ProdServers, _env  # noqa: F401 (autouse fixture)
from ucfp_tpu.core import Hit as JHit
from ucfp_tpu.core import HitSource as JHitSource
from ucfp_tpu.core import Query as JQuery
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu.ingest import filesource as jfs
from ucfp_tpu.ingest import source as jsrc
from ucfp_tpu.rerank.embedding import EmbeddingReranker as JReranker
from ucfp_tpu_torch.core import Hit as THit
from ucfp_tpu_torch.core import HitSource as THitSource
from ucfp_tpu_torch.core import Query as TQuery
from ucfp_tpu_torch.index.embedded import EmbeddedBackend as TBackend
from ucfp_tpu_torch.ingest import filesource as tfs
from ucfp_tpu_torch.ingest import source as tsrc
from ucfp_tpu_torch.rerank.embedding import EmbeddingReranker as TReranker

run = asyncio.run
WORDS = "river stone cloud ember frost meadow thunder willow harbor lantern".split()


def _records(n=24, dim=8, seed=0, integer=False):
    """Text records, most with embeddings. integer=True draws small
    integer embeddings, whose first-stage cosines are exact in any
    summation order (the served vector scores are float32 sums, equal
    to the reference's only then); the reranker's own scores are
    bit-equal either way."""
    rng = np.random.default_rng(seed)

    def vec(d):
        v = rng.integers(-4, 5, d) if integer else rng.normal(size=d).round(3)
        return [float(x) for x in v]

    out = []
    for rid in range(1, n + 1):
        rec = {"tenant_id": 0, "record_id": rid, "modality": "text",
               "algorithm": "embedding-local", "fingerprint": [rid % 256],
               "text": " ".join(rng.choice(WORDS, 6))}
        if rid % 5:  # every fifth record has no embedding
            rec["embedding"] = vec(dim)
        if rid % 7 == 0:  # and some have another width
            rec["embedding"] = vec(dim + 2)
        out.append(rec)
    return out


def test_rerank_embedding_route(tmp_path, monkeypatch):
    """Hybrid, vector-only and terms-only queries with ?rerank=embedding."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        assert s.call("POST", "/v1/records", {"records": _records(integer=True)})[0] == 200
        q = [float(x) for x in np.random.default_rng(9).integers(-4, 5, 8)]
        for body in ({"vector": q, "terms": ["river", "frost"]}, {"vector": q},
                     {"terms": ["ember", "willow", "harbor"]},
                     {"vector": [0.0] * 8, "terms": ["river"]}):
            body = {"tenant_id": 0, "modality": "text", "k": 10, **body}
            st, res = s.call("POST", "/v1/query", body, {"rerank": "embedding"})
            assert st == 200 and res["hits"], body
            assert s.call("POST", "/v1/query", body)[0] == 200
            if any(body.get("vector", [])):
                assert {h["source"] for h in res["hits"]} >= {"fused"}
        # the reranker alone on non-integer embeddings: same order,
        # bit-equal scores
        recs = _records()
        q = np.random.default_rng(9).normal(size=8).round(3).tolist()
        j = JBackend(str(tmp_path / "rj"))
        t = TBackend(str(tmp_path / "rt"), device="cpu")
        try:
            from ucfp_tpu.core import Record as JRecord
            from ucfp_tpu.core import Modality as JModality
            from ucfp_tpu_torch.core import Modality as TModality
            from ucfp_tpu_torch.core import Record as TRecord

            for idx, rec_cls, mod in ((j, JRecord, JModality), (t, TRecord, TModality)):
                run(idx.upsert([rec_cls(tenant_id=0, record_id=r["record_id"],
                                        modality=mod.TEXT, algorithm=r["algorithm"],
                                        fingerprint=bytes(r["fingerprint"]),
                                        embedding=r.get("embedding"), text=r["text"])
                                for r in recs]))
            out = []
            for idx, rr, hit, src, query in ((j, JReranker, JHit, JHitSource, JQuery),
                                             (t, TReranker, THit, THitSource, TQuery)):
                hits = [hit(record_id=rid, score=1.0 / rid, source=src.BM25)
                        for rid in range(1, 25)]
                got = run(rr(idx).rerank(query(tenant_id=0, modality="text", k=24,
                                               vector=q), hits))
                out.append([(h.record_id, h.score, h.source.value) for h in got])
            assert out[0] == out[1] and len(out[1]) == 24
        finally:
            j.close()
            t.close()
    finally:
        s.close()


def _rows(n):
    return [json.dumps({"tenant_id": 3, "record_id": i, "modality": "text",
                        "algorithm": "custom-v1", "config_hash": 1,
                        "fingerprint": [1, 2, i % 251], "text": f"row {i}",
                        "embedding": [float(i), 1.0]}) for i in range(n)]


def _stored(idx, ids):
    out = []
    for tid, rid in ids:
        try:
            row = idx.get_record(tid, rid)
        except Exception as e:  # RecordNotFound on both sides
            out.append((tid, rid, type(e).__name__))
            continue
        emb = row["embedding"]
        out.append((tid, rid, row["modality"], row["algorithm"], row["config_hash"],
                    bytes(row["fingerprint"]), row["text"], bytes(row["metadata"] or b""),
                    None if emb is None else np.asarray(emb, np.float32).tobytes()))
    return out


def test_ndjson_spool_resume_after_stop(tmp_path):
    """An NDJSON spool with bad lines: a stop after two batches handed
    out and one acked resumes from the acked offset; the stored records,
    the skipped count and the .ack file equal the reference's."""
    lines = _rows(10)
    lines.insert(4, "not json")
    lines.insert(7, json.dumps({"tenant_id": 3}))
    results = []
    for name, fs, src_mod, backend in (("j", jfs, jsrc, JBackend),
                                        ("t", tfs, tsrc, TBackend)):
        spool = tmp_path / f"{name}.ndjson"
        spool.write_text("\n".join(lines) + "\n")
        kw = {"device": "cpu"} if backend is TBackend else {}
        idx = backend(str(tmp_path / f"{name}-db"), **kw)
        src = fs.NdjsonIngestSource(str(spool))
        b1 = run(src.next_batch(3))
        run(idx.upsert(b1))
        run(src.ack([(r.tenant_id, r.record_id) for r in b1]))
        b2 = run(src.next_batch(3))  # handed out, never acked: the stop
        ack_after_stop = (tmp_path / f"{name}.ndjson.ack").read_text()
        src2 = fs.NdjsonIngestSource(str(spool))
        total = run(src_mod.run_ingest_loop(src2, idx, batch_size=4))
        results.append((ack_after_stop, [r.record_id for r in b2], total, src2.skipped,
                        (tmp_path / f"{name}.ndjson.ack").read_text(),
                        _stored(idx, [(3, i) for i in range(11)])))
        idx.close()
    assert results[0] == results[1]
    assert results[1][2] == 7 and results[1][3] == 2


def _wav(x, sr):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(np.round(x * 32767), -32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _bmp(seed, w=40, h=36):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="BMP")
    return buf.getvalue()


SPOOL = {
    "5_100.txt": PANGRAM.encode(),
    "5_101.png": fixed_png(10, 64, 64),
    "5_102.f32": fixed_audio(3.0, 8000).tobytes(),
    "5_103.txt": b"\xff\xfe broken utf8",
    "5_104.html": f"<html><body><p>{LONG_TEXT}</p></body></html>".encode(),
    "5_105.bmp": _bmp(1),
    "5_106.bmp": _bmp(2),
    "5_107.bmp": _bmp(3, 52, 40),
    "5_113.bmp": _bmp(4, 52, 20),  # below the 32 px minimum
    "5_108.wav": _wav(fixed_audio(2.0, 16000), 16000),
    "5_109.f32": fixed_audio(2.5, 8000).tobytes(),
    "5_110.f32": fixed_audio(0.05, 8000).tobytes(),  # too short for wang
    "5_111.xyz": b"unsupported",
    "5_112.png": b"not a png",
    "6_1.f32": fixed_audio(3.0, 8000)[::-1].copy().tobytes(),
    "notes.md": b"# heading\n\nstable id fingerprint content",
}


def _ids(fs, spool):
    src = fs.SpoolDirectoryIngestSource(str(spool)) if fs is jfs else \
        fs.SpoolDirectoryIngestSource(str(spool), device="cpu")
    return [src._ids_for(spool / name) for name in sorted(SPOOL)]


def test_spool_directory_batches_equal_reference(tmp_path):
    """The mixed content spool: equal stored records, done/ and failed/
    moves and errors; the port's batch (three BMPs of one shape, two
    clips of one length) equals the reference's one-file-at-a-time."""
    results = []
    for name, fs, src_mod, backend in (("j", jfs, jsrc, JBackend),
                                        ("t", tfs, tsrc, TBackend)):
        spool = tmp_path / f"{name}-spool"
        spool.mkdir()
        for fname, data in SPOOL.items():
            (spool / fname).write_bytes(data)
        kw = {"device": "cpu"} if backend is TBackend else {}
        idx = backend(str(tmp_path / f"{name}-db"), **kw)
        src = fs.SpoolDirectoryIngestSource(str(spool), **kw)
        total = run(src_mod.run_ingest_loop(src, idx, batch_size=8))
        results.append((total, sorted(p.name for p in (spool / "done").iterdir()),
                        sorted(p.name for p in (spool / "failed").iterdir()),
                        # PIL's decode errors name an object address
                        [(n, re.sub(r"0x[0-9a-f]+", "0x?", e)) for n, e in src.errors],
                        _stored(idx, _ids(fs, spool))))
        idx.close()
    assert results[0] == results[1]
    assert results[1][0] == 11 and results[1][2] == ["5_103.txt", "5_110.f32",
                                                      "5_111.xyz", "5_112.png",
                                                      "5_113.bmp"]


def test_spool_files_batch_equals_single(tmp_path):
    """fingerprint_files over a batch equals fingerprint_file per file,
    a failing file keeping its own error inside a group that fails."""
    for fname, data in SPOOL.items():
        (tmp_path / fname).write_bytes(data)
    items = [(tmp_path / n, 5, i) for i, n in enumerate(sorted(SPOOL))]
    batch = tfs.fingerprint_files(items, 8000, "cpu")
    for (path, tid, rid), got in zip(items, batch):
        try:
            want = tfs.fingerprint_file(path, tid, rid, 8000, "cpu")
        except Exception as e:
            assert type(got) is type(e), path.name
            assert re.sub(r"0x[0-9a-f]+", "", str(got)) == re.sub(r"0x[0-9a-f]+", "", str(e))
            continue
        assert (got.algorithm, got.fingerprint, got.config_hash) == (
            want.algorithm, want.fingerprint, want.config_hash), path.name


def test_ingest_cli_on_the_cpu(tmp_path, capsys):
    """python -m ucfp_tpu_torch.ingest --device cpu: the spool form and
    the NDJSON form, durable (a fresh open sees the records)."""
    from ucfp_tpu_torch.ingest.__main__ import main

    spool = tmp_path / "spool"
    spool.mkdir()
    for fname in ("5_100.txt", "5_101.png", "5_102.f32", "5_103.txt"):
        (spool / fname).write_bytes(SPOOL[fname])
    assert main(["--data-dir", str(tmp_path / "db"), "--spool", str(spool),
                 "--device", "cpu"]) == 0
    assert "ingested 3 record(s), 1 skipped/failed" in capsys.readouterr().out
    rows = tmp_path / "rows.ndjson"
    rows.write_text("\n".join(_rows(4)) + "\n")
    assert main(["--data-dir", str(tmp_path / "db"), "--ndjson", str(rows),
                 "--device", "cpu"]) == 0
    assert "ingested 4 record(s)" in capsys.readouterr().out
    idx = TBackend(str(tmp_path / "db"), device="cpu")
    try:
        assert idx.get_record(5, 101)["algorithm"] == "imgfprint-multi-v1"
        assert idx.get_record(3, 2)["text"] == "row 2"
    finally:
        idx.close()


def test_spool_hands_each_file_out_once(tmp_path):
    """The reference's directory spool refreshes its listing in the
    middle of a batch without that batch's own picks, so a drain's last
    batch carries its files twice (fingerprinted and upserted twice,
    counted twice). The port's hands each file out once; what is stored
    is the same."""
    results = []
    for name, fs, src_mod, backend in (("j", jfs, jsrc, JBackend),
                                        ("t", tfs, tsrc, TBackend)):
        spool = tmp_path / f"{name}-spool"
        spool.mkdir()
        for i in range(10):
            (spool / f"4_{i}.txt").write_text(f"{PANGRAM} number {i} " * 3)
        kw = {"device": "cpu"} if backend is TBackend else {}
        idx = backend(str(tmp_path / f"{name}-db"), **kw)
        src = fs.SpoolDirectoryIngestSource(str(spool), **kw)
        handed = []
        while True:
            batch = run(src.next_batch(4))
            if not batch:
                break
            handed += [r.record_id for r in batch]
            run(idx.upsert(batch))
            run(src.ack([(r.tenant_id, r.record_id) for r in batch]))
        results.append((handed, _stored(idx, [(4, i) for i in range(10)]),
                        sorted(p.name for p in (spool / "done").iterdir())))
        idx.close()
    (j_handed, j_rows, j_done), (t_handed, t_rows, t_done) = results
    assert j_handed == list(range(8)) + [8, 9, 8, 9]
    assert t_handed == list(range(10))
    assert j_rows == t_rows and j_done == t_done and len(t_done) == 10
